"""Port parity: the ported scripts (``build_all_configs``,
``run_fbms_table``, ``run_noise_curve``) and the runner helpers of
``runner/functions.py`` (GIF writer, ``saveable``, the SAM-mask utilities,
the space-time tube), against the JAX package's.

The scripts replay reference YAMLs that the repository does not hold, so
their assembly is what is tested here: the synthetic sequence byte for
byte, the FBMS table and the noise curve on run folders written in the
ResultModel layout (held to the JAX scripts' pandas frames and
arithmetic at atol 1e-12), the build/train routing on configs written
here, and the exit naming a missing config directory."""
import importlib.util
import json
import math
import os

import numpy as np
import pytest

from awesome_tpu.analytics import result_model as JR
from awesome_tpu.runner import functions as JFN
from awesome_tpu_torch.analytics import result_model as TR
from awesome_tpu_torch.fit.tracker import Tracker
from awesome_tpu_torch.runner import functions as TFN
from awesome_tpu_torch.runner.config import AwesomeConfig
from awesome_tpu_torch.scripts import build_all_configs as TB
from awesome_tpu_torch.scripts import run_fbms_table as TT
from awesome_tpu_torch.scripts import run_noise_curve as TN
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-12


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_write_sequence_byte_for_byte(tmp_path):
    jb = _jax_script("build_all_configs")
    for kw in ({}, {"n_frames": 10, "h": 48, "w": 64, "n_fg": 60,
                    "n_bg": 140}):
        got = TB.write_sequence(str(tmp_path / "port"), **kw)
        ref = jb.write_sequence(str(tmp_path / "jax"), **kw)
        assert os.path.relpath(got, tmp_path / "port") == \
            os.path.relpath(ref, tmp_path / "jax")
        a, b = _files(tmp_path / "port"), _files(tmp_path / "jax")
        assert a and a == b


def _run_folder(root, name, seed, series, pretrain_args=None):
    """A run folder in the ResultModel layout: ``series`` is a list of
    (epoch, {metric: value}) eval records."""
    d = os.path.join(root, name)
    AwesomeConfig(name_experiment=name, seed=seed, device="cpu",
                  pretrain_args=pretrain_args or {}).save(
        os.path.join(d, "config.yaml"))
    t = Tracker()
    for epoch, metrics in series:
        t.epoch = epoch
        for k, v in metrics.items():
            t.epoch_metric(k, v, "eval")
    t.save(os.path.join(d, "tracker.json"))
    return d


def _same(a, b):
    if isinstance(b, float) and math.isnan(b):
        return a is None or (isinstance(a, float) and math.isnan(a))
    if isinstance(b, (float, np.floating)):
        return abs(a - float(b)) <= ATOL
    return a == b


def test_fbms_table_matches_the_jax_script(tmp_path):
    """Three seed runs (one without CRF metrics): the per-run rows and the
    Sequential/Joint summary equal the JAX script's DataFrames; the
    markdown and LaTeX files are written; the standing checks pass on
    them and fail on a degraded joint IoU."""
    rng = np.random.default_rng(0)
    dirs = []
    for i, seed in enumerate((42, 47, 131)):
        names = list(TT.COLS) if i else list(TT.COLS)[:4]
        # the baseline at epoch 0 below the joint epochs
        series = [(e, {n: float(rng.uniform(0.3, 0.6) + 0.15 * e / 2)
                       for n in names}) for e in (0, 2, 4)]
        dirs.append(_run_folder(str(tmp_path / "runs"), f"run{seed}", seed,
                                series))
    jt = _jax_script("run_fbms_table")
    df, summary = jt.assemble_table(dirs, str(tmp_path / "jax"))
    per_run, got = TT.assemble_table(dirs, str(tmp_path / "port"),
                                      device="cpu")
    assert per_run.columns == list(df.columns)
    for row, (_, ref) in zip(per_run.rows, df.iterrows()):
        for c in per_run.columns:
            assert _same(row[c], ref[c]), (c, row[c], ref[c])
    assert got.columns == [""] + list(summary.columns)
    assert [r[""] for r in got.rows] == list(summary.index)
    for r in got.rows:
        for c in summary.columns:
            assert _same(r[c], summary.loc[r[""], c]), (r[""], c)
    for name in ("fbms_table.md", "fbms_table.tex"):
        assert os.path.getsize(tmp_path / "port" / name) > 0
    with open(tmp_path / "port" / "fbms_table.tex") as f:
        tex = f.read()
    assert "\\hline" in tex and "Prior IoU" in tex
    TT.check_summary(got)
    got.rows[1]["IoU"] = got.rows[0]["IoU"] - 0.05
    with pytest.raises(AssertionError, match="joint IoU"):
        TT.check_summary(got)
    got.rows[1]["IoU"] = 1.5
    with pytest.raises(AssertionError, match=r"out of \[0, 1\]"):
        TT.check_summary(got)


def test_noise_curve_matches_the_jax_script(tmp_path):
    """Mean and sample std per noise level, from the same run folders, as
    the JAX script computes them; the markdown and JSON written."""
    rng = np.random.default_rng(1)
    dirs = []
    for level in (0.0, 0.1, 0.3):
        for seed in ((42, 47, 131) if level < 0.3 else (42,)):
            dirs.append(_run_folder(
                str(tmp_path / "runs"), f"np{level}_s{seed}", seed,
                [(0, {TN.METRIC: float(rng.uniform(0.2, 0.9))})],
                pretrain_args={"noisy_percentage": level}))
    # the JAX script's arithmetic (scripts/run_noise_curve.py:104-116)
    curve = JR.ResultComparison([JR.NoisyUnariesResultModel.from_path(d)
                                 for d in dirs]).noise_curve(TN.METRIC)
    by_level = {}
    for noise, v in curve:
        by_level.setdefault(noise, []).append(v)
    mean_ref = {lvl: sum(vs) / len(vs)
                for lvl, vs in sorted(by_level.items())}
    std_ref = {lvl: (sum((v - mean_ref[lvl]) ** 2 for v in vs)
                     / max(len(vs) - 1, 1)) ** 0.5
               for lvl, vs in sorted(by_level.items())}
    out = str(tmp_path / "out")
    os.makedirs(out)
    mean, std = TN.write_curve(
        [TR.NoisyUnariesResultModel.from_path(d, device="cpu")
         for d in dirs], out, n_frames=10)
    assert list(mean) == list(mean_ref) == [0.0, 0.1, 0.3]
    for lvl in mean_ref:
        assert abs(mean[lvl] - mean_ref[lvl]) <= ATOL
        assert abs(std[lvl] - std_ref[lvl]) <= ATOL
    assert std[0.3] == 0.0
    with open(os.path.join(out, "noise_curve.md")) as f:
        md = f.read()
    assert "| 0.1 |" in md and "MeanForegroundBinaryMIOU" in md
    with open(os.path.join(out, "noise_curve.json")) as f:
        rep = json.load(f)
    assert rep["n_frames"] == 10 and len(rep["points"]) == len(dirs)
    assert TN._jobs(["a_np0_0.yaml", "b_np0_0.yaml", "c_np0_1.yaml"],
                    [7]) == [("a_np0_0.yaml", None), ("b_np0_0.yaml", None),
                             ("c_np0_1.yaml", None), ("a_np0_0.yaml", 7),
                             ("c_np0_1.yaml", 7)]


@pytest.mark.parametrize("script", [TB, TT, TN])
def test_scripts_name_a_missing_config_directory(tmp_path, script):
    missing = str(tmp_path / "no_reference" / "config")
    with pytest.raises(SystemExit) as exc:
        script.main(["--config-root", missing, "--device", "cpu",
                     "--out", str(tmp_path / "out")])
    assert missing in str(exc.value)


def test_default_config_root_is_inside_the_repository():
    """The scripts read nothing around the checkout unless asked:
    ``--config-root`` defaults to ``reference/config`` in this repo."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert TB.REFERENCE_CONFIG == os.path.join(repo, "reference", "config")


def test_build_and_train_routing(tmp_path):
    """``build_one`` and ``train_one`` on configs written here: a
    convexity config (build, then a reduced train with metrics in range)
    and an FBMS joint config built on the synthetic sequence."""
    seq = TB.write_sequence(str(tmp_path / "seq"))
    conv = str(tmp_path / "convexity.yaml")
    AwesomeConfig(name_experiment="c", device="cuda",
                  segmentation_model_args={"n_hidden": 8},
                  prior_model_args={"n_hidden": 8, "n_hidden_layers": 1},
                  num_epochs=5, pretrain_args={"num_epochs": 50}).save(conv)
    runs = str(tmp_path / "runs")
    TB.build_one(conv, seq, runs, device="cpu")
    res = TB.train_one(conv, seq, runs, device="cpu")
    assert res["mode"] == "convexity"
    assert all(0.0 <= v <= 1.0 for k, v in res["metrics"].items()
               if "IOU" in k.upper())
    fbms = str(tmp_path / "fbms.yaml")
    AwesomeConfig(name_experiment="f", device="cuda",
                  dataset_type="awesome_tpu.data.fbms.FBMSSequenceDataset",
                  dataset_args={"dataset": {"dataset_path": "unused"}},
                  prior_model_args={"hidden_units": 8, "flow_n_flows": 2,
                                    "convex_net_hidden_units": 8,
                                    "convex_net_hidden_layers": 1},
                  num_epochs=1).save(fbms)
    TB.build_one(fbms, seq, runs, device="cpu")


# --- runner/functions.py helpers ----------------------------------------------


def test_write_gif_equals_jax(tmp_path):
    frames = [np.random.default_rng(i).uniform(size=(12, 16, 3))
              for i in range(3)]
    got = TFN.write_gif(frames, str(tmp_path / "port" / "a.gif"), 80)
    ref = JFN.write_gif(frames, str(tmp_path / "jax" / "a.gif"), 80)
    with open(got, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_sam_helpers_equal_jax():
    rng = np.random.default_rng(5)
    masks = [rng.uniform(size=(10, 12)) > t for t in (0.2, 0.5, 0.8, 0.9)]
    scores = [0.95, 0.7, 0.85, 0.99]
    for kw in ({}, {"scores": scores}, {"scores": scores, "base_value": 9}):
        np.testing.assert_array_equal(TFN.sam_masks_to_label_mask(masks, **kw),
                                      JFN.sam_masks_to_label_mask(masks, **kw))
    for kw in ({}, {"min_score": 0.5, "min_area": 20, "max_area": 90}):
        gm, gs = TFN.filter_sam_masks(masks, scores, **kw)
        rm, rs = JFN.filter_sam_masks(masks, scores, **kw)
        assert gs == rs and len(gm) == len(rm)
        for a, b in zip(gm, rm):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TFN.sam_masks_to_label_mask([])


def test_saveable_and_space_time_tube(tmp_path):
    pytest.importorskip("matplotlib")
    vol = np.zeros((4, 10, 12), bool)
    vol[:, 3:7, 4:9] = True
    path = str(tmp_path / "fig" / "tube.png")
    fig = TFN.plot_space_time_tube(vol, max_points=50, path=path)
    assert fig is not None and os.path.getsize(path) > 0
    assert TFN.saveable(lambda: None)() is None
