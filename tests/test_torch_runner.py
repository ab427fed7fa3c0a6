"""Port parity: the convexity benchmark's runner of awesome_tpu_torch
(``runner/runner.py``, ``run.py``) against the JAX package's
``AwesomeRunner`` on the same config and bridged params, at a small size
(2 images of 24x24, ``Net(n_hidden=16)``, the fused ICNN prior 12 x 1 with
``proper_prior_fit_retrys: 0``: a retry draws fresh inits from each
package's own RNG, which cannot match by design).

Tolerances: gate IoUs equal (thresholded masks), the training loss history
at rtol 2e-4 (``tests/test_fused_fit.py:37``), ``evaluate()``'s metrics at
atol 1e-3. Resumes are held bitwise. The CLI runs in a subprocess with
``jax`` and ``awesome_tpu`` blocked."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from awesome_tpu.fit.pixel_trainer import shared_pixel_train_init
from awesome_tpu.nn.icnn import ConvexNextNet as JConvexNextNet
from awesome_tpu.runner.config import AwesomeConfig as JConfig
from awesome_tpu.runner.runner import AwesomeRunner as JRunner
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.runner.config import AwesomeConfig
from awesome_tpu_torch.runner.runner import AwesomeRunner, treedef_str
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIST_RTOL = 2e-4
METRIC_ATOL = 1e-3
FUSED = "ops.pallas_mlp.FullyFusedConvexNextNet"


def _kw(folder, **kw):
    base = dict(
        name_experiment="runner",
        dataset_args={"n": 2, "h": 24, "w": 24},
        segmentation_model_args={"n_hidden": 16},
        optimizer_type="adam",
        optimizer_args={"lr": 0.02},
        num_epochs=30,
        compute_metrics_during_training_nth_epoch=10,
        use_extra_penalty_hook=True,
        extra_penalty_after_n_epochs=20,
        pretrain_args={"num_epochs": 30, "proper_prior_fit_retrys": 0},
        runs_path=str(folder),
        output_folder=str(folder),
        seed=5,
    )
    base.update(kw)
    return base


def _port_config(folder, **kw):
    return AwesomeConfig(
        prior_model_type="awesome_tpu_torch.ops.mlp.FullyFusedConvexNextNet",
        prior_model_args={"base": ConvexNextNet(n_hidden=12, device="cpu")},
        device="cpu", **_kw(folder, **kw))


def _bridge_params(jr, tr, mode):
    """The JAX runner's initial params, into the port's runner."""
    if mode == "multi":
        jr.stacked_params = shared_pixel_train_init(
            jr.wrapper, jax.random.PRNGKey(jr.config.seed), len(jr.samples),
            jr._train_cfg(1)).params
        host = jax.device_get(jr.stacked_params)
        tr.stacked_params = {
            "seg": params_from_jax(host["seg"], "cpu"),
            "prior": params_from_jax(host["prior"], "cpu", stacked=1)}
    else:
        tr.stacked_params = params_from_jax(
            jax.device_get(jr.stacked_params), "cpu", stacked=1)


def _assert_metrics_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_ATOL, (k, got[k], ref[k])


_GP = {"criterion": {"__class__": "gradient_penalty", "xygrad": 0.05,
                     "rgbgrad": 0.02}}


@pytest.mark.parametrize("mode, loss_args", [
    ("single", {}), ("none", {}), ("multi", {}), ("single", _GP)],
    ids=["single", "none", "multi", "single-gradient-penalty"])
def test_runner_matches_jax(tmp_path, mode, loss_args):
    """build -> pretrain (gate) -> train (cadenced evals, checkpoints) ->
    evaluate -> refit -> evaluate, in both packages from the same params;
    also with the gradient-penalty criterion (the seg output's input
    gradients penalized)."""
    kw = dict(segmentation_training_mode=mode, loss_args=loss_args)
    jr = JRunner(JConfig(
        prior_model_type="awesome_tpu." + FUSED,
        prior_model_args={"base": JConvexNextNet(n_hidden=12)},
        **_kw(tmp_path / "jax", **kw)))
    tr = AwesomeRunner(_port_config(tmp_path / "port", **kw))
    jr.build()
    tr.build()
    for k, v in jr._batch.items():
        assert np.array_equal(np.asarray(v), tr._batch[k]), k
    _bridge_params(jr, tr, mode)

    pj, pt = jr.pretrain(), tr.pretrain()
    np.testing.assert_array_equal(pt["gate_iou"], pj["gate_iou"])
    rj, rt = jr.train(), tr.train()
    np.testing.assert_allclose(rt["loss_hist"], rj["loss_hist"],
                               rtol=HIST_RTOL)
    _assert_metrics_close(rt["final_metrics"], rj["final_metrics"])
    # the refit without its gate (a retry's fresh inits cannot match)
    jr.sequential_prior_fit(num_steps=20, gate_threshold=None)
    tr.sequential_prior_fit(num_steps=20, gate_threshold=None)
    _assert_metrics_close(tr.evaluate(), jr.evaluate())
    assert tr.tracker.epoch == jr.tracker.epoch == 30


def _pretrained(folder, retries):
    runner = AwesomeRunner(_port_config(
        folder, seed=17, dataset_args={"n": 3, "h": 24, "w": 24},
        pretrain_args={"num_epochs": 3, "proper_prior_fit_retrys": retries}))
    runner.build()
    init = runner.stacked_params["prior"]
    return runner, init, runner.pretrain()


def _slice_equal(a, b, i):
    return all(torch.equal(x, y) for x, y in zip(
        TT.tree_leaves(TT.tree_select(a, i)),
        TT.tree_leaves(TT.tree_select(b, i))))


def test_gate_retries_failures_from_fresh_init(tmp_path):
    """At this seed the untrained seg net gives images 0 and 2
    single-valued unaries (not fitted) and image 1 a fit that misses the
    0.5 IoU gate. With one retry, image 1 is reset to a fresh init (the
    runner's retry seed), refitted for the full step count and reports the
    retry's IoU; images 0 and 2 keep their initial params bitwise though
    their IoUs are under the gate too."""
    from awesome_tpu_torch.fit.prior_fit import (
        FitConfig,
        _init_fresh,
        fit_priors_batched,
    )
    from awesome_tpu_torch.runner.runner import _seeds

    plain, _, res0 = _pretrained(tmp_path / "a", 0)
    runner, init, res = _pretrained(tmp_path / "b", 1)
    assert (res0["gate_iou"] < 0.5).all(), res0
    fitted = runner.stacked_params["prior"]
    for i in (0, 2):
        assert _slice_equal(fitted, init, i)
        assert res["gate_iou"][i] == res0["gate_iou"][i]
    assert not _slice_equal(plain.stacked_params["prior"], init, 1)
    # image 1: the fit of its fresh init
    px = runner._dev_batch["px"]
    with torch.no_grad():
        seg = torch.func.vmap(lambda p, x: runner.wrapper.apply(
            p, x, evaluate_prior=False))(runner.stacked_params, px)
    prior = runner.wrapper.prior_module
    ref, aux = fit_priors_batched(
        prior, _init_fresh(prior, _seeds(runner.config.seed + 7, 3)),
        px[..., 0:2], (seg >= 0.5).float(),
        FitConfig(num_steps=3, gate_threshold=0.5, gate_retries=0),
        point_masks=runner._dev_batch["valid"])
    assert _slice_equal(fitted, ref, 1)
    assert res["gate_iou"][1] == float(aux["gate_iou"][1])


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_resume_bitwise(tmp_path, mode):
    """A run preempted at epoch 20 (its 'end' checkpoint holds the full
    train state) and restarted with ``resume=True`` ends where the
    uninterrupted 40-epoch run ends, bit for bit; the extra-penalty switch
    at epoch 30 falls after the resume point."""
    kw = dict(num_epochs=40, extra_penalty_after_n_epochs=30,
              use_lr_on_plateau_scheduler=True, do_pretraining=False,
              compute_metrics_during_training_nth_epoch=20,
              segmentation_training_mode=mode)
    full = AwesomeRunner(_port_config(tmp_path / "full", **kw))
    full.build()
    res_full = full.train()
    part = AwesomeRunner(_port_config(tmp_path / "part",
                                      **dict(kw, num_epochs=20)))
    part.build()
    part.train()
    assert os.path.isdir(os.path.join(part.output_folder, "checkpoints",
                                      "end"))
    resumed = AwesomeRunner(_port_config(tmp_path / "part", resume=True,
                                         **kw))
    resumed.build()
    res = resumed.train()
    for a, b in zip(TT.tree_leaves(full.stacked_params),
                    TT.tree_leaves(resumed.stacked_params)):
        assert torch.equal(a, b)
    lf, lr_ = res_full["loss_hist"], res["loss_hist"]
    assert lr_.shape[1] == 20
    np.testing.assert_array_equal(lf[:, -20:], lr_)
    assert resumed.tracker.epoch == full.tracker.epoch == 40


def test_run_folder_matches_jax_layout(tmp_path):
    """``save_results`` writes the four files of the run layout; params.npz
    holds the leaves in ``jax.tree_util``'s order and the JAX package's
    layout, treedef.txt the JAX tree's structure."""
    runner = AwesomeRunner(_port_config(tmp_path, num_epochs=20,
                                        do_pretraining=False))
    runner.build()
    runner.train()
    out = runner.save_results()
    for name in ("config.yaml", "tracker.json", "params.npz",
                 "treedef.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    host = params_to_numpy(runner.stacked_params, 1)
    leaves, treedef = jax.tree_util.tree_flatten(host)
    with np.load(os.path.join(out, "params.npz")) as data:
        saved = [data[f"arr_{i}"] for i in range(len(data.files))]
    assert len(saved) == len(leaves)
    for a, b in zip(saved, leaves):
        np.testing.assert_array_equal(a, b)
    with open(os.path.join(out, "treedef.txt")) as f:
        assert f.read() == str(treedef) == treedef_str(host)
    loaded = AwesomeConfig.load(os.path.join(out, "config.yaml"))
    assert loaded.prior_model_args["base"].n_hidden == 12
    assert loaded.device == "cpu"


def test_cli_runs_without_jax(tmp_path):
    """``python -m awesome_tpu_torch.run --device cpu`` end to end, with
    ``jax`` and ``awesome_tpu`` blocked in ``sys.modules``."""
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'awesome_tpu', 'tensorflow'):\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['run'] + {_cli_args(tmp_path)!r}\n"
        "runpy.run_module('awesome_tpu_torch.run', run_name='__main__')\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'awesome_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    runs = [d for d in os.listdir(tmp_path) if d.endswith("_cli")]
    assert len(runs) == 1
    out = os.path.join(tmp_path, runs[0])
    for name in ("config.yaml", "tracker.json", "params.npz", "treedef.txt",
                 "pretrain_state.npz"):
        assert os.path.exists(os.path.join(out, name)), name
    assert "Results in" in res.stderr


def _cli_args(folder):
    return ["--device", "cpu", "--num-epochs", "20", "--name-experiment",
            "cli", "--runs-path", str(folder),
            "--dataset-args", "{n: 2, h: 24, w: 24}",
            "--segmentation-model-args", "{n_hidden: 16}",
            "--prior-model-type", "awesome_tpu." + FUSED,
            "--prior-model-args",
            "{base: {__class__: awesome_tpu.nn.icnn.ConvexNextNet, "
            "n_hidden: 12}}",
            "--pretrain-args", "{num_epochs: 10}"]


@pytest.mark.parametrize("option, error, match", [
    (dict(mesh_shape=[2, 1]), ValueError, "needs 2 processes"),
    (dict(segmentation_model_type="awesome_tpu.nn.seg.CNNNet"), ValueError,
     "convolutional"),
])
def test_options_left_out_raise(tmp_path, option, error, match):
    """A mesh larger than the world (two positions in one process, no
    process group) raises, as JAX's ``make_mesh`` does for devices;
    CNNNet in pixel mode raises as in the JAX runner (a conv net needs
    image mode)."""
    with pytest.raises(error, match=match):
        AwesomeRunner(_port_config(tmp_path, **option)).build()


def test_fbms_config_exits_naming_the_item(tmp_path):
    """An FBMS config routes to ``run.main_fbms``; without its sequence
    directory it exits naming the directory it looked for."""
    from awesome_tpu_torch import run

    cfg = _port_config(
        tmp_path, dataset_type="awesome_tpu.data.fbms.FBMSSequenceDataset",
        dataset_args={"dataset": {"dataset_path": str(tmp_path / "none")}})
    cfg.prepare()
    with pytest.raises(SystemExit, match="FBMS sequence directory .*none"):
        run.main(cfg)


def test_segmentation_state_warm_start(tmp_path):
    """``segmentation_model_state_dict_path``: every image's seg net
    starts from the saved tree; a missing path keeps the fresh init."""
    from awesome_tpu_torch.fit.checkpoint import save_pytree

    donor = AwesomeRunner(_port_config(tmp_path / "donor", seed=9))
    donor.build()
    seg = TT.tree_select(donor.stacked_params["seg"], 1)
    path = str(tmp_path / "seg_state")
    save_pytree(seg, path)
    runner = AwesomeRunner(_port_config(
        tmp_path / "warm", segmentation_model_state_dict_path=path))
    runner.build()
    for i in range(len(runner.samples)):
        for a, b in zip(TT.tree_leaves(TT.tree_select(
                runner.stacked_params["seg"], i)), TT.tree_leaves(seg)):
            assert torch.equal(a, b)
    cold = AwesomeRunner(_port_config(
        tmp_path / "cold", segmentation_model_state_dict_path=path + "x"))
    cold.build()
    fresh = AwesomeRunner(_port_config(tmp_path / "fresh"))
    fresh.build()
    for a, b in zip(TT.tree_leaves(cold.stacked_params),
                    TT.tree_leaves(fresh.stacked_params)):
        assert torch.equal(a, b)
