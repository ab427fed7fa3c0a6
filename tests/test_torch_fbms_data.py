"""Port parity: the FBMS data layer of awesome_tpu_torch
(``data/fbms.py``, ``data/weak_label_processing.py`` and the sequence
writers of ``data/synthetic.py``) against the JAX package's on the same
files and seeds, at the JAX FBMS tests' size (5 frames of 24x32).

Everything here is host numpy, so every comparison is exact: the parsed
trajectories (the native and the Python parser of each package), masks,
weak unaries, seeded flips, GT descriptions and the dataset's samples are
equal, and the writers write the same bytes."""
import os

import numpy as np
import pytest

from awesome_tpu.data import fbms as JF
from awesome_tpu.data import synthetic as JS
from awesome_tpu.data import weak_label_processing as JW
from awesome_tpu_torch.data import fbms as TF
from awesome_tpu_torch.data import synthetic as TS
from awesome_tpu_torch.data import weak_label_processing as TW
from tests.test_multi_object_joint import _write_two_object_sequence
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    return TS.write_synthetic_fbms_sequence(
        str(tmp_path_factory.mktemp("fbms")), n_frames=5, h=24, w=32,
        seed=0)


@pytest.mark.parametrize("kw", [dict(), dict(name="cars3", n_frames=4,
                                             h=30, w=40, seed=7)],
                         ids=["default", "cars3-30x40"])
def test_writer_is_byte_identical(tmp_path, kw):
    port = TS.write_synthetic_fbms_sequence(str(tmp_path / "port"), **kw)
    jax_ = JS.write_synthetic_fbms_sequence(str(tmp_path / "jax"), **kw)
    got, ref = _tree_files(port), _tree_files(jax_)
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name] == ref[name], name


def _assert_trajs_equal(got, ref, line_start=True):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.object_id == b.object_id
        np.testing.assert_array_equal(a.coordinates, b.coordinates)
        np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
        if line_start:
            assert a.line_start == b.line_start


def test_parsers_equal_and_build_outside_native(seq):
    """Both parsers of the port and of the JAX package give the same
    trajectories; the port's native parser is built under
    ``build/awesome_tpu_torch/`` and nothing is written under
    ``native/``."""
    native_dir = os.path.join(REPO, "native")
    before = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
              for f in os.listdir(native_dir)}
    path = os.path.join(seq, "tracks", "multicut", "syn99.dat")
    native = TF.parse_trajectories_file(path, use_native=True)
    assert TF._TRAJ_LIB is not None
    lib = str(TF.build_trajectory_parser())
    assert lib.startswith(os.path.join(REPO, "build", "awesome_tpu_torch"))
    python = TF.parse_trajectories_file(path, use_native=False)
    assert len(native) == 32
    _assert_trajs_equal(native, python)
    _assert_trajs_equal(python, JF.parse_trajectories_file(
        path, use_native=False))
    _assert_trajs_equal(native, JF.parse_trajectories_file(path),
                        line_start=False)
    after = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
             for f in os.listdir(native_dir)}
    assert after == before


def test_parser_falls_back_to_python(seq, monkeypatch, caplog):
    """A native parser that cannot be built leaves the Python parser,
    with one logged warning."""
    monkeypatch.setattr(TF, "TRAJ_SOURCE",
                        TF.TRAJ_SOURCE.with_name("missing_parser.cpp"))
    monkeypatch.setattr(TF, "_TRAJ_LIB", None)
    monkeypatch.setattr(TF, "_TRAJ_LIB_FAILED", False)
    path = os.path.join(seq, "tracks", "multicut", "syn99.dat")
    with caplog.at_level("WARNING", logger=TF.__name__):
        got = TF.parse_trajectories_file(path)
    assert "Python parser" in caplog.text
    assert TF._TRAJ_LIB is None
    _assert_trajs_equal(got, JF.parse_trajectories_file(
        path, use_native=False))


def test_masks_unaries_and_mappings_match_jax(seq):
    path = os.path.join(seq, "tracks", "multicut", "syn99.dat")
    trajs = TF.parse_trajectories_file(path, use_native=False)
    jtrajs = JF.parse_trajectories_file(path, use_native=False)
    for frame in range(5):
        for a, b in zip(TF.trajectories_frame_to_mask(trajs, frame, (24, 32)),
                        JF.trajectories_frame_to_mask(jtrajs, frame,
                                                      (24, 32))):
            np.testing.assert_array_equal(a, b)
        for flip in (0.0, 0.3):
            got = TF.weak_label_unaries(trajs, frame, (24, 32),
                                        flip_probability=flip,
                                        rng=np.random.default_rng(frame))
            ref = JF.weak_label_unaries(jtrajs, frame, (24, 32),
                                        flip_probability=flip,
                                        rng=np.random.default_rng(frame))
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
        for k in (None, 1, 3):
            for a, b in zip(
                    TF.multi_object_weak_labels(trajs, frame, (24, 32),
                                                max_objects=k),
                    JF.multi_object_weak_labels(jtrajs, frame, (24, 32),
                                                max_objects=k)):
                np.testing.assert_array_equal(a, b)
    gt = np.zeros((24, 32), np.uint8)
    gt[4:10, 5:12], gt[14:20, 3:9] = 100, 200
    for a, b in zip(TF.value_mask_to_channels(gt),
                    JF.value_mask_to_channels(gt)):
        np.testing.assert_array_equal(a, b)
    gtc, gt_ids = TF.value_mask_to_channels(gt)
    weak, weak_ids = TF.trajectories_frame_to_mask(trajs, 0, (24, 32))
    m = TF.gt_object_id_weak_label_mapping(gtc, gt_ids, weak > 0, weak_ids)
    assert m == JF.gt_object_id_weak_label_mapping(gtc, gt_ids, weak > 0,
                                                   weak_ids)
    assert TF.weak_label_id_gt_mapping(m) == JF.weak_label_id_gt_mapping(m)


def _assert_samples_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if ref[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(), dict(flip_probability=0.3, noise_seed=5),
    dict(do_weak_label_preprocessing=True, use_memory_cache=True)],
    ids=["plain", "flips", "preprocessed"])
def test_dataset_matches_jax(seq, tmp_path, kw):
    """Frames, weak unaries (seeded flips, outlier preprocessing with its
    disk cache), GT, (x, y, t) channels, the multi-object view, GT
    channels and the GT <-> weak-label id mapping, frame by frame."""
    if kw.get("do_weak_label_preprocessing"):
        kw = dict(kw, processed_weak_labels_dir=str(tmp_path / "port"))
        jkw = dict(kw, processed_weak_labels_dir=str(tmp_path / "jax"))
    else:
        jkw = kw
    ds, jds = TF.FBMSSequenceDataset(seq, **kw), JF.FBMSSequenceDataset(
        seq, **jkw)
    assert len(ds) == len(jds) == 5
    assert ds.get_ground_truth_indices() == jds.get_ground_truth_indices()
    assert ds.batch_settings == TF.FBMSSequenceDataset(seq).batch_settings
    for i in range(5):
        _assert_samples_equal(ds.sample(i), jds.sample(i))
        _assert_samples_equal(ds.sample_multi(i, max_objects=2),
                              jds.sample_multi(i, max_objects=2))
    for i in ds.get_ground_truth_indices():
        for a, b in zip(ds.load_ground_truth_channels(i),
                        jds.load_ground_truth_channels(i)):
            np.testing.assert_array_equal(a, b)
        assert ds.object_id_mapping(i) == jds.object_id_mapping(i)
    if kw.get("do_weak_label_preprocessing"):
        assert sorted(os.listdir(tmp_path / "port")) == sorted(
            os.listdir(tmp_path / "jax"))
        again = TF.FBMSSequenceDataset(seq, **kw)  # from the disk cache
        _assert_samples_equal(again.sample(1), jds.sample(1))


def test_two_object_sequence_and_gt_description(tmp_path):
    seq = str(_write_two_object_sequence(tmp_path))
    ds, jds = TF.FBMSSequenceDataset(seq), JF.FBMSSequenceDataset(seq)
    name = os.path.basename(seq)
    d = TF.GroundTruthDescription.from_file(
        os.path.join(seq, "GroundTruth", f"{name}Def.dat"))
    jd = JF.GroundTruthDescription.from_file(
        os.path.join(seq, "GroundTruth", f"{name}Def.dat"))
    assert d.total_number_of_regions == jd.total_number_of_regions
    assert d.total_number_of_frames == jd.total_number_of_frames
    assert [(f.file_name, f.frame_index) for f in d.frame_descriptions] == [
        (f.file_name, f.frame_index) for f in jd.frame_descriptions]
    np.testing.assert_array_equal(d.scale_of_regions, jd.scale_of_regions)
    np.testing.assert_array_equal(d.confusion_penalty_matrix,
                                  jd.confusion_penalty_matrix)
    for i in range(len(jds)):
        _assert_samples_equal(ds.sample_multi(i, max_objects=3),
                              jds.sample_multi(i, max_objects=3))
    for i in jds.get_ground_truth_indices():
        assert ds.object_id_mapping(i) == jds.object_id_mapping(i)


def _noisy_scene(seed):
    rng = np.random.default_rng(seed)
    unaries = np.ones((96, 96), np.float32)
    labeled = rng.random((96, 96)) < 0.05
    unaries[20:50, 20:60] = 0.0
    unaries[90, 5] = 0.0  # an isolated fg point
    labeled[90, 5] = True
    conf = rng.random((96, 96)).astype(np.float32)
    conf[rng.random((96, 96)) < 0.1] = -1
    return unaries, labeled, conf


@pytest.mark.parametrize("seed", [0, 3])
def test_weak_label_processing_matches_jax(seed):
    unaries, labeled, conf = _noisy_scene(seed)
    for a, b in zip(TW.remove_foreground_outliers(unaries, labeled),
                    JW.remove_foreground_outliers(unaries, labeled)):
        np.testing.assert_array_equal(a, b)
    for thr in (900, 10):
        for a, b in zip(
                TW.flip_probabilities(unaries, labeled,
                                      bg_support_threshold=thr),
                JW.flip_probabilities(unaries, labeled,
                                      bg_support_threshold=thr)):
            np.testing.assert_array_equal(a, b)
    p_fg, p_bg = TW.flip_probabilities(unaries, labeled)
    np.testing.assert_array_equal(
        TW.flip_on_probability(unaries, p_fg, p_bg,
                               np.random.default_rng(seed)),
        JW.flip_on_probability(unaries, p_fg, p_bg,
                               np.random.default_rng(seed)))
    for a, b in zip(
            TW.relabel_uncertain(unaries, labeled, conf,
                                 rng=np.random.default_rng(seed)),
            JW.relabel_uncertain(unaries, labeled, conf,
                                 rng=np.random.default_rng(seed))):
        np.testing.assert_array_equal(a, b)
    for c in (None, conf):
        for a, b in zip(
                TW.process_weak_label(unaries, labeled, c, seed=seed),
                JW.process_weak_label(unaries, labeled, c, seed=seed)):
            np.testing.assert_array_equal(a, b)


def test_fbms_paths_resolve_to_the_port():
    """An FBMS config's class paths (the JAX package's and the
    reference's) resolve through ``PORT_MODULES`` to this package."""
    from awesome_tpu_torch.runner.config import (
        AwesomeConfig,
        translate_reference_value,
    )
    from awesome_tpu_torch.serialization.jsonconv import (
        dynamic_import,
        port_path,
    )

    for jax_path, port in (
            ("awesome_tpu.data.fbms.FBMSSequenceDataset",
             TF.FBMSSequenceDataset),
            ("awesome_tpu.data.weak_label_processing.process_weak_label",
             TW.process_weak_label),
            ("awesome_tpu.runner.fbms_runner.FBMSRunner", None),
            ("awesome_tpu.nn.noisy_path_connected.noisy_path_connected_net",
             None)):
        path = port_path(jax_path)
        assert path.startswith("awesome_tpu_torch."), path
        obj = dynamic_import(path)
        assert port is None or obj is port
    ref = "awesome.dataset.fbms_sequence_dataset.FBMSSequenceDataset"
    assert translate_reference_value(ref) == \
        "awesome_tpu_torch.data.fbms.FBMSSequenceDataset"
    cfg = AwesomeConfig(dataset_type=ref, device="cpu")
    cfg.prepare()
    assert dynamic_import(cfg.dataset_type) is TF.FBMSSequenceDataset
