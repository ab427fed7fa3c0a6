"""Port parity: joint UNet + per-frame prior training in awesome_tpu_torch's
FBMS runner (``runner/fbms_runner.py``: ``pretrain_joint_priors`` ->
``train_joint`` with its eval cadence and checkpoints ->
``evaluate_joint``) against the JAX package's ``FBMSRunner`` on the same
5-frame 24x32 synthetic sequence, the prior 8 hidden x 2 flows with an
ICNN 12 x 1 and the full-width ``UNet(4, 1)`` the runner builds.

The JAX runner's pretrained priors are bridged into the port's
``joint_prior_init``; the joint state's UNet comes from the JAX package's
``joint_train_init`` on the same key, handed to the port's runner by
monkeypatching its ``joint_train_init`` (the runner draws its own init
from a ``torch.Generator``, which cannot match JAX's by design).

Tolerances (``tests/test_torch_trainer.py``): the first step's loss at
rtol 1e-4, every step of the epoch at rtol 1e-3, ``evaluate_joint`` and
the tracker's eval series at atol 1e-3."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from awesome_tpu.fit import trainer as JT
from awesome_tpu.nn import seg as JS
from awesome_tpu.nn import wrapper as JW
from awesome_tpu.runner import fbms_runner as JR
from awesome_tpu_torch.bridge import params_from_jax
from awesome_tpu_torch.data.synthetic import write_synthetic_fbms_sequence
from awesome_tpu_torch.runner import fbms_runner as TR

from torch_one_thread import one_torch_thread  # noqa: F401

SMALL = dict(prior_hidden_units=8, prior_flows=2, convex_hidden_units=12,
             convex_hidden_layers=1)
STEP_RTOL, EPOCH_RTOL, METRIC_ATOL = 1e-4, 1e-3, 1e-3
TRAIN = dict(num_epochs=1, batch_size=2, lr=1e-3, prior_lr=1e-3, seed=2,
             eval_nth_epoch=1)


@pytest.fixture
def one_thread():
    """One intra-op thread for the port-only run below: the suite's other
    workers share the cores (the run is held to itself, so the thread
    count cannot change what it checks)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    return write_synthetic_fbms_sequence(
        str(tmp_path_factory.mktemp("fbms")), n_frames=5, h=24, w=32)


def _jax_initial_state(jr, seed, prior_init):
    """What the JAX runner's ``train_joint`` starts from."""
    jw = JW.WrapperModule(
        segmentation_module=JS.UNet(in_chn=4, out_chn=1),
        prior_module=jr._joint_prior_model(), input_mode="image",
        prior_arg_mode="param_clean_grid", seg_stateful=True)
    return jax.device_get(JT.joint_train_init(
        jw, jax.random.PRNGKey(seed), len(jr.dataset),
        JT.JointTrainConfig(), prior_init=prior_init))


@pytest.fixture(scope="module")
def joint_runs(seq, tmp_path_factory):
    root = tmp_path_factory.mktemp("joint")
    jr = JR.FBMSRunner(JR.FBMSExperimentConfig(dataset_path=seq, **SMALL))
    tr = TR.FBMSRunner(TR.FBMSExperimentConfig(dataset_path=seq, **SMALL),
                       device="cpu")
    jr.build()
    tr.build()
    pre = jr.pretrain_joint_priors(num_steps=30, reuse_state_steps=10,
                                   lr=5e-3)
    tr.joint_prior_init = params_from_jax(
        jax.device_get(jr.joint_prior_init), "cpu", stacked=1)
    j0 = _jax_initial_state(jr, TRAIN["seed"], jr.joint_prior_init)
    seg_init = (params_from_jax(j0.seg_params, "cpu"),
                params_from_jax(j0.seg_state, "cpu"))
    real_init = TR.joint_train_init

    def bridged_init(wrapper, generator, num_images, cfg, seg_init_=None,
                     prior_init=None):
        return real_init(wrapper, generator, num_images, cfg,
                         seg_init=seg_init, prior_init=prior_init)

    rj = jr.train_joint(checkpoint_dir=str(root / "jax"), **TRAIN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR, "joint_train_init", bridged_init)
        rt = tr.train_joint(checkpoint_dir=str(root / "port"), **TRAIN)
    return {"jr": jr, "tr": tr, "rj": rj, "rt": rt, "root": root,
            "pre": pre}


def test_train_joint_matches_jax(joint_runs):
    """One epoch of 3 batches of 2 (the tail padded at weight 0)."""
    lt, lj = np.asarray(joint_runs["rt"]["loss"]), np.asarray(
        joint_runs["rj"]["loss"])
    assert lt.shape == lj.shape == (3,)
    np.testing.assert_allclose(lt[0], lj[0], rtol=STEP_RTOL)
    np.testing.assert_allclose(lt, lj, rtol=EPOCH_RTOL)
    assert joint_runs["rt"]["stopped_early"] is False
    assert joint_runs["rt"]["final_lr_scale"] == \
        joint_runs["rj"]["final_lr_scale"]


def test_evaluate_joint_and_tracker_match_jax(joint_runs):
    tr, jr = joint_runs["tr"], joint_runs["jr"]
    et, ej = tr.evaluate_joint(), jr.evaluate_joint()
    assert set(et) == set(ej) and et["num_gt_frames"] == 2
    for k in ej:
        assert abs(et[k] - ej[k]) <= METRIC_ATOL, (k, et[k], ej[k])
        assert 0.0 <= et[k] <= (1.0 if k != "num_gt_frames" else 2)
    st, sj = tr.joint_tracker.series, jr.joint_tracker.series
    assert set(st) == set(sj)
    for key in sj:
        assert st[key].steps == sj[key].steps, key
        np.testing.assert_allclose(st[key].values, sj[key].values,
                                   atol=METRIC_ATOL, rtol=EPOCH_RTOL,
                                   err_msg=str(key))


def test_joint_checkpoints_and_run_folder(joint_runs, tmp_path):
    """best/latest/end saves as the JAX runner makes them, and the
    joint run folder in the JAX runner's layout."""
    from awesome_tpu_torch.fit.checkpoint import find_resumable
    from awesome_tpu_torch.runner.config import AwesomeConfig

    from awesome_tpu_torch.fit.checkpoint import pytree_exists

    ck = joint_runs["root"] / "port"
    for tag in ("best", "latest", "end"):
        metas = []
        for root in (ck, joint_runs["root"] / "jax"):
            with open(root / tag / "meta.json") as f:
                metas.append(json.load(f))
        assert metas[0]["name"] == metas[1]["name"], tag
        assert metas[0]["extra"] == metas[1]["extra"], tag
        for sub in ("params", "train_state"):
            assert pytree_exists(str(ck / tag / sub)), (tag, sub)
    epoch, _, meta = find_resumable(str(ck), "joint")
    assert epoch == 1 and meta["extra"]["sched"]["scale"] == 1.0
    tr = joint_runs["tr"]
    tr.awesome_config = AwesomeConfig(device="cpu",
                                      output_folder=str(tmp_path / "run"))
    out = tr.save_joint_results()
    for name in ("config.yaml", "tracker.json", "params.npz",
                 "treedef.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    assert tr.export_tensorboard(str(tmp_path / "tb")) == str(tmp_path / "tb")


def test_evaluate_joint_with_crf_matches_jax(joint_runs):
    """``evaluate_joint(compute_crf=True)``: one batched CRF call over the
    GT frames on each side, its IoU and pixel accuracy at atol 1e-3."""
    tr, jr = joint_runs["tr"], joint_runs["jr"]
    et, ej = tr.evaluate_joint(compute_crf=True), \
        jr.evaluate_joint(compute_crf=True)
    assert set(et) == set(ej)
    assert {"CRFMeanForegroundBinaryMIOU", "CRFMeanPixelAccuracy"} <= set(et)
    for k in ej:
        assert abs(et[k] - ej[k]) <= METRIC_ATOL, (k, et[k], ej[k])


def test_train_joint_eval_crf_reaches_the_crf(seq, joint_runs, tmp_path,
                                              monkeypatch, one_thread):
    """``train_joint(eval_crf=True)`` refines with the CRF at the epoch-0
    baseline and at every evaluation tick (port only, one epoch from the
    bridged priors)."""
    tr = TR.FBMSRunner(TR.FBMSExperimentConfig(dataset_path=seq, **SMALL),
                       device="cpu").build()
    tr.joint_prior_init = joint_runs["tr"].joint_prior_init
    seen = []
    real = tr.evaluate_joint

    def spy(compute_crf=False):
        seen.append(compute_crf)
        return real(compute_crf=compute_crf)

    monkeypatch.setattr(tr, "evaluate_joint", spy)
    tr.train_joint(checkpoint_dir=str(tmp_path / "ck"), eval_crf=True,
                   eval_epoch0=True, **TRAIN)
    assert seen == [True, True]
    series = tr.joint_tracker.series[("CRFMeanForegroundBinaryMIOU", "epoch",
                                      "eval")]
    assert series.steps == [0, 1]
