"""Port parity: multi-object joint training in awesome_tpu_torch's FBMS
runner (``train_joint_multi_object``: the children's pretrain, the
multi-object epochs with their eval cadence, ``evaluate_multi_object``)
against the JAX package's ``FBMSRunner`` on the JAX tests' two-object
sequence (4 frames of 24x32, objects 1 and 2), two slots, the prior 8
hidden x 2 flows with an ICNN 12 x 1 and the full-width ``UNet(4, 2)``.

The joint state comes from the JAX package's ``multi_object_train_init``
on the same key, handed to the port's runner by monkeypatching its
``multi_object_train_init`` (the runner draws its own init from a
``torch.Generator``). Growth draws fresh children from each package's own
RNG, so the parity run does not grow; the bitwise CPU resume below does.

Tolerances (``tests/test_torch_trainer.py``): the first step's loss at
rtol 1e-4, the epoch's at rtol 1e-3, ``evaluate_multi_object`` at atol
1e-3. Resumes, joint and multi-object, are held bitwise, and the joint
loop's watchdog, baseline evaluation and frame dumps are checked."""
import os

import jax
import numpy as np
import pytest
import torch

from awesome_tpu.fit import trainer as JT
from awesome_tpu.nn import seg as JS
from awesome_tpu.nn import wrapper as JW
from awesome_tpu.nn.multi_prior import MultiPriorModule as JMultiPrior
from awesome_tpu.runner import fbms_runner as JR
from awesome_tpu_torch.bridge import params_from_jax
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.data.synthetic import write_synthetic_fbms_sequence
from awesome_tpu_torch.runner import fbms_runner as TR
from tests.test_multi_object_joint import _write_two_object_sequence
from torch_one_thread import one_torch_thread  # noqa: F401

SMALL = dict(prior_hidden_units=8, prior_flows=2, convex_hidden_units=12,
             convex_hidden_layers=1)
STEP_RTOL, EPOCH_RTOL, METRIC_ATOL = 1e-4, 1e-3, 1e-3
TRAIN = dict(max_objects=2, num_epochs=1, batch_size=2, lr=1e-3,
             prior_lr=1e-3, seed=2, pretrain_steps=10, eval_nth_epoch=1)


@pytest.fixture
def one_thread():
    """One intra-op thread for the port-only runs below: the suite's
    other workers share the cores (each run is held to itself, so the
    thread count cannot change what they compare)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def multi_runs(tmp_path_factory):
    seq = str(_write_two_object_sequence(tmp_path_factory.mktemp("two")))
    jr = JR.FBMSRunner(JR.FBMSExperimentConfig(dataset_path=seq, **SMALL))
    tr = TR.FBMSRunner(TR.FBMSExperimentConfig(dataset_path=seq, **SMALL),
                       device="cpu")
    jr.build()
    tr.build()
    jw = JW.WrapperModule(
        segmentation_module=JS.UNet(in_chn=4, out_chn=2),
        prior_module=JMultiPrior(child=jr._joint_prior_model(),
                                 max_priors=2),
        input_mode="image", prior_arg_mode="param_clean_grid",
        seg_stateful=True)
    j0 = jax.device_get(JT.multi_object_train_init(
        jw, jax.random.PRNGKey(TRAIN["seed"]), len(jr.dataset),
        JT.JointTrainConfig(), initial_count=2))
    seg_init = (params_from_jax(j0.seg_params, "cpu"),
                params_from_jax(j0.seg_state, "cpu"))
    prior_init = params_from_jax(j0.prior_params, "cpu", stacked=2)
    real_init = TR.multi_object_train_init

    def bridged_init(wrapper, generator, num_images, cfg, initial_count=1,
                     seg_init_=None, prior_init_=None):
        return real_init(wrapper, generator, num_images, cfg,
                         initial_count=initial_count, seg_init=seg_init,
                         prior_init=prior_init)

    rj = jr.train_joint_multi_object(**TRAIN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR, "multi_object_train_init", bridged_init)
        rt = tr.train_joint_multi_object(**TRAIN)
    return {"jr": jr, "tr": tr, "rj": rj, "rt": rt}


def test_multi_object_training_matches_jax(multi_runs):
    """The children's pretrain, then one epoch of 2 batches of 2."""
    lt, lj = np.asarray(multi_runs["rt"]["loss"]), np.asarray(
        multi_runs["rj"]["loss"])
    assert lt.shape == lj.shape == (2,)
    np.testing.assert_allclose(lt[0], lj[0], rtol=STEP_RTOL)
    np.testing.assert_allclose(lt, lj, rtol=EPOCH_RTOL)
    assert multi_runs["rt"]["growth_events"] == []
    assert multi_runs["rt"]["stopped_early"] is False


def test_evaluate_multi_object_matches_jax(multi_runs):
    et = multi_runs["tr"].evaluate_multi_object()
    ej = multi_runs["jr"].evaluate_multi_object()
    for key in ("prior_iou_per_object", "seg_iou_per_object"):
        assert sorted(et[key]) == sorted(ej[key]) == [1, 2], key
        for oid, v in ej[key].items():
            assert abs(et[key][oid] - v) <= METRIC_ATOL, (key, oid)
            assert 0.0 <= et[key][oid] <= 1.0
    st = multi_runs["tr"].joint_tracker.series
    sj = multi_runs["jr"].joint_tracker.series
    assert set(st) == set(sj)
    for key in sj:
        assert st[key].steps == sj[key].steps, key
        np.testing.assert_allclose(st[key].values, sj[key].values,
                                   atol=METRIC_ATOL, rtol=EPOCH_RTOL,
                                   err_msg=str(key))


def _state_leaves(state):
    return [x for x in TT.tree_leaves(tuple(state)) if x is not None]


@pytest.mark.parametrize("kind", ["joint", "multi"])
def test_resume_is_bitwise(tmp_path, kind, one_thread):
    """A run stopped after epoch 1 and resumed to epoch 3 equals the
    uninterrupted run in every leaf of its state, in its losses and in
    its LR schedule (a stepping one, so its restored state matters); the
    multi-object run grows from one slot to two when epoch 2 starts,
    after the resume (fresh slots drawn from the epoch's seed)."""
    seq = write_synthetic_fbms_sequence(str(tmp_path), n_frames=5, h=24,
                                        w=32)
    sched = {"type": "step", "gamma": 0.5, "step_size": 1}
    if kind == "joint":
        kw = dict(batch_size=2, lr=1e-3, prior_lr=1e-3, scheduler=sched,
                  eval_nth_epoch=1)
        train, attr = "train_joint", "joint_state"
    else:
        kw = dict(max_objects=2, initial_count=1, grow_at_epoch={1: 2},
                  batch_size=2, lr=1e-3, prior_lr=1e-3, pretrain_steps=5,
                  scheduler=sched, eval_nth_epoch=1)
        train, attr = "train_joint_multi_object", "multi_state"

    def run(epochs, **extra):
        r = TR.FBMSRunner(TR.FBMSExperimentConfig(dataset_path=seq,
                                                  **SMALL),
                          device="cpu").build()
        return r, getattr(r, train)(num_epochs=epochs, **kw, **extra)

    full, res_full = run(3)
    ck = str(tmp_path / "ck")
    run(1, checkpoint_dir=ck)
    resumed, res = run(3, checkpoint_dir=ck, resume=True)
    assert res["loss"] == res_full["loss"][3:]  # 3 batches of 2 per epoch
    a, b = getattr(full, attr), getattr(resumed, attr)
    for x, y in zip(_state_leaves(a), _state_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if kind == "joint":
        assert res["final_lr_scale"] == res_full["final_lr_scale"] == 0.125
    else:
        assert res["growth_events"] == res_full["growth_events"] == [(1, 2)]
    s = resumed.joint_tracker.series[
        ("MeanForegroundBinaryMIOU", "epoch", "eval")]
    assert s.steps == [1, 2, 3], s.steps


def test_watchdog_baseline_eval_and_plot_dumps(tmp_path, one_thread):
    """The LR watchdog stops a step-decayed run once lr reaches its floor
    (after that epoch's evaluation); ``eval_epoch0`` records the
    untrained baseline at epoch 0; ``plot_indices`` dumps the chosen
    frames every ``plot_nth_epoch``, as the JAX runner's
    ``tests/test_fbms_joint.py`` runs do."""
    seq = write_synthetic_fbms_sequence(str(tmp_path), n_frames=5, h=24,
                                        w=32)
    r = TR.FBMSRunner(TR.FBMSExperimentConfig(dataset_path=seq, **SMALL),
                      device="cpu").build()
    plots = tmp_path / "plots"
    res = r.train_joint(num_epochs=10, batch_size=2, lr=1e-3, prior_lr=1e-3,
                        scheduler={"type": "step", "gamma": 0.1,
                                   "step_size": 2},
                        watchdog_lr=2e-6, eval_nth_epoch=4, eval_epoch0=True,
                        plot_indices=[0, 2], plot_nth_epoch=3,
                        plot_dir=str(plots))
    # lr 1e-3 decays x0.1 every 2 epochs: 1e-6 <= 2e-6 after epoch 6
    assert res["stopped_early"] is True
    assert len(res["loss"]) == 6 * 3 and np.isfinite(res["loss"]).all()
    assert res["final_lr_scale"] == pytest.approx(1e-3)
    s = r.joint_tracker.series[("MeanForegroundBinaryMIOU", "epoch", "eval")]
    assert s.steps == [0, 4, 6], s.steps
    for idx in (0, 2):
        assert sorted(os.listdir(plots / f"{idx:03d}")) == ["e00003",
                                                            "e00006"]
