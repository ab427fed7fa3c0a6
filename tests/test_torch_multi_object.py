"""Port parity: multi-object priors (``nn/multi_prior.py``) and the
multi-object joint trainer (``fit/trainer.py``) of awesome_tpu_torch
against the JAX package on the same weights and batches, at a small size
(a full-width UNet with 2 output channels on 32x32 images; children a
small ICNN or a small flagship prior).

Tolerances are ``tests/test_torch_trainer.py``'s: losses rtol 1e-4 (an
epoch's rtol 1e-3), grads (read from the first moments a step leaves) rtol
2e-3 and an atol of 1e-4 of the largest, params after a step an atol of 2
x lr per step. Inactive slots, weight-0 samples, rows outside the batch
and the old slots across growth are held bitwise; so is a CPU resume
against an uninterrupted run.

The step's batch is made from seed 3. With seeds 1, 2 and 6-8 a relu
input of the UNet lies within float32 rounding of 0 (5e-8 for seed 1), so
a float32 and a float64 run of the same package already take the relu
on different sides there, and the seg grads of every layer below it
move by up to 1% of the largest grad; no comparison at the trainer's
tolerances can hold across such a flip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.fit import trainer as JT
from awesome_tpu.nn import icnn as JI
from awesome_tpu.nn import multi_prior as JMP
from awesome_tpu.nn import seg as JS
from awesome_tpu.nn import wrapper as JW
from awesome_tpu.nn.path_connected import (
    real_nvp_path_connected_net as j_factory,
)
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.fit import checkpoint as TC
from awesome_tpu_torch.fit import trainer as TTR
from awesome_tpu_torch.fit.tracker import Tracker
from awesome_tpu_torch.nn import icnn as TI
from awesome_tpu_torch.nn import multi_prior as TMP
from awesome_tpu_torch.nn import seg as TS
from awesome_tpu_torch.nn import wrapper as TW
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
H = W = 32
K = 2
LR = 1e-3


def _children(prior: str, shape=(H, W)):
    if prior == "icnn":
        return (JI.ConvexNextNet(n_hidden=8, n_hidden_layers=1),
                TI.ConvexNextNet(n_hidden=8, n_hidden_layers=1, device=CPU))
    pkw = dict(channels=2, hidden_units=8, flow_n_flows=2,
               flow_output_fn="tanh", spatial_shape=shape,
               convex_net_hidden_units=8, convex_net_hidden_layers=1)
    return j_factory(**pkw), t_factory(device=CPU, **pkw)


def _wrappers(prior: str, shape=(H, W)):
    jc, tc = _children(prior, shape)
    kw = dict(input_mode="image", prior_arg_mode="param_clean_grid",
              seg_stateful=True)
    jw = JW.WrapperModule(
        segmentation_module=JS.UNet(in_chn=4, out_chn=K),
        prior_module=JMP.MultiPriorModule(child=jc, max_priors=K), **kw)
    tw = TW.WrapperModule(
        segmentation_module=TS.UNet(in_chn=4, out_chn=K, device=CPU),
        prior_module=TMP.MultiPriorModule(tc, max_priors=K), **kw)
    return jw, tw


def _states(jw, tw, num_images, active=None, **cfg_kw):
    cfg_kw = dict(dict(lr=LR, prior_lr=LR), **cfg_kw)
    jcfg = JT.JointTrainConfig(**cfg_kw)
    tcfg = TTR.JointTrainConfig(**cfg_kw)
    js = JT.multi_object_train_init(jw, jax.random.PRNGKey(0), num_images,
                                    jcfg, initial_count=1)
    if active is not None:
        js = js._replace(active=jnp.asarray(active))
    jst = jax.device_get(js)
    ts = TTR.multi_object_train_init(
        tw, None, num_images, tcfg, initial_count=1,
        seg_init=(params_from_jax(jst.seg_params, device=CPU),
                  params_from_jax(jst.seg_state, device=CPU)),
        prior_init={"children": params_from_jax(
            jst.prior_params["children"], device=CPU, stacked=2)})
    if active is not None:
        ts = ts._replace(active=torch.tensor(np.asarray(active)))
    return jcfg, tcfg, js, ts


def _data(t, seed=1, shape=(H, W)):
    h, w = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tgt = np.ones((t, h, w, K), np.float32)
    for i in range(t):
        for k in range(K):
            cy, cx = rng.uniform(0.3, 0.7) * h, (0.3 + 0.4 * k) * w
            tgt[i, :, :, k] = (((yy - cy) / 5) ** 2 + ((xx - cx) / 4) ** 2
                               > 1.0)
    return {
        "image": rng.uniform(size=(t, h, w, 3)).astype(np.float32),
        "features": rng.uniform(size=(t, h, w, 1)).astype(np.float32),
        "grid": np.asarray(JG.flatten_grid(JG.pixel_grid((h, w)))),
        "target_obj": tgt,
        "labeled": rng.uniform(size=(t, h, w)) < 0.2,
    }


def _np(tree, stacked=False):
    return jax.tree_util.tree_leaves(params_to_numpy(tree, stacked=stacked))


def _jnp(tree):
    return [np.asarray(x) for x in
            jax.tree_util.tree_leaves(jax.device_get(tree))]


def _assert_grads(t_m, j_m, stacked=False):
    got, ref = _np(t_m, stacked), _jnp(j_m)
    top = max(np.abs(r).max() for r in ref)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4 * top)


def _assert_params(t_p, j_p, steps=1, stacked=False):
    for a, b in zip(_np(t_p, stacked), _jnp(j_p)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * steps)


def _slots_equal(t_tree, j_tree, frames, slot):
    for a, b in zip(_np(t_tree, 2), _jnp(j_tree)):
        np.testing.assert_array_equal(a[frames, slot], b[frames, slot])


# --- the module --------------------------------------------------------------


@pytest.mark.parametrize("prior", ["icnn", "flagship"])
def test_multi_prior_module_matches_jax(prior):
    """apply (N, K), combine over the active slots, the active mask, the
    convexity clip, the param groups, and (flagship) the per-object
    deformation and inverse."""
    jc, tc = _children(prior, (8, 8))
    jm = (JMP.MultipleObjectsPathConnectedNet if prior == "flagship"
          else JMP.MultiPriorModule)(child=jc, max_priors=3)
    tm = (TMP.MultipleObjectsPathConnectedNet if prior == "flagship"
          else TMP.MultiPriorModule)(tc, max_priors=3)
    rng = np.random.default_rng(3)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    # push the clipped weights negative so the clip has work to do
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.standard_normal(a.shape).astype(a.dtype), jp)
    tp = params_from_jax(jp, device=CPU, stacked=True)
    x = rng.uniform(size=(40, 2)).astype(np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.tensor(x))
    assert got.shape == (40, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tm.apply(tp, torch.tensor(x), num_priors=2).numpy(),
        np.asarray(jm.apply(jp, jnp.asarray(x), num_priors=2)), rtol=1e-5,
        atol=1e-6)
    for count in (1, 2, 3, None):
        np.testing.assert_allclose(
            tm.combine(got, count).numpy(),
            np.asarray(jm.combine(jnp.asarray(ref), count)), rtol=1e-5,
            atol=1e-6)
    np.testing.assert_array_equal(tm.active_mask(2).numpy(),
                                  np.asarray(jm.active_mask(2)))
    clipped = tm.enforce_convexity(tp)
    for a, b in zip(_np(clipped, True),
                    _jnp(jm.enforce_convexity(jp))):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_leaves(tm.param_groups(tp)) == \
        jax.tree_util.tree_leaves(jm.param_groups(jp))
    if prior == "flagship":
        for i in range(3):
            d = tm.deformation(tp, torch.tensor(x), index=i)
            np.testing.assert_allclose(
                d.numpy(), np.asarray(jm.deformation(jp, jnp.asarray(x),
                                                     index=i)),
                rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(
                tm.inverse(tp, d, index=i).numpy(), x, atol=1e-4)


def test_multi_prior_growth_and_images():
    """assure_prior_count keeps the old slots bitwise and fills the new
    ones; apply_images equals apply per image (shared and per-image
    points)."""
    _, tc = _children("icnn")
    tm = TMP.MultiPriorModule(tc, max_priors=3)
    p = tm.init(torch.Generator().manual_seed(0))
    grown = tm.assure_prior_count(p, 1, 3, key=7)
    for a, b in zip(TT.tree_leaves(grown), TT.tree_leaves(p)):
        assert torch.equal(a[0], b[0]) and not torch.equal(a[1:], b[1:])
    assert tm.assure_prior_count(p, 2, 2) is not p
    with pytest.raises(ValueError):
        tm.assure_prior_count(p, 1, 4)
    stacked = TT.stack_trees([tm.init(torch.Generator().manual_seed(s))
                              for s in (1, 2)])
    x = torch.rand(2, 30, 2, generator=torch.Generator().manual_seed(3))
    per = tm.apply_images(stacked["children"], x)
    shared = tm.apply_images(stacked["children"], x[0])
    for b in range(2):
        one = TT.tree_select(stacked, b)
        torch.testing.assert_close(per[b], tm.apply(one, x[b]), rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(shared[b], tm.apply(one, x[0]),
                                   rtol=1e-6, atol=1e-7)


# --- the trainer -------------------------------------------------------------


def _batches(d, index, weight=None):
    jb = {k: jnp.asarray(v) for k, v in d.items()}
    tb = {k: torch.tensor(v) for k, v in d.items()}
    jb["index"], tb["index"] = jnp.asarray(index), torch.tensor(index)
    if weight is not None:
        jb["weight"], tb["weight"] = (jnp.asarray(weight),
                                      torch.tensor(weight))
    return jb, tb


@pytest.mark.parametrize("prior", ["icnn", "flagship"])
def test_multi_object_step_matches_jax(prior):
    """One step on frames 1 and 3 of 4 (frame 3 at weight 0), slot 1
    active on frame 1 only: the loss, the seg and child grads, the
    batch-norm state, the updated params; inactive slots, the weight-0
    frame and the frames outside the batch stay bitwise as they were."""
    jw, tw = _wrappers(prior)
    active = np.array([[1, 0], [1, 1], [1, 0], [1, 1]], bool)
    jcfg, tcfg, js, ts = _states(jw, tw, 4, active=active)
    d = _data(2, seed=3)
    jb, tb = _batches(d, [1, 3], [1.0, 0.0])
    jnew, jmet = jax.jit(JT.make_multi_object_train_step(jw, jcfg))(js, jb)
    tnew, tmet = TTR.make_multi_object_train_step(tw, tcfg)(ts, tb)
    np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]),
                               rtol=1e-4)
    assert not bool(tmet["nan_skipped"]) and int(tnew.step) == 1
    _assert_grads(tnew.seg_opt.m, jnew.seg_opt.m)
    _assert_grads(TT.tree_map(lambda x: x[1], tnew.prior_opt.m),
                  jax.tree_util.tree_map(lambda x: x[1], jnew.prior_opt.m),
                  stacked=True)
    for a, b in zip(_np(tnew.seg_state), _jnp(jnew.seg_state)):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(b).max(), 1.0))
    _assert_params(tnew.seg_params, jnew.seg_params)
    _assert_params(tnew.prior_params, jnew.prior_params, stacked=2)
    np.testing.assert_array_equal(tnew.prior_opt.count.numpy(),
                                  np.asarray(jnew.prior_opt.count))
    assert tnew.prior_opt.count.tolist() == [[0, 0], [1, 1], [0, 0], [0, 0]]
    # untouched: frames 0 and 2, the weight-0 frame 3
    for tree_t, tree_j in ((tnew.prior_params, js.prior_params),
                           (tnew.prior_opt.m, js.prior_opt.m),
                           (tnew.prior_opt.u, js.prior_opt.u)):
        for slot in range(K):
            _slots_equal(tree_t, tree_j, [0, 2, 3], slot)


def test_multi_object_inactive_slot_bitwise_and_nan_guard():
    """An inactive slot of a trained frame keeps params and state as they
    were; a non-finite loss skips the whole update and says so."""
    jw, tw = _wrappers("icnn")
    jcfg, tcfg, js, ts = _states(jw, tw, 3)
    d = _data(2, seed=5)
    _, tb = _batches(d, [0, 2])
    step = TTR.make_multi_object_train_step(tw, tcfg)
    new, _ = step(ts, tb)
    _slots_equal(new.prior_params, js.prior_params, [0, 1, 2], 1)
    _slots_equal(new.prior_opt.m, js.prior_opt.m, [0, 1, 2], 1)
    assert new.prior_opt.count.tolist() == [[1, 0], [0, 0], [1, 0]]
    tb["image"][0, 0, 0, 0] = float("nan")
    skipped, met = step(ts, tb)
    assert bool(met["nan_skipped"])
    # (the batch-norm running stats take the batch's NaN, as in JAX)
    for a, b in zip(TT.tree_leaves((skipped.seg_params, skipped.seg_opt,
                                    skipped.prior_params, skipped.prior_opt)),
                    TT.tree_leaves((ts.seg_params, ts.seg_opt,
                                    ts.prior_params, ts.prior_opt))):
        assert torch.equal(a, b)


def test_multi_object_epoch_matches_jax():
    """One epoch over 3 frames in batches of 2 (the tail padded at weight
    0) on the same plan: every batch's loss and the state after it."""
    idx, wgt = TTR.epoch_batches(3, 2, np.random.default_rng(0))
    assert wgt[-1].tolist() == [1.0, 0.0]
    jw, tw = _wrappers("icnn")
    jcfg, tcfg, js, ts = _states(jw, tw, 3)
    d = _data(3, seed=4)
    jnew, jmet = jax.jit(JT.make_multi_object_epoch_fn(jw, jcfg))(
        js, {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(idx),
        jnp.asarray(wgt))
    tnew, tmet = TTR.make_multi_object_epoch_fn(tw, tcfg)(
        ts, {k: torch.tensor(v) for k, v in d.items()}, idx, wgt)
    assert tmet["loss"].shape == (2,) and int(tnew.step) == 2
    np.testing.assert_allclose(tmet["loss"].numpy(),
                               np.asarray(jmet["loss"]), rtol=1e-3)
    _assert_params(tnew.seg_params, jnew.seg_params, steps=2)
    _assert_params(tnew.prior_params, jnew.prior_params, stacked=2)
    np.testing.assert_array_equal(tnew.prior_opt.count.numpy(),
                                  np.asarray(jnew.prior_opt.count))


def test_growth_keeps_old_slots_and_zeroes_new():
    """After a step, growing 1 -> 2 keeps slot 0's params and moments
    bitwise; slot 1 gets fresh params, zero moments and count 0 (as the
    JAX package's growth does); shrinking only lowers the mask."""
    jw, tw = _wrappers("icnn")
    jcfg, tcfg, js, ts = _states(jw, tw, 3)
    _, tb = _batches(_data(2, seed=6), [0, 1])
    stepped, _ = TTR.make_multi_object_train_step(tw, tcfg)(ts, tb)
    grown = TTR.assure_multi_prior_count(tw, stepped, tcfg, 2, key=11)
    jgrown = JT.assure_multi_prior_count(jw, js, jcfg, 2,
                                         jax.random.PRNGKey(11))
    np.testing.assert_array_equal(grown.active.numpy(),
                                  np.asarray(jgrown.active))
    for new, old in ((grown.prior_params, stepped.prior_params),
                     (grown.prior_opt, stepped.prior_opt)):
        for a, b in zip(TT.tree_leaves(new), TT.tree_leaves(old)):
            assert torch.equal(a[:, 0], b[:, 0])
    for a, b in zip(TT.tree_leaves(grown.prior_params),
                    TT.tree_leaves(stepped.prior_params)):
        assert not torch.equal(a[:, 1], b[:, 1])
    assert not grown.prior_opt.count[:, 1].any()
    for a in TT.tree_leaves((grown.prior_opt.m, grown.prior_opt.u)):
        assert not a[:, 1].any()
    with pytest.raises(ValueError):
        TTR.assure_multi_prior_count(tw, stepped, tcfg, 3, key=0)
    shrunk = TTR.assure_multi_prior_count(tw, grown, tcfg, 1, key=0)
    assert shrunk.active.tolist() == [[True, False]] * 3
    assert all(torch.equal(a, b) for a, b in zip(
        TT.tree_leaves(shrunk.prior_params),
        TT.tree_leaves(grown.prior_params)))


def _train(tw, cfg, state, data, epochs, rng, tracker, ckdir=None,
           start=0, grow_at=1):
    """The multi-object loop of the FBMS runner, cut down: growth to 2 at
    ``grow_at``, one epoch a step of the plan stream, the tracker's Loss,
    a resumable 'latest' save each epoch and 'best' when it improves."""
    epoch_fn = TTR.make_multi_object_epoch_fn(tw, cfg)
    for _ in range(start):
        TTR.epoch_batches(4, 2, rng)
    for e in range(start, epochs):
        if e == grow_at:
            state = TTR.assure_multi_prior_count(tw, state, cfg, 2, key=e)
        idx, wgt = TTR.epoch_batches(4, 2, rng)
        state, met = epoch_fn(state, data, idx, wgt)
        tracker.epoch = e + 1
        tracker.epoch_metric("Loss", met["loss"].mean())
        tags = ["latest"] + (["best"] if
                             tracker.is_current_state_best_model() else [])
        for tag in tags if ckdir else ():
            with TC.atomic_dir(f"{ckdir}/{tag}") as tmp:
                TC.AgentCheckpoint(
                    "multi", {"seg": state.seg_params,
                              "prior": state.prior_params},
                    tracker=tracker.to_dict(),
                    extra={"epoch": e + 1, "state_kind": "multi"}).save(tmp)
                TC.save_pytree(tuple(state), f"{tmp}/train_state")
    return state


def test_cpu_resume_is_bitwise(tmp_path):
    """4 epochs uninterrupted against 2 epochs, a save, a restore into a
    freshly built state and 2 more: every leaf of the final state (params,
    both optimizers, batch-norm stats, active, step) is bitwise equal,
    and so is the tracker."""
    shape = (16, 16)
    jw, tw = _wrappers("icnn", shape)
    _, tcfg, _, fresh = _states(jw, tw, 4)
    d = {k: torch.tensor(v) for k, v in _data(4, seed=7, shape=shape).items()}
    d["grid"] = torch.tensor(np.asarray(JG.flatten_grid(
        JG.pixel_grid(shape))))
    full_tracker = Tracker(primary_metric="Loss", primary_mode="train")
    full = _train(tw, tcfg, fresh, d, 4, np.random.default_rng(0),
                  full_tracker)
    ck = str(tmp_path / "ck")
    _train(tw, tcfg, fresh, d, 2, np.random.default_rng(0),
           Tracker(primary_metric="Loss", primary_mode="train"), ck)
    _, _, _, template = _states(jw, tw, 4)
    res = TC.restore_resumable(ck, "multi", template, 4)
    assert res["epoch"] == 2 and res["best"] is not None
    assert res["state"].active.dtype == torch.bool
    assert res["state"].prior_opt.count.dtype == torch.int32
    resumed = _train(tw, tcfg, res["state"], d, 4, np.random.default_rng(0),
                     res["tracker"], start=2)
    for a, b in zip(TT.tree_leaves(tuple(full)), TT.tree_leaves(
            tuple(resumed))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert res["tracker"].to_dict() == full_tracker.to_dict()
