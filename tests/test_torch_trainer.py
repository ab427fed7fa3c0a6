"""Port parity: the joint training step and epoch of awesome_tpu_torch
(UNet plus per-image priors in a WrapperModule) against the JAX package's
``make_joint_train_step`` / ``make_joint_epoch_fn`` on the same weights and
batches, at a small size (a full-width UNet on 32x32 images, so the
deepest batch norm sees 2x2 pixels per image; the prior a small ICNN or
the flagship model).

Tolerances: the loss terms at rtol 1e-4; the grads, read from the first
moments the step leaves (Adam's and Adamax's m is 0.1 x the grad after one
step), at rtol 2e-3 and an atol of 1e-4 of the largest; the batch-norm
running stats at rtol 1e-4; the params after a step at an atol of 2 x lr
(an element whose tiny grad differs in sign between the packages moves by
+lr in one and -lr in the other). The rows of images outside the batch,
and a padded (weight-0) sample's row, are held bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.fit import trainer as JT
from awesome_tpu.nn import icnn as JI
from awesome_tpu.nn import seg as JS
from awesome_tpu.nn import wrapper as JW
from awesome_tpu.nn.path_connected import (
    real_nvp_path_connected_net as j_factory,
)
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.fit import trainer as TTR
from awesome_tpu_torch.nn import icnn as TI
from awesome_tpu_torch.nn import seg as TS
from awesome_tpu_torch.nn import wrapper as TW
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)

CPU = "cpu"
H = W = 32
LR = 1e-3


def _wrappers(prior: str):
    kw = dict(input_mode="image", prior_arg_mode="param_clean_grid",
              seg_stateful=True)
    if prior == "icnn":
        jp_mod = JI.ConvexNextNet(n_hidden=8, n_hidden_layers=1)
        tp_mod = TI.ConvexNextNet(n_hidden=8, n_hidden_layers=1, device=CPU)
    else:
        pkw = dict(channels=2, hidden_units=8, flow_n_flows=2,
                   flow_output_fn="tanh", spatial_shape=(H, W),
                   convex_net_hidden_units=8, convex_net_hidden_layers=1)
        jp_mod, tp_mod = j_factory(**pkw), t_factory(device=CPU, **pkw)
    jw = JW.WrapperModule(segmentation_module=JS.UNet(in_chn=4, out_chn=1),
                          prior_module=jp_mod, **kw)
    tw = TW.WrapperModule(
        segmentation_module=TS.UNet(in_chn=4, out_chn=1, device=CPU),
        prior_module=tp_mod, **kw)
    return jw, tw


def _states(jw, tw, cfg_kw, num_images):
    jcfg = JT.JointTrainConfig(**cfg_kw)
    tcfg = TTR.JointTrainConfig(**cfg_kw)
    js = JT.joint_train_init(jw, jax.random.PRNGKey(0), num_images, jcfg)
    jstate = jax.device_get(js)
    ts = TTR.joint_train_init(
        tw, None, num_images, tcfg,
        seg_init=(params_from_jax(jstate.seg_params, device=CPU),
                  params_from_jax(jstate.seg_state, device=CPU)),
        prior_init=params_from_jax(jstate.prior_params, device=CPU,
                                   stacked=True))
    return jcfg, tcfg, js, ts


def _data(t, seed=1):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.uniform(size=(t, H, W, 3)).astype(np.float32),
        "features": rng.uniform(size=(t, H, W, 1)).astype(np.float32),
        "grid": np.asarray(JG.flatten_grid(JG.pixel_grid((H, W)))),
        "target": (rng.uniform(size=(t, H, W, 1)) > 0.5).astype(np.float32),
    }


def _np(tree, stacked=False):
    return jax.tree_util.tree_leaves(params_to_numpy(tree, stacked=stacked))


def _jnp(tree):
    return [np.asarray(x) for x in
            jax.tree_util.tree_leaves(jax.device_get(tree))]


def _assert_grads(t_m, j_m, stacked=False):
    got, ref = _np(t_m, stacked), _jnp(j_m)
    top = max(np.abs(r).max() for r in ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4 * top)


def _assert_params(t_p, j_p, steps=1, stacked=False):
    for a, b in zip(_np(t_p, stacked), _jnp(j_p)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * steps)


def _rows_equal(t_tree, j_tree, rows, stacked=True):
    for a, b in zip(_np(t_tree, stacked), _jnp(j_tree)):
        np.testing.assert_array_equal(a[rows], b[rows])


@pytest.mark.parametrize("prior", ["icnn", "flagship"])
def test_joint_step_matches_jax(prior):
    """One joint step on images 1 and 3 of 4: the loss terms, the seg and
    prior grads, the new batch-norm state, the updated seg params and
    prior rows (clipped convex), and the untouched rows 0 and 2."""
    jw, tw = _wrappers(prior)
    jcfg, tcfg, js, ts = _states(jw, tw, dict(lr=LR, prior_lr=LR), 4)
    d = _data(2)
    jbatch = {k: jnp.asarray(v) for k, v in d.items()}
    jbatch["index"] = jnp.asarray([1, 3])
    tbatch = {k: torch.tensor(v) for k, v in d.items()}
    tbatch["index"] = torch.tensor([1, 3])
    jnew, jmet = jax.jit(JT.make_joint_train_step(jw, jcfg))(js, jbatch)
    tnew, tmet = TTR.make_joint_train_step(tw, tcfg)(ts, tbatch)
    for k, v in jmet.items():
        np.testing.assert_allclose(tmet[k].numpy(), np.asarray(v),
                                   rtol=1e-4)
    assert int(tnew.step) == 1
    _assert_grads(tnew.seg_opt.m, jnew.seg_opt.m)
    _assert_grads(TT.tree_map(lambda x: x[[1, 3]], tnew.prior_opt.m),
                  jax.tree_util.tree_map(lambda x: x[np.array([1, 3])],
                                         jnew.prior_opt.m), stacked=True)
    for a, b in zip(_np(tnew.seg_state), _jnp(jnew.seg_state)):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(b).max(), 1.0))
    _assert_params(tnew.seg_params, jnew.seg_params)
    _assert_params(tnew.prior_params, jnew.prior_params, stacked=True)
    _rows_equal(tnew.prior_params, js.prior_params, [0, 2])
    _rows_equal(tnew.prior_opt.m, js.prior_opt.m, [0, 2])
    convex = tnew.prior_params if prior == "icnn" else \
        tnew.prior_params["convex"]
    assert float(convex["out"]["ln"]["w"][[1, 3]].min()) >= 0.0
    assert all(float(b["ln"]["w"][[1, 3]].min()) >= 0.0
               for b in convex["skip"])


def test_joint_step_padded_sample_and_frozen_seg():
    """A weight-0 sample leaves its prior row and moments bitwise as they
    were, the weighted loss equals JAX's, and ``train_segmentation=False``
    leaves the seg params as they were."""
    jw, tw = _wrappers("icnn")
    cfg_kw = dict(lr=LR, prior_lr=LR, train_segmentation=False)
    jcfg, tcfg, js, ts = _states(jw, tw, cfg_kw, 4)
    d = _data(2, seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in d.items()}
    jbatch.update(index=jnp.asarray([1, 3]), weight=jnp.asarray([1.0, 0.0]))
    tbatch = {k: torch.tensor(v) for k, v in d.items()}
    tbatch.update(index=torch.tensor([1, 3]), weight=torch.tensor([1.0, 0.0]))
    jnew, jmet = jax.jit(JT.make_joint_train_step(jw, jcfg))(js, jbatch)
    tnew, tmet = TTR.make_joint_train_step(tw, tcfg)(ts, tbatch)
    np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]),
                               rtol=1e-4)
    _rows_equal(tnew.prior_params, js.prior_params, [0, 2, 3])
    for tree in (tnew.prior_opt.m, tnew.prior_opt.u):
        for a in _np(tree, True):
            assert not np.any(a[3])
    assert int(tnew.prior_opt.count[3]) == 0
    assert int(tnew.prior_opt.count[1]) == 1
    _assert_params(tnew.prior_params, jnew.prior_params, stacked=True)
    for a, b in zip(TT.tree_leaves(tnew.seg_params),
                    TT.tree_leaves(ts.seg_params)):
        assert torch.equal(a, b)


def test_joint_step_nan_guard():
    """A non-finite loss skips the whole update and says so."""
    jw, tw = _wrappers("icnn")
    _, tcfg, _, ts = _states(jw, tw, dict(lr=LR, prior_lr=LR), 4)
    d = {k: torch.tensor(v) for k, v in _data(2, seed=3).items()}
    d["image"][0, 0, 0, 0] = float("nan")
    d["index"] = torch.tensor([0, 2])
    new, met = TTR.make_joint_train_step(tw, tcfg)(ts, d)
    assert bool(met["nan_skipped"]) and not bool(torch.isfinite(met["loss"]))
    for a, b in zip(TT.tree_leaves(new.prior_params) +
                    TT.tree_leaves(new.seg_params),
                    TT.tree_leaves(ts.prior_params) +
                    TT.tree_leaves(ts.seg_params)):
        assert torch.equal(a, b)


def test_epoch_matches_jax():
    """One epoch over 5 images in batches of 2 (the tail padded at weight
    0), on the same batch plan: every batch's loss, every prior trained
    exactly once, and the state after the epoch."""
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    idx_j, wgt_j = JT.epoch_batches(5, 2, rng_j)
    idx_t, wgt_t = TTR.epoch_batches(5, 2, rng_t)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(wgt_t, wgt_j)
    with pytest.raises(ValueError):
        TTR.epoch_batches(2, 3, rng_t)
    jw, tw = _wrappers("icnn")
    jcfg, tcfg, js, ts = _states(jw, tw, dict(lr=LR, prior_lr=LR), 5)
    d = _data(5, seed=4)
    jnew, jmet = jax.jit(JT.make_joint_epoch_fn(jw, jcfg))(
        js, {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(idx_j),
        jnp.asarray(wgt_j))
    tnew, tmet = TTR.make_joint_epoch_fn(tw, tcfg)(
        ts, {k: torch.tensor(v) for k, v in d.items()}, idx_t, wgt_t)
    assert tmet["loss"].shape == (3,) and int(tnew.step) == 3
    np.testing.assert_allclose(tmet["loss"].numpy(),
                               np.asarray(jmet["loss"]), rtol=1e-3)
    _assert_params(tnew.seg_params, jnew.seg_params, steps=3)
    _assert_params(tnew.prior_params, jnew.prior_params, stacked=True)
    assert (tnew.prior_opt.count == 1).all()
    for i in range(5):
        changed = any(not torch.equal(a[i], b[i]) for a, b in zip(
            TT.tree_leaves(tnew.prior_params),
            TT.tree_leaves(ts.prior_params)))
        assert changed, f"prior {i} did not train"
