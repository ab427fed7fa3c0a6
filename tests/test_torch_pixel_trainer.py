"""Port parity: the convexity benchmark's pixel trainer of
awesome_tpu_torch (``fit/pixel_trainer.py``) against the JAX package's on
the same seeded data and bridged params, at a small size (2 images of 40
pixels, ``Net(n_hidden=16)``, the fused ICNN prior 12 x 1, which runs its
plain versions on the CPU in both packages).

Tolerances: ``masked_awesome_loss`` at rtol 2e-5 and its grads at rtol
5e-4, atol 1e-6 (``tests/test_pallas_flagship.py:81,87``); a 30-epoch
segment's loss history at rtol 2e-4 (``tests/test_fused_fit.py:37``) and
its params at the grads' tolerance. A held-out image's params, and a
NaN-target image's, are held bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.fit import optim as JO
from awesome_tpu.fit import pixel_trainer as JP
from awesome_tpu.nn import icnn as JI
from awesome_tpu.nn import seg as JS
from awesome_tpu.nn import wrapper as JW
from awesome_tpu.ops import pallas_mlp as JM
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.fit import optim as TO
from awesome_tpu_torch.fit import pixel_trainer as TP
from awesome_tpu_torch.nn import icnn as TI
from awesome_tpu_torch.nn import seg as TS
from awesome_tpu_torch.nn import wrapper as TW
from awesome_tpu_torch.ops import mlp as TM
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
B, N = 2, 40
EPOCHS = 30
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 5e-4, 1e-6
HIST_RTOL = 2e-4


def _wrappers():
    jw = JW.WrapperModule(
        segmentation_module=JS.Net(n_hidden=16),
        prior_module=JM.FullyFusedConvexNextNet(
            JI.ConvexNextNet(n_hidden=12, n_hidden_layers=1)))
    tw = TW.WrapperModule(
        segmentation_module=TS.Net(n_hidden=16, device=CPU),
        prior_module=TM.FullyFusedConvexNextNet(
            TI.ConvexNextNet(n_hidden=12, n_hidden_layers=1, device=CPU)))
    return jw, tw


def _data(seed=0, b=B):
    """Pixel matrices (y, x, r, g, b), targets and masks: the first 24
    pixels of each image are scribbles, the next 12 random pixels, the last
    4 padding."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(-0.5, 0.5, size=(b, N, 5)).astype(np.float32)
    px[..., 2:] += 0.5
    gt = (px[..., :1] ** 2 + px[..., 1:2] ** 2 > 0.1).astype(np.float32)
    smask = np.zeros((b, N), bool)
    smask[:, :24] = True
    rmask = np.zeros((b, N), bool)
    rmask[:, 24:36] = True
    return px, gt, smask, rmask


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("extra", [False, True])
def test_masked_awesome_loss_and_grads(extra):
    jw, tw = _wrappers()
    jparams = jax.device_get(jw.init(jax.random.PRNGKey(3)))
    tparams = params_from_jax(jparams, CPU)
    px, gt, smask, rmask = (a[0] for a in _data())

    def jloss(p):
        return JP.masked_awesome_loss(jw.apply(p, jnp.asarray(px)),
                                      jnp.asarray(gt), jnp.asarray(smask),
                                      jnp.asarray(rmask), 1.0, extra)

    def tloss(p):
        return TP.masked_awesome_loss(tw.apply(p, torch.as_tensor(px)),
                                      torch.as_tensor(gt),
                                      torch.as_tensor(smask),
                                      torch.as_tensor(rmask), 1.0, extra)

    jl, jg = jax.value_and_grad(jloss)(jparams)
    tg, tl = torch.func.grad_and_value(tloss)(tparams)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    got = params_to_numpy(tg)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def _cfgs(mode, **kw):
    base = dict(num_epochs=EPOCHS, lr=0.02, extra_penalty_after=20,
                use_plateau=True, plateau_patience=5,
                train_segmentation=mode != "none", **kw)
    return JP.PixelTrainConfig(**base), TP.PixelTrainConfig(**base)


def _run_both(mode, trainable=None, data_seed=0, **kw):
    """One 30-epoch segment in both packages from the same params."""
    jw, tw = _wrappers()
    jcfg, tcfg = _cfgs(mode, **kw)
    data = list(_data(data_seed))
    if mode == "multi":
        jstate = JP.shared_pixel_train_init(jw, jax.random.PRNGKey(1), B,
                                            jcfg)
        host = jax.device_get(jstate.params)
        tparams = {"seg": params_from_jax(host["seg"], CPU),
                   "prior": params_from_jax(host["prior"], CPU, stacked=1)}
        tstate = TP.shared_pixel_train_init(tw, None, B, tcfg,
                                            params=tparams)
        jseg = JP.make_shared_pixel_segment_fn(jw, jcfg, EPOCHS)
        tseg = TP.make_shared_pixel_segment_fn(tw, tcfg, EPOCHS)
    else:
        keys = jax.random.split(jax.random.PRNGKey(1), B)
        jstacked = jax.vmap(jw.init)(keys)
        jstate = JP.pixel_train_init(jw, jstacked, jcfg)
        tstate = TP.pixel_train_init(
            tw, params_from_jax(jax.device_get(jstacked), CPU, stacked=1),
            tcfg)
        jseg = JP.make_pixel_segment_fn(jw, jcfg, EPOCHS)
        tseg = TP.make_pixel_segment_fn(tw, tcfg, EPOCHS)
    tr = None if trainable is None else np.asarray(trainable)
    jnew, jaux = jseg(jstate, *_j(data),
                      None if tr is None else jnp.asarray(tr))
    tnew, taux = tseg(tstate, *_t(data),
                      None if tr is None else torch.as_tensor(tr))
    return jstate, jnew, jaux, tstate, tnew, taux


def _params_host(state, mode):
    if mode == "multi":
        return {"seg": params_to_numpy(state.params["seg"]),
                "prior": params_to_numpy(state.params["prior"], 1)}
    return params_to_numpy(state.params, 1)


@pytest.mark.parametrize("mode", ["single", "none", "multi"])
def test_segment_matches_jax(mode):
    """30 epochs crossing the extra-penalty epoch (20) with the plateau
    schedule on: loss history, params, lr scales and the epoch counter."""
    _, jnew, jaux, tstate, tnew, taux = _run_both(mode)
    np.testing.assert_allclose(taux["loss_hist"].numpy(),
                               np.asarray(jaux["loss_hist"]), rtol=HIST_RTOL)
    np.testing.assert_allclose(taux["lr_scale"].numpy(),
                               np.asarray(jaux["lr_scale"]))
    assert np.array_equal(tnew.epoch.numpy(), np.asarray(jnew.epoch))
    got = _params_host(tnew, mode)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jnew.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    if mode == "none":  # seg frozen bitwise
        for a, b in zip(TT.tree_leaves(tnew.params["seg"]),
                        TT.tree_leaves(tstate.params["seg"])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_held_out_image_params_bitwise(mode):
    """A non-trainable (validation) image's per-image params do not move
    at all; its loss is still recorded, and the losses equal JAX's."""
    jstate, jnew, jaux, tstate, tnew, taux = _run_both(
        mode, trainable=[True, False])
    sub = "prior" if mode == "multi" else None

    def img1(params):
        tree = params[sub] if sub else params
        return TT.tree_leaves(TT.tree_select(tree, 1))

    for a, b in zip(img1(tnew.params), img1(tstate.params)):
        assert torch.equal(a, b)
    assert torch.isfinite(taux["loss_hist"][1]).all()
    np.testing.assert_allclose(taux["loss_hist"].numpy(),
                               np.asarray(jaux["loss_hist"]), rtol=HIST_RTOL)


def test_nan_target_freezes_only_its_image():
    """A NaN target makes image 1's loss NaN: its params and optimizer
    state stay as they were; image 0 trains as it does without image 1."""
    _, tw = _wrappers()
    _, tcfg = _cfgs("single")
    gen = torch.Generator().manual_seed(0)
    stacked = TT.stack_trees([tw.init(gen) for _ in range(B)])
    px, gt, smask, rmask = _data()
    bad = gt.copy()
    bad[1, 3, 0] = np.nan
    seg = TP.make_pixel_segment_fn(tw, tcfg, EPOCHS)
    state0 = TP.pixel_train_init(tw, stacked, tcfg)
    new, aux = seg(state0, *_t([px, bad, smask, rmask]))
    assert torch.isnan(aux["loss_hist"][1]).all()
    for a, b in zip(TT.tree_leaves(TT.tree_select(new.params, 1)),
                    TT.tree_leaves(TT.tree_select(stacked, 1))):
        assert torch.equal(a, b)
    assert int(new.opt_state.count[1]) == 0
    assert int(new.opt_state.count[0]) == EPOCHS
    alone = TP.pixel_train_init(tw, TT.tree_map(lambda x: x[:1], stacked),
                                tcfg)
    ref, ref_aux = seg(alone, *_t([a[:1] for a in (px, gt, smask, rmask)]))
    torch.testing.assert_close(aux["loss_hist"][0], ref_aux["loss_hist"][0],
                               rtol=1e-6, atol=0)
    for a, b in zip(TT.tree_leaves(TT.tree_select(new.params, 0)),
                    TT.tree_leaves(TT.tree_select(ref.params, 0))):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_segments_resume_bitwise():
    """Two 15-epoch segments equal one 30-epoch segment bitwise (the
    absolute epoch counter carries the extra-penalty switch)."""
    _, tw = _wrappers()
    _, tcfg = _cfgs("single")
    gen = torch.Generator().manual_seed(0)
    stacked = TT.stack_trees([tw.init(gen) for _ in range(B)])
    data = _t(_data())
    one, aux = TP.make_pixel_segment_fn(tw, tcfg, EPOCHS)(
        TP.pixel_train_init(tw, stacked, tcfg), *data)
    half = TP.make_pixel_segment_fn(tw, tcfg, EPOCHS // 2)
    mid, aux1 = half(TP.pixel_train_init(tw, stacked, tcfg), *data)
    two, aux2 = half(mid, *data)
    assert torch.equal(torch.cat([aux1["loss_hist"], aux2["loss_hist"]], 1),
                       aux["loss_hist"])
    for a, b in zip(TT.tree_leaves(two), TT.tree_leaves(one)):
        assert torch.equal(a, b)


def test_train_pixel_models_matches_jax():
    jw, tw = _wrappers()
    jcfg, tcfg = _cfgs("single", optimizer="adamax")
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    jstacked = jax.vmap(jw.init)(keys)
    data = _data(1)
    jp, jaux = JP.train_pixel_models(jw, jstacked, *_j(data), jcfg)
    tp, taux = TP.train_pixel_models(
        tw, params_from_jax(jax.device_get(jstacked), CPU, stacked=1),
        *_t(data), tcfg)
    np.testing.assert_allclose(taux["loss_hist"].numpy(),
                               np.asarray(jaux["loss_hist"]), rtol=HIST_RTOL)
    one, one_aux = TP.make_pixel_train_fn(tw, tcfg)(
        TT.tree_select(params_from_jax(jax.device_get(jstacked), CPU,
                                       stacked=1), 0),
        *(t[0] for t in _t(data)))
    np.testing.assert_allclose(one_aux["loss_hist"].numpy(),
                               np.asarray(jaux["loss_hist"][0]),
                               rtol=HIST_RTOL)


def test_wn_param_groups_matches_jax():
    tree = {"a": {"g": 1, "v": 2}, "b": [{"g": 3}, {"w": 4}], "g": 5}
    assert TO.wn_param_groups(tree, 0.3) == JO.wn_param_groups(tree, 0.3)


def test_wn_weight_decay_segment_matches_jax():
    """``wn_weight_decay`` decays only 'g' leaves; the port's models have
    none, so the segment equals the undecayed one, as in JAX."""
    _, jnew, jaux, _, tnew, taux = _run_both("single", wn_weight_decay=0.1)
    np.testing.assert_allclose(taux["loss_hist"].numpy(),
                               np.asarray(jaux["loss_hist"]), rtol=HIST_RTOL)
