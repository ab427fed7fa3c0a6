"""Port parity: the prior-fit engine of awesome_tpu_torch (autograd and
fused routes, point masks, the batched fit with the IoU gate, the grouped
fused fit) against the JAX package's fit on the same weights and data.
Tolerances are the JAX suite's own (``tests/test_fused_fit.py``):
loss history rtol 2e-4, params rtol 2e-3 atol 2e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.fit import prior_fit as JF
from awesome_tpu.measures import losses as JL
from awesome_tpu.measures import metrics as JM
from awesome_tpu.nn.path_connected import (
    real_nvp_path_connected_net as j_factory,
)
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.fit import prior_fit as TF
from awesome_tpu_torch.fit.fused_fit import (
    make_fused_fit_fn,
    make_grouped_fused_fit_fn,
)
from awesome_tpu_torch.measures import losses as TL
from awesome_tpu_torch.measures import metrics as TM
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)

CPU = "cpu"
HIST_RTOL, P_RTOL, P_ATOL = 2e-4, 2e-3, 2e-6


def _models(h, w, flows=4, icnn=12, layers=2):
    kw = dict(channels=2, hidden_units=8, flow_n_flows=flows,
              flow_output_fn="tanh", spatial_shape=(h, w),
              convex_net_hidden_units=icnn, convex_net_hidden_layers=layers)
    return j_factory(**kw), t_factory(device=CPU, **kw)


def _disk(h, w, cy=None, cx=None, r=None):
    yy, xx = np.mgrid[0:h, 0:w]
    cy = h / 2 if cy is None else cy
    cx = w / 2 if cx is None else cx
    r = h / 3 if r is None else r
    fg = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r ** 2
    return (1.0 - fg.astype(np.float32)).reshape(-1, 1)


def _assert_tree_close(t_params, j_params, stacked=False):
    got = jax.tree_util.tree_leaves(params_to_numpy(t_params,
                                                    stacked=stacked))
    ref = jax.tree_util.tree_leaves(jax.device_get(j_params))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=P_RTOL,
                                   atol=P_ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_fit_matches_jax_25_steps(fused):
    h = w = 16
    jm, tm = _models(h, w)
    jp = jm.init(jax.random.PRNGKey(0))
    pts = np.asarray(JG.flatten_grid(JG.pixel_grid((h, w))))
    tgt = _disk(h, w)
    cfg = JF.FitConfig(num_steps=25, lr=1e-3, nan_guard_grads=False)
    ref_params, ref_aux = jax.jit(JF.make_fit_fn(jm, cfg))(
        jp, jnp.asarray(pts), jnp.asarray(tgt))
    tcfg = TF.FitConfig(num_steps=25, lr=1e-3, nan_guard_grads=False,
                        fused=fused)
    params, aux = TF.make_fit_fn(tm, tcfg)(
        params_from_jax(jax.device_get(jp), device=CPU), torch.tensor(pts),
        torch.tensor(tgt))
    assert aux["loss_hist"].shape == (25,)
    np.testing.assert_allclose(aux["loss_hist"].numpy(),
                               np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    _assert_tree_close(params, ref_params)
    assert float(aux["lr_scale"]) == float(ref_aux["lr_scale"])


def test_fused_point_mask_matches_unpadded_and_jax():
    h = w = 12
    jm, tm = _models(h, w, flows=2, layers=1)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    yy, xx = np.mgrid[0:h, 0:w]
    pts = (np.stack([yy / h, xx / w], -1).reshape(-1, 2) - 0.5).astype(
        np.float32)
    tgt = ((pts ** 2).sum(-1) > 0.09).astype(np.float32).reshape(-1, 1)
    pad = 32
    pts_p = np.concatenate([pts, np.full((pad, 2), 5.0, np.float32)])
    tgt_p = np.concatenate([tgt, np.zeros((pad, 1), np.float32)])
    mask = np.zeros((pts_p.shape[0],), bool)
    mask[: pts.shape[0]] = True
    cfg = TF.FitConfig(num_steps=10, lr=1e-2, fused=True,
                       nan_guard_grads=False)
    fit = TF.make_fit_fn(tm, cfg)
    p0 = params_from_jax(jp, device=CPU)
    ref, ref_aux = fit(p0, torch.tensor(pts), torch.tensor(tgt))
    padded, pad_aux = fit(p0, torch.tensor(pts_p), torch.tensor(tgt_p),
                          point_mask=torch.tensor(mask))
    for a, b in zip(TT.tree_leaves(ref), TT.tree_leaves(padded)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    np.testing.assert_allclose(ref_aux["loss_hist"].numpy(),
                               pad_aux["loss_hist"].numpy(), atol=1e-6)
    jcfg = JF.FitConfig(num_steps=10, lr=1e-2, nan_guard_grads=False)
    j_padded, j_aux = jax.jit(JF.make_fit_fn(jm, jcfg))(
        jp, jnp.asarray(pts_p), jnp.asarray(tgt_p),
        point_mask=jnp.asarray(mask))
    np.testing.assert_allclose(pad_aux["loss_hist"].numpy(),
                               np.asarray(j_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    _assert_tree_close(padded, j_padded)


@pytest.mark.parametrize("fused", [False, True])
def test_batched_fit_with_gate_matches_jax(fused):
    """Per-image state (plateau, NaN guard) as JAX's vmap gives it, and
    the gate IoU of every image."""
    h = w = 12
    jm, tm = _models(h, w, flows=2, icnn=8, layers=1)
    b = 3
    js = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(0), b))
    pts = np.asarray(JG.flatten_grid(JG.pixel_grid((h, w))))
    tgts = np.stack([_disk(h, w, cy=4 + i, cx=5 + i, r=3.5)
                     for i in range(b)])
    jcfg = JF.FitConfig(num_steps=20, lr=5e-3, nan_guard_grads=False,
                        gate_threshold=0.5)
    j_fit, j_aux = JF.fit_priors_batched(jm, js, jnp.asarray(pts),
                                         jnp.asarray(tgts), jcfg)
    tcfg = TF.FitConfig(num_steps=20, lr=5e-3, nan_guard_grads=False,
                        gate_threshold=0.5, fused=fused)
    t_fit, t_aux = TF.fit_priors_batched(
        tm, params_from_jax(jax.device_get(js), device=CPU, stacked=True),
        torch.tensor(pts), torch.tensor(tgts), tcfg)
    assert t_aux["loss_hist"].shape == (b, 20)
    np.testing.assert_allclose(t_aux["loss_hist"].numpy(),
                               np.asarray(j_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    _assert_tree_close(t_fit, j_fit, stacked=True)
    np.testing.assert_allclose(t_aux["gate_iou"].numpy(),
                               np.asarray(j_aux["gate_iou"]), atol=1e-6)
    np.testing.assert_array_equal(t_aux["gate_pass"].numpy(),
                                  np.asarray(j_aux["gate_pass"]))


def test_gate_retry_and_valid_mask():
    """An unreachable gate makes every valid image fail and refit from a
    fresh init; an invalid image keeps its params."""
    h = w = 12
    _, tm = _models(h, w, flows=2, icnn=8, layers=1)
    b = 3
    stacked = TT.stack_trees([tm.init(torch.Generator().manual_seed(i))
                              for i in range(b)])
    pts = torch.tensor(np.asarray(JG.flatten_grid(JG.pixel_grid((h, w)))))
    tgts = torch.tensor(np.stack([_disk(h, w)] * b))
    valid = torch.tensor([True, False, True])
    cfg = TF.FitConfig(num_steps=5, lr=5e-3, fused=True,
                       nan_guard_grads=False, gate_threshold=1.5)
    run = TF.make_batched_fit_fn(tm, cfg)
    plain, aux0 = run(stacked, pts, tgts, valid_mask=valid)
    retried, aux = run(stacked, pts, tgts, valid_mask=valid,
                       retry_keys=[7, 8, 9])
    assert not bool(aux["gate_pass"].any())
    w0 = "convex"
    a = retried[w0]["input"]["w"]
    assert not torch.equal(a[0], plain[w0]["input"]["w"][0])
    assert torch.equal(a[1], stacked[w0]["input"]["w"][1])
    assert torch.equal(plain[w0]["input"]["w"][1],
                       stacked[w0]["input"]["w"][1])
    assert aux["gate_iou"].shape == (b,)


def test_nan_guard_is_per_image():
    h = w = 12
    _, tm = _models(h, w, flows=2, icnn=8, layers=1)
    stacked = TT.stack_trees([tm.init(torch.Generator().manual_seed(i))
                              for i in range(2)])
    pts = torch.tensor(np.asarray(JG.flatten_grid(JG.pixel_grid((h, w)))))
    tgts = torch.tensor(np.stack([_disk(h, w)] * 2))
    tgts[1, 0, 0] = float("nan")
    for fused in (False, True):
        cfg = TF.FitConfig(num_steps=3, fused=fused)
        fit, aux = TF.make_batched_fit_fn(tm, cfg)(stacked, pts, tgts)
        w_in = fit["convex"]["input"]["w"]
        assert torch.equal(w_in[1], stacked["convex"]["input"]["w"][1])
        assert not torch.equal(w_in[0], stacked["convex"]["input"]["w"][0])
        assert bool(torch.isnan(aux["loss_hist"][1]).all())


def test_grouped_fused_fit_matches_single():
    """The grouped fused fit equals each image's single fused fit, in the
    FP32 and in the bf16 build (``compute_dtype``)."""
    h = w = 12
    _, tm = _models(h, w, flows=2, icnn=8, layers=1)
    g = 2
    stacked = TT.stack_trees([tm.init(torch.Generator().manual_seed(i))
                              for i in range(g)])
    pts = torch.tensor(np.asarray(JG.flatten_grid(JG.pixel_grid((h, w)))))
    tgts = torch.tensor(np.stack([_disk(h, w, 5, 5, 3), _disk(h, w, 7, 7, 3)]))
    base = TF.FitConfig(num_steps=20, lr=1e-3, nan_guard_grads=False)
    for cfg in (base, dataclasses.replace(base,
                                          compute_dtype=torch.bfloat16)):
        g_params, g_aux = make_grouped_fused_fit_fn(tm, cfg, group=g)(
            stacked, pts, tgts)
        assert g_aux["loss_hist"].shape == (20, g)
        single = make_fused_fit_fn(tm, cfg)
        for i in range(g):
            s_params, s_aux = single(TT.tree_select(stacked, i), pts,
                                     tgts[i])
            np.testing.assert_allclose(g_aux["loss_hist"][:, i].numpy(),
                                       s_aux["loss_hist"].numpy(), rtol=2e-4)
            for a, b in zip(TT.tree_leaves(TT.tree_select(g_params, i)),
                            TT.tree_leaves(s_params)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                           atol=2e-6)


@pytest.mark.parametrize("nan_target", [False, True])
def test_grouped_fused_fit_matches_jax(nan_target):
    """The group-mean semantics against JAX's grouped fused fit (its Pallas
    kernel in interpret mode): a short plateau patience and a large LR make
    the group's one LR decay within the run; a NaN target in one image
    must freeze the whole group."""
    _grouped_vs_jax(nan_target, interleave=False)


def test_grouped_fused_fit_interleave_matches_jax():
    """``interleave=True`` runs JAX's ``_kernel_interleaved`` (K3); the
    port serves it with the grouped kernel, so it follows the same fit."""
    _grouped_vs_jax(False, interleave=True)


def _grouped_vs_jax(nan_target, interleave):
    from awesome_tpu.fit.fused_fit import (
        make_grouped_fused_fit_fn as j_grouped,
    )

    h = w = 12
    jm, tm = _models(h, w, flows=2, icnn=8, layers=1)
    g = 2
    js = jax.device_get(
        jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(0), g)))
    pts = np.asarray(JG.flatten_grid(JG.pixel_grid((h, w))))
    tgts = np.stack([_disk(h, w, 5, 5, 3), _disk(h, w, 7, 7, 3)])
    if nan_target:
        tgts[1, 7, 0] = np.nan
    kw = dict(num_steps=20, lr=5e-2, nan_guard_grads=False,
              plateau_patience=1)
    ref_params, ref_aux = jax.jit(j_grouped(
        jm, JF.FitConfig(**kw), group=g, interpret=True, tile_n=64,
        interleave=interleave))(js, jnp.asarray(pts), jnp.asarray(tgts))
    params, aux = make_grouped_fused_fit_fn(
        tm, TF.FitConfig(**kw), group=g, interleave=interleave)(
        params_from_jax(js, device=CPU, stacked=True), torch.tensor(pts),
        torch.tensor(tgts))
    assert aux["loss_hist"].shape == (20, g)
    np.testing.assert_allclose(aux["loss_hist"].numpy(),
                               np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    _assert_tree_close(params, ref_params, stacked=True)
    assert float(aux["lr_scale"]) == float(ref_aux["lr_scale"])
    if nan_target:
        assert bool(torch.isnan(aux["loss_hist"][:, 1]).all())
        _assert_tree_close(params, js, stacked=True)
    else:
        assert float(aux["lr_scale"]) < 1.0


@pytest.mark.parametrize("mode,fg_weight,masked", [
    ("none", None, False), ("equal", None, True), ("ratio", None, False),
    ("sssdms", None, True), ("none", 0.7, False), ("none", 0.7, True)])
def test_point_weights_match_jax(mode, fg_weight, masked):
    rng = np.random.default_rng(0)
    t = (rng.uniform(size=(40, 1)) > 0.3).astype(np.float32)
    m = rng.uniform(size=(40,)) > 0.2 if masked else None
    jcfg = JF.FitConfig(weight_mode=mode, fg_weight=fg_weight)
    tcfg = TF.FitConfig(weight_mode=mode, fg_weight=fg_weight)
    ref = JF.make_point_weights(jnp.asarray(t), jcfg,
                                None if m is None else jnp.asarray(m))
    got = TF.make_point_weights(torch.tensor(t), tcfg,
                                None if m is None else torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(
        TL.unaries_weight(torch.tensor(t), mode=mode).numpy(),
        np.asarray(JL.unaries_weight(jnp.asarray(t), mode=mode)), rtol=1e-6)


def test_iou_matches_jax():
    rng = np.random.default_rng(1)
    o = rng.uniform(size=(50,)).astype(np.float32)
    t = (rng.uniform(size=(50,)) > 0.5).astype(np.float32)
    t[:5] = 2.0
    for kw in ({}, {"invert": True}, {"noneclass": 2.0}):
        np.testing.assert_allclose(
            float(TM.iou(torch.tensor(o), torch.tensor(t), **kw)),
            float(JM.iou(jnp.asarray(o), jnp.asarray(t), **kw)), rtol=1e-6)
    zeros = torch.zeros(4)
    assert float(TM.iou(zeros, zeros)) == 0.0
