"""Port parity: the convex prior fit and the sequential (reuse_state)
pretrain of awesome_tpu_torch against the JAX package, on the same weights
and data: the how-to fit with the fused ICNN wrappers, the batched fit with
the IoU gate, the multi-object fit, the sequential fit with an invalid
image and point masks, the prefits, and the circle helpers. Tolerances are
the JAX suite's own (``tests/test_fused_fit.py``): loss history rtol 2e-4,
params rtol 2e-3 atol 2e-6. On the CPU the fused wrappers run their plain
versions; the kernels are held to those on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.fit import prior_fit as JF
from awesome_tpu.nn.icnn import ConvexNextNet as JConvexNextNet
from awesome_tpu.nn.path_connected import (
    real_nvp_path_connected_net as j_factory,
)
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import grids as TG
from awesome_tpu_torch.fit import prior_fit as TF
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)
from awesome_tpu_torch.ops import mlp as M

CPU = "cpu"
HIST_RTOL, P_RTOL, P_ATOL = 2e-4, 2e-3, 2e-6
WRAPPERS = {"plain": lambda m: m, "fused": M.FusedConvexNextNet,
            "fully_fused": M.FullyFusedConvexNextNet}


def _icnn(width=14, layers=1):
    return (JConvexNextNet(n_hidden=width, n_hidden_layers=layers),
            ConvexNextNet(n_hidden=width, n_hidden_layers=layers,
                          device=CPU))


def _flagship(h, w):
    kw = dict(channels=2, hidden_units=8, flow_n_flows=2,
              flow_output_fn="tanh", spatial_shape=(h, w),
              convex_net_hidden_units=8, convex_net_hidden_layers=1)
    return j_factory(**kw), t_factory(device=CPU, **kw)


def _disk(h, w, cy, cx, r):
    yy, xx = np.mgrid[0:h, 0:w]
    fg = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r ** 2
    return (1.0 - fg.astype(np.float32)).reshape(-1, 1)


def _grid(h, w):
    return np.asarray(JG.flatten_grid(JG.pixel_grid((h, w))))


def _assert_tree_close(t_params, j_params, stacked=False):
    got = jax.tree_util.tree_leaves(params_to_numpy(t_params,
                                                    stacked=stacked))
    ref = jax.tree_util.tree_leaves(jax.device_get(j_params))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=P_RTOL,
                                   atol=P_ATOL)


@pytest.mark.parametrize("wrap", ["fused", "fully_fused"])
def test_howto_fit_matches_jax(wrap):
    """25 steps of the README's how-to fit (Adam, fg_weight 0.4)."""
    h = w = 16
    jm, tm = _icnn()
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    pts, tgt = _grid(h, w), _disk(h, w, 7, 8, 5)
    kw = dict(num_steps=25, lr=2e-3, optimizer="adam", fg_weight=0.4,
              plateau_patience=10 ** 6)
    ref, ref_aux = JF.fit_prior(jm, jp, jnp.asarray(pts), jnp.asarray(tgt),
                                JF.FitConfig(**kw))
    got, aux = TF.fit_prior(WRAPPERS[wrap](tm),
                            params_from_jax(jp, device=CPU),
                            torch.tensor(pts), torch.tensor(tgt),
                            TF.FitConfig(**kw))
    np.testing.assert_allclose(aux["loss_hist"].numpy(),
                               np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    _assert_tree_close(got, ref)


def test_batched_fit_with_gate_matches_jax():
    h = w = 12
    jm, tm = _icnn(width=12)
    b = 3
    js = jax.device_get(jax.vmap(jm.init)(
        jax.random.split(jax.random.PRNGKey(1), b)))
    pts = _grid(h, w)
    tgts = np.stack([_disk(h, w, 4 + i, 5 + i, 3.5) for i in range(b)])
    kw = dict(num_steps=20, lr=5e-3, optimizer="adam", fg_weight=0.4,
              gate_threshold=0.5)
    ref, ref_aux = JF.fit_priors_batched(jm, js, jnp.asarray(pts),
                                         jnp.asarray(tgts),
                                         JF.FitConfig(**kw))
    got, aux = TF.fit_priors_batched(
        M.FullyFusedConvexNextNet(tm),
        params_from_jax(js, device=CPU, stacked=True), torch.tensor(pts),
        torch.tensor(tgts), TF.FitConfig(**kw))
    np.testing.assert_allclose(aux["loss_hist"].numpy(),
                               np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    _assert_tree_close(got, ref, stacked=True)
    np.testing.assert_allclose(aux["gate_iou"].numpy(),
                               np.asarray(ref_aux["gate_iou"]), atol=1e-6)


def test_multi_object_fit_matches_jax(monkeypatch):
    """B = 2 images x K = 2 objects, one slot inactive: the B*K fits run as
    one batch (FullyFusedConvexNextNet children), one grouped forward and
    backward per step (plus one forward for the gate's scores)."""
    calls = []
    for name in ("grouped_forward", "grouped_backward"):
        orig = getattr(M, name)

        def spy(spec, xx, *rest, _orig=orig, _name=name):
            calls.append((_name, tuple(rest[-1][0].shape[:-2])))
            return _orig(spec, xx, *rest)

        monkeypatch.setattr(M, name, spy)
    h = w = 12
    jm, tm = _icnn(width=10)
    bsz, k = 2, 2
    keys = jax.random.split(jax.random.PRNGKey(2), bsz * k)
    js = jax.device_get(jax.tree_util.tree_map(
        lambda a: a.reshape((bsz, k) + a.shape[1:]),
        jax.vmap(jm.init)(keys)))
    pts = _grid(h, w)
    objs = [_disk(h, w, 4, 4, 3), _disk(h, w, 8, 8, 3)]
    tgts = np.stack([np.stack(objs), np.stack(objs[::-1])])  # (B, K, N, 1)
    valid = np.array([[True, True], [True, False]])
    kw = dict(num_steps=15, lr=1e-2, fg_weight=0.5, gate_threshold=0.5)
    ref, ref_aux = JF.fit_multi_object_priors(
        jm, js, jnp.asarray(pts), jnp.asarray(tgts), JF.FitConfig(**kw),
        valid_mask=jnp.asarray(valid))
    got, aux = TF.fit_multi_object_priors(
        M.FullyFusedConvexNextNet(tm),
        params_from_jax(js, device=CPU, stacked=2), torch.tensor(pts),
        torch.tensor(tgts), TF.FitConfig(**kw),
        valid_mask=torch.tensor(valid))
    assert aux["loss_hist"].shape == (bsz, k, 15)
    assert calls == ([("grouped_forward", (bsz * k,)),
                      ("grouped_backward", (bsz * k,))] * 15
                     + [("grouped_forward", (bsz * k,))])
    np.testing.assert_allclose(aux["loss_hist"].numpy(),
                               np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    _assert_tree_close(got, ref, stacked=2)
    np.testing.assert_allclose(aux["gate_iou"].numpy(),
                               np.asarray(ref_aux["gate_iou"]), atol=1e-6)
    np.testing.assert_array_equal(
        params_to_numpy(got, stacked=2)["input"]["w"][1, 1],
        js["input"]["w"][1, 1])


def _sequential_data(h, w, b, pad):
    """Per-image points (b, N + pad, 2) whose last ``pad`` points are
    padding (masked out), and per-image disk targets."""
    base = _grid(h, w)
    pts = np.stack([np.concatenate([base, np.full((pad, 2), 3.0 + i,
                                                  np.float32)])
                    for i in range(b)])
    tgts = np.stack([np.concatenate([_disk(h, w, 5 + i, 6, 3.5),
                                     np.zeros((pad, 1), np.float32)])
                     for i in range(b)])
    masks = np.zeros((b, h * w + pad), bool)
    masks[:, :h * w] = True
    return pts, tgts, masks


@pytest.mark.parametrize("kind", ["convex", "fully_fused", "flagship_fused"])
def test_sequential_fit_matches_jax(kind):
    """Cold fit, then warm fits from the carry; image 2 is invalid, so its
    slot holds the carry and the carry passes through it."""
    h = w = 10
    b = 4
    if kind == "flagship_fused":
        jm, tm = _flagship(h, w)
        model = tm
        kw = dict(num_steps=12, lr=5e-3, nan_guard_grads=False)
    else:
        jm, tm = _icnn(width=12)
        model = WRAPPERS["fully_fused" if kind == "fully_fused"
                         else "plain"](tm)
        kw = dict(num_steps=12, lr=5e-3, optimizer="adam", fg_weight=0.4)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    pts, tgts, masks = _sequential_data(h, w, b, pad=7)
    valid = np.array([True, True, False, True])
    warm = dict(kw, num_steps=6)
    ref, ref_aux = JF.fit_priors_sequential(
        jm, jp, jnp.asarray(pts), jnp.asarray(tgts), JF.FitConfig(**kw),
        warm_cfg=JF.FitConfig(**warm), valid_mask=jnp.asarray(valid),
        point_masks=jnp.asarray(masks))
    fused = kind == "flagship_fused"
    got, aux = TF.fit_priors_sequential(
        model, params_from_jax(jp, device=CPU), torch.tensor(pts),
        torch.tensor(tgts), TF.FitConfig(fused=fused, **kw),
        warm_cfg=TF.FitConfig(fused=fused, **warm),
        valid_mask=torch.tensor(valid), point_masks=torch.tensor(masks))
    _assert_tree_close(got, ref, stacked=True)
    np.testing.assert_allclose(aux["first_aux"]["loss_hist"].numpy(),
                               np.asarray(ref_aux["first_aux"]["loss_hist"]),
                               rtol=HIST_RTOL)
    np.testing.assert_array_equal(aux["warm_lr_scale"].numpy(),
                                  np.asarray(ref_aux["warm_lr_scale"]))
    slots = params_to_numpy(got, stacked=True)
    for a in jax.tree_util.tree_leaves(slots):
        np.testing.assert_array_equal(a[2], a[1])


@pytest.mark.parametrize("which", ["flow_identity", "circle", "unaries"])
def test_prefits_match_jax(which):
    h, w = 12, 14
    jm, tm = _flagship(h, w)
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a)))
        .astype(np.float32), jax.device_get(jm.init(jax.random.PRNGKey(4))))
    pts = _grid(h, w)
    tgt = _disk(h, w, 5, 6, 4)
    tp = params_from_jax(jp, device=CPU)
    if which == "flow_identity":
        ref, ref_hist = JF.learn_flow_identity(jm, jp, jnp.asarray(pts),
                                               max_iter=10)
        got, hist = TF.learn_flow_identity(tm, tp, torch.tensor(pts),
                                           max_iter=10)
    else:
        kw = dict(mode=which, grid_shape=(h, w), lr=1e-2, max_iter=10)
        ref, ref_hist = JF.learn_convex_net(jm, jp, jnp.asarray(pts),
                                            jnp.asarray(tgt), **kw)
        got, hist = TF.learn_convex_net(tm, tp, torch.tensor(pts),
                                        torch.tensor(tgt), **kw)
    np.testing.assert_allclose(hist.numpy(), np.asarray(ref_hist),
                               rtol=HIST_RTOL)
    _assert_tree_close(got, ref)


def test_apply_prefits_pass_through_and_zoo():
    _, tm = _icnn()
    params = tm.init()
    pts = torch.tensor(_grid(6, 6))
    assert TF.apply_prefits(tm, params, pts, prefit_flow_identity=True,
                            prefit_convex=True) is params
    with pytest.raises(NotImplementedError, match="zoo"):
        TF.apply_prefits(tm, params, pts, zoo=object())
    jm, fm = _flagship(6, 6)
    fp = fm.init()
    both = TF.apply_prefits(fm, fp, pts, prefit_flow_identity=True,
                            flow_identity_steps=3, prefit_convex=True,
                            convex_mode="unaries",
                            convex_target=torch.tensor(_disk(6, 6, 3, 3, 2)),
                            convex_steps=3)
    assert both["linear"] is fp["linear"]
    assert not torch.equal(both["flow"]["steps"][0]["s"]["l1"]["w"],
                           fp["flow"]["steps"][0]["s"]["l1"]["w"])
    assert not torch.equal(both["convex"]["input"]["w"],
                           fp["convex"]["input"]["w"])


@pytest.mark.parametrize("shape,radius,center", [
    ((21, 21), 5.0, (10.0, 10.0)), ((16, 20), 4.3, (7.5, 9.25)),
    ((9, 13), 0.0, (4.0, 4.0))])
def test_circle_helpers_are_exact(shape, radius, center):
    np.testing.assert_array_equal(
        TG.circle_mask(shape, radius, center, device=CPU).numpy(),
        np.asarray(JG.circle_mask(shape, radius, center)))
    rng = np.random.default_rng(int(radius * 10))
    blob = (rng.uniform(size=shape) > 0.6).astype(np.float32)
    blob[: shape[0] // 3] = 0.0
    for u in (blob, np.zeros(shape, np.float32), blob[None, None]):
        np.testing.assert_array_equal(
            TG.unary_circle_approximation(torch.tensor(u)).numpy(),
            np.asarray(JG.unary_circle_approximation(jnp.asarray(u))))
