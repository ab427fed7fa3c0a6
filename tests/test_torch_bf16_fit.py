"""Port parity: the fits under ``FitConfig(compute_dtype=bfloat16)`` and the
fused batched fit with per-image points, against the JAX package's fits on
the same weights and data.

Fused route: the kernel's bf16 build against the JAX kernel's bf16 build
(interpret mode). Both round the same product operands, so the fit is held
at the FP32 fit tolerances (loss history rtol 2e-4, params rtol 2e-3 atol
2e-6) and, by norm-relative distance of the fitted params, within a tenth
of the gap between JAX's bf16 and FP32 fits.

Autograd route: params and points are cast to bf16 around ``model.apply``.
The JAX reference is not one function here: XLA may keep bf16 values in
float32 between ops (its "excess precision"; the JAX fit compiled with and
without it differs by about half the bf16-vs-FP32 gap), and JAX's autodiff
sums the cotangents of broadcast bf16 operands (the biases) in bf16, where
torch sums in float32 (on the flagship model the one-step grads of every
other leaf are equal). The JAX fit is compiled without excess precision
(each bf16 op rounds, as torch does); the port's loss history must stay
within rtol 1e-3 of it, and its fitted params no further from JAX's bf16
fit than JAX's FP32 fit is."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.fit import prior_fit as JF
from awesome_tpu.fit.fused_fit import make_fused_fit_fn as j_fused
from awesome_tpu.fit.fused_fit import make_grouped_fused_fit_fn as j_grouped
from awesome_tpu.nn.icnn import ConvexNextNet as JConvexNextNet
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
from awesome_tpu_torch.nn.icnn import ConvexNextNet as TConvexNextNet
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)

CPU = "cpu"
HIST_RTOL, P_RTOL, P_ATOL = 2e-4, 2e-3, 2e-6
H = W = 12


def _models(flows=2, icnn=8, layers=1):
    kw = dict(channels=2, hidden_units=8, flow_n_flows=flows,
              flow_output_fn="tanh", spatial_shape=(H, W),
              convex_net_hidden_units=icnn, convex_net_hidden_layers=layers)
    return j_factory(**kw), t_factory(device=CPU, **kw)


def _disk(cy, cx, r):
    yy, xx = np.mgrid[0:H, 0:W]
    fg = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r ** 2
    return (1.0 - fg.astype(np.float32)).reshape(-1, 1)


def _grid():
    return np.asarray(JG.flatten_grid(JG.pixel_grid((H, W))))


def _leaves(tree, stacked=False):
    """The leaves of a param tree of either package, as JAX-layout numpy."""
    if isinstance(TT.tree_leaves(tree)[0], torch.Tensor):
        tree = params_to_numpy(tree, stacked=stacked)
    return [np.asarray(x, np.float32)
            for x in jax.tree_util.tree_leaves(jax.device_get(tree))]


def _dist(a, b, stacked=False) -> float:
    """Norm-relative distance between two param trees (either package)."""
    a = np.concatenate([x.ravel() for x in _leaves(a, stacked)])
    b = np.concatenate([x.ravel() for x in _leaves(b, stacked)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_fused_bf16(params, aux, ref, ref_aux, ref_f32, stacked=False):
    np.testing.assert_allclose(aux["loss_hist"].numpy(),
                               np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    for a, b in zip(_leaves(params, stacked), _leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=P_RTOL, atol=P_ATOL)
    gap = _dist(ref, ref_f32)
    assert gap > 0.0
    assert _dist(params, ref, stacked) <= 0.1 * gap
    for leaf in TT.tree_leaves(params):
        assert leaf.dtype == torch.float32  # the master weights


def test_fused_fit_compute_dtype_matches_jax():
    """``make_fit_fn(FitConfig(fused=True, compute_dtype=bf16))`` runs the
    kernel's bf16 build and follows JAX's fused bf16 fit."""
    jm, tm = _models()
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    pts, tgt = _grid(), _disk(6, 6, 4)
    kw = dict(num_steps=20, lr=1e-2, nan_guard_grads=False)
    args = (jp, jnp.asarray(pts), jnp.asarray(tgt))
    ref, ref_aux = jax.jit(j_fused(jm, JF.FitConfig(
        compute_dtype=jnp.bfloat16, **kw), interpret=True, tile_n=64))(*args)
    ref_f32, _ = jax.jit(j_fused(jm, JF.FitConfig(**kw), interpret=True,
                                 tile_n=64))(*args)
    fit = TF.make_fit_fn(tm, TF.FitConfig(fused=True,
                                          compute_dtype=torch.bfloat16, **kw))
    assert fit.__qualname__.startswith("make_fused_fit_fn")
    params, aux = fit(params_from_jax(jp, device=CPU), torch.tensor(pts),
                      torch.tensor(tgt))
    _assert_fused_bf16(params, aux, ref, ref_aux, ref_f32)


@pytest.mark.parametrize("interleave", [False, True])
def test_grouped_fused_fit_compute_dtype_matches_jax(interleave):
    """The grouped fused fit (and ``interleave=True``) with
    ``compute_dtype`` against JAX's grouped fused bf16 fit."""
    jm, tm = _models()
    js = jax.device_get(
        jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(1), 2)))
    pts = _grid()
    tgts = np.stack([_disk(5, 5, 3), _disk(7, 7, 3)])
    kw = dict(num_steps=15, lr=1e-2, nan_guard_grads=False)
    args = (js, jnp.asarray(pts), jnp.asarray(tgts))
    ref, ref_aux = jax.jit(j_grouped(
        jm, JF.FitConfig(compute_dtype=jnp.bfloat16, **kw), group=2,
        interpret=True, tile_n=64, interleave=interleave))(*args)
    ref_f32, _ = jax.jit(j_grouped(jm, JF.FitConfig(**kw), group=2,
                                   interpret=True, tile_n=64,
                                   interleave=interleave))(*args)
    params, aux = make_grouped_fused_fit_fn(
        tm, TF.FitConfig(compute_dtype=torch.bfloat16, **kw), group=2,
        interleave=interleave)(params_from_jax(js, device=CPU, stacked=True),
                               torch.tensor(pts), torch.tensor(tgts))
    _assert_fused_bf16(params, aux, ref, ref_aux, ref_f32, stacked=True)


@pytest.mark.parametrize("compute_dtype", [None, "bf16"])
def test_batched_fused_fit_per_image_points_matches_jax(compute_dtype):
    """``fit_priors_batched`` with (B, N, 2) points and ``fused=True``
    (one grouped kernel call per step, a point set per image) against
    JAX's ``make_batched_fit_fn(per_image_points=True)`` with
    ``fused=True`` (its kernel vmapped over the images), with the gate."""
    jm, tm = _models()
    b = 3
    js = jax.device_get(
        jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(2), b)))
    rng = np.random.default_rng(0)
    pts = np.stack([_grid() + rng.normal(scale=0.2, size=(H * W, 2))
                    .astype(np.float32) for _ in range(b)])
    tgts = np.stack([_disk(4 + i, 5 + i, 3.5) for i in range(b)])
    kw = dict(num_steps=15, lr=5e-3, nan_guard_grads=False,
              gate_threshold=0.5, fused=True)
    jdt = None if compute_dtype is None else jnp.bfloat16
    tdt = None if compute_dtype is None else torch.bfloat16
    run = JF.make_batched_fit_fn(jm, JF.FitConfig(compute_dtype=jdt, **kw),
                                 per_image_points=True)
    ref, ref_aux = run(js, jnp.asarray(pts), jnp.asarray(tgts))
    got, aux = TF.fit_priors_batched(
        tm, params_from_jax(js, device=CPU, stacked=True), torch.tensor(pts),
        torch.tensor(tgts), TF.FitConfig(compute_dtype=tdt, **kw))
    assert aux["loss_hist"].shape == (b, 15)
    np.testing.assert_allclose(aux["loss_hist"].numpy(),
                               np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    for x, y in zip(_leaves(got, True), _leaves(ref)):
        np.testing.assert_allclose(x, y, rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_allclose(aux["gate_iou"].numpy(),
                               np.asarray(ref_aux["gate_iou"]), atol=1e-6)


def test_multi_object_fused_fit_per_image_points_matches_jax():
    """``fit_multi_object_priors`` with (B, N, 2) points and ``fused=True``
    against the JAX package's (B = 2 images x K = 2 objects, one slot
    inactive)."""
    jm, tm = _models()
    bsz, k = 2, 2
    js = jax.device_get(jax.tree_util.tree_map(
        lambda a: a.reshape((bsz, k) + a.shape[1:]),
        jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(3), bsz * k))))
    pts = np.stack([_grid(), _grid()[::-1].copy()])
    objs = [_disk(4, 4, 3), _disk(8, 8, 3)]
    tgts = np.stack([np.stack(objs), np.stack(objs[::-1])])
    valid = np.array([[True, True], [True, False]])
    kw = dict(num_steps=10, lr=1e-2, nan_guard_grads=False, fused=True)
    ref, ref_aux = JF.fit_multi_object_priors(
        jm, js, jnp.asarray(pts), jnp.asarray(tgts), JF.FitConfig(**kw),
        valid_mask=jnp.asarray(valid))
    got, aux = TF.fit_multi_object_priors(
        tm, params_from_jax(js, device=CPU, stacked=2), torch.tensor(pts),
        torch.tensor(tgts), TF.FitConfig(**kw),
        valid_mask=torch.tensor(valid))
    assert aux["loss_hist"].shape == (bsz, k, 10)
    np.testing.assert_allclose(aux["loss_hist"].numpy(),
                               np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    for x, y in zip(_leaves(got, 2), _leaves(ref)):
        np.testing.assert_allclose(x, y, rtol=P_RTOL, atol=P_ATOL)


@pytest.mark.parametrize("model", ["icnn", "flagship"])
def test_autograd_fit_compute_dtype_matches_jax(model):
    """The non-fused route under ``compute_dtype``: the analogue of the
    JAX suite's mixed-precision fit test (ConvexNextNet 16 x 1, Adam, 80
    steps at 16x16), and the flagship model: the fit converges, the master
    weights stay float32, and the fitted params follow JAX's bf16 fit
    (see the module docstring for the bound)."""
    if model == "icnn":
        jm = JConvexNextNet(n_hidden=16, n_hidden_layers=1)
        tm = TConvexNextNet(n_hidden=16, n_hidden_layers=1, device=CPU)
        kw = dict(num_steps=80, lr=2e-3, optimizer="adam")
        pts = np.asarray(JG.flatten_grid(JG.pixel_grid((16, 16))))
        yy, xx = np.mgrid[0:16, 0:16]
        fg = ((yy - 7.5) ** 2 + (xx - 7.5) ** 2) <= 25.0
        tgt = (1.0 - fg.astype(np.float32)).reshape(-1, 1)
    else:
        jm, tm = _models()
        kw = dict(num_steps=20, lr=1e-2, nan_guard_grads=False)
        pts, tgt = _grid(), _disk(6, 6, 4)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    args = (jp, jnp.asarray(pts), jnp.asarray(tgt))

    def jax_fit(dtype):
        fit = jax.jit(JF.make_fit_fn(jm, JF.FitConfig(compute_dtype=dtype,
                                                      **kw)))
        return fit.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)

    ref, ref_aux = jax_fit(jnp.bfloat16)
    ref_f32, _ = jax_fit(None)
    params, aux = TF.make_fit_fn(
        tm, TF.FitConfig(compute_dtype=torch.bfloat16, **kw))(
        params_from_jax(jp, device=CPU), torch.tensor(pts),
        torch.tensor(tgt))
    hist = aux["loss_hist"].numpy()
    assert np.isfinite(hist).all() and hist[-1] < hist[0]
    for leaf in TT.tree_leaves(params):
        assert leaf.dtype == torch.float32
    np.testing.assert_allclose(hist, np.asarray(ref_aux["loss_hist"]),
                               rtol=1e-3)
    gap = _dist(ref, ref_f32)
    assert gap > 0.0
    assert _dist(params, ref) <= gap
