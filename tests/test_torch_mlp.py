"""Port parity: the fused ICNN of awesome_tpu_torch (ops/mlp.py).

On the CPU the fused wrappers run their plain PyTorch versions; these are
held to the JAX ConvexNextNet (``model.apply``, ``jax.vjp``), to the JAX
Pallas kernels ``_icnn_kernel`` and ``_icnn_bwd_kernel`` in interpret mode,
and to JAX's ``FusedConvexNextNet``/``FullyFusedConvexNextNet`` grads, under
``torch.func.grad`` and ``torch.func.vmap``. Tolerances: outputs and dx atol
1e-5 (the JAX suite's own, ``tests/test_pallas_mlp.py``); weight grads rtol
5e-4 atol 1e-6 (``tests/test_torch_flagship.py``). The CUDA kernels are
held to the plain versions on the card by ``tests/test_torch_kernel_gpu.py``
and ``chip_smoke.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from awesome_tpu.nn.icnn import ConvexNextNet as JConvexNextNet
from awesome_tpu.ops import pallas_mlp as JM
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.ops import mlp as M
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 1e-6


def _models(width=12, layers=1, c=2):
    return (JConvexNextNet(n_hidden=width, in_features=c,
                           n_hidden_layers=layers),
            ConvexNextNet(n_hidden=width, in_features=c,
                          n_hidden_layers=layers, device=CPU))


def _params(jm, seed):
    """JAX init plus numpy noise (numpy leaves, JAX layout)."""
    rng = np.random.default_rng(seed)
    p = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)))
        .astype(np.float32), p)


def _stacked(jm, b, seed):
    trees = [_params(jm, seed + i) for i in range(b)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _points(n, c, seed, batch=()):
    return np.random.default_rng(seed).uniform(
        size=batch + (n, c)).astype(np.float32)


def _assert_leaves(got, ref, stacked=False):
    got = jax.tree_util.tree_leaves(params_to_numpy(got, stacked=stacked))
    ref = jax.tree_util.tree_leaves(ref)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def _kernel_weights(jp):
    """The JAX kernels' transposed weights: (out, in), biases (H, 1)."""
    return tuple(w[:, None] if w.ndim == 1 else w.T
                 for w in JM._flat_weights(jax.tree_util.tree_map(
                     jnp.asarray, jp)))


@pytest.mark.parametrize("layers,c,n", [(1, 2, 64), (2, 2, 97), (1, 3, 50)])
def test_plain_forward_matches_jax_and_interpret_kernel(layers, c, n):
    jm, tm = _models(layers=layers, c=c)
    jp = _params(jm, 1)
    x = _points(n, c, 2)
    ref = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                              jnp.asarray(x)))
    kern = pl.pallas_call(
        functools.partial(JM._icnn_kernel, layers),
        out_shape=jax.ShapeDtypeStruct((1, n), jnp.float32),
        interpret=True)(jnp.asarray(x).T, *_kernel_weights(jp))
    got = M.icnn_forward_plain(params_from_jax(jp, device=CPU),
                               torch.tensor(x)).numpy()
    assert got.shape == (n, 1)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got[:, 0], np.asarray(kern[0]), atol=ATOL)
    # the fused wrappers take the plain version on CPU tensors
    for wrap in (M.FusedConvexNextNet, M.FullyFusedConvexNextNet):
        out = wrap(tm).apply(params_from_jax(jp, device=CPU), torch.tensor(x))
        np.testing.assert_array_equal(out.numpy(), got)


@pytest.mark.parametrize("layers,c,n", [(2, 2, 64), (1, 3, 77)])
def test_plain_backward_matches_jax_vjp_and_interpret_kernel(layers, c, n):
    jm, _ = _models(layers=layers, c=c)
    jp = _params(jm, 3)
    x = _points(n, c, 4)
    g = np.random.default_rng(5).normal(size=(n, 1)).astype(np.float32)
    weights = _kernel_weights(jp)
    outs = pl.pallas_call(
        functools.partial(JM._icnn_bwd_kernel, layers),
        out_shape=tuple([jax.ShapeDtypeStruct((c, n), jnp.float32)]
                        + [jax.ShapeDtypeStruct(w.shape, jnp.float32)
                           for w in weights]),
        grid=(1,), interpret=True)(jnp.asarray(x).T, jnp.asarray(g).T,
                                   *weights)
    _, vjp = jax.vjp(jm.apply, jax.tree_util.tree_map(jnp.asarray, jp),
                     jnp.asarray(x))
    ref_tree, ref_dx = vjp(jnp.asarray(g))
    tree, dx = M.icnn_backward_plain(params_from_jax(jp, device=CPU),
                                     torch.tensor(x), torch.tensor(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(outs[0]).T, atol=ATOL)
    _assert_leaves(tree, jax.device_get(ref_tree))
    # the interpret kernel's grads, flat in (out, in) layout
    for got, kern in zip(M.flat_weights(tree), outs[1:]):
        kern = np.asarray(kern)
        kern = kern[:, 0] if got.ndim == 1 else kern
        np.testing.assert_allclose(got.numpy(), kern, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def _jax_loss(model, tgt, wts):
    def loss(p, x):
        prob = jax.nn.sigmoid(model.apply(p, x))
        return jnp.sum(wts * (prob - tgt) ** 2)

    return loss


def _port_loss(model):
    def loss(p, x, tgt, wts):
        prob = torch.sigmoid(model.apply(p, x))
        return torch.sum(wts * (prob - tgt) ** 2)

    return loss


@pytest.mark.parametrize("fully", [False, True])
@pytest.mark.parametrize("layers,c,n", [(1, 2, 90), (2, 3, 61)])
def test_fused_grads_match_jax_wrappers(fully, layers, c, n):
    jm, tm = _models(layers=layers, c=c)
    jwrap = JM.FullyFusedConvexNextNet if fully else JM.FusedConvexNextNet
    twrap = M.FullyFusedConvexNextNet if fully else M.FusedConvexNextNet
    jp = _params(jm, 6)
    x = _points(n, c, 7)
    rng = np.random.default_rng(8)
    tgt = (rng.uniform(size=(n, 1)) > 0.5).astype(np.float32)
    wts = np.full((n, 1), 1.0 / n, np.float32)
    ref_v, ref_g = jax.value_and_grad(_jax_loss(jwrap(jm), tgt, wts))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    grads, v = torch.func.grad_and_value(_port_loss(twrap(tm)))(
        params_from_jax(jp, device=CPU), torch.tensor(x), torch.tensor(tgt),
        torch.tensor(wts))
    np.testing.assert_allclose(float(v), float(ref_v), rtol=1e-5)
    _assert_leaves(grads, jax.device_get(ref_g))
    # dx through the wrapper's backward (the sum over the points of x)
    ref_dx = jax.grad(_jax_loss(jwrap(jm), tgt, wts), argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    dx = torch.func.grad(_port_loss(twrap(tm)), argnums=1)(
        params_from_jax(jp, device=CPU), torch.tensor(x), torch.tensor(tgt),
        torch.tensor(wts))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=ATOL)


@pytest.mark.parametrize("fully", [False, True])
@pytest.mark.parametrize("per_image", [False, True])
def test_vmapped_grads_match_jax_in_one_grouped_call(monkeypatch, fully,
                                                     per_image):
    """vmap(grad) over B = 3 images equals JAX's vmap(grad), and the
    forward and (K5) backward each run once for the whole batch, on the
    image axis, as the kernels do on the card."""
    b, n, c = 3, 45, 2
    jm, tm = _models(width=14, layers=2, c=c)
    jwrap = JM.FullyFusedConvexNextNet if fully else JM.FusedConvexNextNet
    twrap = M.FullyFusedConvexNextNet if fully else M.FusedConvexNextNet
    js = _stacked(jm, b, 20)
    x = _points(n, c, 9, (b,) if per_image else ())
    rng = np.random.default_rng(10)
    tgt = (rng.uniform(size=(b, n, 1)) > 0.5).astype(np.float32)
    wts = np.full((b, n, 1), 1.0 / n, np.float32)
    x_ax = 0 if per_image else None

    def jloss(p, xx, t, w):
        return _jax_loss(jwrap(jm), t, w)(p, xx)

    ref_v, ref_g = jax.vmap(jax.value_and_grad(jloss),
                            in_axes=(0, x_ax, 0, 0))(
        jax.tree_util.tree_map(jnp.asarray, js), jnp.asarray(x),
        jnp.asarray(tgt), jnp.asarray(wts))
    calls = []
    for name in ("grouped_forward", "grouped_backward"):
        orig = getattr(M, name)

        def spy(spec, xx, *rest, _orig=orig, _name=name):
            calls.append((_name, tuple(rest[-1][0].shape[:-2])))
            return _orig(spec, xx, *rest)

        monkeypatch.setattr(M, name, spy)
    grads, v = torch.func.vmap(torch.func.grad_and_value(
        _port_loss(twrap(tm))), in_dims=(0, x_ax, 0, 0))(
        params_from_jax(js, device=CPU, stacked=True), torch.tensor(x),
        torch.tensor(tgt), torch.tensor(wts))
    want = [("grouped_forward", (b,))]
    if fully:
        want.append(("grouped_backward", (b,)))
    assert calls == want
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=1e-5)
    _assert_leaves(grads, jax.device_get(ref_g), stacked=True)


def test_flat_layout_and_rejections():
    jm, tm = _models(width=10, layers=2, c=3)
    jp = _params(jm, 11)
    tp = params_from_jax(jp, device=CPU)
    spec = M.IcnnSpec.of(tm)
    ref = [np.asarray(w) for w in _kernel_weights(jp)]
    leaves = M.flat_weights(tp)
    assert [tuple(t.shape) for t in leaves] == spec.field_shapes()
    for got, want in zip(leaves, ref):
        np.testing.assert_array_equal(got.numpy(),
                                      want[:, 0] if got.ndim == 1 else want)
    assert spec.row_len == sum(a.size for a in ref)
    for a, b in zip(M.flat_weights(M.unflat_weights(leaves)), leaves):
        assert a is b
    with pytest.raises(ValueError, match="out_features"):
        M.FullyFusedConvexNextNet(ConvexNextNet(n_hidden=8, out_features=2,
                                                device=CPU))
    flat = torch.zeros((1, spec.row_len))
    with pytest.raises(ValueError, match="CUDA"):
        M.icnn_forward_cuda(spec, flat, torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        M.icnn_backward_cuda(spec, flat, torch.zeros((4, 3)),
                             torch.zeros((1, 4)))
    # stacked (B, K) trees convert both ways
    two = jax.tree_util.tree_map(lambda a: np.stack([np.stack([a] * 2)] * 3),
                                 jp)
    back = params_to_numpy(params_from_jax(two, device=CPU, stacked=2),
                           stacked=2)
    assert params_from_jax(two, device=CPU, stacked=2)["input"]["w"].shape \
        == (3, 2, 10, 3)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(two)):
        np.testing.assert_array_equal(a, b)
