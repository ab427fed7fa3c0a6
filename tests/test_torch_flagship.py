"""Port parity: the fused flagship loss+grad of awesome_tpu_torch.

On the CPU the wrapper runs its plain PyTorch version; it is held to
``jax.value_and_grad`` of the JAX model and to the JAX Pallas kernel in
interpret mode (loss rtol 2e-5, grads rtol 5e-4 atol 1e-6, the JAX suite's
own tolerances). The CUDA kernel itself is held to the plain version on
the card by ``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.fit.prior_fit import FitConfig as JFitConfig
from awesome_tpu.fit.prior_fit import make_point_weights as j_weights
from awesome_tpu.nn.path_connected import (
    real_nvp_path_connected_net as j_factory,
)
from awesome_tpu.ops import pallas_flagship as JP
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)
from awesome_tpu_torch.ops import flagship as TP

CPU = "cpu"
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 5e-4, 1e-6


def _models(h=16, w=16, flows=4, hidden=8, icnn=12, layers=2):
    kw = dict(channels=2, hidden_units=hidden, flow_n_flows=flows,
              flow_output_fn="tanh", spatial_shape=(h, w),
              convex_net_hidden_units=icnn, convex_net_hidden_layers=layers)
    return j_factory(**kw), t_factory(device=CPU, **kw)


def _params(jm, seed):
    rng = np.random.default_rng(seed)
    p = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))
        .astype(np.float32), p)


def _data(h=16, w=16, n=None, shift=0):
    pts = np.asarray(JG.flatten_grid(JG.pixel_grid((h, w))))
    yy, xx = np.mgrid[0:h, 0:w]
    fg = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2) <= (h / 3) ** 2
    tgt = np.roll((1.0 - fg.astype(np.float32)).reshape(-1, 1), shift, 0)
    if n is not None:
        pts, tgt = pts[:n], tgt[:n]
    wts = np.asarray(j_weights(jnp.asarray(tgt), JFitConfig()))
    return pts, tgt, wts


def _jax_value_and_grad(jm, jp, pts, tgt, wts):
    def loss(p):
        prob = jax.nn.sigmoid(jm.apply(p, jnp.asarray(pts)))
        return jnp.sum(jnp.asarray(wts) * (prob - jnp.asarray(tgt)) ** 2)

    return jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, jp))


def _port_value_and_grad(tm, jp, pts, tgt, wts):
    f = TP.make_flagship_loss_grad(tm)
    packed = TP.pack_flagship(tm, params_from_jax(jp, device=CPU))
    loss, grads = f(packed, torch.tensor(pts), torch.tensor(tgt),
                    torch.tensor(wts))
    return loss, params_to_numpy(TP.unpack_flagship(tm, grads))


def _assert_grads(got_tree, ref_tree):
    got = jax.tree_util.tree_leaves(got_tree)
    ref = jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("n", [None, 97])
def test_plain_matches_jax_value_and_grad(n):
    """Full grid and a ragged point count."""
    jm, tm = _models()
    jp = _params(jm, 3)
    pts, tgt, wts = _data(n=n)
    ref_loss, ref_grads = _jax_value_and_grad(jm, jp, pts, tgt, wts)
    loss, grads = _port_value_and_grad(tm, jp, pts, tgt, wts)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    _assert_grads(grads, ref_grads)


def test_plain_matches_jax_pallas_interpret():
    jm, tm = _models(h=12, w=12, flows=2, hidden=8, icnn=8, layers=1)
    jp = _params(jm, 5)
    pts, tgt, wts = _data(12, 12)
    kern = JP.make_flagship_loss_grad(jm, tile_n=64, interpret=True)
    jpacked = JP.pack_flagship(jm, jax.tree_util.tree_map(jnp.asarray, jp))
    j_loss, j_grads = kern(jpacked, jnp.asarray(pts), jnp.asarray(tgt),
                           jnp.asarray(wts))
    f = TP.make_flagship_loss_grad(tm)
    packed = TP.pack_flagship(tm, params_from_jax(jp, device=CPU))
    loss, grads = f(packed, torch.tensor(pts), torch.tensor(tgt),
                    torch.tensor(wts))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    for name in TP.PACKED_FIELDS:
        np.testing.assert_allclose(grads[name].numpy(),
                                   np.asarray(j_grads[name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_pack_matches_jax_and_roundtrips():
    jm, tm = _models()
    jp = _params(jm, 1)
    tp = params_from_jax(jp, device=CPU)
    packed = TP.pack_flagship(tm, tp)
    jpacked = JP.pack_flagship(jm, jax.tree_util.tree_map(jnp.asarray, jp))
    assert tuple(packed) == TP.PACKED_FIELDS == JP.PACKED_FIELDS
    spec = TP.FlagshipSpec.of(tm)
    for name in TP.PACKED_FIELDS:
        np.testing.assert_array_equal(packed[name].numpy(),
                                      np.asarray(jpacked[name]))
        assert tuple(packed[name].shape) == spec.field_shapes()[name]
    for a, b in zip(
            jax.tree_util.tree_leaves(
                params_to_numpy(TP.unpack_flagship(tm, packed))),
            jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)
    flat = TP.pack_flat({k: v[None] for k, v in packed.items()}, 1)
    assert flat.shape == (1, spec.offsets()[1])
    for name, v in TP.unpack_flat(spec, flat).items():
        assert torch.equal(v[0], packed[name])
    for a, b in zip(TP._norm_constants(tm), JP._norm_constants(jm)):
        np.testing.assert_array_equal(a, b)


def test_grouped_matches_per_image():
    """G = 2 with distinct params and targets: each image's loss and grads
    equal its own G = 1 call, so nothing mixes across images."""
    jm, tm = _models()
    f1 = TP.make_flagship_loss_grad(tm)
    f2 = TP.make_flagship_loss_grad(tm, group=2)
    packs, tgts, wgts = [], [], []
    for g in range(2):
        packs.append(TP.pack_flagship(
            tm, params_from_jax(_params(jm, 10 + g), device=CPU)))
        pts, tgt, wts = _data(shift=3 * g)
        tgts.append(torch.tensor(tgt))
        wgts.append(torch.tensor(wts))
    x = torch.tensor(pts)
    stacked = {k: torch.stack([p[k] for p in packs]) for k in packs[0]}
    losses, grads = f2(stacked, x, torch.stack(tgts), torch.stack(wgts))
    assert losses.shape == (2,)
    for g in range(2):
        loss, gr = f1(packs[g], x, tgts[g], wgts[g])
        np.testing.assert_allclose(float(losses[g]), float(loss), rtol=1e-6)
        for k in TP.PACKED_FIELDS:
            np.testing.assert_allclose(grads[k][g].numpy(), gr[k].numpy(),
                                       rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("n", [None, 97])
def test_interleave_matches_jax_interleaved_kernel(n):
    """``interleave=True`` (the JAX package's ``_kernel_interleaved``, K3)
    against that kernel in interpret mode, G = 2, full grid and ragged N:
    the port serves it with the grouped kernel's function."""
    jm, tm = _models(h=12, w=12, flows=2, hidden=8, icnn=8, layers=1)
    packs, jpacks, tgts, wgts = [], [], [], []
    for g in range(2):
        jp = _params(jm, 30 + g)
        jpacks.append(JP.pack_flagship(
            jm, jax.tree_util.tree_map(jnp.asarray, jp)))
        packs.append(TP.pack_flagship(tm, params_from_jax(jp, device=CPU)))
        pts, tgt, wts = _data(12, 12, n=n, shift=2 * g)
        tgts.append(tgt)
        wgts.append(wts)
    kern = JP.make_flagship_loss_grad(jm, tile_n=64, interpret=True, group=2,
                                      interleave=True)
    j_loss, j_grads = kern(
        {k: jnp.stack([p[k] for p in jpacks]) for k in jpacks[0]},
        jnp.asarray(pts), jnp.asarray(np.stack(tgts)),
        jnp.asarray(np.stack(wgts)))
    f = TP.make_flagship_loss_grad(tm, group=2, interleave=True)
    loss, grads = f({k: torch.stack([p[k] for p in packs]) for k in packs[0]},
                    torch.tensor(pts), torch.tensor(np.stack(tgts)),
                    torch.tensor(np.stack(wgts)))
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss).reshape(2),
                               rtol=LOSS_RTOL)
    for name in TP.PACKED_FIELDS:
        np.testing.assert_allclose(grads[name].numpy(),
                                   np.asarray(j_grads[name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_w2_off_block_grads_are_masked():
    jm, tm = _models()
    pts, tgt, wts = _data()
    packed = TP.pack_flagship(tm, params_from_jax(_params(jm, 2), device=CPU))
    _, grads = TP.make_flagship_loss_grad(tm)(
        packed, torch.tensor(pts), torch.tensor(tgt), torch.tensor(wts))
    h = tm.flow_net.hidden_units
    assert float(grads["w2"][:, :2, h:].abs().max()) == 0.0
    assert float(grads["w2"][:, 2:, :h].abs().max()) == 0.0
    assert float(grads["w2"][:, :2, :h].abs().max()) > 0.0


def test_rejections():
    jm, tm = _models()
    packed = TP.pack_flagship(tm, tm.init())
    f = TP.make_flagship_loss_grad(tm)
    with pytest.raises(ValueError, match="at least one point"):
        f(packed, torch.zeros((0, 2)), torch.zeros((0, 1)),
          torch.zeros((0, 1)))
    with pytest.raises(ValueError):
        TP.make_flagship_loss_grad(tm, interleave=True)
    with pytest.raises(NotImplementedError):
        TP.make_flagship_loss_grad(tm, use_bf16=True)
    sig = t_factory(channels=2, hidden_units=8, flow_n_flows=2,
                    flow_output_fn="sigmoid", spatial_shape=(8, 8),
                    device=CPU)
    assert TP.flagship_supported(tm) and not TP.flagship_supported(sig)
    with pytest.raises(ValueError):
        TP.make_flagship_loss_grad(sig)
    # the kernel wrapper takes CUDA tensors only and says so
    spec = TP.FlagshipSpec.of(tm)
    _, p_len = spec.offsets()
    shape = TP.LaunchShape(64, 0, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        TP.flagship_loss_grad_cuda(spec, torch.zeros((1, p_len)),
                                   torch.zeros((4, 2)), torch.zeros((1, 4)),
                                   torch.zeros((1, 4)), True, shape)
    with pytest.raises(ValueError, match="float32"):
        TP.flagship_loss_grad_cuda(spec, torch.zeros((1, p_len)),
                                   torch.zeros((4, 2), dtype=torch.float64),
                                   torch.zeros((1, 4)), torch.zeros((1, 4)),
                                   True, shape)


def test_packed_weight_decay_and_convexity():
    jm, tm = _models()
    packed = TP.pack_flagship(tm, params_from_jax(_params(jm, 4), device=CPU))
    wd = TP.packed_weight_decay(packed, 1e-5)
    assert wd == JP.packed_weight_decay(packed, 1e-5)
    shifted = dict(packed, wln=packed["wln"] - 0.5, wout=packed["wout"] - 0.5)
    clipped = TP.packed_enforce_convexity(shifted)
    tree = tm.enforce_convexity(TP.unpack_flagship(tm, shifted))
    for a, b in zip(jax.tree_util.tree_leaves(
            params_to_numpy(TP.unpack_flagship(tm, clipped))),
            jax.tree_util.tree_leaves(params_to_numpy(tree))):
        np.testing.assert_array_equal(a, b)
