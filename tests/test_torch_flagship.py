"""Port parity: the fused flagship loss+grad of awesome_tpu_torch.

On the CPU the wrapper runs its plain PyTorch version; it is held to
``jax.value_and_grad`` of the JAX model and to the JAX Pallas kernel in
interpret mode (loss rtol 2e-5, grads rtol 5e-4 atol 1e-6, the JAX suite's
own tolerances). The CUDA kernel itself is held to the plain version on
the card by ``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py``.

The bf16 build (``use_bf16``) is held to the JAX kernel's bf16 build by
norm-relative error, leaf by leaf: each error must stay under a tenth of
the gap between that kernel's bf16 and FP32 results on the same inputs
(a build that forgot to round is off by the whole gap)."""
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
from torch_one_thread import one_torch_thread  # noqa: F401

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
    assert TP.make_flagship_loss_grad(tm, use_bf16=True).use_bf16
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
    # per-image points must come one set per image
    with pytest.raises(ValueError, match="expected contiguous"):
        TP.flagship_loss_grad_cuda(spec, torch.zeros((1, p_len)),
                                   torch.zeros((3, 4, 2)),
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


def _nrel(a, b) -> float:
    a, b = np.ravel(np.asarray(a)), np.ravel(np.asarray(b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_bf16_close(loss, grads, ref, ref_f32):
    """The bf16 accuracy rule: loss and every leaf within a tenth of the
    reference's bf16-vs-FP32 gap, by (norm-)relative error."""
    (r_loss, r_grads), (f_loss, f_grads) = ref, ref_f32
    gap = _nrel(r_loss, f_loss)
    assert gap > 0.0
    assert _nrel(np.asarray(loss).reshape(np.shape(r_loss)), r_loss) \
        <= 0.1 * gap
    for name in TP.PACKED_FIELDS:
        gap = _nrel(r_grads[name], f_grads[name])
        assert gap > 0.0, name
        assert _nrel(grads[name], r_grads[name]) <= 0.1 * gap, name


@pytest.mark.parametrize("group,interleave", [(1, False), (2, False),
                                              (2, True)])
def test_bf16_plain_matches_jax_bf16_kernel(group, interleave):
    """``use_bf16=True`` against the JAX kernel's bf16 build in interpret
    mode: G = 1, G = 2 and ``interleave=True`` (``_kernel_interleaved``)."""
    jm, tm = _models(h=12, w=12, flows=2, hidden=8, icnn=8, layers=1)
    jpacks, packs, tgts, wgts = [], [], [], []
    for g in range(group):
        jp = _params(jm, 50 + g)
        jpacks.append(JP.pack_flagship(
            jm, jax.tree_util.tree_map(jnp.asarray, jp)))
        packs.append(TP.pack_flagship(tm, params_from_jax(jp, device=CPU)))
        pts, tgt, wts = _data(12, 12, shift=2 * g)
        tgts.append(tgt)
        wgts.append(wts)
    if group > 1:
        args = ({k: jnp.stack([p[k] for p in jpacks]) for k in jpacks[0]},
                jnp.asarray(pts), jnp.asarray(np.stack(tgts)),
                jnp.asarray(np.stack(wgts)))
        targs = ({k: torch.stack([p[k] for p in packs]) for k in packs[0]},
                 torch.tensor(pts), torch.tensor(np.stack(tgts)),
                 torch.tensor(np.stack(wgts)))
    else:
        args = (jpacks[0], jnp.asarray(pts), jnp.asarray(tgts[0]),
                jnp.asarray(wgts[0]))
        targs = (packs[0], torch.tensor(pts), torch.tensor(tgts[0]),
                 torch.tensor(wgts[0]))
    ref, ref_f32 = (JP.make_flagship_loss_grad(
        jm, tile_n=64, interpret=True, group=group, interleave=interleave,
        use_bf16=bf16)(*args) for bf16 in (True, False))
    f = TP.make_flagship_loss_grad(tm, group=group, interleave=interleave,
                                   use_bf16=True)
    loss, grads = f(*targs)
    _assert_bf16_close(loss.numpy(), {k: v.numpy() for k, v in grads.items()},
                       ref, ref_f32)


@pytest.mark.parametrize("n,use_bf16", [(None, False), (97, False),
                                        (None, True)])
def test_per_image_points_match_jax_vmapped_kernel(n, use_bf16):
    """Per-image points (G, N, 2) on the grouped call against ``jax.vmap``
    of the JAX kernel over params, points and targets (what the JAX
    batched fused fit with per-image points runs); full grid, ragged N,
    and the bf16 build."""
    jm, tm = _models(h=12, w=12, flows=2, hidden=8, icnn=8, layers=1)
    rng = np.random.default_rng(7)
    g = 3
    jps = [_params(jm, 60 + i) for i in range(g)]
    data = [_data(12, 12, n=n, shift=i) for i in range(g)]
    pts = np.stack([d[0] + rng.normal(scale=0.3, size=d[0].shape)
                    .astype(np.float32) for d in data])
    tgts = np.stack([d[1] for d in data])
    wgts = np.stack([d[2] for d in data])
    jpacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[JP.pack_flagship(jm, jax.tree_util.tree_map(jnp.asarray, jp))
          for jp in jps])

    def jax_run(bf16):
        kern = JP.make_flagship_loss_grad(jm, tile_n=64, interpret=True,
                                          use_bf16=bf16)
        return jax.vmap(kern)(jpacked, jnp.asarray(pts), jnp.asarray(tgts),
                              jnp.asarray(wgts))

    f = TP.make_flagship_loss_grad(tm, group=g, use_bf16=use_bf16)
    stacked = {k: torch.stack([TP.pack_flagship(
        tm, params_from_jax(jp, device=CPU))[k] for jp in jps])
        for k in TP.PACKED_FIELDS}
    loss, grads = f(stacked, torch.tensor(pts), torch.tensor(tgts),
                    torch.tensor(wgts))
    ref = jax_run(use_bf16)
    if use_bf16:
        _assert_bf16_close(loss.numpy(),
                           {k: v.numpy() for k, v in grads.items()},
                           ref, jax_run(False))
        return
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref[0]).reshape(g),
                               rtol=LOSS_RTOL)
    for name in TP.PACKED_FIELDS:
        np.testing.assert_allclose(grads[name].numpy(),
                                   np.asarray(ref[1][name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_per_image_points_equal_shared_when_repeated():
    """The same point set given once per image gives exactly what the
    shared points give."""
    jm, tm = _models(h=12, w=12, flows=2, hidden=8, icnn=8, layers=1)
    f = TP.make_flagship_loss_grad(tm, group=2)
    stacked = {k: torch.stack([TP.pack_flagship(
        tm, params_from_jax(_params(jm, 70 + i), device=CPU))[k]
        for i in range(2)]) for k in TP.PACKED_FIELDS}
    pts, tgt, wts = _data(12, 12)
    x = torch.tensor(pts)
    t2 = torch.tensor(np.stack([tgt] * 2))
    w2 = torch.tensor(np.stack([wts] * 2))
    loss, grads = f(stacked, x, t2, w2)
    loss_p, grads_p = f(stacked, torch.stack([x, x]), t2, w2)
    assert torch.equal(loss, loss_p)
    for k in TP.PACKED_FIELDS:
        assert torch.equal(grads[k], grads_p[k])


def test_rounded_matmul_rounds_operands_and_cotangents():
    """RoundedMatmul's value and grads are the products of bf16-rounded
    operands (and cotangent), summed in FP32."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((3, 5, 7), generator=gen, requires_grad=True)
    b = torch.randn((1, 7, 4), generator=gen, requires_grad=True)
    g = torch.randn((3, 5, 4), generator=gen)
    out = TP.RoundedMatmul.apply(a, b)
    ga, gb = torch.autograd.grad(out, (a, b), g)

    def r(t):
        return t.detach().to(torch.bfloat16).to(torch.float32)

    torch.testing.assert_close(out, r(a) @ r(b), rtol=0, atol=0)
    torch.testing.assert_close(ga, r(g) @ r(b).mT, rtol=0, atol=0)
    torch.testing.assert_close(gb, (r(a).mT @ r(g)).sum(0, keepdim=True),
                               rtol=0, atol=0)
    assert not torch.equal(out, a.detach() @ b.detach())
