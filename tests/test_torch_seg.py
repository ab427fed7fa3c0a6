"""Port parity: the conv primitives, the segmentation nets and the adapters
of awesome_tpu_torch against the JAX package's on the same weights
(converted by ``awesome_tpu_torch.bridge``: HWIO conv weights to torch's
(out, in, kh, kw)) and the same NHWC inputs.

Tolerances: FP32 conv stacks sum in another order than XLA's, so outputs
are held at rtol 1e-4 with an atol of 1e-5 times the output's scale;
batch-norm state and elementwise ops at rtol 1e-5. The UNet's batch norm
in train mode divides by the batch's std, which scales those differences
up: its outputs are held at an atol of 1e-4 of their scale, its grads at
rtol 2e-3 and an atol of 1e-4 of the largest grad (a conv bias in front
of a batch norm has a zero gradient, rounding noise in both packages)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import transforms as JT
from awesome_tpu.nn import adapters as JA
from awesome_tpu.nn import conv as JC
from awesome_tpu.nn import seg as JS
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import transforms as TTr
from awesome_tpu_torch.nn import adapters as TA
from awesome_tpu_torch.nn import conv as TC
from awesome_tpu_torch.nn import seg as TS

CPU = "cpu"


def _rand(shape, seed=0, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def _close(got, ref, rtol=1e-4, scale_atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=scale_atol * max(np.abs(ref).max(), 1.0))


def _tree_close(got, ref, rtol=1e-4, scale_atol=1e-5):
    g = jax.tree_util.tree_leaves(params_to_numpy(got))
    r = jax.tree_util.tree_leaves(jax.device_get(ref))
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b)
        _close(a, b, rtol, scale_atol)


@pytest.mark.parametrize("k,stride,padding", [(3, 1, "SAME"), (1, 1, "SAME"),
                                              (4, 2, "SAME"), (3, 1, "VALID"),
                                              (2, 1, "SAME")])
def test_conv2d_matches_jax(k, stride, padding):
    x = _rand((2, 9, 11, 3), 1, -1, 1)
    w = _rand((k, k, 3, 5), 2, -0.5, 0.5)
    b = _rand((5,), 3)
    ref = JC.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    stride=stride, padding=padding)
    tw = params_from_jax({"w": w}, device=CPU)["w"]
    got = TC.conv2d(torch.tensor(x), tw, torch.tensor(b), stride=stride,
                    padding=padding)
    assert got.shape == ref.shape
    _close(got, ref)


def test_conv2d_bf16_compute_dtype_matches_jax():
    """bf16 inputs, float32 output: both round the inputs and the conv's
    output to bf16; the two sum in their own order, so an output can land
    one bf16 step apart (atol: one bf16 ulp of the largest output)."""
    x = _rand((2, 8, 8, 4), 4, -1, 1)
    w = _rand((3, 3, 4, 6), 5, -0.5, 0.5)
    b = _rand((6,), 6)
    ref = JC.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    compute_dtype=jnp.bfloat16)
    got = TC.conv2d(torch.tensor(x), params_from_jax({"w": w},
                                                     device=CPU)["w"],
                    torch.tensor(b), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    ulp = 2.0 ** -7 * np.abs(np.asarray(ref)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ulp)
    f32 = TC.conv2d(torch.tensor(x), params_from_jax({"w": w},
                                                     device=CPU)["w"],
                    torch.tensor(b))
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train):
    x = _rand((2, 5, 6, 4), 7, -2, 3)
    jp, js = JC.batchnorm_init(4)
    jp = {"scale": np.asarray(_rand((4,), 8, 0.5, 1.5)),
          "bias": np.asarray(_rand((4,), 9))}
    js = dict(js, mean=_rand((4,), 10), var=_rand((4,), 11, 0.5, 2.0))
    ref_y, ref_s = JC.batchnorm_apply(jp, js, jnp.asarray(x), train)
    tp = params_from_jax(jp, device=CPU)
    ts = params_from_jax(jax.device_get(js), device=CPU)
    y, s = TC.batchnorm_apply(tp, ts, torch.tensor(x), train)
    _close(y, ref_y, 1e-5)
    _tree_close(s, ref_s, 1e-5)
    assert s["count"].dtype == torch.int32
    tp0, ts0 = TC.batchnorm_init(4, device=CPU)
    jp0, js0 = JC.batchnorm_init(4)
    _tree_close(tp0, jp0, 0)
    _tree_close(ts0, js0, 0)


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 7, 5, 2)])
def test_pool_upsample_pad_match_jax(shape):
    """Max pool (odd edges dropped), the bilinear 2x upsample (what
    ``jax.image.resize`` computes: half-pixel centres) and pad-to-match."""
    x = _rand(shape, 12, -1, 1)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    _close(TC.max_pool2x2(tx), JC.max_pool2x2(jx), 0)
    _close(TC.upsample_bilinear_2x(tx), JC.upsample_bilinear_2x(jx), 1e-5)
    _close(TC.pad_to_match(tx, shape[1] + 3, shape[2] + 2),
           JC.pad_to_match(jx, shape[1] + 3, shape[2] + 2), 0)


def test_conv_module_and_bridge_roundtrip():
    jm = JC.Conv2d(3, 4, 3)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = TC.Conv2d(3, 4, 3, device=CPU)
    tp = params_from_jax(jp, device=CPU)
    assert tuple(tp["w"].shape) == (4, 3, 3, 3)
    back = params_to_numpy(tp)
    np.testing.assert_array_equal(back["w"], jp["w"])
    x = _rand((1, 6, 7, 3), 13)
    _close(tm.apply(tp, torch.tensor(x)), jm.apply(jp, jnp.asarray(x)))
    init = tm.init(torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(27)
    assert float(init["w"].abs().max()) <= bound
    assert tuple(init["w"].shape) == (4, 3, 3, 3)


def test_pointwise_nets_match_jax():
    x = _rand((10, 5), 14)
    img, grid = _rand((10, 3), 15), _rand((10, 2), 16)
    for jm, tm, args in (
            (JS.Net(n_hidden=16), TS.Net(n_hidden=16, device=CPU), (x,)),
            (JS.FCNet(5, 1, 16, 2), TS.FCNet(5, 1, 16, 2, device=CPU),
             (img, grid)),
            (JA.DenseNet(5, 2, 12, 3), TA.DenseNet(5, 2, 12, 3, device=CPU),
             (x,)),
            (JA.PixelMatrixSeg(JS.FCNet(5, 1, 8, 1)),
             TA.PixelMatrixSeg(TS.FCNet(5, 1, 8, 1, device=CPU)), (x,))):
        jp = jax.device_get(jm.init(jax.random.PRNGKey(1)))
        ref = jm.apply(jp, *map(jnp.asarray, args))
        got = tm.apply(params_from_jax(jp, device=CPU),
                       *map(torch.tensor, args))
        _close(got, ref, 1e-5)
        assert jax.tree_util.tree_structure(params_to_numpy(
            tm.init(torch.Generator().manual_seed(0)))) == \
            jax.tree_util.tree_structure(jp)
    assert TS.concat_input("rgbxy", torch.tensor(img),
                           torch.tensor(grid)).shape == (10, 5)
    with pytest.raises(ValueError):
        TS.concat_input("bogus", torch.tensor(img), torch.tensor(grid))


def test_forward_and_norm_adapters_match_jax():
    x = _rand((12, 2), 17, -1, 2)
    fwd = TA.ForwardModule(device=CPU)
    assert fwd.init() == {} and torch.equal(fwd.apply({}, torch.tensor(x)),
                                            torch.tensor(x))
    pts = _rand((30, 2), 18, 0, 5)
    jn = JT.MinMax.fit(jnp.asarray(pts), dim=0)
    tn = TTr.MinMax.fit(torch.tensor(pts), dim=0)
    jm = JA.NormNet(net=JA.DenseNet(2, 2, 8, 2), norm=jn)
    tm = TA.NormNet(TA.DenseNet(2, 2, 8, 2, device=CPU), norm=tn)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(2)))
    _close(tm.apply(params_from_jax(jp, device=CPU), torch.tensor(x)),
           jm.apply(jp, jnp.asarray(x)), 1e-5)


def test_cnnnet_matches_jax():
    jm = JS.CNNNet(5, 1, 3, width=8, depth=1)
    tm = TS.CNNNet(5, 1, 3, width=8, depth=1, device=CPU)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    img, grid = _rand((2, 10, 9, 3), 19), _rand((2, 10, 9, 2), 20)
    _close(tm.apply(params_from_jax(jp, device=CPU), torch.tensor(img),
                    torch.tensor(grid)),
           jm.apply(jp, jnp.asarray(img), jnp.asarray(grid)))


def _unet_case(h, w, compute_dtype=None):
    jm = JS.UNet(in_chn=4, out_chn=1, compute_dtype=compute_dtype)
    tm = TS.UNet(in_chn=4, out_chn=1, compute_dtype=compute_dtype,
                 device=CPU)
    jp, js = jax.device_get(jm.init(jax.random.PRNGKey(4)))
    img, ft = _rand((2, h, w, 3), 21), _rand((2, h, w, 1), 22)
    return jm, tm, jp, js, img, ft


@pytest.mark.parametrize("h,w,train", [(32, 32, True), (16, 16, False),
                                       (35, 43, True)])
def test_unet_matches_jax(h, w, train):
    """Full-width UNet (64-512 channels) at a small size: the logits and
    the new batch-norm state (with its int ``count``); 35x43 takes the
    pad-to-match path."""
    jm, tm, jp, js, img, ft = _unet_case(h, w)
    ref, ref_state = jm.apply(jp, js, jnp.asarray(img), jnp.asarray(ft),
                              train=train)
    tp = params_from_jax(jp, device=CPU)
    ts = params_from_jax(js, device=CPU)
    out, state = tm.apply(tp, ts, torch.tensor(img), torch.tensor(ft),
                          train=train)
    assert out.shape == (2, h, w, 1)
    _close(out, ref, scale_atol=1e-4)
    _tree_close(state, jax.device_get(ref_state), scale_atol=1e-4)
    tp0, ts0 = tm.init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(params_to_numpy(tp0)) == \
        jax.tree_util.tree_structure(jp)
    assert jax.tree_util.tree_structure(params_to_numpy(ts0)) == \
        jax.tree_util.tree_structure(js)


def test_unet_grads_match_jax():
    """The UNet's param grads in train mode (batch statistics) against
    ``jax.grad`` of the same loss."""
    jm, tm, jp, js, img, ft = _unet_case(32, 32)

    def jloss(p):
        out, _ = jm.apply(p, js, jnp.asarray(img), jnp.asarray(ft),
                          train=True)
        return jnp.mean(jax.nn.sigmoid(out) ** 2)

    ref = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, jp))
    ts = params_from_jax(js, device=CPU)

    def tloss(p):
        out, _ = tm.apply(p, ts, torch.tensor(img), torch.tensor(ft),
                          train=True)
        return torch.mean(torch.sigmoid(out) ** 2)

    got = torch.func.grad(tloss)(params_from_jax(jp, device=CPU))
    g = jax.tree_util.tree_leaves(params_to_numpy(got))
    r = jax.tree_util.tree_leaves(jax.device_get(ref))
    top = max(np.abs(b).max() for b in r)
    for a, b in zip(g, r):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4 * top)


def test_unet_bf16_compute_dtype_matches_jax():
    """``compute_dtype='bfloat16'``: the convs in bf16, float32 out; the
    port follows JAX's bf16 UNet more closely than JAX's float32 UNet does,
    and its grads come back float32."""
    jm, tm, jp, js, img, ft = _unet_case(16, 16, "bfloat16")
    args = (jnp.asarray(img), jnp.asarray(ft))
    ref, _ = jm.apply(jp, js, *args, train=False)
    ref_f32, _ = JS.UNet(in_chn=4, out_chn=1).apply(jp, js, *args,
                                                    train=False)
    tp = params_from_jax(jp, device=CPU)
    ts = params_from_jax(js, device=CPU)
    out, _ = tm.apply(tp, ts, torch.tensor(img), torch.tensor(ft),
                      train=False)
    assert out.dtype == torch.float32
    gap = np.linalg.norm(np.asarray(ref) - np.asarray(ref_f32))
    err = np.linalg.norm(out.numpy() - np.asarray(ref))
    assert 0.0 < err < gap

    def tloss(p):
        o, _ = tm.apply(p, ts, torch.tensor(img), torch.tensor(ft),
                        train=True)
        return torch.mean(o ** 2)

    for leaf in jax.tree_util.tree_leaves(
            params_to_numpy(torch.func.grad(tloss)(tp))):
        assert leaf.dtype == np.float32 and np.isfinite(leaf).all()
