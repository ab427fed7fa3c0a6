"""Port parity: the other shape priors and flows of awesome_tpu_torch
(``nn/linear.py:WNLinear``, ``nn/flows.py``'s DiffeomorphismNet and
NormalizingFlow1D, ``nn/convex_modules.py``, ``nn/priors_extra.py``,
``nn/convex_diffeo.py``, ``nn/flows_extra.py``, ``fit/optim.py:StepLR``)
against the JAX package on the same numpy-seeded inputs, params bridged
with ``bridge.params_from_jax``, at widths 8-16.

Tolerances are the JAX suite's: apply and inverse rtol 1e-5, atol 1e-6
(an inverse element past it must be within twice the JAX package's own
largest error against float64: an inverse amplifies rounding in
float32); grads rtol 5e-4, atol 1e-6
(``tests/test_pallas_flagship.py:81,87``); a fit's loss history rtol
2e-4 (``tests/test_fused_fit.py:37``). The initialisers agree in
distribution only (JAX's PRNG cannot be reproduced), so the mirrors of
``tests/test_convex_modules.py``, ``tests/test_flows_extra.py`` and
``tests/test_multi_prior.py`` draw the port's own inits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.fit import optim as JO
from awesome_tpu.fit import prior_fit as JF
from awesome_tpu.nn import convex_diffeo as JCD
from awesome_tpu.nn import convex_modules as JCM
from awesome_tpu.nn import flows as JFl
from awesome_tpu.nn import flows_extra as JFX
from awesome_tpu.nn import icnn as JI
from awesome_tpu.nn import linear as JL
from awesome_tpu.nn import priors_extra as JP
from awesome_tpu.ops import pallas_mlp as JM
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.fit import optim as TO
from awesome_tpu_torch.fit import prior_fit as TF
from awesome_tpu_torch.nn import convex_diffeo as TCD
from awesome_tpu_torch.nn import convex_modules as TCM
from awesome_tpu_torch.nn import flows as TFl
from awesome_tpu_torch.nn import flows_extra as TFX
from awesome_tpu_torch.nn import icnn as TI
from awesome_tpu_torch.nn import linear as TL
from awesome_tpu_torch.nn import priors_extra as TP
from awesome_tpu_torch.ops import mlp as TM
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
APPLY_RTOL, APPLY_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
HIST_RTOL = 2e-4


def _icnn(width=8, c=2, fused=False):
    j = JI.ConvexNextNet(n_hidden=width, n_hidden_layers=1, in_features=c)
    t = TI.ConvexNextNet(n_hidden=width, n_hidden_layers=1, in_features=c,
                         device=CPU)
    if fused:
        return JM.FullyFusedConvexNextNet(j), TM.FullyFusedConvexNextNet(t)
    return j, t


def _convex_diffeo(fused=False):
    jc, tc = _icnn(fused=fused)
    return (JCD.ConvexDiffeomorphismNet(
                flow=JFl.NormalizingFlow1D(num_coupling=2, width=8),
                convex=jc),
            TCD.ConvexDiffeomorphismNet(
                flow=TFl.NormalizingFlow1D(num_coupling=2, width=8,
                                           device=CPU),
                convex=tc, device=CPU))


# name -> (JAX module, port module, input channels)
MODELS = {
    "wn_linear": lambda: (JL.WNLinear(3, 5), TL.WNLinear(3, 5, device=CPU),
                          3),
    "diffeomorphism": lambda: (JFl.DiffeomorphismNet(hidden=8),
                               TFl.DiffeomorphismNet(hidden=8, device=CPU),
                               2),
    "nf1d": lambda: (JFl.NormalizingFlow1D(4, 8),
                     TFl.NormalizingFlow1D(4, 8, device=CPU), 2),
    "nf1d_normal_block": lambda: (
        JFl.NormalizingFlow1D(2, 8, backbone="normal_block"),
        TFl.NormalizingFlow1D(2, 8, backbone="normal_block", device=CPU), 2),
    "nf1d_3d": lambda: (JFl.NormalizingFlow1D(3, 8, in_features=3),
                        TFl.NormalizingFlow1D(3, 8, in_features=3,
                                              device=CPU), 3),
    "glow": lambda: (JFX.GlowFlow(2, 8, 3), TFX.GlowFlow(2, 8, 3, device=CPU),
                     2),
    "spline": lambda: (JFX.SplineFlow(2, 8, 3, num_bins=6),
                       TFX.SplineFlow(2, 8, 3, num_bins=6, device=CPU), 2),
    "star": lambda: (JP.StarShapedNet(12), TP.StarShapedNet(12, device=CPU),
                     2),
    "star_train_offset": lambda: (
        JP.StarShapedNet(12, train_offset=True),
        TP.StarShapedNet(12, train_offset=True, device=CPU), 2),
    "rotation_symmetric": lambda: (JP.RotationSymmetricNet(12),
                                   TP.RotationSymmetricNet(12, device=CPU),
                                   2),
    "rotation_no_fold": lambda: (
        JP.RotationSymmetricNet(12, symmetry_prior=False),
        TP.RotationSymmetricNet(12, symmetry_prior=False, device=CPU), 2),
    "periodic": lambda: (JP.PeriodicNet(12), TP.PeriodicNet(12, device=CPU),
                         2),
    "periodic_no_premap": lambda: (
        JP.PeriodicNet(12, use_premap=False),
        TP.PeriodicNet(12, use_premap=False, device=CPU), 2),
    "convex_diffeo": lambda: _convex_diffeo() + (2,),
    "convex_diffeo_fused": lambda: _convex_diffeo(fused=True) + (2,),
    "convex_diffeo_3d": lambda: (
        JCD.ConvexDiffeomorphismNet.create(in_features=3, n_hidden=8,
                                           nf_layers=4, nf_hidden=8),
        TCD.ConvexDiffeomorphismNet.create(in_features=3, n_hidden=8,
                                           nf_layers=4, nf_hidden=8,
                                           device=CPU), 3),
    "convex_mlp": lambda: (JCM.ConvexMLP(2, 8, 3),
                           TCM.ConvexMLP(2, 8, 3, device=CPU), 2),
    "convex_linear_clipped": lambda: (
        JCM.ConvexLinear(3, 4, "clipped"),
        TCM.ConvexLinear(3, 4, "clipped", device=CPU), 3),
    "convex_linear_negexp": lambda: (
        JCM.ConvexLinear(3, 4, "negexp", bias=False),
        TCM.ConvexLinear(3, 4, "negexp", bias=False, device=CPU), 3),
    "convex_layer_norm": lambda: (JCM.ConvexLayerNorm(6),
                                  TCM.ConvexLayerNorm(6, device=CPU), 6),
    "linear_skip": lambda: (
        JCM.LinearSkip(3, 4, main=JCM.ConvexLinear(3, 4)),
        TCM.LinearSkip(3, 4, main=TCM.ConvexLinear(3, 4, device=CPU),
                       device=CPU), 3),
}
INVERTIBLE = ("diffeomorphism", "nf1d", "nf1d_normal_block", "nf1d_3d",
              "glow", "spline", "convex_diffeo", "convex_diffeo_fused",
              "convex_diffeo_3d")


def _strip_mask(tree):
    if isinstance(tree, dict):
        return {k: _strip_mask(v) for k, v in tree.items() if k != "mask"}
    if isinstance(tree, (list, tuple)):
        return [_strip_mask(v) for v in tree]
    return tree


def _perturbed(jm, seed, scale=0.3):
    """JAX init moved off its zero-initialized layers (so every coupling
    and spline does work), the coupling masks untouched."""
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        a = np.asarray(node, np.float32)
        if key == "mask":
            return a
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(params)


def _assert_tree_close(t_tree, j_tree, rtol, atol):
    got = jax.tree_util.tree_leaves(params_to_numpy(t_tree))
    ref = jax.tree_util.tree_leaves(_strip_mask(jax.device_get(j_tree)))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _setup(name, seed=0, n=32):
    jm, tm, c = MODELS[name]()
    jp = _perturbed(jm, seed)
    rng = np.random.default_rng(seed + 100)
    x = rng.uniform(-1, 1, (n, c)).astype(np.float32)
    return jm, tm, jp, params_from_jax(jp, CPU), x


@pytest.mark.parametrize("name", sorted(MODELS))
def test_apply_and_grads_match_jax(name):
    jm, tm, jp, tp, x = _setup(name)
    got = tm.apply(tp, torch.tensor(x))
    r = np.random.default_rng(1).standard_normal(got.shape).astype(
        np.float32)

    def loss(p):  # one JAX program for the output and the grads
        out = jm.apply(p, jnp.asarray(x))
        return jnp.sum(out * r), out

    (_, ref), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=APPLY_RTOL, atol=APPLY_ATOL)
    tg = torch.func.grad(
        lambda p: torch.sum(tm.apply(p, torch.tensor(x)) * torch.tensor(r)))(
            tp)
    _assert_tree_close(tg, jg, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("name", INVERTIBLE)
def test_inverse_matches_jax(name):
    jm, tm, jp, tp, x = _setup(name, seed=3)
    # the convex-diffeomorphism prior inverts its deformation
    jf = jm.deformation if hasattr(jm, "deformation") else jm.apply
    tf = tm.deformation if hasattr(tm, "deformation") else tm.apply
    y = np.asarray(jax.jit(jf)(jp, jnp.asarray(x)))
    ref = np.asarray(jax.jit(jm.inverse)(jp, jnp.asarray(y)))
    got = tm.inverse(tp, torch.tensor(y)).numpy()
    # an inverse amplifies float32 rounding (the spline's inverse is a
    # quadratic's root through knots that each package sums in its own
    # order; the flows invert exp scales and a 3x3 linear map): an element
    # past the tolerance must be within twice the JAX package's own
    # largest error against a float64 run of the same function
    f64 = tm.double().inverse(jax.tree_util.tree_map(
        lambda t: t.double(), tp), torch.tensor(y).double()).numpy()
    tm.float()
    off = np.abs(got - ref) > APPLY_ATOL + APPLY_RTOL * np.abs(ref)
    bound = 2 * np.abs(ref - f64).max()
    assert np.all(np.abs(got - f64)[off] <= bound), (
        name, bound, got[off], ref[off], f64[off])
    np.testing.assert_allclose(tm.inverse(tp, tf(tp, torch.tensor(x))),
                               x, atol=1e-4)


def test_spline_at_knots_and_outside_the_bound():
    """Points on the spline's knots (each package's own knots, from the
    same bias-only spline parameters) and at or beyond +-bound."""
    jm, tm = JFX.SplineFlow(2, 8, 2, num_bins=6), \
        TFX.SplineFlow(2, 8, 2, num_bins=6, device=CPU)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for step in jp["steps"]:  # output weights stay 0: knots per point equal
        b = step["st"]["l2"]["b"]
        step["st"]["l2"]["b"] = (b + rng.standard_normal(b.shape)).astype(
            np.float32)
    tp = params_from_jax(jp, CPU)
    k, bound = 6, jm.bound
    knots = []
    for step in jp["steps"]:
        raw = np.asarray(step["st"]["l2"]["b"]).reshape(2, 3 * k + 1)
        cw = jnp.cumsum(jax.nn.softmax(jnp.asarray(raw[:, :k]), -1), -1)
        knots.append(np.asarray(-bound + 2 * bound * cw))  # (2, K)
    knots = np.concatenate([np.stack(knots).transpose(0, 2, 1)
                            .reshape(-1, 2),
                            [[bound, -bound], [-3.5, 4.0], [5.0, -0.0],
                             [0.0, 3.0]]]).astype(np.float32)
    for inverse in (False, True):
        f_j = jm.inverse if inverse else jm.apply
        f_t = tm.inverse if inverse else tm.apply
        ref = np.asarray(f_j(jp, jnp.asarray(knots)))
        got = f_t(tp, torch.tensor(knots)).numpy()
        np.testing.assert_allclose(got, ref, rtol=APPLY_RTOL,
                                   atol=APPLY_ATOL)
    outside = np.abs(knots) >= bound
    n = knots.shape[0]
    np.testing.assert_array_equal(
        TFX._rqs(torch.tensor(knots), *(torch.full((n, 2, 4), 0.25),) * 2,
                 torch.full((n, 2, 5), 1.3), bound, False).numpy()[outside],
        knots[outside])


def test_rqs_counts_knots_at_or_below():
    """On exact knots the bin is the count of knots <= x, less one: the
    spline's value there is the knot's height from either side."""
    xk = np.asarray([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32)
    widths = np.full((5, 4), 0.25, np.float32)
    heights = np.tile(np.asarray([0.1, 0.2, 0.3, 0.4], np.float32), (5, 1))
    derivs = np.tile(np.asarray([1.0, 0.5, 2.0, 1.5, 1.0], np.float32),
                     (5, 1))
    x = xk[:, None].repeat(1, 1)[:, 0]
    ref = np.asarray(JFX._rqs(jnp.asarray(x), jnp.asarray(widths),
                              jnp.asarray(heights), jnp.asarray(derivs), 2.0,
                              False))
    got = TFX._rqs(torch.tensor(x), torch.tensor(widths),
                   torch.tensor(heights), torch.tensor(derivs), 2.0,
                   False).numpy()
    np.testing.assert_allclose(got, ref, rtol=APPLY_RTOL, atol=APPLY_ATOL)
    yk = -2.0 + 4.0 * np.concatenate([[0.0], np.cumsum(heights[0])])
    np.testing.assert_allclose(got[1:4], yk[1:4], atol=1e-6)


def test_capped_exp_and_step_lr():
    x = np.asarray([-3.0, 0.0, 4.9, 5.0, 7.5, 40.0], np.float32)
    np.testing.assert_allclose(TFl.capped_exp(torch.tensor(x)).numpy(),
                               np.asarray(JFl.capped_exp(jnp.asarray(x))),
                               rtol=APPLY_RTOL)
    j, t = JO.StepLR(step_size=3, gamma=0.5), TO.StepLR(step_size=3,
                                                        gamma=0.5)
    for e in (0, 2, 3, 7, 12):
        assert float(t.scale(e)) == float(j.scale(e))
    epochs = torch.arange(10)
    np.testing.assert_array_equal(
        t.scale(epochs).numpy(), np.asarray(j.scale(jnp.arange(10))))


def test_offsets_detached():
    """The star and periodic offsets take no gradient (star: unless
    ``train_offset``); the symmetry prior trains its offset."""
    for name, trained in (("star", False), ("star_train_offset", True),
                          ("periodic", False), ("rotation_symmetric", True)):
        _, tm, _, tp, x = _setup(name)
        g = torch.func.grad(
            lambda p: torch.sum(tm.apply(p, torch.tensor(x)) ** 2))(tp)
        assert bool(torch.any(g["offset"] != 0)) == trained, name


def test_star_enforce_convexity_and_param_groups():
    _, tm, _, tp, _ = _setup("star")
    clipped = tm.enforce_convexity(tp)
    assert float(clipped["W2_r"]["w"].min()) >= 0.0
    assert torch.equal(clipped["W1"]["w"], tp["W1"]["w"])
    jm, tm, jp, tp, _ = _setup("convex_diffeo_fused")
    assert jax.tree_util.tree_leaves(jm.param_groups(jp)) == \
        jax.tree_util.tree_leaves(tm.param_groups(tp))
    _assert_tree_close(tm.enforce_convexity(tp), jm.enforce_convexity(jp),
                       0.0, 0.0)


def test_convex_diffeo_translate_matches_jax():
    jm, tm, jp, tp, x = _setup("convex_diffeo", seed=2)
    shift = np.asarray([0.3, -0.1], np.float32)
    src = x[:8]
    j_new = jm.translate(jp, jnp.asarray(src), jnp.asarray(src + shift))
    t_new = tm.translate(tp, torch.tensor(src), torch.tensor(src + shift))
    _assert_tree_close(t_new, j_new, 1e-4, 1e-5)
    np.testing.assert_allclose(
        tm.apply(t_new, torch.tensor(x + shift)).numpy(),
        tm.apply(tp, torch.tensor(x)).numpy(), atol=1e-4)
    j_pt = jm.translate_only_point(jp, jnp.asarray(src[0]),
                                   jnp.asarray(src[0] + shift))
    t_pt = tm.translate_only_point(tp, torch.tensor(src[0]),
                                   torch.tensor(src[0] + shift))
    _assert_tree_close(t_pt, j_pt, 1e-4, 1e-5)
    with pytest.raises(ValueError, match="same shape"):
        tm.translate(tp, torch.tensor(src), torch.tensor(src[:4]))


# --- mirrors of the JAX package's own tests ------------------------------


def test_positivity_transforms():
    w = torch.tensor([-1.0, 0.0, 2.0])
    assert TCM.no_positivity(w).tolist() == [-1, 0, 2]
    assert TCM.clipped_positivity(w).tolist() == [0, 0, 2]
    np.testing.assert_allclose(TCM.negexp_positivity(w).numpy(),
                               [np.exp(-1), 0, 2], rtol=1e-6)
    assert bool((TCM.exponential_positivity(w) > 0).all())
    np.testing.assert_allclose(
        TCM.exponential_inverse(TCM.exponential_positivity(w)).numpy(),
        w.numpy(), atol=1e-6)


def test_convex_initialisers_match_in_distribution():
    init = TCM.ConvexInitialiser()
    params = init.init(0, 400, 300, positivity="exp", device=CPU)
    assert params["w"].shape == (300, 400)
    w = torch.exp(params["w"]).numpy()
    (mean_sq, w_var), (b_mean, _) = init.compute_parameters(400)
    assert (mean_sq, w_var, b_mean) == tuple(
        v for pair in JCM.ConvexInitialiser().compute_parameters(400)
        for v in pair)[:3]
    np.testing.assert_allclose(w.mean(), np.sqrt(mean_sq), rtol=0.05)
    assert 0.1 * w_var < w.var() < 10 * w_var
    np.testing.assert_allclose(params["b"].numpy().mean(), b_mean,
                               rtol=0.05)
    trad = TCM.TraditionalInitialiser(gain=2.0).init(0, 100, 50, device=CPU)
    np.testing.assert_allclose(trad["w"].numpy().var(), 2.0 / 100, rtol=0.2)
    assert float(trad["b"].abs().max()) == 0.0


def test_convex_linear_and_layer_norm():
    layer = TCM.ConvexLinear(4, 3, positivity="exp", device=CPU)
    params = layer.init(0)
    x = torch.randn((10, 4), generator=torch.Generator().manual_seed(1))
    assert layer.apply(params, x).shape == (10, 3)
    assert bool((torch.exp(params["w"]) > 0).all())
    ln = TCM.ConvexLayerNorm(8, device=CPU)
    y = ln.apply(ln.init(), 3 * torch.randn((16, 8)) + 1)
    np.testing.assert_allclose(y.mean(-1).numpy(), 0, atol=1e-5)


def test_convex_conv2d_matches_jax():
    jm, tm = JCM.ConvexConv2d(3, 4), TCM.ConvexConv2d(3, 4, device=CPU)
    jp = _perturbed(jm, 4, scale=0.1)
    x = np.random.default_rng(4).standard_normal((2, 6, 5, 3)).astype(
        np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm.apply(params_from_jax(jp, CPU), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=APPLY_RTOL,
                               atol=APPLY_ATOL * np.abs(ref).max())
    tp = tm.init(0)
    assert tp["w"].shape == (4, 3, 3, 3)
    assert float(tp["w"].max()) < 0.0  # log of the raw init's magnitude


def test_convex_mlp_is_convex():
    model = TCM.ConvexMLP(in_features=2, hidden=32, depth=2, device=CPU)
    params = model.init(0)
    gen = torch.Generator().manual_seed(1)
    a = torch.rand((256, 2), generator=gen) * 3 - 1
    b = torch.rand((256, 2), generator=gen) * 3 - 1

    def violation(p):
        fa, fb = model.apply(p, a), model.apply(p, b)
        return float((model.apply(p, 0.5 * (a + b)) - 0.5 * (fa + fb)).max())

    assert violation(params) <= 5e-3
    g = torch.func.grad(lambda p: torch.sum(model.apply(p, a) ** 2))(params)
    stepped = jax.tree_util.tree_map(lambda p, gr: p - 0.1 * gr, params, g)
    assert violation(stepped) <= 5e-3
    assert model.enforce_convexity(params) is params


@pytest.mark.parametrize("flow", [
    TFX.GlowFlow(channels=2, hidden_channels=16, n_flows=3, device=CPU),
    TFX.SplineFlow(channels=2, hidden_units=16, n_flows=3, num_bins=6,
                   device=CPU)], ids=["glow", "spline"])
def test_extra_flows_invertible(flow):
    params = flow.init(0)
    x = torch.rand((128, 2), generator=torch.Generator().manual_seed(1)) \
        * 2 - 1
    np.testing.assert_allclose(flow.inverse(params, flow.apply(params, x)),
                               x, atol=2e-4)
    assert "mask" not in params["steps"][0]
    assert flow.masks.shape == (3, 2)


def test_spline_identity_at_init():
    flow = TFX.SplineFlow(channels=2, hidden_units=16, n_flows=2, num_bins=6,
                          device=CPU)
    x = torch.rand((64, 2), generator=torch.Generator().manual_seed(1)) \
        * 4 - 2
    np.testing.assert_allclose(flow.apply(flow.init(0), x), x, atol=1e-2)


def test_glow_stays_invertible_under_training():
    """Invertibility survives gradient steps; ``P`` is trained as in the
    JAX package, the masks stay buffers."""
    flow = TFX.GlowFlow(channels=2, hidden_channels=8, n_flows=2,
                        device=CPU)
    params = flow.init(0)
    x = torch.rand((64, 2), generator=torch.Generator().manual_seed(1))
    target = x.flip(1)
    grad = torch.func.grad(
        lambda p: torch.mean((flow.apply(p, x) - target) ** 2))
    p0 = params["steps"][0]["P"].clone()
    for _ in range(10):
        params = jax.tree_util.tree_map(lambda p, g: p - 0.05 * g, params,
                                        grad(params))
    assert not torch.equal(params["steps"][0]["P"], p0)
    np.testing.assert_allclose(flow.inverse(params, flow.apply(params, x)),
                               x, atol=1e-3)


def test_convex_diffeo_translate_and_round_trip():
    model = TCD.ConvexDiffeomorphismNet(
        flow=TFl.NormalizingFlow1D(num_coupling=2, width=8, device=CPU),
        convex=TI.ConvexNextNet(n_hidden=8, n_hidden_layers=1, device=CPU),
        device=CPU)
    params = model.init(0)
    x = torch.rand((64, 2), generator=torch.Generator().manual_seed(1))
    assert model.apply(params, x).shape == (64, 1)
    shift = torch.tensor([0.3, -0.1])
    new = model.translate(params, x[:8], x[:8] + shift)
    np.testing.assert_allclose(model.apply(new, x + shift),
                               model.apply(params, x), atol=1e-4)
    np.testing.assert_allclose(
        model.inverse(params, model.deformation(params, x)), x, atol=1e-4)
    created = TCD.ConvexDiffeomorphismNet.create(in_features=3, nf_layers=4,
                                                 device=CPU)
    assert created.flow.num_coupling == 6 and created.flow.width == 70
    with pytest.raises(ValueError, match="in_features"):
        TCD.ConvexDiffeomorphismNet(in_features=3, device=CPU).init(0)


@pytest.mark.parametrize("cls", [TP.StarShapedNet, TP.RotationSymmetricNet,
                                 TP.PeriodicNet])
def test_extra_priors_forward(cls):
    model = cls(n_hidden=16, device=CPU)
    x = torch.rand((32, 2), generator=torch.Generator().manual_seed(1)) \
        * 2 - 1
    out = model.apply(model.init(0), x)
    assert out.shape == (32, 1) and bool(torch.isfinite(out).all())


def test_star_shaped_is_star_shaped():
    """Along any ray from the center the inside set (f < 0) is a prefix."""
    model = TP.StarShapedNet(n_hidden=16, device=CPU)
    params = model.init(0)
    rs = np.linspace(0.01, 2.0, 64)
    for a in np.linspace(0, 2 * np.pi, 16, endpoint=False):
        pts = torch.tensor(np.stack([rs * np.cos(a), rs * np.sin(a)], -1),
                           dtype=torch.float32)
        inside = (model.apply(params, pts)[:, 0] < 0).numpy()
        if inside.any():
            assert inside[: np.max(np.nonzero(inside)[0]) + 1].all()


# --- fits ---------------------------------------------------------------

FITS = ("star", "rotation_symmetric", "periodic_no_premap",
        "convex_diffeo_fused", "convex_mlp")


@pytest.mark.parametrize("name", FITS)
def test_fit_matches_jax(name):
    """20 steps of the fit engine (Adamax, the flow weight-decay group,
    the projection after the step) on a 16x16 grid with a disk target.
    The grid is of pixel centres, centred on 0: a point exactly at the
    symmetry prior's offset gives its offset a NaN gradient (the radius's
    square root), and the NaN guard then rejects every step, in both
    packages alike."""
    jm, tm, _ = MODELS[name]()
    jp = jax.device_get(jm.init(jax.random.PRNGKey(7)))
    h = w = 16
    yy, xx = np.mgrid[0:h, 0:w]
    pts = np.stack([(xx + 0.5) / w - 0.5, (yy + 0.5) / h - 0.5],
                   -1).reshape(-1, 2).astype(np.float32)
    tgt = (((yy - 7) ** 2 + (xx - 8) ** 2) > 25).astype(np.float32)
    tgt = tgt.reshape(-1, 1)
    kw = dict(num_steps=20, lr=1e-2)
    ref, ref_aux = JF.fit_prior(jm, jp, jnp.asarray(pts), jnp.asarray(tgt),
                                JF.FitConfig(**kw))
    got, aux = TF.fit_prior(tm, params_from_jax(jp, CPU), torch.tensor(pts),
                            torch.tensor(tgt), TF.FitConfig(**kw))
    hist = aux["loss_hist"].numpy()
    np.testing.assert_allclose(hist, np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    assert hist[-1] < hist[0]
