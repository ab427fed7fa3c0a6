"""Port parity: WrapperModule of awesome_tpu_torch (segmentation net plus
prior) against the JAX package's, on the same weights and inputs: pixel
and image input modes, every prior_arg_mode, GradientMode (which grads
flow), PriorMode extract/apply, a stateful (batch-norm) segmentation net,
and the output processing. Outputs at rtol 1e-5 (atol 1e-6), grads at
rtol 1e-4 (atol 1e-6 of the largest)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.nn import icnn as JI
from awesome_tpu.nn import seg as JS
from awesome_tpu.nn import wrapper as JW
from awesome_tpu.nn.path_connected import (
    real_nvp_path_connected_net as j_factory,
)
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.nn import icnn as TI
from awesome_tpu_torch.nn import seg as TS
from awesome_tpu_torch.nn import wrapper as TW
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)

CPU = "cpu"


def _pixel_pair(**kw):
    j = JW.WrapperModule(segmentation_module=JS.Net(n_hidden=8),
                         prior_module=JI.ConvexNextNet(n_hidden=8,
                                                       n_hidden_layers=1),
                         input_mode="pixel", **kw)
    t = TW.WrapperModule(
        segmentation_module=TS.Net(n_hidden=8, device=CPU),
        prior_module=TI.ConvexNextNet(n_hidden=8, n_hidden_layers=1,
                                      device=CPU),
        input_mode="pixel", **kw)
    return j, t


def _px(n=32, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, 5)).astype(
        np.float32)


def _close(got, ref, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("kw", [
    {}, {"prior_arg_mode": "param_grid"},
    {"prior_arg_mode": "param_clean_grid"},
    {"use_segmentation_output_inversion": True, "use_prior_sigmoid": False},
    {"use_segmentation_sigmoid": False}])
def test_pixel_mode_matches_jax(kw):
    jw, tw = _pixel_pair(**kw)
    jp = jax.device_get(jw.init(jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, device=CPU)
    px = _px()
    grid = px[:, :2] + 0.3
    clean = px[:, :2]
    ref = jw.apply(jp, jnp.asarray(px), grid=jnp.asarray(grid),
                   clean_grid=jnp.asarray(clean))
    got = tw.apply(tp, torch.tensor(px), grid=torch.tensor(grid),
                   clean_grid=torch.tensor(clean))
    assert got.shape == (32, 2)
    _close(got, ref)
    seg, prior = tw.split_output(got)
    _close(seg, jw.split_output(ref)[0])
    _close(prior, jw.split_output(ref)[1])
    _close(tw.apply(tp, torch.tensor(px), evaluate_prior=False),
           jw.apply(jp, jnp.asarray(px), evaluate_prior=False))


@pytest.mark.parametrize("mode", ["none", "segmentation", "prior", "both"])
def test_gradient_modes_match_jax(mode):
    """Which parts receive gradients: the grads of a loss on the combined
    output, leaf by leaf, against ``jax.grad`` (the gated part's grads are
    exactly zero in both)."""
    jw, tw = _pixel_pair(gradient_mode=mode)
    jp = jax.device_get(jw.init(jax.random.PRNGKey(2)))
    px = _px(seed=3)

    def jloss(p):
        return jnp.sum(jw.apply(p, jnp.asarray(px)) ** 2)

    def tloss(p):
        return torch.sum(tw.apply(p, torch.tensor(px)) ** 2)

    ref = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, jp))
    got = torch.func.grad(tloss)(params_from_jax(jp, device=CPU))
    g = jax.tree_util.tree_leaves(params_to_numpy(got))
    r = jax.tree_util.tree_leaves(jax.device_get(ref))
    top = max(np.abs(b).max() for b in r)
    for a, b in zip(g, r):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * top)
        if not np.any(b):
            assert not np.any(a)
    seg_zero = not any(np.any(x) for x in
                       jax.tree_util.tree_leaves(params_to_numpy(got["seg"])))
    assert seg_zero == (mode in ("none", "prior"))


@pytest.mark.parametrize("mode", ["partial", "full", "none"])
def test_prior_modes_extract_apply(mode):
    jw, tw = _pixel_pair(prior_mode=mode)
    jp = jax.device_get(jw.init(jax.random.PRNGKey(4)))
    tp = params_from_jax(jp, device=CPU)
    jx, tx = jw.extract_prior(jp), tw.extract_prior(tp)
    assert (jx is None) == (tx is None)
    if tx is not None:
        for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(tx)),
                        jax.tree_util.tree_leaves(jx)):
            np.testing.assert_array_equal(a, b)
    assert tw.apply_prior(tp, None) is tp
    back = tw.apply_prior(tp, tx)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(back)),
                    jax.tree_util.tree_leaves(jw.apply_prior(jp, jx))):
        np.testing.assert_array_equal(a, b)
    shifted = dict(tp, prior=dict(tp["prior"], out=dict(
        tp["prior"]["out"], ln=dict(tp["prior"]["out"]["ln"],
                                    w=tp["prior"]["out"]["ln"]["w"] - 1.0))))
    clipped = tw.enforce_convexity(shifted)
    assert float(clipped["prior"]["out"]["ln"]["w"].min()) >= 0.0


def test_image_mode_stateful_unet_with_flagship_prior_matches_jax():
    """The flagship wrapper's shape: a stateful UNet and the path-connected
    prior on the clean grid, image mode, in train and eval mode; the new
    batch-norm state too."""
    h = w = 16
    prior_kw = dict(channels=2, hidden_units=8, flow_n_flows=2,
                    flow_output_fn="tanh", spatial_shape=(h, w),
                    convex_net_hidden_units=8, convex_net_hidden_layers=1)
    kw = dict(input_mode="image", prior_arg_mode="param_clean_grid",
              seg_stateful=True)
    jw = JW.WrapperModule(segmentation_module=JS.UNet(in_chn=4, out_chn=1),
                          prior_module=j_factory(**prior_kw), **kw)
    tw = TW.WrapperModule(
        segmentation_module=TS.UNet(in_chn=4, out_chn=1, device=CPU),
        prior_module=t_factory(device=CPU, **prior_kw), **kw)
    jp, js = jax.device_get(jw.init(jax.random.PRNGKey(5)))
    tp, ts = params_from_jax(jp, device=CPU), params_from_jax(js,
                                                              device=CPU)
    rng = np.random.default_rng(6)
    img = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    ft = rng.uniform(size=(1, h, w, 1)).astype(np.float32)
    grid = np.asarray(JG.flatten_grid(JG.pixel_grid((h, w))))
    ref, ref_state = jw.apply(jp, jnp.asarray(img), features=jnp.asarray(ft),
                              grid=jnp.asarray(grid), seg_state=js,
                              train=False)
    got, state = tw.apply(tp, torch.tensor(img), features=torch.tensor(ft),
                          grid=torch.tensor(grid), seg_state=ts, train=False)
    assert got.shape == (1, h, w, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(state)),
                    jax.tree_util.tree_leaves(js)):
        assert a.shape == np.shape(b) and a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)  # eval mode keeps the state
    seg_only, _ = tw.apply(tp, torch.tensor(img), features=torch.tensor(ft),
                           seg_state=ts, evaluate_prior=False)
    assert seg_only.shape == (1, h, w, 1)
    _, new_state = tw.apply(tp, torch.tensor(img), features=torch.tensor(ft),
                            grid=torch.tensor(grid), seg_state=ts,
                            train=True)
    assert int(new_state["inc"]["bn1"]["count"]) == 1
    with pytest.raises(ValueError):
        tw.get_prior_input(None)


def test_enums_match_jax():
    for je, te in ((JW.PriorMode, TW.PriorMode),
                   (JW.InputMode, TW.InputMode),
                   (JW.EvaluationMode, TW.EvaluationMode),
                   (JW.GradientMode, TW.GradientMode)):
        assert [m.value for m in je] == [m.value for m in te]
