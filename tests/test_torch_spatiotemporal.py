"""Port parity: the spatio-temporal prior fit (``fit/spatiotemporal.py``),
``sequence_points``/``positional_grid``, and the extra and instance losses
(``measures/losses_extra.py``, ``measures/instance_losses.py``) of
awesome_tpu_torch against the JAX package on the same numpy inputs.

Tolerances: the fit's epoch-loss history at rtol 2e-4 and its params at
rtol 2e-3, atol 2e-6 (``tests/test_fused_fit.py``'s fit tolerances); the
grids bitwise; the losses at rtol 1e-5 (grads rtol 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.fit import spatiotemporal as JST
from awesome_tpu.fit.prior_fit import FitConfig as JFitConfig
from awesome_tpu.measures import instance_losses as JIL
from awesome_tpu.measures import losses as JL
from awesome_tpu.measures import losses_extra as JLX
from awesome_tpu.nn.path_connected import (
    real_nvp_path_connected_net as j_factory,
)
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import grids as TG
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.fit import spatiotemporal as TST
from awesome_tpu_torch.fit.prior_fit import FitConfig as TFitConfig
from awesome_tpu_torch.measures import instance_losses as TIL
from awesome_tpu_torch.measures import losses as TL
from awesome_tpu_torch.measures import losses_extra as TLX
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
HIST_RTOL, P_RTOL, P_ATOL = 2e-4, 2e-3, 2e-6


@pytest.mark.parametrize("w,h,t", [(7, 5, None), (8, 8, 2.0), (640, 480, 1.0),
                                   (1, 3, 0.0)])
def test_positional_grid_and_sequence_points_equal(w, h, t):
    t_max = None if t is None else 3.0
    np.testing.assert_array_equal(
        TG.positional_grid(w, h, t, t_max, device=CPU).numpy(),
        np.asarray(JG.positional_grid(w, h, t, t_max)))
    with pytest.raises(ValueError):
        TG.positional_grid(w, h, t=1.0, device=CPU)
    for frames in (1, 3):
        np.testing.assert_array_equal(
            TST.sequence_points((h, w), frames, device=CPU).numpy(),
            np.asarray(JST.sequence_points((h, w), frames)))


def _sequence(frames=3, h=8, w=8, seed=0):
    """Per-frame unaries (a disk moving right, fg 0) and sparse labels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tgt = np.stack([((yy - 3.5) ** 2 + (xx - 2.5 - f) ** 2 > 5.0)
                    for f in range(frames)]).astype(np.float32)
    labeled = rng.uniform(size=(frames, h * w)) < 0.6
    return tgt.reshape(frames, h * w, 1), labeled


@pytest.mark.parametrize("weight_mode", ["none", "equal"])
def test_spatiotemporal_fit_matches_jax(weight_mode):
    """A tiny 3-channel prior, 3 frames at 8x8, 4 epochs: the epoch-loss
    history, the plateau scale and the fitted params."""
    kw = dict(channels=3, hidden_units=8, flow_n_flows=2,
              flow_output_fn="tanh", spatial_shape=(8, 8),
              convex_net_hidden_units=8, convex_net_hidden_layers=1)
    jm, tm = j_factory(**kw), t_factory(device=CPU, **kw)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device=CPU)
    tgt, labeled = _sequence()
    pts = np.asarray(JST.sequence_points((8, 8), 3))
    cfg = dict(lr=1e-2, weight_mode=weight_mode, plateau_patience=1)
    jfit, jaux = JST.make_spatiotemporal_fit_fn(jm, JFitConfig(**cfg), 4)(
        jp, jnp.asarray(pts), jnp.asarray(tgt), jnp.asarray(labeled))
    tfit, taux = TST.fit_spatiotemporal_prior(
        tm, tp, torch.tensor(pts), torch.tensor(tgt), torch.tensor(labeled),
        TFitConfig(**cfg), num_epochs=4)
    hist = taux["epoch_loss"].numpy()
    assert hist.shape == (4,) and hist[-1] < hist[0]
    np.testing.assert_allclose(hist, np.asarray(jaux["epoch_loss"]),
                               rtol=HIST_RTOL)
    np.testing.assert_allclose(taux["lr_scale"].numpy(),
                               np.asarray(jaux["lr_scale"]))
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(tfit)),
                    jax.tree_util.tree_leaves(jax.device_get(jfit))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=P_RTOL,
                                   atol=P_ATOL)
    np.testing.assert_allclose(
        TST.make_frame_weights(torch.tensor(tgt), torch.tensor(labeled),
                               TFitConfig(weight_mode=weight_mode)).numpy(),
        np.asarray(JST.make_frame_weights(
            jnp.asarray(tgt), jnp.asarray(labeled),
            JFitConfig(weight_mode=weight_mode))),
        rtol=1e-6)
    # shared points (N, 3) and no labels: every point weighs in
    _, jaux2 = JST.make_spatiotemporal_fit_fn(jm, JFitConfig(**cfg), 2)(
        jp, jnp.asarray(pts[1]), jnp.asarray(tgt))
    _, taux2 = TST.make_spatiotemporal_fit_fn(tm, TFitConfig(**cfg), 2)(
        tp, torch.tensor(pts[1]), torch.tensor(tgt))
    np.testing.assert_allclose(taux2["epoch_loss"].numpy(),
                               np.asarray(jaux2["epoch_loss"]),
                               rtol=HIST_RTOL)


def test_spatiotemporal_nan_guard():
    """A NaN target frame skips that frame's update; the others train."""
    kw = dict(channels=3, hidden_units=8, flow_n_flows=2,
              flow_output_fn="tanh", spatial_shape=(8, 8),
              convex_net_hidden_units=8, convex_net_hidden_layers=1)
    tm = t_factory(device=CPU, **kw)
    tp = tm.init(torch.Generator().manual_seed(0))
    tgt, labeled = _sequence()
    tgt[1, 0, 0] = np.nan
    pts = TST.sequence_points((8, 8), 3, device=CPU)
    fitted, aux = TST.fit_spatiotemporal_prior(
        tm, tp, pts, torch.tensor(tgt), torch.tensor(labeled),
        TFitConfig(lr=1e-2), num_epochs=2)
    assert all(torch.isfinite(v).all() for v in TT.tree_leaves(fitted))
    assert not torch.isfinite(aux["epoch_loss"]).any()


# --- the extra and instance losses -------------------------------------------


def _u(shape, seed, lo=0.01, hi=0.99):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _close(got, ref, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=1e-7)


def _grad_close(tf, jf, *arrays):
    """The grads of ``f`` w.r.t. its first argument in both packages."""
    t_in = [torch.tensor(a) for a in arrays]
    t_in[0].requires_grad_(True)
    g, = torch.autograd.grad(tf(*t_in), t_in[0])
    ref = jax.grad(jf)(*[jnp.asarray(a) for a in arrays])
    _close(g, ref, rtol=1e-4)


@pytest.mark.parametrize("extra_penalty", [False, True])
def test_losses_extra_match_jax(extra_penalty):
    out, tgt = _u((2, 2, 5, 6), 0), (_u((2, 1, 5, 6), 1) > 0.5) * 1.0
    tgt = tgt.astype(np.float32)
    for jf, tf in (
            (lambda o, t: JLX.awesome_image_loss(
                o, t, extra_penalty=extra_penalty),
             lambda o, t: TLX.awesome_image_loss(
                 o, t, extra_penalty=extra_penalty)),
            (lambda o, t: JLX.prior_image_loss(o, t),
             lambda o, t: TLX.prior_image_loss(o, t)),
            (lambda o, t: JLX.prior_image_loss(o, t, noneclass=None),
             lambda o, t: TLX.prior_image_loss(o, t, noneclass=None))):
        _close(tf(torch.tensor(out), torch.tensor(tgt)),
               jf(jnp.asarray(out), jnp.asarray(tgt)))
        _grad_close(tf, jf, out, tgt)
    # a noneclass label (2) is left out
    tgt_n = np.where(_u((2, 1, 5, 6), 2) > 0.8, 2.0, tgt).astype(np.float32)
    _close(TLX.prior_image_loss(torch.tensor(out), torch.tensor(tgt_n)),
           JLX.prior_image_loss(jnp.asarray(out), jnp.asarray(tgt_n)))
    pix, ptgt = _u((40, 2), 3), (_u((30, 1), 4) > 0.5).astype(np.float32)
    for pct in (1.0, 0.75):
        _close(TLX.awesome_loss_joint(torch.tensor(pix),
                                      torch.tensor(ptgt if pct < 1 else
                                                   _u((40, 1), 4) > 0.5)
                                      .float(),
                                      scribble_percentage=pct,
                                      extra_penalty=extra_penalty),
               JLX.awesome_loss_joint(jnp.asarray(pix),
                                      jnp.asarray(ptgt if pct < 1 else
                                                  (_u((40, 1), 4) > 0.5)
                                                  .astype(np.float32)),
                                      scribble_percentage=pct,
                                      extra_penalty=extra_penalty))
    soft = _u((2, 1, 5, 6), 5)
    _close(TLX.unaries_conversion_loss(torch.tensor(out[:, :1]),
                                       torch.tensor(soft), TL.bce),
           JLX.unaries_conversion_loss(jnp.asarray(out[:, :1]),
                                       jnp.asarray(soft), JL.bce))
    _close(TLX.regularizer_loss(torch.tensor(out), torch.tensor(out),
                                TL.se, 0.5, TL.total_variation),
           JLX.regularizer_loss(jnp.asarray(out), jnp.asarray(out), JL.se,
                                0.5, JL.total_variation))
    with pytest.raises(ValueError):
        TLX.regularizer_loss(torch.tensor(out), torch.tensor(out), TL.se,
                             0.5)
    pred = (_u((3, 7), 6) > 0.5).astype(np.float32)
    lab = np.where(_u((3, 7), 7) > 0.7, 2.0, _u((3, 7), 8) > 0.4).astype(
        np.float32)
    for none in (None, 2.0):
        _close(TLX.true_pixel_accuracy(torch.tensor(pred), torch.tensor(lab),
                                       none),
               JLX.true_pixel_accuracy(jnp.asarray(pred), jnp.asarray(lab),
                                       none))


@pytest.mark.parametrize("extra_penalty", [False, True])
def test_instance_losses_match_jax(extra_penalty):
    logits = np.random.default_rng(0).standard_normal((3, 6, 5)).astype(
        np.float32)
    prior = _u((3, 6, 5), 1)
    valid = np.array([True, False, True])
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        tv = None if v is None else torch.tensor(v)
        _close(TIL.instance_prior_loss(
            torch.tensor(1.5), torch.tensor(logits), torch.tensor(prior), tv,
            alpha=0.7, extra_penalty=extra_penalty),
            JIL.instance_prior_loss(1.5, jnp.asarray(logits),
                                    jnp.asarray(prior), jv, alpha=0.7,
                                    extra_penalty=extra_penalty))
        _close(TIL.instance_finetune_loss(
            torch.tensor(1.5), torch.tensor(logits), torch.tensor(prior), tv),
            JIL.instance_finetune_loss(1.5, jnp.asarray(logits),
                                       jnp.asarray(prior), jv))
    # the prior loss's grads reach the prior only; the finetune loss's
    # the detector's masks only
    _grad_close(
        lambda p, lg: TIL.instance_prior_loss(0.0, lg, p,
                                              extra_penalty=extra_penalty),
        lambda p, lg: JIL.instance_prior_loss(0.0, lg, p,
                                              extra_penalty=extra_penalty),
        prior, logits)
    _grad_close(lambda lg, p: TIL.instance_finetune_loss(0.0, lg, p),
                lambda lg, p: JIL.instance_finetune_loss(0.0, lg, p),
                logits, prior)
