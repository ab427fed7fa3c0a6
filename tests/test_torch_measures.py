"""Port parity: the losses and metrics of awesome_tpu_torch against the JAX
package's on the same numpy inputs (rtol 1e-5; grads rtol 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.measures import losses as JL
from awesome_tpu.measures import metrics as JM
from awesome_tpu_torch.measures import losses as TL
from awesome_tpu_torch.measures import metrics as TM


def _u(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _mask(shape, seed, p=0.5):
    return (np.random.default_rng(seed).uniform(size=shape) > p).astype(
        np.float32)


def _close(got, ref, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_elementwise_losses_match_jax(reduction):
    o, t = _u((3, 4, 5), 0, 0.01, 0.99), _mask((3, 4, 5), 1)
    for jf, tf in ((JL.se, TL.se), (JL.ae, TL.ae), (JL.bce, TL.bce)):
        _close(tf(torch.tensor(o), torch.tensor(t), reduction=reduction),
               jf(jnp.asarray(o), jnp.asarray(t), reduction=reduction))
    w = _u((3, 4, 5), 2)
    _close(TL.bce(torch.tensor(o), torch.tensor(t), reduction=reduction,
                  weight=torch.tensor(w)),
           JL.bce(jnp.asarray(o), jnp.asarray(t), reduction=reduction,
                  weight=jnp.asarray(w)))
    if reduction != "none":
        _close(TL.total_variation(torch.tensor(o), reduction),
               JL.total_variation(jnp.asarray(o), reduction))
        _close(TL.se(torch.tensor(o), torch.tensor(t), reduction, dim=1),
               JL.se(jnp.asarray(o), jnp.asarray(t), reduction, axis=1))
    with pytest.raises(ValueError):
        TL.se(torch.tensor(o), torch.tensor(t), reduction="bogus")


@pytest.mark.parametrize("mode", ["none", "equal", "ratio", "sssdms"])
def test_unaries_weighted_loss_matches_jax(mode):
    o, t = _u((2, 1, 6, 7), 3, 0.01, 0.99), _mask((2, 1, 6, 7), 4, 0.7)
    for crit in ("se", "bce"):
        jc = JL.se if crit == "se" else JL._bce_none
        tc = TL.se if crit == "se" else TL._bce_none
        _close(TL.unaries_weighted_loss(torch.tensor(o), torch.tensor(t),
                                        criterion=tc, mode=mode, ratio=0.5),
               JL.unaries_weighted_loss(jnp.asarray(o), jnp.asarray(t),
                                        criterion=jc, mode=mode, ratio=0.5))


@pytest.mark.parametrize("extra,pct", [(False, 1.0), (True, 0.6)])
def test_awesome_loss_matches_jax(extra, pct):
    out = _u((20, 2), 5, 0.01, 0.99)
    n_s = int(20 * pct)
    t = _mask((n_s, 1), 6)
    _close(TL.awesome_loss(torch.tensor(out), torch.tensor(t), alpha=0.7,
                           extra_penalty=extra, scribble_percentage=pct),
           JL.awesome_loss(jnp.asarray(out), jnp.asarray(t), alpha=0.7,
                           extra_penalty=extra, scribble_percentage=pct))


@pytest.mark.parametrize("clip,beta", [(True, 1.0), (True, 50.0),
                                       (False, 2.0)])
def test_fbms_joint_loss_and_grads_match_jax(clip, beta):
    """Every returned term, and the grad of 'loss' (the soft clip's scale
    is detached in both)."""
    out = _u((2, 2, 6, 5), 7, 0.01, 0.99)
    t = _mask((2, 1, 6, 5), 8, 0.6)
    ref = JL.fbms_joint_loss(jnp.asarray(out), jnp.asarray(t), beta=beta,
                             clip_penalty=clip)
    got = TL.fbms_joint_loss(torch.tensor(out), torch.tensor(t), beta=beta,
                             clip_penalty=clip)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])
    jg = jax.grad(lambda o: JL.fbms_joint_loss(
        o, jnp.asarray(t), beta=beta, clip_penalty=clip)["loss"])(
        jnp.asarray(out))
    tg = torch.func.grad(lambda o: TL.fbms_joint_loss(
        o, torch.tensor(t), beta=beta, clip_penalty=clip)["loss"])(
        torch.tensor(out))
    _close(tg, jg, 1e-4)


def test_gradient_penalty_matches_jax():
    """The input-gradient penalties, and the grad of the whole loss w.r.t.
    the model's weight (the penalty is differentiable in both)."""
    x = _u((16, 7), 9, -1, 1)
    t = _mask((16, 1), 10)
    w = _u((7, 1), 11, -1, 1)

    def jfn(wt):
        return lambda xx: jax.nn.sigmoid(jnp.tanh(xx @ wt) * 2.0)

    def tfn(wt):
        return lambda xx: torch.sigmoid(torch.tanh(xx @ wt) * 2.0)

    kw = dict(xy_weight=0.5, feat_weight=0.2, rgb_weight=0.1)
    _close(TL.gradient_penalty(tfn(torch.tensor(w)), torch.tensor(x),
                               torch.tensor(t), **kw),
           JL.gradient_penalty(jfn(jnp.asarray(w)), jnp.asarray(x),
                               jnp.asarray(t), **kw))
    jg = jax.grad(lambda wt: JL.gradient_penalty(
        jfn(wt), jnp.asarray(x), jnp.asarray(t), **kw))(jnp.asarray(w))
    tg = torch.func.grad(lambda wt: TL.gradient_penalty(
        tfn(wt), torch.tensor(x), torch.tensor(t), **kw))(torch.tensor(w))
    _close(tg, jg, 1e-4)


def test_metrics_match_jax():
    o, t = _u((3, 9, 8), 12), _mask((3, 9, 8), 13)
    t[0, 0, :3] = 2.0
    for kw in ({}, {"invert": True}):
        _close(TM.miou(torch.tensor(o), torch.tensor(t), **kw),
               JM.miou(jnp.asarray(o), jnp.asarray(t), **kw))
        _close(TM.miou(torch.tensor(o), torch.tensor(t), axis=0, **kw),
               JM.miou(jnp.asarray(o), jnp.asarray(t), axis=0, **kw))
    for kw in ({}, {"noneclass": 2.0}):
        _close(TM.pixel_accuracy(torch.tensor(o), torch.tensor(t), **kw),
               JM.pixel_accuracy(jnp.asarray(o), jnp.asarray(t), **kw))
        assert TM.pixel_accuracy_np(o, t, **kw) == pytest.approx(
            JM.pixel_accuracy_np(o, t, **kw), rel=1e-6)
    for kw in ({}, {"invert": True}, {"noneclass": 2.0}):
        assert TM.iou_np(o, t, **kw) == pytest.approx(
            JM.iou_np(o, t, **kw), rel=1e-6)
    assert TM.iou_np(np.zeros(4), np.zeros(4)) == 0.0
    for tol in (1, 2):
        _close(TM.boundary_f1(torch.tensor(o[0]), torch.tensor(t[1]), tol),
               JM.boundary_f1(jnp.asarray(o[0]), jnp.asarray(t[1]), tol))
    disk = np.zeros((12, 12), np.float32)
    disk[3:9, 4:10] = 1.0
    assert float(TM.boundary_f1(torch.tensor(disk), torch.tensor(disk))) \
        == pytest.approx(1.0)
