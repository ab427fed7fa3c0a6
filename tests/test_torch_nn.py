"""Port parity: the flow, the ICNNs and the path-connected prior of
awesome_tpu_torch compute what the JAX package computes from the same
weights (converted with ``awesome_tpu_torch.bridge``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.nn import flows as JF
from awesome_tpu.nn import icnn as JI
from awesome_tpu.nn.path_connected import (
    real_nvp_path_connected_net as j_factory,
)
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.nn import flows as TF
from awesome_tpu_torch.nn import icnn as TI
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
ATOL = 1e-5


def _perturb(params, seed=0, scale=0.05):
    """Numpy noise on every leaf so zero-initialized layers carry signal."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.normal(size=np.shape(p))
        .astype(np.float32), jax.device_get(params))


def _points(n=60, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.2, 1.2, size=(n, 2)).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=1e-5)


def test_binary_counting_masks_match():
    for c, n in ((2, 5), (3, 7)):
        np.testing.assert_array_equal(TF.binary_counting_masks(c, n),
                                      JF.binary_counting_masks(c, n))


@pytest.mark.parametrize("output_fn", ["tanh", None])
def test_realnvp_apply_inverse_actnorm_match(output_fn):
    jf = JF.RealNVPFlow(channels=2, hidden_units=8, n_flows=3,
                        output_fn=output_fn)
    tf = TF.RealNVPFlow(channels=2, hidden_units=8, n_flows=3,
                        output_fn=output_fn, device=CPU)
    assert "masks" in dict(tf.named_buffers())
    assert not list(tf.parameters())
    jp = _perturb(jf.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device=CPU)
    x = _points()
    _close(tf.apply(tp, torch.tensor(x)), jf.apply(jp, jnp.asarray(x)))
    _close(tf.inverse(tp, torch.tensor(x)), jf.inverse(jp, jnp.asarray(x)))
    ja = jf.actnorm_data_init(jp, jnp.asarray(x))
    ta = tf.actnorm_data_init(tp, torch.tensor(x))
    for a, b in zip(TT.tree_leaves(params_to_numpy(ta)),
                    jax.tree_util.tree_leaves(ja)):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=1e-5)


def test_convex_next_net_and_clip_match():
    jn = JI.ConvexNextNet(n_hidden=12, n_hidden_layers=2)
    tn = TI.ConvexNextNet(n_hidden=12, n_hidden_layers=2, device=CPU)
    jp = _perturb(jn.init(jax.random.PRNGKey(1)), scale=0.3)
    tp = params_from_jax(jp, device=CPU)
    x = _points()
    _close(tn.apply(tp, torch.tensor(x)), jn.apply(jp, jnp.asarray(x)))
    jc = jn.enforce_convexity(jp)
    tc = tn.enforce_convexity(tp)
    for a, b in zip(TT.tree_leaves(params_to_numpy(tc)),
                    jax.tree_util.tree_leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert min(float(b["ln"]["w"].min()) for b in tc["skip"]) >= 0.0


def test_convex_net_and_clip_match():
    jn = JI.ConvexNet(n_hidden=10)
    tn = TI.ConvexNet(n_hidden=10, device=CPU)
    jp = _perturb(jn.init(jax.random.PRNGKey(2)), scale=0.3)
    tp = params_from_jax(jp, device=CPU)
    x = _points()
    _close(tn.apply(tp, torch.tensor(x)), jn.apply(jp, jnp.asarray(x)))
    _close(tn.apply(tn.enforce_convexity(tp), torch.tensor(x)),
           jn.apply(jn.enforce_convexity(jp), jnp.asarray(x)))


@pytest.mark.parametrize("flows,hidden", [(2, 8), (4, 8)])
def test_path_connected_apply_inverse_match(flows, hidden):
    kw = dict(channels=2, hidden_units=hidden, flow_n_flows=flows,
              flow_output_fn="tanh", spatial_shape=(12, 16),
              convex_net_hidden_units=12, convex_net_hidden_layers=2)
    jm, tm = j_factory(**kw), t_factory(device=CPU, **kw)
    jp = _perturb(jm.init(jax.random.PRNGKey(3)))
    tp = params_from_jax(jp, device=CPU)
    x = np.asarray(JG.flatten_grid(JG.pixel_grid((12, 16))))
    xt, xj = torch.tensor(x), jnp.asarray(x)
    _close(tm.apply(tp, xt), jm.apply(jp, xj))
    _close(tm.deformation(tp, xt), jm.deformation(jp, xj))
    _close(tm.inverse(tp, xt), jm.inverse(jp, xj))
    # the analytic inverse undoes the deformation
    _close(tm.inverse(tp, tm.deformation(tp, xt)), x, atol=1e-4)
    tc = tm.enforce_convexity(tp)
    _close(tm.apply(tc, xt), jm.apply(jm.enforce_convexity(jp), xj))
    groups = tm.param_groups(tp)
    assert set(TT.tree_leaves(groups["flow"])) == {"flow"}
    assert set(TT.tree_leaves(groups["convex"])) == {"convex"}


def test_bridge_roundtrip_and_layout():
    jm = j_factory(channels=2, hidden_units=8, flow_n_flows=2,
                   flow_output_fn="tanh", spatial_shape=(8, 8),
                   convex_net_hidden_units=12, convex_net_hidden_layers=1)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(4)))
    tp = params_from_jax(jp, device=CPU)
    assert tuple(tp["convex"]["input"]["w"].shape) == (12, 2)  # (out, in)
    assert tuple(tp["linear"]["w"].shape) == (2,)
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    stacked = jax.tree_util.tree_map(lambda a: np.stack([a, a]), jp)
    ts = params_from_jax(stacked, device=CPU, stacked=True)
    torch.testing.assert_close(ts["convex"]["input"]["w"][1],
                               tp["convex"]["input"]["w"])
    for a, b in zip(jax.tree_util.tree_leaves(
            params_to_numpy(ts, stacked=True)),
            jax.tree_util.tree_leaves(stacked)):
        np.testing.assert_array_equal(a, b)


def test_init_distributions_and_structure():
    """Torch inits match the JAX ones in structure and distribution (the
    PRNG streams themselves differ)."""
    kw = dict(channels=2, hidden_units=16, flow_n_flows=3,
              flow_output_fn="tanh", spatial_shape=(8, 8),
              convex_net_hidden_units=64, convex_net_hidden_layers=2)
    jp = jax.device_get(j_factory(**kw).init(jax.random.PRNGKey(0)))
    tm = t_factory(device=CPU, **kw)
    tp = tm.init(torch.Generator().manual_seed(0))
    back = params_to_numpy(tp)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jp))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        assert a.shape == np.shape(b)
    w = tp["convex"]["skip"][0]["ln"]["w"]
    bound = 1.0 / math.sqrt(64)
    assert float(w.abs().max()) <= bound
    assert abs(float(w.std()) - bound / math.sqrt(3)) < 0.1 * bound
    # zero-initialized coupling outputs: the flow starts as the identity
    x = torch.tensor(_points())
    torch.testing.assert_close(tm.deformation(tp, x), x)
    # the same seed gives the same params
    tp2 = tm.init(torch.Generator().manual_seed(0))
    for a, b in zip(TT.tree_leaves(tp), TT.tree_leaves(tp2)):
        assert torch.equal(a, b)
