"""Port parity: Adamax, Adam and the plateau schedule of awesome_tpu_torch
follow the JAX package's updates over 50 steps (rtol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.fit import optim as JO
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.fit import optim as TO

STEPS = 50


def _tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32)]}


@pytest.mark.parametrize("name", ["adamax", "adam"])
def test_optimizer_matches_jax_50_steps(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads_seq = [_tree(rng) for _ in range(STEPS)]
    wd = {"a": 1e-2, "b": [0.0]}
    j_init, j_upd = getattr(JO, f"{name}_init"), getattr(JO, f"{name}_update")
    t_init, t_upd = getattr(TO, f"{name}_init"), getattr(TO, f"{name}_update")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = TT.tree_map(torch.tensor, params)
    js, ts = j_init(jp), t_init(tp)
    j_step = jax.jit(lambda p, g, s, lr: j_upd(p, g, s, lr, weight_decay=wd))
    for i, g in enumerate(grads_seq):
        lr = 1e-2 * (0.5 if i >= 25 else 1.0)
        jp, js = j_step(jp, jax.tree_util.tree_map(jnp.asarray, g), js,
                        jnp.float32(lr))
        tp, ts = t_upd(tp, TT.tree_map(torch.tensor, g), ts,
                       torch.tensor(lr), weight_decay=wd)
    for a, b in zip(TT.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert int(ts.count) == int(js.count) == STEPS


def test_plateau_matches_jax():
    rng = np.random.default_rng(1)
    losses = np.concatenate([np.linspace(1.0, 0.5, 10),
                             0.5 + 1e-6 * rng.normal(size=40)]
                            ).astype(np.float32)
    js, ts = JO.plateau_init(), TO.plateau_init()
    j_upd = jax.jit(lambda s, l_: JO.plateau_update(s, l_, factor=0.5,
                                                    patience=5))
    for loss in losses:
        js = j_upd(js, jnp.float32(loss))
        ts = TO.plateau_update(ts, torch.tensor(loss), factor=0.5,
                               patience=5)
        np.testing.assert_allclose(float(ts.scale), float(js.scale),
                                   rtol=1e-6)
        assert int(ts.num_bad) == int(js.num_bad)
        np.testing.assert_allclose(float(ts.best), float(js.best), rtol=1e-6)
    assert float(ts.scale) < 1.0


def test_per_image_state_broadcasts():
    """A leading image axis on count and lr: each image steps as a single
    fit with its own lr would."""
    rng = np.random.default_rng(2)
    p = torch.tensor(rng.normal(size=(2, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(2, 3)).astype(np.float32))
    st = TO.adamax_init(p, batch_shape=(2,))
    lr = torch.tensor([1e-2, 1e-3])
    new, st2 = TO.adamax_update(p, g, st, lr)
    for i in range(2):
        one, _ = TO.adamax_update(p[i], g[i], TO.adamax_init(p[i]), lr[i])
        torch.testing.assert_close(new[i], one, rtol=0, atol=0)
    assert st2.count.shape == (2,)
    sched = TO.plateau_init(batch_shape=(2,))
    sched = TO.plateau_update(sched, torch.tensor([1.0, float("nan")]))
    assert float(sched.best[0]) == 1.0 and int(sched.num_bad[1]) == 1
