"""Port parity: grids and normalization transforms of awesome_tpu_torch
equal the JAX package's exactly (same point order, dtype and values)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.core import transforms as JTr
from awesome_tpu_torch.core import grids as TG
from awesome_tpu_torch.core import transforms as TTr
from awesome_tpu_torch.core import tree as TT
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"


def _eq(t, j):
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(12, 16), (7, 5)])
def test_pixel_grid_and_flatten_match(shape):
    g = TG.pixel_grid(shape, device=CPU)
    _eq(g, JG.pixel_grid(shape))
    _eq(TG.flatten_grid(g), JG.flatten_grid(JG.pixel_grid(shape)))
    pts = TG.flatten_grid(g)
    _eq(TG.unflatten_grid(pts, g.shape), JG.unflatten_grid(
        JG.flatten_grid(JG.pixel_grid(shape)), g.shape))
    torch.testing.assert_close(TG.unflatten_grid(pts, g.shape), g,
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(6, 9), (3, 4, 5), (1, 4)])
def test_coordinate_and_normalized_grid_match(shape):
    _eq(TG.coordinate_grid(shape, device=CPU), JG.coordinate_grid(shape))
    _eq(TG.normalized_grid(shape, device=CPU), JG.normalized_grid(shape))


def test_transforms_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 2)).astype(np.float32)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    for dim in (None, 0):
        tm, jm = TTr.MinMax.fit(xt, dim=dim), JTr.MinMax.fit(xj, dim=dim)
        _eq(tm.transform(xt), jm.transform(xj))
        _eq(tm.inverse_transform(xt), jm.inverse_transform(xj))
        ts, js = TTr.MeanStd.fit(xt, dim=dim), JTr.MeanStd.fit(xj, dim=dim)
        np.testing.assert_allclose(ts.transform(xt).numpy(),
                                   np.asarray(js.transform(xj)), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ts.inverse_transform(xt).numpy(),
                                   np.asarray(js.inverse_transform(xj)),
                                   rtol=1e-6, atol=1e-6)
    mm = TTr.MinMax(torch.zeros(2), torch.ones(2), -1.0, 1.0)
    torch.testing.assert_close(mm.inverse_transform(mm(xt)), xt)
    assert TTr.minmax(3.0, 1.0, 5.0) == JTr.minmax(3.0, 1.0, 5.0)


def test_tree_helpers():
    trees = [{"a": torch.full((2,), float(i)), "b": [torch.ones(3) * i]}
             for i in range(3)]
    st = TT.stack_trees(trees)
    assert st["a"].shape == (3, 2) and st["b"][0].shape == (3, 3)
    torch.testing.assert_close(TT.tree_select(st, 1)["b"][0],
                               torch.ones(3))
    sel = TT.tree_where(torch.tensor([True, False, True]), st,
                        TT.tree_map(torch.zeros_like, st))
    np.testing.assert_array_equal(sel["a"][:, 0].numpy(), [0.0, 0.0, 2.0])
    assert TT.count_parameters(st) == 15


def test_deep_tree_helpers_match_jax():
    """apply_deep, to_dtype, to_device, unstack_tree and tree_update against
    the JAX package's on the same stacked tree; ``None`` leaves pass the
    deep helpers; tree_where takes a (B, K) mask over two leading axes."""
    from awesome_tpu.core import tree as JT

    rng = np.random.default_rng(0)
    # keys in sorted order: JAX's leaves come sorted by key
    src = {"n": [np.arange(3, dtype=np.int32)],
           "w": rng.standard_normal((3, 2, 4)).astype(np.float32)}
    jt = jax.tree_util.tree_map(jnp.asarray, src)
    tt = TT.tree_map(torch.tensor, src)
    for got, ref in ((TT.apply_deep(tt, lambda x: x * 2),
                      JT.apply_deep(jt, lambda x: x * 2)),
                     (TT.to_dtype(tt, torch.float16),
                      JT.to_dtype(jt, jnp.float16))):
        for a, b in zip(TT.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert TT.apply_deep({"a": None, "b": torch.ones(1)},
                         lambda x: x + 1)["a"] is None
    moved = TT.to_device(tt, "cpu")
    assert all(x.device.type == "cpu" for x in TT.tree_leaves(moved))
    ju, tu = JT.unstack_tree(jt), TT.unstack_tree(tt)
    assert len(tu) == len(ju) == 3
    for a_tree, b_tree in zip(tu, ju):
        for a, b in zip(TT.tree_leaves(a_tree),
                        jax.tree_util.tree_leaves(b_tree)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    value = TT.tree_select(TT.apply_deep(tt, lambda x: x + 5), 2)
    got = TT.tree_update(tt, 1, value)
    ref = JT.tree_update(jt, 1, JT.tree_select(
        JT.apply_deep(jt, lambda x: x + 5), 2))
    for a, b in zip(TT.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not torch.equal(tt["w"][1], got["w"][1])  # the input is kept
    keep = torch.tensor([[True, False], [False, True], [True, True]])
    mixed = TT.tree_where(keep, {"w": tt["w"]},
                          {"w": torch.zeros_like(tt["w"])})
    np.testing.assert_array_equal(mixed["w"][:, :, 0].numpy() != 0,
                                  keep.numpy())


def test_tree_hash_and_paths():
    """tree_hash sees structure, dtype and values, and repeats; key paths
    name dict keys, NamedTuple fields and list indices."""
    from awesome_tpu_torch.fit.optim import adamax_init

    tree = {"a": torch.arange(4.0), "b": [torch.ones(2, dtype=torch.int32),
                                          None]}
    h = TT.tree_hash(tree)
    assert h == TT.tree_hash(TT.tree_map(
        lambda x: None if x is None else x.clone(), tree))
    assert h != TT.tree_hash({"a": torch.arange(4.0) + 1, "b": tree["b"]})
    assert h != TT.tree_hash({"a": torch.arange(4), "b": tree["b"]})
    assert h != TT.tree_hash({"b": tree["b"], "a": tree["a"]})
    st = adamax_init({"w": torch.zeros(2)}, (3,))
    assert [p for p, _ in TT.tree_flatten_with_path(st)] == [
        ("count",), ("m", "w"), ("u", "w")]
    # the node type counts: the same fields and leaves in a dict differ
    assert TT.tree_hash(st) != TT.tree_hash(st._asdict())
    assert TT.tree_hash([st.m]) != TT.tree_hash((st.m,))
