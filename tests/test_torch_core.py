"""Port parity: grids and normalization transforms of awesome_tpu_torch
equal the JAX package's exactly (same point order, dtype and values)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.core import transforms as JTr
from awesome_tpu_torch.core import grids as TG
from awesome_tpu_torch.core import transforms as TTr
from awesome_tpu_torch.core import tree as TT

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
