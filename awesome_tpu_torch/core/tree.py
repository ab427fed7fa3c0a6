"""Helpers over param trees (nested dicts, lists and tuples of tensors);
counterpart of the parts of ``awesome_tpu/core/tree.py`` the fit needs.

A stacked tree carries a leading image axis on every leaf — the torch
form of the JAX package's stacked PyTree."""
from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence

import torch

Params = Any


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """Apply ``fn`` leafwise over one or more trees of the same structure
    (dicts, lists, tuples and NamedTuples are nodes, all else is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Params) -> List[Any]:
    """Leaves in the same order as :func:`tree_map` visits them."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def stack_trees(trees: Sequence[Params]) -> Params:
    """Stack structurally identical trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_select(stacked: Params, index) -> Params:
    """Entry ``index`` of a stacked tree."""
    return tree_map(lambda x: x[index], stacked)


def lead(v, like: torch.Tensor):
    """Right-pad the dims of a per-image value (scalar or ``(B,)``) so it
    broadcasts against a leaf whose leading axis is the image axis."""
    if not isinstance(v, torch.Tensor) or v.ndim == 0:
        return v
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def tree_where(pred, a: Params, b: Params) -> Params:
    """Leafwise ``where``; ``pred`` is a scalar or one flag per image."""
    if isinstance(pred, bool):
        return a if pred else b
    return tree_map(lambda x, y: torch.where(lead(pred, x), x, y), a, b)


def count_parameters(tree: Params) -> int:
    """Total number of scalar parameters."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))
