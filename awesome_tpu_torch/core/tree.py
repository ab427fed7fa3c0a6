"""Helpers over param trees (nested dicts, lists and tuples of tensors);
counterpart of ``awesome_tpu/core/tree.py``.

A stacked tree carries a leading image axis on every leaf — the torch
form of the JAX package's stacked PyTree. ``None`` is a leaf to
:func:`tree_map`; the deep helpers (:func:`apply_deep`, :func:`to_dtype`,
:func:`to_device`) pass it through, as JAX treats ``None`` as an empty
subtree."""
from __future__ import annotations

import hashlib
import math
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from awesome_tpu_torch.device import DeviceLike, resolve_device

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


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_flatten_with_path(tree: Params, prefix: Tuple[str, ...] = ()
                           ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order. A path names
    each step as a string: a dict key, a NamedTuple field, or a list or
    tuple index (so a NamedTuple and its dict form have the same paths,
    as the JAX package's checkpoint key paths do)."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, child in items:
        out.extend(tree_flatten_with_path(child, prefix + (name,)))
    return out


def _structure(tree: Params) -> str:
    """The tree's nodes and leaf kinds as a string (no values): equal for
    two trees iff they have the same keys, fields, lengths and node
    types."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(v)}"
                               for k, v in tree.items()) + "}"
    if is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_structure(v)}" for f, v in zip(tree._fields, tree)
        ) + ")"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    return "None" if tree is None else "*"


def _deep(fn: Callable, tree: Params) -> Params:
    return tree_map(lambda x: None if x is None else fn(x), tree)


def apply_deep(tree: Params, fnc: Callable) -> Params:
    """Apply ``fnc`` to every leaf (``None`` passes through)."""
    return _deep(fnc, tree)


def to_dtype(tree: Params, dtype) -> Params:
    """Cast every floating leaf to ``dtype``; other leaves stay as they
    are."""
    return _deep(lambda x: x.to(dtype) if x.is_floating_point() else x,
                 tree)


def to_device(tree: Params, device: DeviceLike = None) -> Params:
    """Every leaf on ``device`` (the card unless the caller says
    otherwise)."""
    dev = resolve_device(device)
    return _deep(lambda x: x.to(dev), tree)


def tree_hash(tree: Params) -> str:
    """Deterministic content hash of a tree: its structure, and each
    leaf's dtype, shape and bytes."""
    h = hashlib.sha256()
    h.update(_structure(tree).encode())
    for leaf in tree_leaves(tree):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            h.update(str(t.dtype).encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            arr = np.asarray(leaf)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def stack_trees(trees: Sequence[Params]) -> Params:
    """Stack structurally identical trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def unstack_tree(tree: Params) -> list:
    """Inverse of :func:`stack_trees`: the leading axis split into a
    list of trees."""
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


def tree_select(stacked: Params, index) -> Params:
    """Entry ``index`` of a stacked tree."""
    return tree_map(lambda x: x[index], stacked)


def tree_update(stacked: Params, index, value: Params) -> Params:
    """``value`` written at ``index`` of a stacked tree (a new tree; the
    input is not changed)."""

    def put(s, v):
        out = s.clone()
        out[index] = v
        return out

    return tree_map(put, stacked, value)


def lead(v, like: torch.Tensor):
    """Right-pad the dims of a per-image value (a scalar, ``(B,)``, or
    ``(B, K)`` for an (image, object) tree) so it broadcasts against a
    leaf whose leading axes are those axes."""
    if not isinstance(v, torch.Tensor) or v.ndim == 0:
        return v
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def tree_where(pred, a: Params, b: Params) -> Params:
    """Leafwise ``where``; ``pred`` is a scalar, one flag per image, or
    one per (image, object) slot."""
    if isinstance(pred, bool):
        return a if pred else b
    return tree_map(lambda x, y: torch.where(lead(pred, x), x, y), a, b)


def count_parameters(tree: Params) -> int:
    """Total number of scalar parameters."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))
