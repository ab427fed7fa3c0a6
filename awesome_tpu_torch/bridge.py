"""Conversion between the JAX package's param trees and this port's.

The trees have the same structure (dicts and lists, the same keys). One
layout differs: a JAX ``Linear`` weight ``w`` is ``(in, out)`` and the
port's is torch's ``(out, in)``. Every weight leaf named ``w`` with a
matrix shape is transposed; 1-D ``w`` leaves (``PerChannelAffine``) are
not. ``stacked=True`` means every leaf carries a leading image axis;
an int ``stacked`` counts leading axes (2 for an (image, object) tree).

The JAX side is passed as numpy arrays (``jax.device_get`` of a tree), so
this module imports no JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from awesome_tpu_torch.device import DeviceLike, resolve_device

Params = Any


def _walk(tree, leaf_fn, key=None):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf_fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, leaf_fn, key) for v in tree]
    return leaf_fn(key, tree)


def _is_matrix_weight(key, ndim: int, stacked: int) -> bool:
    return key == "w" and ndim == 2 + int(stacked)


def params_from_jax(tree: Params, device: DeviceLike = None,
                    stacked: int = False) -> Params:
    """JAX param tree (leaves as numpy arrays) -> the port's params."""
    dev = resolve_device(device)

    def leaf(key, x):
        a = np.asarray(x, dtype=np.float32)
        if _is_matrix_weight(key, a.ndim, stacked):
            a = np.swapaxes(a, -1, -2)
        return torch.tensor(np.ascontiguousarray(a), device=dev)

    return _walk(tree, leaf)


def params_to_numpy(params: Params, stacked: int = False) -> Params:
    """The port's params -> a JAX-layout tree of numpy arrays; the exact
    inverse of :func:`params_from_jax`."""

    def leaf(key, x):
        a = x.detach().cpu().numpy()
        if _is_matrix_weight(key, a.ndim, stacked):
            a = np.ascontiguousarray(np.swapaxes(a, -1, -2))
        return a

    return _walk(params, leaf)
