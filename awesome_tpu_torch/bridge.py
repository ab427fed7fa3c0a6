"""Conversion between the JAX package's param trees and this port's.

The trees have the same structure (dicts and lists, the same keys). Two
layouts differ: a JAX ``Linear`` weight ``w`` is ``(in, out)`` and the
port's is torch's ``(out, in)`` (so is a weight-normalized layer's
``v``); a JAX conv weight ``w`` is HWIO ``(kh, kw, in, out)`` and the
port's is torch's ``(out, in, kh, kw)``. Every weight leaf named ``w``
(or ``v``) with a matrix shape, and every ``w`` with a 4-D shape, is
converted; 1-D ``w`` leaves (``PerChannelAffine``) are not. A ``mask`` leaf (the JAX ``GlowFlow``/``SplineFlow`` coupling
masks, which the port keeps as buffers) is dropped. Float leaves become
float32; integer leaves (the batch-norm ``count``) keep their type.
``stacked=True`` means every leaf carries a leading image axis; an int
``stacked`` counts leading axes (2 for an (image, object) tree).

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
        return {k: _walk(v, leaf_fn, k) for k, v in tree.items()
                if k != "mask"}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, leaf_fn, key) for v in tree]
    return leaf_fn(key, tree)


_MATRIX_KEYS = ("w", "v")


def _to_port(key, a: np.ndarray, stacked: int) -> np.ndarray:
    lead = int(stacked)
    if key in _MATRIX_KEYS and a.ndim == 2 + lead:  # (in, out) -> (out, in)
        return np.swapaxes(a, -1, -2)
    if key == "w" and a.ndim == 4 + lead:  # HWIO -> (out, in, kh, kw)
        return np.moveaxis(a, (lead + 3, lead + 2), (lead, lead + 1))
    return a


def _to_jax(key, a: np.ndarray, stacked: int) -> np.ndarray:
    lead = int(stacked)
    if key in _MATRIX_KEYS and a.ndim == 2 + lead:
        return np.swapaxes(a, -1, -2)
    if key == "w" and a.ndim == 4 + lead:
        return np.moveaxis(a, (lead, lead + 1), (lead + 3, lead + 2))
    return a


def params_from_jax(tree: Params, device: DeviceLike = None,
                    stacked: int = False) -> Params:
    """JAX param or state tree (leaves as numpy arrays) -> the port's.
    ``None`` leaves stay ``None``."""
    dev = resolve_device(device)

    def leaf(key, x):
        if x is None:
            return None
        a = np.asarray(x)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        a = _to_port(key, a, stacked)
        return torch.tensor(a.copy(order="C"), device=dev)

    return _walk(tree, leaf)


def params_to_numpy(params: Params, stacked: int = False) -> Params:
    """The port's params -> a JAX-layout tree of numpy arrays; the exact
    inverse of :func:`params_from_jax`."""

    def leaf(key, x):
        if x is None:
            return None
        return _to_jax(key, x.detach().cpu().numpy(), stacked).copy(
            order="C")

    return _walk(params, leaf)
