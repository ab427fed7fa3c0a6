"""API-familiarity shims for users migrating from the reference;
counterpart of ``awesome_tpu/utils/shims.py``.

Most of these are unnecessary in the port's design (models already
operate on point matrices; params are trees passed explicitly), but the
names are part of the reference's public surface, so thin functional
equivalents live here:

- :func:`pixelize` — decorator reshaping (B, C, H, W) -> (N, C) around a
  pointwise function (`awesome/util/pixelize.py:7-53`),
- :func:`batcherize` — decorator adding/removing leading batch dims to
  reach an expected rank (`awesome/util/batcherize.py:5-50`),
- :class:`temporary_attrs` — context manager temporarily mutating
  (nested) attributes (`awesome/util/temporary_property.py:44`) of
  host-side Python objects (datasets, runners).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict

import torch


def pixelize(arg_index: int = 0):
    """Wrap a pointwise fn(points (N, C)) so it accepts (B, C, H, W)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            x = args[arg_index]
            if x.ndim <= 2:
                return fn(*args, **kwargs)
            from awesome_tpu_torch.core.grids import (
                flatten_grid,
                unflatten_grid,
            )

            pts = flatten_grid(x)
            out = fn(*args[:arg_index], pts, *args[arg_index + 1:], **kwargs)
            out_shape = (x.shape[0], out.shape[-1]) + tuple(x.shape[2:])
            return unflatten_grid(out, out_shape)

        return wrapper

    return deco


def batcherize(expected_dim: int = 4, keep: bool = False):
    """Add leading singleton dims to reach ``expected_dim``; squeeze them
    back off the result unless ``keep``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(x, *args, **kwargs):
            added = 0
            while x.ndim < expected_dim:
                x = x[None]
                added += 1
            out = fn(x, *args, **kwargs)
            if not keep:
                for _ in range(added):
                    out = out.squeeze(0)
            return out

        return wrapper

    return deco


@contextlib.contextmanager
def temporary_attrs(obj: Any, **attrs: Dict[str, Any]):
    """Temporarily set attributes (supports 'a.b' nested paths)."""

    def resolve(path):
        parts = path.split(".")
        target = obj
        for p in parts[:-1]:
            target = getattr(target, p)
        return target, parts[-1]

    saved = []
    try:
        for path, value in attrs.items():
            target, name = resolve(path)
            saved.append((target, name, getattr(target, name)))
            setattr(target, name, value)
        yield obj
    finally:
        for target, name, old in reversed(saved):
            setattr(target, name, old)


def fourier(x: torch.Tensor) -> torch.Tensor:
    """Shifted, forward-normalized 2D FFT (`awesome/util/torch.py:74-87`;
    imported by the reference agent for spectrum analysis). The shift is
    over EVERY axis, batch axes too, as ``jnp.fft.fftshift`` with no axes
    does."""
    return torch.fft.fftshift(torch.fft.fft2(x, norm="forward"))


def inverse_fourier(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fourier` (`awesome/util/torch.py:90-103`)."""
    return torch.fft.ifft2(torch.fft.ifftshift(x), norm="forward")
