"""Coordinate grids for implicit representations; counterpart of
``awesome_tpu/core/grids.py``. Channel-first tensors, the same point order
and dtype as the JAX package, so parity tests can feed the same points to
both."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from awesome_tpu_torch.device import DeviceLike, resolve_device


def coordinate_grid(grid_shape: Sequence[int], dtype=torch.float32,
                    device: DeviceLike = None) -> torch.Tensor:
    """Integer coordinate grid: ``(2, h, w)`` with channels (x, y) for
    ``(h, w)``; ``(t, 3, h, w)`` for ``(t, h, w)``."""
    dev = resolve_device(device)
    aranges = [torch.arange(s, dtype=dtype, device=dev) for s in grid_shape]
    mesh = torch.meshgrid(*aranges, indexing="ij")
    grid = torch.stack(mesh[::-1])  # (x, y[, z]) channel order
    if grid.ndim == 4:
        grid = grid.transpose(0, 1)  # time -> batch dim
    return grid


def normalized_grid(grid_shape: Sequence[int], dtype=torch.float32,
                    device: DeviceLike = None) -> torch.Tensor:
    """Coordinate grid min-max normalized to [0, 1] per channel:
    ``(1, 2, h, w)`` for 2D shapes, ``(t, 3, h, w)`` for 3D."""
    grid = coordinate_grid(grid_shape, dtype=dtype, device=device)
    if grid.ndim == 3:
        grid = grid[None]
    mn = grid.amin(dim=(0, 2, 3), keepdim=True)
    mx = grid.amax(dim=(0, 2, 3), keepdim=True)
    span = mx - mn
    return (grid - mn) / torch.where(span == 0, torch.ones_like(span), span)


def pixel_grid(image_shape: Tuple[int, int], dtype=torch.float32,
               device: DeviceLike = None) -> torch.Tensor:
    """The how-to query grid ``(1, 2, h, w)``: x = arange(w)/w,
    y = arange(h)/h."""
    dev = resolve_device(device)
    ny, nx = image_shape
    y = torch.arange(ny, dtype=dtype, device=dev)
    x = torch.arange(nx, dtype=dtype, device=dev)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack((xx / nx, yy / ny), dim=0)[None]


def flatten_grid(grid: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B*H*W, C) point matrix."""
    c = grid.shape[1]
    n = grid.numel() // max(c, 1)
    return torch.movedim(grid, 1, -1).reshape(n, c)


def unflatten_grid(points: torch.Tensor,
                   grid_shape: Sequence[int]) -> torch.Tensor:
    """(B*H*W, C) -> (B, C, H, W), inverse of :func:`flatten_grid`."""
    b = grid_shape[0]
    spatial = tuple(grid_shape[2:])
    c = points.shape[-1]
    return torch.movedim(points.reshape((b,) + spatial + (c,)), -1, 1)


def circle_mask(grid_shape: Tuple[int, int], radius, center,
                device: DeviceLike = None) -> torch.Tensor:
    """Binary circle on a pixel grid (the ICNN circle prefit's target);
    ``center`` is (row, col) in pixel units, as in the JAX package."""
    dev = resolve_device(device)
    h, w = grid_shape
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cy, cx = center
    return ((yy - cy) ** 2 + (xx - cx) ** 2) <= radius ** 2


def unary_circle_approximation(unaries: torch.Tensor) -> torch.Tensor:
    """Circle with the foreground's area and center of mass. ``unaries``
    is (H, W), or squeezes to it, with foreground > 0."""
    u = unaries.reshape(unaries.shape[-2:])
    fg = (u > 0.0).to(torch.float32)
    area = fg.sum()
    h, w = u.shape
    yy = torch.arange(h, dtype=torch.float32, device=u.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=u.device)[None, :]
    denom = torch.clamp_min(area, 1.0)
    cy = (fg * yy).sum() / denom
    cx = (fg * xx).sum() / denom
    radius = torch.sqrt(area / math.pi)
    return ((yy - cy) ** 2 + (xx - cx) ** 2) <= radius ** 2
