"""2D/3D affine transformation matrix algebra; counterpart of
``awesome_tpu/core/affine.py``.

Behavior port of `awesome/run/transforms2d.py:216-382` and
`awesome/run/transforms3d.py:216-433` (homogeneous transformation
matrices for plotting/analysis of learned deformations). Angles, scales
and shears may be Python numbers or tensors (then the matrix follows
their device, dtype and grads); a matrix made from Python numbers only is
made on ``device`` (``None``: the card) in ``dtype``.
"""
from __future__ import annotations

import torch

from awesome_tpu_torch.device import DeviceLike, resolve_device


def _device(values, device: DeviceLike) -> torch.device:
    """The device of the first tensor among ``values``, else ``device``."""
    ref = next((v for v in values if isinstance(v, torch.Tensor)), None)
    return ref.device if ref is not None else resolve_device(device)


def _like(values, device: DeviceLike, dtype) -> tuple:
    """``values`` as 0-d tensors in ``dtype`` on :func:`_device`."""
    dev = _device(values, device)
    return tuple(torch.as_tensor(v, dtype=dtype, device=dev)
                 for v in values)


def rotation_matrix_2d(theta, device: DeviceLike = None,
                       dtype=torch.float32) -> torch.Tensor:
    (theta,) = _like((theta,), device, dtype)
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def scale_matrix_2d(sx, sy=None, device: DeviceLike = None,
                    dtype=torch.float32) -> torch.Tensor:
    sy = sx if sy is None else sy
    sx, sy, zero = _like((sx, sy, 0.0), device, dtype)
    return torch.stack([torch.stack([sx, zero]), torch.stack([zero, sy])])


def shear_matrix_2d(kx=0.0, ky=0.0, device: DeviceLike = None,
                    dtype=torch.float32) -> torch.Tensor:
    kx, ky, one = _like((kx, ky, 1.0), device, dtype)
    return torch.stack([torch.stack([one, kx]), torch.stack([ky, one])])


def transformation_matrix_2d(
    rotation=0.0, scale=(1.0, 1.0), shear=(0.0, 0.0),
    translation=(0.0, 0.0), device: DeviceLike = None, dtype=torch.float32,
) -> torch.Tensor:
    """3x3 homogeneous 2D transform: T @ R @ Sh @ Sc."""
    dev = _device((rotation, *scale, *shear, *translation), device)
    kw = dict(device=dev, dtype=dtype)
    lin = (
        rotation_matrix_2d(rotation, **kw)
        @ shear_matrix_2d(*shear, **kw)
        @ scale_matrix_2d(*scale, **kw)
    )
    m = torch.eye(3, dtype=dtype, device=dev)
    m[:2, :2] = lin
    m[:2, 2] = torch.stack(_like(tuple(translation), dev, dtype))
    return m


def rotation_matrix_3d(axis: str, theta, device: DeviceLike = None,
                       dtype=torch.float32) -> torch.Tensor:
    theta, zero, one = _like((theta, 0.0, 1.0), device, dtype)
    c, s = torch.cos(theta), torch.sin(theta)
    if axis == "x":
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == "y":
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    elif axis == "z":
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    else:
        raise ValueError(f"axis must be x|y|z, got {axis}")
    return torch.stack([torch.stack(r) for r in rows])


def transformation_matrix_3d(
    rotations=((0.0, "z"),), scale=(1.0, 1.0, 1.0),
    translation=(0.0, 0.0, 0.0), device: DeviceLike = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """4x4 homogeneous 3D transform."""
    dev = _device((*(t for t, _ in rotations), *scale, *translation),
                  device)
    scale = torch.stack(_like(tuple(scale), dev, dtype))
    lin = torch.eye(3, dtype=dtype, device=dev)
    for theta, axis in rotations:
        lin = rotation_matrix_3d(axis, theta, device=dev, dtype=dtype) @ lin
    lin = lin @ torch.diag(scale)
    m = torch.eye(4, dtype=dtype, device=dev)
    m[:3, :3] = lin
    m[:3, 3] = torch.stack(_like(tuple(translation), dev, dtype))
    return m


def apply_homogeneous(matrix: torch.Tensor,
                      points: torch.Tensor) -> torch.Tensor:
    """Apply an (d+1)x(d+1) matrix to (N, d) points."""
    d = points.shape[-1]
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    homo = torch.cat([points, ones], dim=-1)
    out = homo @ matrix.T
    return out[..., :d] / out[..., d:]
