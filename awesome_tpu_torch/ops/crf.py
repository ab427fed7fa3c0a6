"""Dense CRF post-processing: fully connected mean-field inference;
counterpart of ``awesome_tpu/ops/crf.py``.

Behavior port of the reference's pydensecrf wrapper
(`awesome/run/crf.py:45-146`). Mean field with Potts compatibility
(Kraehenbuehl & Koltun)::

    Q <- softmax(-U + sum_m w_m (k_m (x) Q))

- The Gaussian pairwise kernel is an exact separable Gaussian blur
  (``conv1d`` per axis, the unnormalized kernel ``exp(-d^2 / 2 s^2)``,
  radius ``max(int(3 s + 0.5), 1)``).
- The bilateral kernel splats onto a 5-D bilateral grid (position /
  ``bilateral_sdims`` x color / ``bilateral_schan``), blurs it separably
  and slices it back, the bilateral-grid approximation of the
  permutohedral filter. The grid assignment is numpy on the host; the
  color axes' blur widths are per-image tensors with a full-axis radius,
  so a batch of images with their own color normalizations is one program.
- The splat is a sorted segment sum (points ordered by grid cell on the
  host, each cell's points summed in point order), so a refinement repeats
  bitwise on the card as on the CPU (no atomics).
- Both kernels are symmetric-normalized; the normalizations do not depend
  on Q and are computed once per call. The iterations run on the device
  with no host sync.

The exact permutohedral CRF for checking this one is
``awesome_tpu_torch.ops.permutohedral``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from awesome_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class CRFOptions:
    """Field-per-field mirror of `awesome/run/crf.py:11-42` (the kernel and
    normalization enums dropped: diagonal kernels and symmetric
    normalization are what is implemented)."""

    max_iterations: int = 15
    gaussian_sdims: Tuple[float, float] = (3.0, 3.0)
    gaussian_compat: float = 3.0
    bilateral_sdims: Tuple[float, float] = (50.0, 50.0)
    bilateral_schan: Tuple[float, float, float] = (10.0, 10.0, 10.0)
    bilateral_compat: float = 5.0
    color_bins: int = 16  # bilateral-grid color resolution per channel


# A blur along one axis: (kernel, radius); the kernel is (K,) for every
# image or (B, K) with one row per image.
Blur = Tuple[torch.Tensor, int]


def _radius(sigma: float, truncate: float = 3.0) -> int:
    return max(int(truncate * float(sigma) + 0.5), 1)


def _kernel(sigma: Union[float, torch.Tensor], radius: int,
            device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    if isinstance(sigma, torch.Tensor):  # (B,) float32, one row per image
        return torch.exp(-(x ** 2) / (2.0 * sigma[:, None] ** 2))
    return torch.exp(-(x ** 2) / (2.0 * float(sigma) ** 2))


def _blur_axis(t: torch.Tensor, axis: int, blur: Blur) -> torch.Tensor:
    """Unnormalized 1-D blur of ``t`` (B, ...) along ``axis``, zero
    outside the axis."""
    kern, radius = blur
    moved = t.movedim(axis, -1)
    shape = moved.shape
    if kern.ndim == 1:
        out = F.conv1d(moved.reshape(-1, 1, shape[-1]),
                       kern.reshape(1, 1, -1), padding=radius)
    else:
        b = shape[0]
        rows = moved.reshape(b, -1, shape[-1]).transpose(0, 1)
        out = F.conv1d(rows, kern[:, None, :], padding=radius, groups=b)
        out = out.transpose(0, 1)
    return out.reshape(shape).movedim(-1, axis)


def _sep_blur(t: torch.Tensor, blurs: Sequence[Blur]) -> torch.Tensor:
    """Separable blur of ``t`` (B, d1, ..., dk, C) along d1..dk."""
    for axis, blur in enumerate(blurs, start=1):
        t = _blur_axis(t, axis, blur)
    return t


def _inv_sqrt(norm: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(torch.clamp_min(norm, 1e-20))


@dataclasses.dataclass
class _Grid:
    """A batch's bilateral-grid assignment, on the device: ``order`` sorts
    the (B * H * W) points by (image, cell), ``lengths`` counts the points
    of each of the B * prod(dims) cells, ``cell`` is each point's row of
    the flattened grids."""

    order: torch.Tensor
    lengths: torch.Tensor
    cell: torch.Tensor
    dims: Tuple[int, ...]

    @classmethod
    def of(cls, flat_idx: np.ndarray, dims: Tuple[int, ...],
           device) -> "_Grid":
        b = flat_idx.shape[0]
        total = int(np.prod(dims))
        cell = (flat_idx.astype(np.int64)
                + total * np.arange(b, dtype=np.int64)[:, None]).reshape(-1)
        order = np.argsort(cell, kind="stable")
        lengths = np.bincount(cell, minlength=b * total)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        return cls(dev(order), dev(lengths), dev(cell), tuple(dims))

    def filter(self, values: torch.Tensor, blurs: Sequence[Blur]
               ) -> torch.Tensor:
        """Splat ``values`` (B, H, W, V), blur the grids, slice them back."""
        shape = values.shape
        flat = values.reshape(-1, shape[-1])
        grid = torch.segment_reduce(flat[self.order], "sum",
                                    lengths=self.lengths, axis=0,
                                    unsafe=True)
        grid = _sep_blur(grid.reshape((shape[0],) + self.dims
                                      + (shape[-1],)), blurs)
        return grid.reshape(-1, shape[-1])[self.cell].reshape(shape)


def _mean_field_loop(probs: torch.Tensor, grid: _Grid,
                     bilateral_blurs: Sequence[Blur],
                     options: CRFOptions) -> torch.Tensor:
    """Mean field on (B, H, W, C) probabilities."""
    dev = probs.device
    u = -torch.log(torch.clamp(probs, 1e-8, 1.0))
    gauss = [(_kernel(s, _radius(s), dev), _radius(s))
             for s in options.gaussian_sdims]
    ones = torch.ones(probs.shape[:3] + (1,), device=dev)
    g_inv = _inv_sqrt(_sep_blur(ones, gauss))
    b_inv = _inv_sqrt(grid.filter(ones, bilateral_blurs))
    q = torch.softmax(-u, dim=-1)
    for _ in range(options.max_iterations):
        msg = options.gaussian_compat * (_sep_blur(q * g_inv, gauss) * g_inv)
        msg = msg + options.bilateral_compat * (
            grid.filter(q * b_inv, bilateral_blurs) * b_inv)
        q = torch.softmax(-u + msg, dim=-1)
    return q


def _mean_field(probs: torch.Tensor, flat_idx: np.ndarray,
                dims: Tuple[int, ...], blur_sigmas: Tuple[float, ...],
                options: CRFOptions) -> torch.Tensor:
    """The per-image oracle with static blur widths: (H, W, C)
    probabilities, every grid axis truncated at ``max(int(3 s + 0.5), 1)``
    (the batched route takes the full axis for the color blurs). The
    tests hold the batched route against it."""
    dev = probs.device
    blurs = [(_kernel(s, _radius(s), dev), _radius(s)) for s in blur_sigmas]
    grid = _Grid.of(np.asarray(flat_idx)[None], dims, dev)
    return _mean_field_loop(probs[None], grid, blurs, options)[0]


def _mean_field_batched(probs: torch.Tensor, flat_idx: np.ndarray,
                        color_sigmas: torch.Tensor, dims: Tuple[int, ...],
                        options: CRFOptions) -> torch.Tensor:
    """probs (B, H, W, C), flat_idx (B, H * W), color_sigmas (B, 3): each
    image's color blur widths, with the full color axis as the radius
    (exact for any width)."""
    dev = probs.device
    nb = dims[2]
    spatial = (_kernel(1.0, 3, dev), 3)  # blur sigma 1 grid unit
    blurs: List[Blur] = [spatial, spatial] + [
        (_kernel(color_sigmas[:, k], nb, dev), nb) for k in range(3)]
    return _mean_field_loop(probs, _Grid.of(flat_idx, dims, dev), blurs,
                            options)


def _bilateral_grid_assignment(img255: np.ndarray, options: CRFOptions):
    """Host side: each pixel's nearest grid bin, and the blur widths in
    bins (1 feature unit)."""
    h, w, _ = img255.shape
    sy, sx = options.bilateral_sdims
    nb = options.color_bins
    ny = int(np.floor((h - 1) / sy)) + 2
    nx = int(np.floor((w - 1) / sx)) + 2
    col = img255 / np.asarray(options.bilateral_schan, np.float32)
    col_min = col.min(axis=(0, 1), keepdims=True)
    col_span = col.max(axis=(0, 1), keepdims=True) - col_min + 1e-6
    col_unit = (col - col_min) / col_span
    iy = np.clip(np.round(np.arange(h) / sy).astype(np.int32), 0, ny - 1)
    ix = np.clip(np.round(np.arange(w) / sx).astype(np.int32), 0, nx - 1)
    idx = [np.broadcast_to(iy[:, None], (h, w)),
           np.broadcast_to(ix[None, :], (h, w))]
    for k in range(3):
        idx.append(np.clip(np.round(col_unit[..., k] * (nb - 1))
                           .astype(np.int32), 0, nb - 1))
    dims = (ny, nx, nb, nb, nb)
    flat = (((idx[0] * nx + idx[1]) * nb + idx[2]) * nb + idx[3]) * nb \
        + idx[4]
    # blur sigma = 1 feature unit; a color bin is span / (nb - 1) feature
    # units wide, so the color sigma in bins is (nb - 1) / span
    span = np.asarray(col_span).reshape(3)
    blur_sigmas = (1.0, 1.0) + tuple(float((nb - 1) / s) for s in span)
    return flat.reshape(-1), dims, blur_sigmas


def _reject_logits(is_softmax_unaries: bool) -> None:
    if not is_softmax_unaries:
        # the reference's own False path is broken (U is unbound when
        # is_softmax_unaries is False, `awesome/run/crf.py:112-115`), so
        # there are no semantics to match
        raise NotImplementedError(
            "is_softmax_unaries=False has no reference semantics "
            "(awesome/run/crf.py leaves U unbound); pass probabilities")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to255(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8:
        return (np.clip(img, 0, 1) * 255.0).astype(np.float32)
    return img.astype(np.float32)


def dense_crf_batched(imgs, unaries, is_softmax_unaries: bool = True,
                      options: Optional[CRFOptions] = None,
                      device: DeviceLike = None) -> np.ndarray:
    """One device call refines every image: the per-evaluation batching of
    `awesome/run/handles.py:376-459` (the reference loops pydensecrf per
    image on the host).

    imgs: (B, H, W, 3) float in [0, 1] or uint8; unaries: (B, H, W[, C])
    probabilities, one channel expanded to [p, 1 - p]. Each image keeps
    its own color normalization. Returns (B, H, W, C) numpy refined
    probabilities (one channel in, one channel out). Arrays or tensors
    are accepted; the mean field runs on ``device`` (the card unless the
    caller says otherwise)."""
    _reject_logits(is_softmax_unaries)
    imgs = _host(imgs)
    unaries = _host(unaries)
    if unaries.ndim == 3:
        unaries = unaries[..., None]
    single_channel = unaries.shape[-1] == 1
    if single_channel:
        unaries = np.concatenate([unaries, 1.0 - unaries], axis=-1)
    if imgs.shape[0] == 0:
        return np.zeros(unaries.shape, np.float32)
    options = options or CRFOptions()
    dev = resolve_device(device)
    flats, sigmas, dims = [], [], None
    for img in imgs:
        flat, dims, blur = _bilateral_grid_assignment(_to255(img), options)
        flats.append(flat)
        sigmas.append(blur[2:])
    q = _mean_field_batched(
        torch.as_tensor(unaries, dtype=torch.float32, device=dev),
        np.stack(flats),
        torch.as_tensor(np.asarray(sigmas, np.float32), device=dev),
        dims, options)
    q = q.cpu().numpy()
    return q[..., 0:1] if single_channel else q


def dense_crf(img, unaries, is_softmax_unaries: bool = True,
              options: Optional[CRFOptions] = None,
              device: DeviceLike = None) -> np.ndarray:
    """Drop-in equivalent of `awesome/run/crf.py:45` ``dense_crf``.

    img: (H, W, 3) float in [0, 1] or uint8, or (H, W); channel-first
    layouts are transposed like the reference. unaries: (H, W, C)
    probabilities, or (H, W) / (H, W, 1) expanded to [p, 1 - p]
    (`:99-106`). Returns (H, W, C) numpy refined probabilities, through the
    batched route with one image."""
    _reject_logits(is_softmax_unaries)
    img = _host(img)
    unaries = _host(unaries)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] > 4:
        img = img.transpose(1, 2, 0)
    if unaries.ndim == 3 and unaries.shape[0] <= 4 < unaries.shape[-1]:
        unaries = unaries.transpose(1, 2, 0)
    if unaries.ndim == 2:
        unaries = unaries[:, :, None]
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=-1)
    return dense_crf_batched(img[None], unaries[None], True, options,
                             device)[0]
