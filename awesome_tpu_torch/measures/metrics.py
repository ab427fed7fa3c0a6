"""Segmentation metrics; counterpart of ``awesome_tpu/measures/metrics.py``.

The tensor forms return 0-d tensors (no host sync); the ``_np`` forms are
their host-side numpy twins for per-image loops.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def iou(output, target, invert: bool = False,
        noneclass: Optional[float] = None,
        noneclass_replacement: float = 0.0,
        eps: float = 0.0,
        count_sum: Optional[Callable] = None) -> torch.Tensor:
    """Binary intersection-over-union of thresholded masks (a 0-d tensor,
    no host sync).

    ``invert=True`` scores the complement — against foreground when fg is
    encoded as 0. An empty union scores 0.0, as sklearn's
    ``jaccard_score(average='binary')`` does. ``count_sum``: sums the
    (2,) intersection and union counts over the ranks that hold the other
    pixels of the masks (a mesh's grid axis) before the ratio.
    """
    o = torch.as_tensor(output).to(torch.float32)
    t = torch.as_tensor(target).to(torch.float32)
    if noneclass is not None:
        none = t == noneclass
        o = torch.where(none, noneclass_replacement, o)
        t = torch.where(none, noneclass_replacement, t)
    if invert:
        o = 1.0 - o
        t = 1.0 - t
    o = o > 0.5
    t = t > 0.5
    counts = torch.stack([torch.logical_and(o, t).sum(),
                          torch.logical_or(o, t).sum()]).to(torch.float32)
    if count_sum is not None:
        counts = count_sum(counts)
    inter, union = counts[0], counts[1]
    return torch.where(union > 0,
                       inter / torch.clamp_min(union, eps + 1.0e-30),
                       torch.zeros_like(union))


def iou_np(output, target, invert: bool = False,
           noneclass: Optional[float] = None,
           noneclass_replacement: float = 0.0) -> float:
    """Host-side numpy twin of :func:`iou`."""
    o = np.asarray(output, np.float32)
    t = np.asarray(target, np.float32)
    if noneclass is not None:
        o = np.where(t == noneclass, noneclass_replacement, o)
        t = np.where(t == noneclass, noneclass_replacement, t)
    if invert:
        o = 1.0 - o
        t = 1.0 - t
    o = o > 0.5
    t = t > 0.5
    union = np.logical_or(o, t).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(o, t).sum() / union)


def pixel_accuracy(output, target, noneclass: Optional[float] = None):
    """Fraction of matching thresholded pixels (those whose target is
    ``noneclass`` left out)."""
    target = torch.as_tensor(target)
    match = ((torch.as_tensor(output) > 0.5) == (target > 0.5)).to(
        torch.float32)
    if noneclass is not None:
        valid = (target != noneclass).to(torch.float32)
        return (match * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
    return match.mean()


def pixel_accuracy_np(output, target,
                      noneclass: Optional[float] = None) -> float:
    """Host-side numpy twin of :func:`pixel_accuracy`."""
    match = ((np.asarray(output) > 0.5) == (np.asarray(target) > 0.5)
             ).astype(np.float32)
    if noneclass is not None:
        valid = np.asarray(target) != noneclass
        return float((match * valid).sum() / max(valid.sum(), 1.0))
    return float(match.mean())


def miou(outputs, targets, invert: bool = False, axis=None):
    """Mean IoU over the leading batch axis of (B, ...) mask stacks; the
    per-image IoUs with ``axis`` given."""
    per = torch.stack([iou(o, t, invert=invert)
                       for o, t in zip(outputs, targets)])
    return per.mean() if axis is None else per


def boundary_f1(output, target, tolerance: int = 2):
    """Boundary F-measure of two (H, W) masks with a pixel tolerance: the
    boundaries (fg pixels with a 4-neighbour of another value) dilated by
    ``tolerance`` 3x3 max pools."""

    def boundary(mask):
        m = mask.to(torch.float32)
        up = F.pad(m, (0, 0, 1, 0))[:-1]
        dn = F.pad(m, (0, 0, 0, 1))[1:]
        lf = F.pad(m, (1, 0))[:, :-1]
        rt = F.pad(m, (0, 1))[:, 1:]
        diff = (torch.abs(m - up) + torch.abs(m - dn) + torch.abs(m - lf)
                + torch.abs(m - rt))
        return (diff > 0) & (m > 0)

    def dilate(mask, it):
        m = mask.to(torch.float32)[None, None]
        for _ in range(it):
            m = F.max_pool2d(m, 3, stride=1, padding=1)
        return m[0, 0] > 0

    o = torch.as_tensor(output) > 0.5
    t = torch.as_tensor(target) > 0.5
    bo, bt = boundary(o), boundary(t)
    bo_d, bt_d = dilate(bo, tolerance), dilate(bt, tolerance)
    precision = (bo & bt_d).sum() / torch.clamp_min(bo.sum(), 1)
    recall = (bt & bo_d).sum() / torch.clamp_min(bt.sum(), 1)
    return 2 * precision * recall / torch.clamp_min(precision + recall,
                                                    1e-12)
