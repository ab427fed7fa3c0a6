"""Segmentation metrics; counterpart of ``iou`` in
``awesome_tpu/measures/metrics.py``."""
from __future__ import annotations

from typing import Optional

import torch


def iou(output, target, invert: bool = False,
        noneclass: Optional[float] = None,
        noneclass_replacement: float = 0.0,
        eps: float = 0.0) -> torch.Tensor:
    """Binary intersection-over-union of thresholded masks (a 0-d tensor,
    no host sync).

    ``invert=True`` scores the complement — against foreground when fg is
    encoded as 0. An empty union scores 0.0, as sklearn's
    ``jaccard_score(average='binary')`` does.
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
    inter = torch.logical_and(o, t).sum().to(torch.float32)
    union = torch.logical_or(o, t).sum().to(torch.float32)
    return torch.where(union > 0,
                       inter / torch.clamp_min(union, eps + 1.0e-30),
                       torch.zeros_like(union))
