"""Loss weighting; counterpart of ``unaries_weight`` in
``awesome_tpu/measures/losses.py``."""
from __future__ import annotations

import torch


def unaries_weight(target: torch.Tensor, mode: str = "none",
                   ratio: float = 1.0, mask=None) -> torch.Tensor:
    """Class-balancing pixel weights from soft unaries.

    Foreground is encoded as 0: fg = target < 0.5, bg = target >= 0.5.
    Modes: 'none' (all ones), 'equal' (fg weighted bg/fg), 'ratio'
    (fg weighted (bg/fg - 1) * ratio + 1), 'sssdms' (fg weighted
    round((bg/fg)/10) + 1). ``mask``: padded points get weight 0 and are
    left out of the class counts.
    """
    dt = target.dtype
    if mode == "none":
        ones = torch.ones_like(target)
        return ones if mask is None else ones * mask.to(dt)
    is_bg = (target >= 0.5).to(dt)
    if mask is not None:
        m = torch.broadcast_to(mask.to(dt), target.shape)
        bg_count = (is_bg * m).sum()
        fg_count = torch.clamp_min(((1.0 - is_bg) * m).sum(), 1.0)
    else:
        m = None
        bg_count = is_bg.sum()
        fg_count = torch.clamp_min((1.0 - is_bg).sum(), 1.0)
    cc = bg_count / fg_count
    if mode == "equal":
        w_fg = cc
    elif mode == "ratio":
        w_fg = (cc - 1.0) * ratio + 1.0
    elif mode == "sssdms":
        w_fg = torch.round(cc / 10.0) + 1.0
    else:
        raise ValueError(f"Mode {mode} is not supported")
    w = torch.where(is_bg > 0, torch.ones_like(target), w_fg)
    return w if m is None else w * m
