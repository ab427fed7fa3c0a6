"""Losses as pure functions; counterpart of
``awesome_tpu/measures/losses.py``.

Losses return scalars under 'mean' / 'sum' reduction, or the elementwise
tensor under 'none'. Foreground is encoded as 0 in the unaries.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def _reduce(x, reduction: str = "mean", dim=None):
    if reduction == "mean":
        return x.mean() if dim is None else x.mean(dim=dim)
    if reduction == "sum":
        return x.sum() if dim is None else x.sum(dim=dim)
    if reduction == "none":
        return x
    raise ValueError(f"Unknown reduction {reduction}")


def se(output, target, reduction: str = "mean", dim=None):
    """Squared error."""
    return _reduce((target - output) ** 2, reduction, dim)


def ae(output, target, reduction: str = "mean", dim=None):
    """Absolute error."""
    return _reduce(torch.abs(target - output), reduction, dim)


def bce(output, target, reduction: str = "mean", eps: float = 1e-7,
        weight=None):
    """Binary cross-entropy on probabilities (``nn.BCELoss`` semantics,
    with the input clamped to [eps, 1 - eps])."""
    p = torch.clamp(output, eps, 1.0 - eps)
    ll = -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))
    if weight is not None:
        ll = ll * weight
    return _reduce(ll, reduction)


def total_variation(img, reduction: str = "mean"):
    """Anisotropic total variation over the last two dims (..., H, W)."""
    dh = torch.abs(torch.diff(img, dim=-2))
    dw = torch.abs(torch.diff(img, dim=-1))
    return _reduce(dh, reduction) + _reduce(dw, reduction)


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


def unaries_weighted_loss(output, target, criterion: Callable = se,
                          mode: str = "none", ratio: float = 1.0,
                          reduction: str = "mean"):
    """The elementwise ``criterion`` times the unaries' class weights,
    then reduced."""
    raw = criterion(output, target, reduction="none")
    w = unaries_weight(target, mode=mode, ratio=ratio)
    return _reduce(raw * w, reduction)


def awesome_loss(output, target, criterion: Callable = bce,
                 alpha: float = 1.0, extra_penalty: bool = False,
                 scribble_percentage: float = 1.0):
    """Pixel-mode 2-channel loss ``crit(seg) + alpha * crit(prior)`` on
    (..., N, 2) outputs; the first ``floor(N * scribble_percentage)``
    points are the supervised scribbles. ``extra_penalty`` aligns the prior
    to the thresholded segmentation on the random tail."""
    n_total = output.shape[-2]
    n_scribbles = int(n_total * scribble_percentage)
    n_random = n_total - n_scribbles
    out_seg = output[..., :n_scribbles, 0:1]
    out_prior = output[..., :n_scribbles, 1:2]
    loss = criterion(out_seg, target) + alpha * criterion(out_prior, target)
    if extra_penalty and n_random > 0:
        seg_rand = output[..., n_random:, 0:1]
        prior_rand = output[..., n_random:, 1:2]
        hard_seg = (seg_rand > 0.5).to(output.dtype).detach()
        loss = 0.1 * loss + 100.0 * torch.mean((prior_rand - hard_seg) ** 2)
    return loss


def _bce_none(output, target, reduction="none"):
    return bce(output, target, reduction=reduction)


def fbms_joint_loss(output, target, criterion: Optional[Callable] = None,
                    penalty_criterion: Callable = se, alpha: float = 1.0,
                    beta: float = 1.0, clip_penalty: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """Joint FBMS loss on (B, 2C, H, W) outputs (segmentation channels,
    then prior channels): sssdms-weighted BCE of the segmentation plus the
    prior's SE to it, the penalty soft-clipped (by a detached scale) so it
    never exceeds the segmentation loss. Returns 'loss' and the logged
    sub-terms."""
    if criterion is None:
        def criterion(o, t):
            return unaries_weighted_loss(o, t, criterion=_bce_none,
                                         mode="sssdms")

    c_half = output.shape[1] // 2
    out_seg = output[:, :c_half]
    out_prior = output[:, c_half:]
    seg_raw = criterion(out_seg, target)
    seg_loss = alpha * seg_raw
    pen_raw = penalty_criterion(out_prior, out_seg)
    pen_loss = beta * pen_raw
    if clip_penalty:
        scale = torch.where(pen_loss > seg_loss,
                            seg_loss / torch.clamp_min(pen_loss, 1e-12),
                            torch.ones_like(pen_loss)).detach()
        pen_loss = pen_loss * scale
    loss = seg_loss + pen_loss
    denom = torch.clamp_min(loss, 1e-12)
    return {
        "loss": loss,
        "segmentation_loss": seg_raw,
        "penalty_loss": pen_raw,
        "penalty_loss_frac": pen_loss / denom,
        "segmentation_loss_frac": seg_loss / denom,
    }


def gradient_penalty(model_fn: Callable, inputs, target,
                     criterion: Callable = bce, xy_weight: float = 0.0,
                     feat_weight: float = 0.0, rgb_weight: float = 0.0,
                     xy_slice=slice(0, 2), feat_slice=slice(2, 4),
                     rgb_slice=slice(4, 7)):
    """``criterion`` plus penalties on the mean squared derivative of the
    summed output w.r.t. groups of input channels; ``model_fn(inputs)``
    on an (N, C) point matrix. The input gradient is ``torch.func.grad``
    of the summed output, so the penalty stays differentiable."""
    output = model_fn(inputs)
    loss = criterion(output, target)
    g = torch.func.grad(lambda x: model_fn(x).sum())(inputs)
    for weight, sl in ((xy_weight, xy_slice), (feat_weight, feat_slice),
                       (rgb_weight, rgb_slice)):
        if weight:
            loss = loss + weight * torch.mean(g[..., sl] ** 2)
    return loss
