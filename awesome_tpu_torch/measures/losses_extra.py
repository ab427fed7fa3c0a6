"""More losses and a metric: image-mode joint losses, a regularizer
wrapper, unary conversion, the prior-image loss and true-pixel accuracy;
counterpart of ``awesome_tpu/measures/losses_extra.py``.

Noneclass pixels are left out by masked reductions, not boolean indexing,
so every function keeps static shapes.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from awesome_tpu_torch.measures.losses import bce


def _masked_mean(values, mask):
    m = mask.to(values.dtype)
    return (values * m).sum() / torch.clamp_min(m.sum(), 1.0)


def _select(flag, a, b):
    """``a`` where ``flag`` (a bool or a 0-d bool tensor) else ``b``."""
    if isinstance(flag, torch.Tensor):
        return torch.where(flag, a, b)
    return a if flag else b


def awesome_image_loss(output, target, criterion: Callable = bce,
                       prior_criterion: Callable = bce, alpha: float = 1.0,
                       beta: float = 100.0, gamma: float = 0.1,
                       extra_penalty=False):
    """Image mode: ``output`` (B, 2C, H, W), seg and prior halves on the
    channel axis; with ``extra_penalty`` gamma times the loss plus beta
    times the SE of prior against the thresholded seg."""
    half = output.shape[1] // 2
    seg, prior = output[:, :half], output[:, half:]
    loss = criterion(seg, target) + alpha * prior_criterion(prior, target)
    hard_seg = (seg > 0.5).to(output.dtype).detach()
    with_pen = gamma * loss + beta * torch.mean((prior - hard_seg) ** 2)
    return _select(extra_penalty, with_pen, loss)


def awesome_loss_joint(output, target, criterion: Callable = bce,
                       alpha: float = 1.0, beta: float = 1.0,
                       gamma: float = 1.0, scribble_percentage: float = 1.0,
                       extra_penalty=False):
    """Pixel mode (N, 2): crit(seg) + alpha crit(prior) over the scribbled
    share of the points; with ``extra_penalty`` gamma times that plus beta
    times the SE of prior against the thresholded seg over all points."""
    n_scr = int(output.shape[-2] * scribble_percentage)
    seg = output[..., :n_scr, 0:1]
    prior = output[..., :n_scr, 1:2]
    loss = criterion(seg, target) + alpha * criterion(prior, target)
    hard_seg = (output[..., 0:1] > 0.5).to(output.dtype).detach()
    align = torch.mean((output[..., 1:2] - hard_seg) ** 2)
    return _select(extra_penalty, gamma * loss + beta * align, loss)


def regularizer_loss(output, target, criterion: Callable, tau: float = 0.0,
                     regularizer: Optional[Callable] = None):
    loss = criterion(output, target)
    if tau > 0.0:
        if regularizer is None:
            raise ValueError(
                "regularizer must not be None if tau is larger zero!")
        loss = loss + tau * regularizer(output)
    return loss


def unaries_conversion_loss(output, target, criterion: Callable):
    """Soft unary targets thresholded to hard classes before the
    criterion."""
    return criterion(output, (target >= 0.5).to(output.dtype))


def bce_like(criterion: Callable, output, target):
    """The elementwise form of a criterion, for masked reductions."""
    try:
        return criterion(output, target, reduction="none")
    except TypeError:
        return (output - target) ** 2


def prior_image_loss(output, target, criterion: Callable = bce,
                     alpha: float = 1.0, beta: float = 100.0,
                     delta: float = 1.0, noneclass: Optional[float] = 2.0):
    """Seg and prior criterion over the non-noneclass pixels, plus beta
    times the SE of prior against the thresholded seg over all pixels.
    ``output`` (B, 2C, ...), ``target`` (B, C, ...)."""
    half = output.shape[1] // 2
    seg, prior = output[:, :half], output[:, half:]
    if noneclass is not None:
        valid = (target != noneclass).to(output.dtype)
        t = torch.where(valid > 0, target, torch.zeros_like(target))
        loss = delta * _masked_mean(bce_like(criterion, seg, t), valid) + \
            alpha * _masked_mean(bce_like(criterion, prior, t), valid)
    else:
        loss = delta * criterion(seg, target) + alpha * criterion(prior,
                                                                  target)
    hard_seg = (seg > 0.5).to(output.dtype).detach()
    return loss + beta * torch.mean((prior - hard_seg) ** 2)


def true_pixel_accuracy(output, target, noneclass: Optional[float] = None):
    """The share of target-positive pixels predicted positive (the recall
    of the true class)."""
    o, t = torch.as_tensor(output), torch.as_tensor(target)
    valid = (t != noneclass) if noneclass is not None else \
        torch.ones_like(t, dtype=torch.bool)
    is_true = (t == 1.0) & valid
    correct = ((o == t) & is_true).to(torch.float32)
    return correct.sum() / torch.clamp_min(
        is_true.sum().to(torch.float32), 1.0)
