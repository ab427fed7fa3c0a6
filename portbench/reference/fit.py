"""A prior fit's first steps, and the answers of a fitted prior, in plain
PyTorch.

The loss is ``sum(W * (sigmoid(prior(x)) - unaries)^2)`` with the point
weights W of the fit's settings (``1/N`` each, or the how-to's
``fg_weight / fg_count`` on foreground and ``(1 - fg_weight) / bg_count``
on background; foreground is encoded 0). A step is torch.optim's Adamax or
Adam (coupled L2 weight decay per leaf), then the convexity clip; for the
first steps ReduceLROnPlateau keeps the rate and the NaN guard passes.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from portbench.reference.layout import leaves, rebuild


def point_weights(target: torch.Tensor, fg_weight) -> torch.Tensor:
    """(N, 1) weights of one image's (N, 1) unaries."""
    if fg_weight is None:
        return torch.full_like(target, 1.0 / target.numel())
    bg = target >= 0.5
    bg_count = torch.clamp_min(bg.sum().to(torch.float32), 1.0)
    fg_count = torch.clamp_min((~bg).sum().to(torch.float32), 1.0)
    return torch.where(bg, (1.0 - fg_weight) / bg_count, fg_weight / fg_count)


def loss_and_grads(apply: Callable, p: dict, x: torch.Tensor,
                   target: torch.Tensor, weights: torch.Tensor
                   ) -> Tuple[torch.Tensor, list]:
    ps = [t.detach().requires_grad_(True) for t in leaves(p)]
    with torch.enable_grad():
        out = apply(rebuild(p, iter(ps)), x)
        loss = torch.sum(weights * (torch.sigmoid(out) - target) ** 2)
        grads = torch.autograd.grad(loss, ps)
    return loss.detach(), list(grads)


def adamax(p, g, m, u, count, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    g = g + wd * p
    m = b1 * m + (1.0 - b1) * g
    u = torch.maximum(b2 * u, torch.abs(g) + eps)
    return p - lr / (1.0 - b1 ** count) * m / u, m, u


def adam(p, g, m, v, count, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    g = g + wd * p
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    step = (m / (1.0 - b1 ** count)) / (torch.sqrt(v / (1.0 - b2 ** count))
                                        + eps)
    return p - lr * step, m, v


OPTIMIZERS = {"adamax": adamax, "adam": adam}


def follow(model, cfg: dict, p0: dict, x: torch.Tensor,
           target: torch.Tensor, steps: int) -> Tuple[List[float], dict]:
    """``steps`` steps of one image's fit from ``p0``: the loss before
    each step, and the params after the last."""
    upd = OPTIMIZERS[cfg["optimizer"]]
    w = point_weights(target, cfg.get("fg_weight"))
    wd = leaves(model.weight_decay(p0, cfg.get("flow_weight_decay", 0.0)))
    p = [t.clone() for t in leaves(p0)]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    losses = []
    for k in range(1, steps + 1):
        loss, g = loss_and_grads(model.apply, rebuild(p0, iter(p)), x,
                                 target, w)
        losses.append(float(loss))
        new = [upd(pi, gi, mi, vi, k, cfg["lr"], wi)
               for pi, gi, mi, vi, wi in zip(p, g, m, v, wd)]
        p = leaves(model.clip(rebuild(p0, iter([n[0] for n in new]))))
        m, v = [n[1] for n in new], [n[2] for n in new]
    return losses, rebuild(p0, iter(p))


def masks(model, p: dict, x: torch.Tensor, rows: int = 65536
          ) -> torch.Tensor:
    """(N,) foreground of a fitted prior: ``sigmoid(prior(x)) <= 0.5``
    (foreground is encoded 0), in blocks of rows."""
    with torch.no_grad():
        outs = [torch.sigmoid(model.apply(p, x[i:i + rows]))
                for i in range(0, x.shape[0], rows)]
    return torch.cat(outs).reshape(-1) <= 0.5


def iou(a: torch.Tensor, b: torch.Tensor) -> float:
    """Intersection over union of two foreground masks (0 for an empty
    union)."""
    union = (a | b).sum()
    if int(union) == 0:
        return 0.0
    return float((a & b).sum() / union)
