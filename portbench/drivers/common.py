"""What the fit drivers share: the port's models and fit settings from a
configuration, the sample of units to check, and the gaps compared with
the reference."""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Sequence, Tuple

import torch

from portbench.reference import fit as rfit


def port_prior(cfg: dict, h: int, w: int, device):
    """The configuration's prior as the port builds it."""
    if cfg["prior"] == "path_connected":
        from awesome_tpu_torch.nn.path_connected import (
            real_nvp_path_connected_net,
        )

        return real_nvp_path_connected_net(
            channels=cfg["channels"], hidden_units=cfg["flow_hidden_units"],
            flow_n_flows=cfg["flow_n_flows"],
            flow_output_fn=cfg["flow_output_fn"], norm=cfg["norm"],
            spatial_shape=(h, w),
            convex_net_hidden_units=cfg["convex_hidden_units"],
            convex_net_hidden_layers=cfg["convex_hidden_layers"],
            device=device)
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.ops.mlp import FullyFusedConvexNextNet

    return FullyFusedConvexNextNet(ConvexNextNet(
        n_hidden=cfg["convex_hidden_units"], in_features=cfg["channels"],
        out_features=1, n_hidden_layers=cfg["convex_hidden_layers"],
        device=device))


def fit_config(ctx, steps: int, **kw):
    """The port's FitConfig of the configuration; the control runs the
    model's math in bf16 (the fused flagship kernel's bf16 build, or the
    ICNN kernels on bf16-rounded params and points)."""
    from awesome_tpu_torch.fit.prior_fit import FitConfig

    cfg = ctx.config
    return FitConfig(
        num_steps=steps, lr=cfg["lr"], optimizer=cfg["optimizer"],
        flow_weight_decay=cfg.get("flow_weight_decay", 0.0),
        fg_weight=cfg.get("fg_weight"),
        plateau_patience=cfg["plateau_patience"],
        plateau_factor=cfg["plateau_factor"],
        gate_threshold=cfg.get("gate_threshold"),
        gate_retries=cfg.get("gate_retries", 1),
        compute_dtype=torch.bfloat16 if ctx.control else None, **kw)


def short(cfg, steps: int = 2):
    """The same settings with ``steps`` steps: the warm-up's."""
    return dataclasses.replace(cfg, num_steps=steps)


def reference_fit_settings(cfg: dict) -> dict:
    return {"optimizer": cfg["optimizer"], "lr": cfg["lr"],
            "flow_weight_decay": cfg.get("flow_weight_decay", 0.0),
            "fg_weight": cfg.get("fg_weight")}


def sample(seed: int, n: int, k: int) -> List[int]:
    """``k`` of the window's ``n`` units, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(n), min(k, n)))


def loss_gaps(prog: Sequence[float], ref: Sequence[float]
              ) -> Tuple[float, float]:
    """(the largest gap of a step's loss, relative to the reference's; the
    largest gap of the loss's change since the first step, relative to the
    reference's change)."""
    gap = max(abs(p - r) / abs(r) for p, r in zip(prog, ref))
    dgap = max(abs((p - prog[0]) - (r - ref[0])) / abs(r - ref[0])
               for p, r in zip(prog[1:], ref[1:]))
    return gap, dgap


def loss_at(model, p: dict, x: torch.Tensor, target: torch.Tensor,
            weights: torch.Tensor, rows: int = 65536) -> float:
    """The reference's loss of the params ``p`` on one image, in blocks of
    rows."""
    with torch.no_grad():
        out = torch.cat([model.apply(p, x[i:i + rows])
                         for i in range(0, x.shape[0], rows)])
        return float(torch.sum(weights * (torch.sigmoid(out) - target) ** 2))


def final_gap(model, fitted: dict, x: torch.Tensor, target: torch.Tensor,
              weights: torch.Tensor, last: float) -> float:
    """The gap between the reference's loss at a fit's returned params and
    the program's loss before its last step, relative to the latter: one
    step's progress for a sound fit, far more for an answer altered after
    its loss was taken."""
    return abs(loss_at(model, fitted, x, target, weights) - last) / abs(last)


def follow_gaps(model, settings: dict, init: dict, x: torch.Tensor,
                target: torch.Tensor, hist: Sequence[float], fitted: dict,
                last: float) -> Tuple[float, float, float]:
    """One fit against the reference: the reference follows its first
    ``len(hist)`` steps from ``init``; returns (the loss gap, the gap of
    the loss's change, the final gap of the returned params ``fitted``)."""
    ref, _ = rfit.follow(model, settings, init, x, target, len(hist))
    gap, dgap = loss_gaps(hist, ref)
    weights = rfit.point_weights(target, settings.get("fg_weight"))
    return gap, dgap, final_gap(model, fitted, x, target, weights, last)


def warm_gap(model, settings: dict, start: dict, x: torch.Tensor,
             target: torch.Tensor, fitted: dict, steps: int) -> float:
    """A warm fit against the reference's: the reference runs its
    ``steps`` steps from the program's previous answer ``start``; returns
    the gap between the reference's loss at the program's answer
    ``fitted`` and at its own, relative to the latter."""
    _, ref = rfit.follow(model, settings, start, x, target, steps)
    weights = rfit.point_weights(target, settings.get("fg_weight"))
    own = loss_at(model, ref, x, target, weights)
    return abs(loss_at(model, fitted, x, target, weights) - own) / own


def finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def worst(values) -> float:
    vals = list(values)
    return max(vals) if vals else math.nan
