"""The priors' forward passes in plain PyTorch.

- ICNN (ConvexNextNet, the convexity prior): ``h = relu(W_in x + b)``,
  per block ``h = relu(W_ln h + b + W_skp x)``, out ``W_ln h + b + W_skp
  x``; convexity by clipping the ``ln`` weights to >= 0 after each step.
- Path-connected prior: translate ``x * w + b``, MinMax norm fitted on the
  min-max normalized coordinate grid of the frame, RealNVP (masked affine
  couplings ``z = b z + (1 - b)(z exp(s(b z)) + t(b z))`` with tanh s/t
  MLPs, the masks alternating channel 0 and 1, then ActNorm ``z exp(an_s)
  + an_t``), the inverse norm, then the ICNN.
"""
from __future__ import annotations

from typing import Tuple

import torch


def icnn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["input"]["w"].T + p["input"]["b"])
    for blk in p["skip"]:
        h = torch.relu(h @ blk["ln"]["w"].T + blk["ln"]["b"]
                       + x @ blk["skp"]["w"].T)
    out = p["out"]
    return h @ out["ln"]["w"].T + out["ln"]["b"] + x @ out["skp"]["w"].T


def icnn_clip(p: dict) -> dict:
    return {
        "input": p["input"],
        "skip": [{"ln": {"w": torch.relu(b["ln"]["w"]), "b": b["ln"]["b"]},
                  "skp": b["skp"]} for b in p["skip"]],
        "out": {"ln": {"w": torch.relu(p["out"]["ln"]["w"]),
                       "b": p["out"]["ln"]["b"]},
                "skp": p["out"]["skp"]},
    }


def minmax_stats(h: int, w: int, channels: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel min and max of the frame's coordinate grid after its
    own min-max normalization (x = column, y = row)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1)][:channels], dim=1)
    lo, hi = grid.amin(dim=0), grid.amax(dim=0)
    span = torch.where(hi - lo == 0, torch.ones_like(hi), hi - lo)
    norm = (grid - lo) / span
    return norm.amin(dim=0), norm.amax(dim=0)


class PathConnected:
    def __init__(self, cfg: dict, h: int, w: int, device):
        self.channels = cfg.get("channels", 2)
        self.lo, self.hi = minmax_stats(h, w, self.channels, device)
        span = self.hi - self.lo
        self.span = torch.where(span == 0, torch.ones_like(span), span)
        n = cfg["flow_n_flows"]
        self.masks = [torch.tensor([1.0, 0.0] if i % 2 == 0 else [0.0, 1.0],
                                   device=device) for i in range(n)]

    @staticmethod
    def _mlp(p, z):
        h = torch.relu(z @ p["l1"]["w"].T + p["l1"]["b"])
        return torch.tanh(h @ p["l2"]["w"].T + p["l2"]["b"])

    def deformation(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        z = x * p["linear"]["w"] + p["linear"]["b"]
        z = (z - self.lo) / self.span
        for step, b in zip(p["flow"]["steps"], self.masks):
            zm = b * z
            s, t = self._mlp(step["s"], zm), self._mlp(step["t"], zm)
            z = zm + (1.0 - b) * (z * torch.exp(s) + t)
            z = z * torch.exp(step["an_s"]) + step["an_t"]
        return z * (self.hi - self.lo) + self.lo

    def apply(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return icnn_apply(p["convex"], self.deformation(p, x))

    @staticmethod
    def clip(p: dict) -> dict:
        return dict(p, convex=icnn_clip(p["convex"]))

    @staticmethod
    def weight_decay(p: dict, flow_wd: float) -> dict:
        """The optimizer's groups: the flow's leaves decay, the rest not."""
        from portbench.reference.layout import tree_map

        return {k: tree_map(lambda _, k=k: flow_wd if k == "flow" else 0.0,
                            v) for k, v in p.items()}


class Convex:
    def __init__(self, cfg: dict, h: int, w: int, device):
        del cfg, h, w, device

    @staticmethod
    def apply(p: dict, x: torch.Tensor) -> torch.Tensor:
        return icnn_apply(p, x)

    @staticmethod
    def clip(p: dict) -> dict:
        return icnn_clip(p)

    @staticmethod
    def weight_decay(p: dict, flow_wd: float) -> dict:
        from portbench.reference.layout import tree_map

        del flow_wd
        return tree_map(lambda _: 0.0, p)


def model(cfg: dict, h: int, w: int, device):
    cls = PathConnected if cfg["prior"] == "path_connected" else Convex
    return cls(cfg, h, w, device)
