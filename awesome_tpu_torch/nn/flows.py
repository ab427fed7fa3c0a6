"""RealNVP flow (masked affine couplings + ActNorm) for the
path-connectedness prior; counterpart of ``RealNVPFlow`` and
``binary_counting_masks`` in ``awesome_tpu/nn/flows.py``.

Points are (N, C) float32. Per flow step::

    coupling: z = b*z + (1-b) * (z * exp(s(b*z)) + t(b*z))
    ActNorm:  z = z * exp(an_s) + an_t

``s`` and ``t`` are [C, hidden, C] MLPs (relu, zero-initialized last
layer, optional tanh/sigmoid/clampexp output). The masks ``b`` are a
registered buffer, never a parameter: an optimizer step on a mask would
break bijectivity.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.nn.linear import Linear, matmul_t
from awesome_tpu_torch.nn.module import Module, make_generator


def binary_counting_masks(channels: int, n_flows: int) -> np.ndarray:
    """Coupling masks enumerating all non-trivial binary channel subsets,
    repeated and cropped to ``n_flows`` — (n_flows, channels) float32.
    For 2 channels, even flows keep channel 0 and odd flows channel 1."""
    vals = np.arange(1, 2**channels - 1, dtype=np.int64)
    bits = np.arange(channels)
    all_masks = ((vals[:, None] >> bits[None, :]) & 1).astype(np.float32)
    reps = int(np.ceil(n_flows / len(all_masks)))
    return np.tile(all_masks, (reps, 1))[:n_flows]


class RealNVPFlow(Module):
    """Masked affine couplings (zero-initialized s/t MLPs) + ActNorm.
    ActNorm starts as the identity; :meth:`actnorm_data_init` sets it from
    data."""

    masks: torch.Tensor

    def __init__(self, channels: int = 2, hidden_units: int = 130,
                 n_flows: int = 6, output_fn: Optional[str] = None,
                 output_scale: Optional[float] = None,
                 device: DeviceLike = None):
        super().__init__(device)
        self.channels = channels
        self.hidden_units = hidden_units
        self.n_flows = n_flows
        self.output_fn = output_fn
        self.output_scale = output_scale
        self.register_buffer("masks", torch.as_tensor(
            binary_counting_masks(channels, n_flows), device=self.device))

    def _mlp_init(self, gen):
        lin1 = Linear(self.channels, self.hidden_units,
                      device=self.device).init(gen)
        # init_zeros: the last layer's weight AND bias start at zero
        lin2 = {
            "w": torch.zeros((self.channels, self.hidden_units),
                             device=self.device),
            "b": torch.zeros((self.channels,), device=self.device),
        }
        return {"l1": lin1, "l2": lin2}

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        steps = []
        for _ in range(self.n_flows):
            steps.append({
                "s": self._mlp_init(gen),
                "t": self._mlp_init(gen),
                "an_s": torch.zeros((self.channels,), device=self.device),
                "an_t": torch.zeros((self.channels,), device=self.device),
            })
        return {"steps": steps}

    def _out_fn(self, out):
        if self.output_fn == "tanh":
            out = torch.tanh(out)
        elif self.output_fn == "sigmoid":
            out = torch.sigmoid(out)
        elif self.output_fn == "clampexp":
            out = torch.clamp_max(out, 0.0)
        if self.output_scale is not None:
            out = out * self.output_scale
        return out

    def _mlp(self, p, x):
        h = torch.relu(matmul_t(x, p["l1"]["w"]) + p["l1"]["b"])
        return self._out_fn(matmul_t(h, p["l2"]["w"]) + p["l2"]["b"])

    def _st(self, step, zm):
        """s and t with their first layers merged into one matmul."""
        w1 = torch.cat([step["s"]["l1"]["w"], step["t"]["l1"]["w"]], dim=0)
        b1 = torch.cat([step["s"]["l1"]["b"], step["t"]["l1"]["b"]])
        h = torch.relu(matmul_t(zm, w1) + b1)
        hs, ht = h[:, :self.hidden_units], h[:, self.hidden_units:]
        s = matmul_t(hs, step["s"]["l2"]["w"]) + step["s"]["l2"]["b"]
        t = matmul_t(ht, step["t"]["l2"]["w"]) + step["t"]["l2"]["b"]
        return self._out_fn(s), self._out_fn(t)

    def apply(self, params, x):
        z = x
        for step, b in zip(params["steps"], self.masks):
            zm = b * z
            s, t = self._st(step, zm)
            z = zm + (1.0 - b) * (z * torch.exp(s) + t)
            z = z * torch.exp(step["an_s"]) + step["an_t"]
        return z

    def inverse(self, params, y):
        z = y
        for step, b in zip(reversed(params["steps"]), self.masks.flip(0)):
            z = (z - step["an_t"]) * torch.exp(-step["an_s"])
            zm = b * z
            s = self._mlp(step["s"], zm)
            t = self._mlp(step["t"], zm)
            z = zm + (1.0 - b) * (z - t) * torch.exp(-s)
        return z

    def actnorm_data_init(self, params, x):
        """Data-dependent ActNorm init: each ActNorm's output over ``x`` gets
        zero mean and unit std, layer by layer. Returns updated params."""
        z = x
        new_steps = []
        for step, b in zip(params["steps"], self.masks):
            zm = b * z
            s = self._mlp(step["s"], zm)
            t = self._mlp(step["t"], zm)
            z = zm + (1.0 - b) * (z * torch.exp(s) + t)
            std = torch.clamp_min(z.std(dim=0, correction=0), 1e-12)
            an_s = -torch.log(std)
            an_t = -(z.mean(dim=0)) * torch.exp(an_s)
            z = z * torch.exp(an_s) + an_t
            new_steps.append(dict(step, an_s=an_s, an_t=an_t))
        return {"steps": new_steps}
