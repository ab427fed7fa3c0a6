"""Normalizing flows (diffeomorphisms) for the path-connectedness prior;
counterpart of ``awesome_tpu/nn/flows.py``.

Three families, each with an analytic inverse, on (N, C) float32 points:

- :class:`DiffeomorphismNet`: two hand-rolled couplings with capped exp
  scales (`awesome/model/diffeomorphism_net.py:30-80`);
- :class:`NormalizingFlow1D`: alternating couplings with weight-normalized
  scale/translate backbones and learned scalar scales
  (`diffeomorphism_net.py:235-302`);
- :class:`RealNVPFlow`: masked affine couplings + ActNorm, the flagship
  prior's flow.

RealNVP, per flow step::

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
from awesome_tpu_torch.nn.linear import Linear, WNLinear, matmul_t, wn_weight
from awesome_tpu_torch.nn.module import Module, make_generator


def capped_exp(x, thresh: float = 5.0, slope: float = 1e-2):
    """exp(x) below ``thresh``, a linear continuation above: scale factors
    stay finite. Spec: `awesome/model/diffeomorphism_net.py:10-27`."""
    safe = torch.clamp_max(x, thresh)
    return torch.where(x < thresh, torch.exp(safe),
                       float(np.exp(thresh)) + slope * x)


class DiffeomorphismNet(Module):
    """Two coupling layers on (N, 2) whose scale/translate maps are
    1 -> hidden -> 1 relu MLPs with zero-initialized output weights (the
    flow starts as the identity)."""

    def __init__(self, hidden: int = 50, device: DeviceLike = None):
        super().__init__(device)
        self.hidden = hidden

    def _mlp_init(self, gen):
        a = Linear(1, self.hidden, device=self.device).init(gen)
        b = Linear(self.hidden, 1, device=self.device).init(gen)
        return {"a": a, "b": dict(b, w=torch.zeros_like(b["w"]))}

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        return {name: self._mlp_init(gen) for name in
                ("l1_scale", "l1_bias", "l2_scale", "l2_bias")}

    @staticmethod
    def _mlp(p, x):
        h = torch.relu(matmul_t(x, p["a"]["w"]) + p["a"]["b"])
        return matmul_t(h, p["b"]["w"]) + p["b"]["b"]

    def apply(self, params, x):
        x1, x2 = x[:, :1], x[:, 1:2]
        xx = (x2 * capped_exp(self._mlp(params["l1_scale"], x1))
              + self._mlp(params["l1_bias"], x1))
        yy = (x1 * capped_exp(self._mlp(params["l2_scale"], xx))
              + self._mlp(params["l2_bias"], xx))
        return torch.cat([xx, yy], dim=1)

    def inverse(self, params, y):
        xx, yy = y[:, :1], y[:, 1:2]
        x1 = ((yy - self._mlp(params["l2_bias"], xx))
              / capped_exp(self._mlp(params["l2_scale"], xx)))
        x2 = ((xx - self._mlp(params["l1_bias"], x1))
              / capped_exp(self._mlp(params["l1_scale"], x1)))
        return torch.cat([x1, x2], dim=1)


class SimpleBackbone(Module):
    """WNLinear -> relu -> WNLinear -> tanh. Spec:
    `awesome/model/diffeomorphism_net.py:86-105`."""

    def __init__(self, in_channels: int = 1, network_width: int = 10,
                 out_channels: Optional[int] = None,
                 device: DeviceLike = None):
        super().__init__(device)
        self.in_channels = in_channels
        self.network_width = network_width
        self.out_channels = out_channels

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        out = self.out_channels or self.in_channels
        d = self.device
        return {
            "linear1": WNLinear(self.in_channels, self.network_width,
                                device=d).init(gen),
            "linear2": WNLinear(self.network_width, out, device=d).init(gen),
        }

    def apply(self, params, x):
        p1, p2 = params["linear1"], params["linear2"]
        h = torch.relu(matmul_t(x, wn_weight(p1)) + p1["b"])
        return torch.tanh(matmul_t(h, wn_weight(p2)) + p2["b"])


class NormalBlock(Module):
    """WNLinear -> leaky_relu(0.01) -> WNLinear -> tanh. Spec:
    `awesome/model/diffeomorphism_net.py:173-196`."""

    def __init__(self, in_channels: int = 1, mid_channels: int = 128,
                 out_channels: int = 1, device: DeviceLike = None):
        super().__init__(device)
        self.in_channels = in_channels
        self.mid_channels = mid_channels
        self.out_channels = out_channels

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        d = self.device
        return {
            "in_linear": WNLinear(self.in_channels, self.mid_channels,
                                  device=d).init(gen),
            "out_linear": WNLinear(self.mid_channels, self.out_channels,
                                   device=d).init(gen),
        }

    def apply(self, params, x):
        pi, po = params["in_linear"], params["out_linear"]
        h = torch.nn.functional.leaky_relu(
            matmul_t(x, wn_weight(pi)) + pi["b"], negative_slope=0.01)
        return torch.tanh(matmul_t(h, wn_weight(po)) + po["b"])


def _wnscale_init(gen: torch.Generator, device) -> dict:
    """A learned scalar output scale, ``WN(Linear(1, 1))(weight)``: the
    scale layer's ``v ~ N(0, 1)``, ``g = 1``, ``b = 0``, and its input
    ``weight ~ 1 + 0.01 N(0, 1)``. Spec:
    `awesome/model/diffeomorphism_net.py:211-233` ``WNScale``."""
    v = torch.randn((1, 1), generator=gen)
    weight = 1.0 + 0.01 * torch.randn((1,), generator=gen)
    return {
        "scale": {"v": v.to(device), "g": torch.ones((), device=device),
                  "b": torch.zeros((1,), device=device)},
        "weight": weight.to(device),
    }


def _wnscale_apply(p) -> torch.Tensor:
    return matmul_t(p["weight"], wn_weight(p["scale"])) + p["scale"]["b"]


class NormalizingFlow1D(Module):
    """Alternating coupling flow: coupling ``i`` transforms channel ``j =
    (i + 1) % d`` conditioned on the other ``d - 1`` channels,
    ``x_j' = exp(scale_i * s_i(cond)) * x_j + t_i(cond)``. For d = 2 this is
    the reference's alternating scheme (even i: x2' = exp(s(x1)) x2 +
    t(x1)); for d > 2 the rotation its divisibility check
    (`diffeomorphism_net.py:246-249`) promises. ``backbone``: 'default'
    (:class:`SimpleBackbone`) or 'normal_block'/'residual_block'
    (:class:`NormalBlock`). Spec: `diffeomorphism_net.py:235-302`."""

    def __init__(self, num_coupling: int = 4, width: int = 130,
                 in_features: int = 2, backbone: str = "default",
                 device: DeviceLike = None):
        super().__init__(device)
        self.num_coupling = num_coupling
        self.width = width
        self.in_features = in_features
        self.backbone = backbone

    def _backbone(self) -> Module:
        cond = max(self.in_features - 1, 1)
        if self.backbone == "default":
            return SimpleBackbone(in_channels=cond, network_width=self.width,
                                  out_channels=1, device=self.device)
        if self.backbone in ("residual_block", "normal_block"):
            return NormalBlock(in_channels=cond, mid_channels=self.width,
                               out_channels=1, device=self.device)
        raise ValueError(f"Unknown backbone: {self.backbone}")

    def init(self, generator: Optional[torch.Generator] = None):
        if self.num_coupling % self.in_features != 0:
            raise ValueError("Number of coupling layers should be divisible "
                             "by in_features")
        gen = make_generator(generator)
        bb = self._backbone()
        params = {"s": [], "t": [], "scale": []}
        for _ in range(self.num_coupling):
            params["s"].append(bb.init(gen))
            params["t"].append(bb.init(gen))
            params["scale"].append(_wnscale_init(gen, self.device))
        return params

    def _couplings(self, params, cols, order):
        bb = self._backbone()
        d = self.in_features
        for i in order:
            j = (i + 1) % d
            cond = torch.cat([cols[k] for k in range(d) if k != j], dim=1)
            s = _wnscale_apply(params["scale"][i]) * bb.apply(
                params["s"][i], cond)
            yield j, s, bb.apply(params["t"][i], cond)

    def apply(self, params, x):
        cols = [x[:, j:j + 1] for j in range(self.in_features)]
        for j, s, t in self._couplings(params, cols,
                                       range(self.num_coupling)):
            cols[j] = torch.exp(s) * cols[j] + t
        return torch.cat(cols, dim=1)

    def inverse(self, params, y):
        cols = [y[:, j:j + 1] for j in range(self.in_features)]
        for j, s, t in self._couplings(
                params, cols, reversed(range(self.num_coupling))):
            cols[j] = (cols[j] - t) * torch.exp(-s)
        return torch.cat(cols, dim=1)


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
