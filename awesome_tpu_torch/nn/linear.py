"""Linear layers over param dicts; counterpart of
``awesome_tpu/nn/linear.py``.

Weight layout is torch's ``(out_features, in_features)``: the forward is
``x @ w.T + b``; a weight-normalized layer's direction ``v`` has the same
layout. (The JAX package stores ``(in, out)``; ``awesome_tpu_torch.bridge``
converts.)"""
from __future__ import annotations

from typing import Optional

import torch

from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.nn import init as winit
from awesome_tpu_torch.nn.module import Module, make_generator


def matmul_t(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with the JAX package's type promotion: two float types
    meet in the wider one (bf16 with float32 gives float32), where
    torch's matmul would refuse mixed operands."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt).T


class Linear(Module):
    """``torch.nn.Linear`` as a functional layer. ``init_mode``:
    'torch_default' | 'uniform' | 'normal' (kaiming, ``init_activation``)
    | 'zeros' | 'ones'."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init_mode: str = "torch_default",
                 init_activation: str = "relu", device: DeviceLike = None):
        super().__init__(device)
        self.in_features = in_features
        self.out_features = out_features
        self.bias = bias
        self.init_mode = init_mode
        self.init_activation = init_activation

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        fi, fo, dev = self.in_features, self.out_features, self.device
        if self.init_mode == "torch_default":
            w, b = winit.torch_linear_default(gen, fi, fo, dev, self.bias)
        else:
            if self.init_mode == "uniform":
                w = winit.kaiming_uniform(gen, fi, fo, dev,
                                          self.init_activation)
            elif self.init_mode == "normal":
                w = winit.kaiming_normal(gen, fi, fo, dev,
                                         self.init_activation)
            elif self.init_mode == "zeros":
                w = torch.zeros((fo, fi), device=dev)
            elif self.init_mode == "ones":
                w = torch.ones((fo, fi), device=dev)
            else:
                raise ValueError(f"Unknown init_mode {self.init_mode}")
            b = (winit.fan_in_bias(gen, fi, fo, dev, self.init_activation)
                 if self.bias else None)
        params = {"w": w}
        if self.bias:
            params["b"] = b
        return params

    def apply(self, params, x):
        y = matmul_t(x, params["w"])
        if self.bias:
            y = y + params["b"]
        return y


class PerChannelAffine(Module):
    """Per-channel scale and shift ``x * w + b`` on (N, C) points, initialized
    to the identity (the global translation in front of the flow)."""

    def __init__(self, channels: int, device: DeviceLike = None):
        super().__init__(device)
        self.channels = channels

    def init(self, generator: Optional[torch.Generator] = None):
        del generator
        return {
            "w": torch.ones((self.channels,), device=self.device),
            "b": torch.zeros((self.channels,), device=self.device),
        }

    def apply(self, params, x):
        return x * params["w"] + params["b"]

    def inverse(self, params, y):
        return (y - params["b"]) / params["w"]


def wn_weight(params) -> torch.Tensor:
    """Effective weight of a :class:`WNLinear` param dict:
    ``g * v / ||v||_F``."""
    v = params["v"]
    norm = torch.sqrt(torch.sum(v * v))
    return params["g"] * v / torch.clamp_min(norm, 1e-12)


class WNLinear(Module):
    """Weight-normalized linear with a scalar (0-d) norm ``g``, as torch's
    ``weight_norm(dim=None)``: ``w = g * v / ||v||_F``. 'torch_default'
    draws ``v`` and ``b`` as ``nn.Linear`` does and sets ``g = ||v||_F``;
    'uniform'/'normal' draw kaiming ``v`` with ``g = 1``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init_mode: str = "torch_default",
                 init_activation: str = "relu", device: DeviceLike = None):
        super().__init__(device)
        self.in_features = in_features
        self.out_features = out_features
        self.bias = bias
        self.init_mode = init_mode
        self.init_activation = init_activation

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        fi, fo, dev = self.in_features, self.out_features, self.device
        if self.init_mode == "torch_default":
            v, b = winit.torch_linear_default(gen, fi, fo, dev, self.bias)
            g = torch.sqrt(torch.sum(v * v))
        else:
            if self.init_mode == "uniform":
                v = winit.kaiming_uniform(gen, fi, fo, dev,
                                          self.init_activation)
            elif self.init_mode == "normal":
                v = winit.kaiming_normal(gen, fi, fo, dev,
                                         self.init_activation)
            else:
                raise ValueError(f"Unknown init_mode {self.init_mode}")
            g = torch.ones((), device=dev)
            b = (winit.fan_in_bias(gen, fi, fo, dev, self.init_activation)
                 if self.bias else None)
        params = {"v": v, "g": g}
        if self.bias:
            params["b"] = b
        return params

    def apply(self, params, x):
        y = matmul_t(x, wn_weight(params))
        if self.bias:
            y = y + params["b"]
        return y
