"""Parameter initializers with torch's kaiming-family distributions;
counterpart of ``awesome_tpu/nn/init.py``.

Weights use torch's ``(out_features, in_features)`` layout, so fan_in is
``w.shape[1]``. Samples come from an explicit CPU ``torch.Generator`` and
are then moved to ``device``: the same seed gives the same parameters on
every device (the JAX PRNG stream itself cannot be reproduced, so the two
packages agree in distribution only)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def calculate_gain(activation: str, param: float = 0.0) -> float:
    """``torch.nn.init.calculate_gain`` for the activations used here."""
    if activation in ("linear", "identity", "sigmoid", "conv1d", "conv2d"):
        return 1.0
    if activation == "tanh":
        return 5.0 / 3.0
    if activation == "relu":
        return math.sqrt(2.0)
    if activation == "leaky_relu":
        return math.sqrt(2.0 / (1.0 + param**2))
    if activation == "selu":
        return 3.0 / 4.0
    raise ValueError(f"Unsupported activation: {activation}")


def uniform(generator: torch.Generator, shape, bound: float,
            device: torch.device) -> torch.Tensor:
    """U(-bound, bound) in float32."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device)


def kaiming_uniform(generator, in_features: int, out_features: int,
                    device: torch.device, activation: str = "relu",
                    param: float = 0.0) -> torch.Tensor:
    """U(-bound, bound), bound = gain * sqrt(3 / fan_in)."""
    bound = calculate_gain(activation, param) * math.sqrt(3.0 / in_features)
    return uniform(generator, (out_features, in_features), bound, device)


def kaiming_normal(generator, in_features: int, out_features: int,
                   device: torch.device, activation: str = "relu",
                   param: float = 0.0) -> torch.Tensor:
    """N(0, std^2), std = gain / sqrt(fan_in)."""
    std = calculate_gain(activation, param) / math.sqrt(in_features)
    w = torch.randn((out_features, in_features), generator=generator)
    return (w * std).to(device)


def fan_in_bias(generator, in_features: int, out_features: int,
                device: torch.device, activation: str = "relu",
                param: float = 0.0) -> torch.Tensor:
    """Bias ~ U(-std, std) with std = gain / sqrt(fan_in)."""
    std = calculate_gain(activation, param) / math.sqrt(in_features)
    return uniform(generator, (out_features,), std, device)


def torch_linear_default(generator, in_features: int, out_features: int,
                         device: torch.device, bias: bool = True):
    """torch's default ``nn.Linear`` init: weight and bias both
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(in_features)
    w = uniform(generator, (out_features, in_features), bound, device)
    b: Optional[torch.Tensor] = None
    if bias:
        b = uniform(generator, (out_features,), bound, device)
    return w, b
