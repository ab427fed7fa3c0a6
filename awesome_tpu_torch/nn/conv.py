"""Convolution, batch norm, pooling and resampling over NHWC images;
counterpart of ``awesome_tpu/nn/conv.py``.

Images are (B, H, W, C) at every function's boundary, as in the JAX
package. Inside, an NHWC tensor is handed to torch as its NCHW view (a
permute, no copy: torch's ``channels_last`` layout), so cuDNN runs the
convolutions on the NHWC memory as it is. Conv weights use torch's
``(out, in, kh, kw)`` layout (the JAX package stores HWIO;
``awesome_tpu_torch.bridge`` converts). Init matches torch's Conv2d
default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from awesome_tpu_torch.device import DeviceLike, resolve_device
from awesome_tpu_torch.nn import init as winit
from awesome_tpu_torch.nn.module import Module, make_generator


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor (no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of an NCHW tensor (no copy for channels_last)."""
    return x.permute(0, 2, 3, 1)


def _same_pad(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding="SAME", compute_dtype=None,
           groups: int = 1) -> torch.Tensor:
    """x: (B, H, W, Cin), w: (Cout, Cin / groups, kh, kw) -> (B, H', W',
    Cout). ``padding``: 'SAME' (XLA's: the extra pixel of an odd total on
    the high side) or 'VALID'.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): the conv's inputs are
    cast to it and its output back to the input's type, so the bias, the
    batch norm and the master params stay float32 (the backward then runs
    in that type too)."""
    out_dtype = x.dtype
    xc = _nchw(x)
    if compute_dtype is not None:
        xc, w = xc.to(compute_dtype), w.to(compute_dtype)
    if padding == "SAME":
        ph = _same_pad(x.shape[1], w.shape[2], stride)
        pw = _same_pad(x.shape[2], w.shape[3], stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"Unknown padding {padding}")
    fuse_bias = b is not None and compute_dtype is None
    y = F.conv2d(xc, w, b if fuse_bias else None, stride=stride,
                 padding=pad, groups=groups)
    y = _nhwc(y).to(out_dtype)
    if b is not None and not fuse_bias:
        y = y + b
    return y


class Conv2d(Module):
    """Conv layer over NHWC images ('SAME' padding, stride 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, bias: bool = True, groups: int = 1,
                 device: DeviceLike = None):
        super().__init__(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.bias = bias
        self.groups = groups

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        k = self.kernel_size
        cin = self.in_channels // self.groups
        bound = 1.0 / math.sqrt(k * k * cin)
        params = {"w": winit.uniform(gen, (self.out_channels, cin, k, k),
                                     bound, self.device)}
        if self.bias:
            params["b"] = winit.uniform(gen, (self.out_channels,), bound,
                                        self.device)
        return params

    def apply(self, params, x):
        return conv2d(x, params["w"], params.get("b"), groups=self.groups)


def batchnorm_init(channels: int, device: DeviceLike = None):
    """(params, state): scale 1 and bias 0; running mean 0, var 1, and an
    int32 count of the updates."""
    dev = resolve_device(device)
    return ({"scale": torch.ones((channels,), device=dev),
             "bias": torch.zeros((channels,), device=dev)},
            {"mean": torch.zeros((channels,), device=dev),
             "var": torch.ones((channels,), device=dev),
             "count": torch.zeros((), dtype=torch.int32, device=dev)})


def batchnorm_apply(params, state, x: torch.Tensor, train: bool,
                    momentum: float = 0.1, eps: float = 1e-5):
    """torch BatchNorm2d semantics on NHWC input; returns (y, new_state).

    ``train=True`` normalizes with the batch's biased variance and moves
    the running stats towards the batch mean and the unbiased variance;
    ``train=False`` normalizes with the running stats."""
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = torch.square(x - mean).mean(dim=(0, 1, 2))
        n = x.shape[0] * x.shape[1] * x.shape[2]
        with torch.no_grad():
            unbiased = var * n / max(n - 1, 1)
            new_state = {
                "mean": (1 - momentum) * state["mean"] + momentum * mean,
                "var": (1 - momentum) * state["var"] + momentum * unbiased,
                "count": state["count"] + 1,
            }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"], new_state


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2 (odd edges dropped)."""
    return _nhwc(F.max_pool2d(_nchw(x), 2, 2))


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample with half-pixel centres: what the JAX
    package's ``jax.image.resize(..., 'bilinear')`` computes (its docstring
    says ``align_corners=True``; the function does not do that)."""
    return _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="bilinear",
                              align_corners=False))


def pad_to_match(x: torch.Tensor, target_h: int, target_w: int
                 ) -> torch.Tensor:
    """Zero-pad H and W up to the skip connection's size."""
    dh = target_h - x.shape[1]
    dw = target_w - x.shape[2]
    return F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
