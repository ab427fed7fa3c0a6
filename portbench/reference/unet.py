"""The UNet in plain PyTorch, on NHWC images.

Double conv: (3x3 conv with 'same' zero padding, batch norm, relu) twice;
four 2x2 max pools down; four bilinear 2x upsamples (half-pixel centres,
``align_corners=False``) zero-padded to the skip's size and concatenated
after it; a 1x1 conv out. Training-mode batch norm normalizes with the
batch's biased variance and moves the running mean and unbiased variance
by momentum 0.1.

Each conv sees the NCHW view of the NHWC memory (torch's channels_last
layout, which cuDNN takes as it is); on the CPU the view is made
contiguous, where oneDNN's channels_last float32 conv sums less
accurately. A relu input within rounding of 0 takes the other side under
another summation order and moves the grads below it, so the reference
sums as a plain NHWC program on the card does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MOMENTUM, EPS = 0.1, 1e-5


def _nchw(x: torch.Tensor) -> torch.Tensor:
    x = x.permute(0, 3, 1, 2)
    return x.contiguous() if x.device.type == "cpu" else x


def _conv(x: torch.Tensor, c: dict, pad: int) -> torch.Tensor:
    return F.conv2d(_nchw(x), c["w"], c["b"], padding=pad).permute(
        0, 2, 3, 1)


def _bn(p: dict, s: dict, x: torch.Tensor):
    mean = x.mean(dim=(0, 1, 2))
    var = torch.square(x - mean).mean(dim=(0, 1, 2))
    n = x.shape[0] * x.shape[1] * x.shape[2]
    with torch.no_grad():
        new = {"mean": (1 - MOMENTUM) * s["mean"] + MOMENTUM * mean,
               "var": (1 - MOMENTUM) * s["var"]
               + MOMENTUM * var * n / max(n - 1, 1),
               "count": s["count"] + 1}
    return (x - mean) * torch.rsqrt(var + EPS) * p["scale"] + p["bias"], new


def _double(p: dict, s: dict, x: torch.Tensor):
    new = {}
    for i in (1, 2):
        x = _conv(x, p[f"conv{i}"], 1)
        x, new[f"bn{i}"] = _bn(p[f"bn{i}"], s[f"bn{i}"], x)
        x = torch.relu(x)
    return x, new


def apply(p: dict, s: dict, image: torch.Tensor, features: torch.Tensor):
    """Logits (B, H, W, out) and the new batch-norm state of a training
    step, from NHWC image and features."""
    x = torch.cat((image, features), dim=-1)
    new = {}
    h, new["inc"] = _double(p["inc"], s["inc"], x)
    skips = [h]
    for i in range(1, 5):
        pooled = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        h, new[f"down{i}"] = _double(p[f"down{i}"], s[f"down{i}"], pooled)
        skips.append(h)
    for i, skip in enumerate(skips[-2::-1], start=1):
        h = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2,
                          mode="bilinear", align_corners=False)
        dh, dw = skip.shape[1] - h.shape[2], skip.shape[2] - h.shape[3]
        h = F.pad(h, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        h, new[f"up{i}"] = _double(p[f"up{i}"], s[f"up{i}"],
                                   torch.cat([skip, h.permute(0, 2, 3, 1)],
                                             dim=-1))
    return _conv(h, p["outc"], 0), new
