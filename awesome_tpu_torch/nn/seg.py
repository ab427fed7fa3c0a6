"""Segmentation networks: pointwise MLPs (Net, FCNet) and conv nets
(CNNNet, UNet); counterpart of ``awesome_tpu/nn/seg.py``.

Pointwise nets take (N, C) point matrices; conv nets take NHWC images.
``concat_input`` is the rgb | xy | rgbxy input switch. The UNet's batch
norm is stateful: ``init`` returns ``(params, state)`` and ``apply``
returns ``(logits, new_state)``; ``train=False`` uses the running stats.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.nn.conv import (
    Conv2d,
    batchnorm_apply,
    batchnorm_init,
    conv2d,
    max_pool2x2,
    pad_to_match,
    upsample_bilinear_2x,
)
from awesome_tpu_torch.nn.linear import Linear, matmul_t
from awesome_tpu_torch.nn.module import Module, make_generator


def concat_input(in_type: str, image, grid, axis: int = -1):
    """rgb | xy | rgbxy input selection."""
    if in_type == "rgb":
        return image
    if in_type == "xy":
        return grid
    if in_type == "rgbxy":
        return torch.cat((image, grid), dim=axis)
    raise ValueError(
        f"in_type must be one of: rgb, xy, rgbxy but was: {in_type}")


def _mlp(layers, x):
    """relu MLP over Linear param dicts; the last layer is linear."""
    *hidden, last = layers
    for lyr in hidden:
        x = torch.relu(matmul_t(x, lyr["w"]) + lyr["b"])
    return matmul_t(x, last["w"]) + last["b"]


class Net(Module):
    """in_features -> n_hidden -> n_hidden -> 1 pointwise MLP over (y, x,
    r, g, b) pixels: the convexity benchmark's segmentor."""

    def __init__(self, n_hidden: int = 130, in_features: int = 5,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_hidden = n_hidden
        self.in_features = in_features

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        n, d = self.n_hidden, self.device
        return {"W0": Linear(self.in_features, n, device=d).init(gen),
                "W1": Linear(n, n, device=d).init(gen),
                "W2": Linear(n, 1, device=d).init(gen)}

    def apply(self, params, x):
        return _mlp([params["W0"], params["W1"], params["W2"]], x)


class FCNet(Module):
    """Pointwise MLP of any width and depth, with the in_type switch."""

    def __init__(self, in_chn: int, out_chn: int, width: int, depth: int,
                 in_type: str = "rgbxy", device: DeviceLike = None):
        super().__init__(device)
        self.in_chn, self.out_chn = in_chn, out_chn
        self.width, self.depth = width, depth
        self.in_type = in_type

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        d = self.device
        layers = [Linear(self.in_chn, self.width, device=d).init(gen)]
        layers += [Linear(self.width, self.width, device=d).init(gen)
                   for _ in range(self.depth)]
        layers.append(Linear(self.width, self.out_chn, device=d).init(gen))
        return {"layers": layers}

    def apply(self, params, image, grid):
        return _mlp(params["layers"],
                    concat_input(self.in_type, image, grid))


class CNNNet(Module):
    """Conv net of any width and depth (LeakyReLU after the first conv,
    ReLU after the rest, a 1x1 conv out); NHWC images."""

    def __init__(self, in_chn: int, out_chn: int, kernel_size: int = 3,
                 width: int = 32, depth: int = 2, in_type: str = "rgbxy",
                 device: DeviceLike = None):
        super().__init__(device)
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        self.in_chn, self.out_chn = in_chn, out_chn
        self.kernel_size, self.width, self.depth = kernel_size, width, depth
        self.in_type = in_type

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        k, wd, d = self.kernel_size, self.width, self.device
        convs = [Conv2d(self.in_chn, wd, k, device=d).init(gen)]
        convs += [Conv2d(wd, wd, k, device=d).init(gen)
                  for _ in range(self.depth)]
        convs.append(Conv2d(wd, self.out_chn, 1, device=d).init(gen))
        return {"convs": convs}

    def apply(self, params, image, grid):
        x = concat_input(self.in_type, image, grid)
        first, *blocks, last = params["convs"]
        x = F.leaky_relu(conv2d(x, first["w"], first.get("b")), 0.01)
        for blk in blocks:
            x = torch.relu(conv2d(x, blk["w"], blk.get("b")))
        return conv2d(x, last["w"], last.get("b"))


def _double_conv_init(gen, in_ch: int, out_ch: int, device):
    p1, s1 = batchnorm_init(out_ch, device)
    p2, s2 = batchnorm_init(out_ch, device)
    conv1 = Conv2d(in_ch, out_ch, 3, device=device).init(gen)
    conv2 = Conv2d(out_ch, out_ch, 3, device=device).init(gen)
    return ({"conv1": conv1, "bn1": p1, "conv2": conv2, "bn2": p2},
            {"bn1": s1, "bn2": s2})


def _double_conv_apply(params, state, x, train, compute_dtype=None):
    new_state = {}
    for i in (1, 2):
        conv = params[f"conv{i}"]
        x = conv2d(x, conv["w"], conv.get("b"), compute_dtype=compute_dtype)
        x, new_state[f"bn{i}"] = batchnorm_apply(
            params[f"bn{i}"], state[f"bn{i}"], x, train)
        x = torch.relu(x)
    return x, new_state


def _dtype(compute_dtype):
    """A torch dtype from a dtype or its name ('bfloat16')."""
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, str(compute_dtype))


class UNet(Module):
    """4-down / 4-up UNet on concat(image, features): double convs (3x3
    conv, batch norm, relu, twice), 2x2 max pools, bilinear 2x upsamples
    padded to the skip's size, a 1x1 conv out. ``compute_dtype`` (e.g.
    'bfloat16') runs every conv in that type, with float32 batch norm and
    master params (see ``nn.conv.conv2d``)."""

    DOWN = ((64, 128), (128, 256), (256, 512), (512, 512))
    # an Up block's conv sees cat(skip, upsampled): in_ch channels in all
    UP = ((1024, 256), (512, 128), (256, 64), (128, 64))

    def __init__(self, in_chn: int = 5, out_chn: int = 1,
                 compute_dtype=None, device: DeviceLike = None):
        super().__init__(device)
        self.in_chn = in_chn
        self.out_chn = out_chn
        self.compute_dtype = compute_dtype

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        d = self.device
        params, state = {}, {}
        params["inc"], state["inc"] = _double_conv_init(gen, self.in_chn, 64,
                                                        d)
        for i, (ci, co) in enumerate(self.DOWN, start=1):
            params[f"down{i}"], state[f"down{i}"] = _double_conv_init(
                gen, ci, co, d)
        for i, (ci, co) in enumerate(self.UP, start=1):
            params[f"up{i}"], state[f"up{i}"] = _double_conv_init(gen, ci,
                                                                  co, d)
        params["outc"] = Conv2d(64, self.out_chn, 1, device=d).init(gen)
        return params, state

    def apply(self, params, state, image, features, train: bool = False):
        cd = _dtype(self.compute_dtype)
        x = torch.cat((image, features), dim=-1)
        new_state = {}
        h, new_state["inc"] = _double_conv_apply(params["inc"], state["inc"],
                                                 x, train, cd)
        skips = [h]
        for i in range(1, 5):
            h, new_state[f"down{i}"] = _double_conv_apply(
                params[f"down{i}"], state[f"down{i}"], max_pool2x2(h), train,
                cd)
            skips.append(h)
        for i, skip in enumerate(skips[-2::-1], start=1):
            h = pad_to_match(upsample_bilinear_2x(h), skip.shape[1],
                             skip.shape[2])
            h, new_state[f"up{i}"] = _double_conv_apply(
                params[f"up{i}"], state[f"up{i}"],
                torch.cat([skip, h], dim=-1), train, cd)
        out = conv2d(h, params["outc"]["w"], params["outc"].get("b"),
                     compute_dtype=cd)
        return out, new_state
