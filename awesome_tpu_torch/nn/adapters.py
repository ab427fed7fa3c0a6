"""Small adapter modules of the model zoo; counterpart of
``awesome_tpu/nn/adapters.py``.

- :class:`ForwardModule`: the identity, for a config slot that needs a
  no-op segmentation or prior module.
- :class:`DenseNet`: a plain dense MLP head of any depth.
- :class:`NormNet`: normalize -> net -> denormalize, for a net whose
  normalization is not folded into a composite.
- :class:`PixelMatrixSeg`: an (image, grid) segmentation net over pixel
  matrices (N, C): rgb is the last 3 channels, the rest goes in as grid.
"""
from __future__ import annotations

from typing import Optional

import torch

from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.nn.linear import Linear, matmul_t
from awesome_tpu_torch.nn.module import Module, make_generator


class ForwardModule(Module):
    def __init__(self, device: DeviceLike = None):
        super().__init__(device)

    def init(self, generator: Optional[torch.Generator] = None):
        del generator
        return {}

    def apply(self, params, x, *args, **kwargs):
        return x


class DenseNet(Module):
    def __init__(self, in_features: int = 5, out_features: int = 1,
                 width: int = 128, depth: int = 2, device: DeviceLike = None):
        super().__init__(device)
        self.in_features, self.out_features = in_features, out_features
        self.width, self.depth = width, depth

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        d = self.device
        layers = [Linear(self.in_features, self.width, device=d).init(gen)]
        layers += [Linear(self.width, self.width, device=d).init(gen)
                   for _ in range(self.depth - 1)]
        layers.append(Linear(self.width, self.out_features,
                             device=d).init(gen))
        return {"layers": layers}

    def apply(self, params, x):
        *hidden, last = params["layers"]
        for lyr in hidden:
            x = torch.relu(matmul_t(x, lyr["w"]) + lyr["b"])
        return matmul_t(x, last["w"]) + last["b"]


class NormNet(Module):
    """``net`` between a frozen normalization (MinMax or MeanStd) and its
    inverse."""

    def __init__(self, net: Module, norm=None):
        super().__init__(net.device)
        self.net = net
        self.norm = norm

    def init(self, generator: Optional[torch.Generator] = None):
        return self.net.init(generator)

    def apply(self, params, x):
        if self.norm is not None:
            x = self.norm.transform(x)
        y = self.net.apply(params, x)
        if self.norm is not None:
            y = self.norm.inverse_transform(y)
        return y

    def inverse(self, params, y):
        if self.norm is not None:
            y = self.norm.transform(y)
        x = self.net.inverse(params, y)
        if self.norm is not None:
            x = self.norm.inverse_transform(x)
        return x


class PixelMatrixSeg(Module):
    """An (image, grid)-signature segmentation net over pixel matrices."""

    def __init__(self, base: Module):
        super().__init__(base.device)
        self.base = base

    def init(self, generator: Optional[torch.Generator] = None):
        return self.base.init(generator)

    def apply(self, params, px, **kwargs):
        return self.base.apply(params, px[:, -3:], px[:, :-3])
