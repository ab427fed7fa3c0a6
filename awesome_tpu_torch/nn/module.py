"""Module protocol; counterpart of ``awesome_tpu/nn/module.py``.

A module is a ``torch.nn.Module`` that holds hyperparameters and static
buffers (e.g. coupling masks), never the trainable parameters:

- ``init(generator=None) -> params``: a nested dict of tensors on the
  module's device,
- ``apply(params, x) -> out``: the forward pass (also ``module(params, x)``).

Parameters stay in plain dicts so they can be stacked along a leading image
axis, optimized as flat buffers and projected (convexity clips) leafwise —
the same contract as the JAX param trees.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from awesome_tpu_torch.device import DeviceLike, resolve_device

Params = Any


def make_generator(generator: Optional[torch.Generator] = None,
                   seed: int = 0) -> torch.Generator:
    """The given CPU generator, or a fresh one seeded with ``seed``."""
    if generator is not None:
        return generator
    return torch.Generator().manual_seed(seed)


class Module(torch.nn.Module):
    """Base class: hyperparameters plus the device params are made on."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)

    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        raise NotImplementedError  # pragma: no cover - interface

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError  # pragma: no cover - interface

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)
