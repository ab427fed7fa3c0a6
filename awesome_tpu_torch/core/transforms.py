"""Fittable, invertible normalization transforms; counterpart of
``awesome_tpu/core/transforms.py``. A transform is a frozen dataclass of
statistics (tensors) made by ``fit``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

DimSpec = Optional[Union[int, Tuple[int, ...]]]


def _where_zero_one(span: torch.Tensor) -> torch.Tensor:
    return torch.where(span == 0, torch.ones_like(span), span)


@dataclasses.dataclass(frozen=True)
class MinMax:
    """Min-max normalization to [new_min, new_max]."""

    min: torch.Tensor
    max: torch.Tensor
    new_min: float = 0.0
    new_max: float = 1.0

    @staticmethod
    def fit(x: torch.Tensor, dim: DimSpec = None, new_min: float = 0.0,
            new_max: float = 1.0) -> "MinMax":
        if dim is None:
            return MinMax(x.amin(), x.amax(), new_min, new_max)
        return MinMax(x.amin(dim=dim, keepdim=True),
                      x.amax(dim=dim, keepdim=True), new_min, new_max)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        span = _where_zero_one(self.max - self.min)
        return ((x - self.min) / span * (self.new_max - self.new_min)
                + self.new_min)

    def inverse_transform(self, x: torch.Tensor) -> torch.Tensor:
        new_span = self.new_max - self.new_min
        return (x - self.new_min) / new_span * (self.max - self.min) + self.min

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.transform(x)


@dataclasses.dataclass(frozen=True)
class MeanStd:
    """Mean/std standardization (population std, as ``jnp.std``)."""

    mean: torch.Tensor
    std: torch.Tensor

    @staticmethod
    def fit(x: torch.Tensor, dim: DimSpec = None) -> "MeanStd":
        if dim is None:
            mean, std = x.mean(), x.std(correction=0)
        else:
            mean = x.mean(dim=dim, keepdim=True)
            std = x.std(dim=dim, correction=0, keepdim=True)
        return MeanStd(mean=mean, std=_where_zero_one(std))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std

    def inverse_transform(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.std + self.mean

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.transform(x)


def minmax(v, v_min, v_max, new_min=0.0, new_max=1.0):
    """Scalar min-max helper."""
    return (v - v_min) / (v_max - v_min) * (new_max - new_min) + new_min
