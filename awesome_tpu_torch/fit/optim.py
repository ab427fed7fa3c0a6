"""Optimizers and the plateau schedule as pure state transitions over param
trees; counterpart of ``awesome_tpu/fit/optim.py``.

torch.optim semantics (Adamax's infinity norm, coupled L2 weight decay,
ReduceLROnPlateau in 'min'/'rel' mode), but the learning rate and every
piece of state are device tensors, so a fit loop never waits on the host.
Weight decay is given per leaf (a tree of floats or tensors). Scalars of
the state may carry a leading image axis ``(B,)``; they broadcast against
leaves whose leading axis is the image axis.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from awesome_tpu_torch.core.tree import lead, tree_leaves, tree_map

Params = Any


def _zero_wd(params: Params) -> Params:
    return tree_map(lambda _: 0.0, params)


def _count0(params: Params, batch_shape: Tuple[int, ...]) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros(batch_shape, dtype=torch.int32, device=dev)


class AdamaxState(NamedTuple):
    count: torch.Tensor  # int32, () or (B,)
    m: Params  # first moment
    u: Params  # infinity norm


def adamax_init(params: Params, batch_shape: Tuple[int, ...] = ()
                ) -> AdamaxState:
    return AdamaxState(count=_count0(params, batch_shape),
                       m=tree_map(torch.zeros_like, params),
                       u=tree_map(torch.zeros_like, params))


def adamax_update(params: Params, grads: Params, state: AdamaxState, lr,
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  weight_decay: Optional[Params] = None):
    """torch.optim.Adamax."""
    count = state.count + 1
    bc = 1.0 - b1 ** count.to(torch.float32)
    step = lr / bc
    wd = weight_decay if weight_decay is not None else _zero_wd(params)
    g = tree_map(lambda g_, p, w: g_ + w * p, grads, params, wd)
    m = tree_map(lambda m_, g_: b1 * m_ + (1.0 - b1) * g_, state.m, g)
    u = tree_map(lambda u_, g_: torch.maximum(b2 * u_, torch.abs(g_) + eps),
                 state.u, g)
    new_params = tree_map(lambda p, m_, u_: p - lead(step, p) * m_ / u_,
                          params, m, u)
    return new_params, AdamaxState(count=count, m=m, u=u)


class AdamState(NamedTuple):
    count: torch.Tensor
    m: Params
    v: Params


def adam_init(params: Params, batch_shape: Tuple[int, ...] = ()
              ) -> AdamState:
    return AdamState(count=_count0(params, batch_shape),
                     m=tree_map(torch.zeros_like, params),
                     v=tree_map(torch.zeros_like, params))


def adam_update(params: Params, grads: Params, state: AdamState, lr,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: Optional[Params] = None):
    """torch.optim.Adam (coupled L2 weight decay)."""
    count = state.count + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    wd = weight_decay if weight_decay is not None else _zero_wd(params)
    g = tree_map(lambda g_, p, w: g_ + w * p, grads, params, wd)
    m = tree_map(lambda m_, g_: b1 * m_ + (1.0 - b1) * g_, state.m, g)
    v = tree_map(lambda v_, g_: b2 * v_ + (1.0 - b2) * g_ * g_, state.v, g)
    new_params = tree_map(
        lambda p, m_, v_: p - lead(lr, p) * (m_ / lead(bc1, p)) / (
            torch.sqrt(v_ / lead(bc2, p)) + eps),
        params, m, v,
    )
    return new_params, AdamState(count=count, m=m, v=v)


class PlateauState(NamedTuple):
    """ReduceLROnPlateau (mode='min', threshold_mode='rel',
    threshold=1e-4, cooldown=0): after more than ``patience`` steps without
    improvement the LR scale is multiplied by ``factor``."""

    best: torch.Tensor
    num_bad: torch.Tensor
    scale: torch.Tensor


def plateau_init(dtype=torch.float32, batch_shape: Tuple[int, ...] = (),
                 device=None) -> PlateauState:
    return PlateauState(
        best=torch.full(batch_shape, float("inf"), dtype=dtype,
                        device=device),
        num_bad=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        scale=torch.ones(batch_shape, dtype=dtype, device=device),
    )


def plateau_update(state: PlateauState, loss, factor: float = 0.5,
                   patience: int = 200, threshold: float = 1e-4,
                   min_scale: float = 0.0) -> PlateauState:
    improved = loss < state.best * (1.0 - threshold)
    best = torch.where(improved, loss, state.best)
    num_bad = torch.where(improved, torch.zeros_like(state.num_bad),
                          state.num_bad + 1)
    reduce_now = num_bad > patience
    scale = torch.where(
        reduce_now, torch.clamp_min(state.scale * factor, min_scale),
        state.scale)
    num_bad = torch.where(reduce_now, torch.zeros_like(num_bad), num_bad)
    return PlateauState(best=best, num_bad=num_bad, scale=scale)
