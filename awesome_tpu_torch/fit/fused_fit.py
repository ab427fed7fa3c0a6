"""Fused flagship fit: each step is ONE call of the fused loss+grad
(``awesome_tpu_torch.ops.flagship``: the CUDA kernel on the card) plus the
optimizer update on the flat parameter rows; counterpart of
``awesome_tpu/fit/fused_fit.py``.

Semantics are those of :func:`awesome_tpu_torch.fit.prior_fit.make_fit_fn`
(Adamax with the flow weight-decay group, convexity clip after the step,
ReduceLROnPlateau, NaN guard on the loss, LR-watchdog freeze). The params
are kept as one (G, P) tensor in the kernel's row layout for the whole
fit, so the update is a few elementwise ops on one buffer per step; the
param trees are packed once before and unpacked once after.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.fit.prior_fit import (
    FitConfig,
    _stacked_weights,
    make_point_weights,
    run_fit_loop,
)
from awesome_tpu_torch.ops.flagship import (
    FlagshipLossGrad,
    make_flagship_loss_grad,
    pack_flagship,
    pack_flat,
    packed_weight_decay,
    unpack_flagship,
    unpack_flat,
)

Params = Any


class _FlatFit:
    """What every fused engine shares: the loss+grad, the per-column weight
    decay and convexity mask of a flat row, and the pack/unpack of trees."""

    def __init__(self, model, cfg: FitConfig, tile_n: Optional[int],
                 group: int = 1, interleave: bool = False):
        self.model = model
        self.cfg = cfg
        # compute_dtype: the kernel's bf16 build (bf16 product operands,
        # FP32 master params and loss), as the JAX fused fit does
        self.fused: FlagshipLossGrad = make_flagship_loss_grad(
            model, use_sigmoid=cfg.use_sigmoid, tile_n=tile_n, group=group,
            interleave=interleave, use_bf16=cfg.compute_dtype is not None)
        self.spec = self.fused.spec
        off, p_len = self.spec.offsets()
        wd = packed_weight_decay(self.spec.field_shapes(),
                                 cfg.flow_weight_decay)
        dev = model.device
        self.wd = torch.zeros(p_len, device=dev)
        self.convex = torch.zeros(p_len, dtype=torch.bool, device=dev)
        for name, shape in self.spec.field_shapes().items():
            size = int(torch.Size(shape).numel())
            self.wd[off[name]:off[name] + size] = wd[name]
            if name in ("wln", "wout"):
                self.convex[off[name]:off[name] + size] = True

    def clip(self, flat: torch.Tensor) -> torch.Tensor:
        """``packed_enforce_convexity`` on flat rows."""
        return torch.where(self.convex, torch.clamp_min(flat, 0.0), flat)

    def pack(self, stacked: Params) -> torch.Tensor:
        """Stacked param tree (leading image axis) -> (G, P)."""
        g = T.tree_leaves(stacked)[0].shape[0]
        return pack_flat(pack_flagship(self.model, stacked),
                         g).contiguous()

    def unpack(self, flat: torch.Tensor) -> Params:
        tree = unpack_flagship(self.model, unpack_flat(self.spec, flat))
        return T.tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format), tree)

    def run(self, flat, points, targets, weights, active, batch_shape,
            group_mean):
        x = points.contiguous()
        g = flat.shape[0]
        tgt = targets.reshape(g, -1).contiguous()
        wpt = weights.reshape(g, -1).contiguous()
        squeeze = batch_shape == ()

        def loss_grad(p):
            loss, grads = self.fused.flat(p, x, tgt, wpt)
            return (loss[0] if squeeze else loss), grads

        return run_fit_loop(loss_grad, flat, self.cfg, self.wd, self.clip,
                            active, batch_shape=batch_shape,
                            group_mean=group_mean)


def make_fused_fit_fn(model, cfg: FitConfig,
                      tile_n: Optional[int] = None) -> Callable:
    """Build ``fit(params, points, target_points, active=True,
    point_mask=None) -> (params, aux)`` on the fused kernel; same contract
    as ``prior_fit.make_fit_fn`` (param trees in and out)."""
    eng = _FlatFit(model, cfg, tile_n)

    def fit(params, points, target_points, active=True, point_mask=None):
        weights = make_point_weights(target_points, cfg, point_mask)
        flat = eng.pack(T.tree_map(lambda t: t[None], params))
        flat, hist, scale = eng.run(flat, points, target_points, weights,
                                    active, (), False)
        return T.tree_select(eng.unpack(flat), 0), {
            "loss_hist": hist, "lr_scale": scale}

    return fit


def make_batched_fused_fit_fn(model, cfg: FitConfig,
                              tile_n: Optional[int] = None) -> Callable:
    """The batched fit on the fused kernel: the images are the kernel's
    leading axis, with shared points (N, 2) or one set per image (B, N,
    2); every image keeps its own optimizer, plateau and NaN-guard state
    (what ``vmap`` of the single fit gives).
    ``engine(stacked_params, points, targets, active (B,),
    point_masks=None) -> (params, aux)`` with ``loss_hist`` (B, steps)."""
    eng = _FlatFit(model, cfg, tile_n)

    def engine(stacked, points, targets, active, point_masks=None):
        weights = _stacked_weights(targets, cfg, point_masks)
        flat, hist, scale = eng.run(eng.pack(stacked), points, targets,
                                    weights, active, (targets.shape[0],),
                                    False)
        return eng.unpack(flat), {"loss_hist": hist.T, "lr_scale": scale}

    return engine


def make_grouped_fused_fit_fn(model, cfg: FitConfig, group: int,
                              tile_n: Optional[int] = None,
                              interleave: bool = False) -> Callable:
    """Grouped fused fit ``fit(stacked_params, points, stacked_targets,
    active=True, point_masks=None) -> (stacked_params, aux)``: the group's
    images share one kernel call per step, and the plateau scheduler and
    NaN guard act on the MEAN loss of the group (one LR for the group).
    Per-image losses come back in ``aux['loss_hist']`` (steps, G).
    ``interleave=True`` (``group >= 2``) is the JAX package's TPU schedule
    of the same function; here it runs the same grouped kernel (see
    ``ops.flagship.make_flagship_loss_grad``)."""
    eng = _FlatFit(model, cfg, tile_n, group, interleave)

    def fit(stacked_params, points, stacked_targets, active=True,
            point_masks=None):
        if stacked_targets.shape[0] != group:
            raise ValueError(f"expected {group} images, got "
                             f"{stacked_targets.shape[0]}")
        weights = _stacked_weights(stacked_targets, cfg, point_masks)
        flat, hist, scale = eng.run(eng.pack(stacked_params), points,
                                    stacked_targets, weights, active,
                                    (stacked_targets.shape[0],), True)
        return eng.unpack(flat), {"loss_hist": hist, "lr_scale": scale}

    return fit


def fit_prior_fused(model, params: Params, points, target_points,
                    cfg: FitConfig) -> Tuple[Params, dict]:
    """Single-image fused fit: one call of the fused loss+grad per step
    (on the card one K1 launch; on CPU tensors its plain version)."""
    return make_fused_fit_fn(model, cfg)(params, points, target_points)
