"""Spatio-temporal prior fitting: one shared (x, y, t) prior for a whole
video sequence; counterpart of ``awesome_tpu/fit/spatiotemporal.py``.

Per epoch, the frames in order, one optimizer step per frame against that
frame's weak unaries (a class-weighted SE over its labeled points), the
convexity clip after each step, and ReduceLROnPlateau on the epoch's mean
loss. The prior sees (x, y, t / t_max) points, so temporal connectedness
comes from the same architecture as spatial connectedness.

The JAX package runs the epoch x frame loops as one ``lax.scan``; here they
are Python loops that never wait on the device: the NaN guard and the
plateau state are device tensors combined with ``torch.where``, and the
losses stay on the device until the end.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from awesome_tpu_torch.core import grids as G
from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.fit import optim
from awesome_tpu_torch.fit.prior_fit import (
    FitConfig,
    _optim_fns,
    make_weight_decay_tree,
)
from awesome_tpu_torch.measures.losses import unaries_weight

Params = Any


def make_frame_weights(targets: torch.Tensor, labeled: torch.Tensor,
                       cfg: FitConfig) -> torch.Tensor:
    """(T, N, 1) unaries and (T, N) labeled masks -> (T, N, 1) point
    weights: the class weights of each frame (``cfg.weight_mode``), 0 on
    unlabeled points, over the frame's labeled count."""
    out = []
    for t, lab in zip(targets, labeled):
        w = unaries_weight(t[:, 0], mode=cfg.weight_mode) * lab.to(t.dtype)
        out.append((w / torch.clamp_min(lab.sum(), 1.0))[:, None])
    return torch.stack(out)


def make_spatiotemporal_fit_fn(model, cfg: FitConfig,
                               num_epochs: Optional[int] = None):
    """Build ``fit(params, frame_points, frame_targets, labeled_masks=None)
    -> (params, aux)``: ``frame_points`` (T, N, 3) or shared (N, 3),
    ``frame_targets`` (T, N, 1), ``labeled_masks`` (T, N) bool. ``aux``
    holds the per-epoch mean loss (``epoch_loss``, (epochs,)) and the
    plateau's final ``lr_scale``. ``num_epochs`` defaults to
    ``cfg.num_steps``."""
    epochs = num_epochs if num_epochs is not None else cfg.num_steps
    init_fn, update_fn = _optim_fns(cfg)
    clip = getattr(model, "enforce_convexity", lambda p: p)

    def loss_fn(p, pts, tgt, w):
        prob = torch.sigmoid(model.apply(p, pts))
        return torch.sum(w * (prob - tgt) ** 2)

    gv = torch.func.grad_and_value(loss_fn)

    def fit(params, frame_points, frame_targets, labeled_masks=None):
        t_frames = frame_targets.shape[0]
        dev = frame_targets.device
        if labeled_masks is None:
            labeled_masks = torch.ones(frame_targets.shape[:2],
                                       dtype=torch.bool, device=dev)
        weights = make_frame_weights(frame_targets, labeled_masks, cfg)
        wd = make_weight_decay_tree(model, params, cfg)
        pts = frame_points if frame_points.ndim == 3 else \
            frame_points.expand((t_frames,) + tuple(frame_points.shape))
        opt_state = init_fn(params)
        sched = optim.plateau_init(cfg.dtype, (), dev)
        epoch_losses = []
        for _ in range(epochs):
            losses = []
            for f in range(t_frames):
                grads, loss = gv(params, pts[f], frame_targets[f],
                                 weights[f])
                new_p, new_opt = update_fn(params, grads, opt_state,
                                           cfg.lr * sched.scale,
                                           weight_decay=wd)
                ok = torch.isfinite(loss)
                params = T.tree_where(ok, clip(new_p), params)
                opt_state = T.tree_where(ok, new_opt, opt_state)
                losses.append(loss)
            epoch_loss = torch.stack(losses).mean()
            sched = optim.plateau_update(sched, epoch_loss,
                                         factor=cfg.plateau_factor,
                                         patience=cfg.plateau_patience)
            epoch_losses.append(epoch_loss)
        return params, {"epoch_loss": torch.stack(epoch_losses),
                        "lr_scale": sched.scale}

    return fit


def fit_spatiotemporal_prior(model, params: Params,
                             frame_points: torch.Tensor,
                             frame_targets: torch.Tensor,
                             labeled_masks: Optional[torch.Tensor],
                             cfg: FitConfig,
                             num_epochs: Optional[int] = None
                             ) -> Tuple[Params, dict]:
    """The fitted shared params and aux with the per-epoch loss; for
    repeated fits build :func:`make_spatiotemporal_fit_fn` once."""
    fit = make_spatiotemporal_fit_fn(model, cfg, num_epochs)
    return fit(params, frame_points, frame_targets, labeled_masks)


def sequence_points(shape: Tuple[int, int], num_frames: int,
                    dtype=torch.float32,
                    device: DeviceLike = None) -> torch.Tensor:
    """(T, H*W, 3) (x, y, t / t_max) point matrices of a sequence."""
    h, w = shape
    t_max = max(num_frames - 1, 1)
    return torch.stack([
        G.flatten_grid(G.positional_grid(w, h, t=float(t), t_max=float(t_max),
                                         dtype=dtype, device=device)[None])
        for t in range(num_frames)])
