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

On a mesh (``mesh=``) the frames' points are split over the grid axis and
the shared prior is replicated: the frame weights' counts and each frame
step's loss and grads are summed over the grid group.
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
    summed_over_points,
)
from awesome_tpu_torch.measures.losses import unaries_weight

Params = Any


def make_frame_weights(targets: torch.Tensor, labeled: torch.Tensor,
                       cfg: FitConfig, grid_sum=None) -> torch.Tensor:
    """(T, N, 1) unaries and (T, N) labeled masks -> (T, N, 1) point
    weights: the class weights of each frame (``cfg.weight_mode``), 0 on
    unlabeled points, over the frame's labeled count. ``grid_sum``: the
    points are this rank's block of each frame, the counts summed over
    the blocks."""
    total = grid_sum or (lambda c: c)
    out = []
    for t, lab in zip(targets, labeled):
        w = unaries_weight(t[:, 0], mode=cfg.weight_mode,
                           count_sum=grid_sum) * lab.to(t.dtype)
        out.append((w / torch.clamp_min(total(lab.sum()), 1.0))[:, None])
    return torch.stack(out)


def make_spatiotemporal_fit_fn(model, cfg: FitConfig,
                               num_epochs: Optional[int] = None, mesh=None):
    """Build ``fit(params, frame_points, frame_targets, labeled_masks=None)
    -> (params, aux)``: ``frame_points`` (T, N, 3) or shared (N, 3),
    ``frame_targets`` (T, N, 1), ``labeled_masks`` (T, N) bool. ``aux``
    holds the per-epoch mean loss (``epoch_loss``, (epochs,)) and the
    plateau's final ``lr_scale``. ``num_epochs`` defaults to
    ``cfg.num_steps``. ``mesh``: every rank passes the whole sequence and
    gets the same params; each steps on its block of every frame's
    points (the 'grid' axis)."""
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
        pts = frame_points if frame_points.ndim == 3 else \
            frame_points.expand((t_frames,) + tuple(frame_points.shape))
        grid_sum = None
        if mesh is not None:
            n = frame_targets.shape[1]
            gs = mesh.local("grid", n)
            pts, frame_targets = pts[:, gs], frame_targets[:, gs]
            labeled_masks = labeled_masks[:, gs]
            grid_sum = mesh.reducer("grid", n)
        weights = make_frame_weights(frame_targets, labeled_masks, cfg,
                                     grid_sum)
        wd = make_weight_decay_tree(model, params, cfg)

        def loss_grad(p, f):
            grads, loss = gv(p, pts[f], frame_targets[f], weights[f])
            return loss, grads
        opt_state = init_fn(params)
        sched = optim.plateau_init(cfg.dtype, (), dev)
        epoch_losses = []
        for _ in range(epochs):
            losses = []
            for f in range(t_frames):
                loss, grads = summed_over_points(
                    lambda p: loss_grad(p, f), grid_sum)(params)
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
                             num_epochs: Optional[int] = None, mesh=None
                             ) -> Tuple[Params, dict]:
    """The fitted shared params and aux with the per-epoch loss; for
    repeated fits build :func:`make_spatiotemporal_fit_fn` once."""
    fit = make_spatiotemporal_fit_fn(model, cfg, num_epochs, mesh)
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
