"""Joint training: the segmentation net and the per-image priors in one
step; counterpart of the joint step and epoch of
``awesome_tpu/fit/trainer.py``.

The priors of ALL images live in one stacked param tree (a leading image
axis), with their optimizer moments stacked beside them. A step gathers
the batch's slices by ``batch['index']``, applies the prior to each image
(``torch.func.vmap``), computes the joint loss, updates the shared seg
params and the gathered prior slices (the convexity clip after the
update), and scatters the slices back. Nothing in a step waits on the
host: the NaN guard and the padded-sample mask are device tensors
combined with ``torch.where``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.fit import optim
from awesome_tpu_torch.measures.losses import (
    bce,
    fbms_joint_loss,
    unaries_weighted_loss,
)
from awesome_tpu_torch.nn.module import make_generator

Params = Any


@dataclasses.dataclass(frozen=True)
class JointTrainConfig:
    """The joint FBMS config's defaults: lr 1e-4, Adam on the seg net,
    Adamax on the priors, sssdms-weighted BCE plus the soft-clipped SE
    penalty."""

    lr: float = 1e-4
    prior_lr: float = 1e-4
    optimizer: str = "adam"
    prior_optimizer: str = "adamax"
    flow_weight_decay: float = 1e-5
    alpha: float = 1.0
    beta: float = 1.0
    clip_penalty: bool = True
    train_segmentation: bool = True
    nan_guard: bool = True


class JointTrainState(NamedTuple):
    seg_params: Params
    seg_state: Any  # batch-norm running stats (or None)
    seg_opt: Any
    prior_params: Params  # stacked over ALL dataset images
    prior_opt: Any  # stacked optimizer state
    step: torch.Tensor


def _optim(name: str):
    return {"adam": (optim.adam_init, optim.adam_update),
            "adamax": (optim.adamax_init, optim.adamax_update)}[name]


def joint_train_init(wrapper, generator: Optional[torch.Generator],
                     num_images: int, cfg: JointTrainConfig,
                     seg_init=None, prior_init=None) -> JointTrainState:
    """The train state: seg params (and state) and stacked per-image prior
    params, fresh ones or ``prior_init`` (e.g. the pretrained priors)."""
    gen = make_generator(generator)
    if seg_init is not None:
        seg_params, seg_state = seg_init
    elif wrapper.seg_stateful:
        seg_params, seg_state = wrapper.segmentation_module.init(gen)
    else:
        seg_params, seg_state = wrapper.segmentation_module.init(gen), None
    seg_opt = _optim(cfg.optimizer)[0](seg_params)
    if wrapper.prior_module is None:
        prior_params, prior_opt = {}, {}
    else:
        prior_params = prior_init if prior_init is not None else \
            T.stack_trees([wrapper.prior_module.init(gen)
                           for _ in range(num_images)])
        prior_opt = _optim(cfg.prior_optimizer)[0](prior_params,
                                                   (num_images,))
    dev = T.tree_leaves(seg_params)[0].device
    return JointTrainState(seg_params, seg_state, seg_opt, prior_params,
                           prior_opt, torch.zeros((), dtype=torch.int32,
                                                  device=dev))


def _default_loss_fn(cfg: JointTrainConfig, has_prior: bool) -> Callable:
    """The joint loss on NHWC (B, H, W, 2) [seg, prior] outputs (the
    sssdms-weighted BCE alone without a prior); with per-sample weights,
    each sample's loss (its own class weights) weighted and normalized."""

    def one(out_cf, tgt_cf):
        if has_prior:
            return fbms_joint_loss(out_cf, tgt_cf, alpha=cfg.alpha,
                                   beta=cfg.beta,
                                   clip_penalty=cfg.clip_penalty)
        return {"loss": unaries_weighted_loss(out_cf, tgt_cf, criterion=bce,
                                              mode="sssdms")}

    def loss_fn(output, target, weight=None):
        out_cf = torch.movedim(output, -1, 1)
        tgt_cf = torch.movedim(target, -1, 1)
        if weight is None:
            return one(out_cf, tgt_cf)
        per = torch.func.vmap(lambda o, t: one(o[None], t[None]))(out_cf,
                                                                  tgt_cf)
        wsum = torch.clamp_min(weight.sum(), 1.0)
        return {k: (v * weight).sum() / wsum for k, v in per.items()}

    return loss_fn


def make_joint_train_step(wrapper, cfg: JointTrainConfig,
                          loss_fn: Optional[Callable] = None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``batch``: 'image' (B, H, W, C), 'features' (B, H, W, F), 'grid' (B, N,
    2) or (N, 2) shared, 'target' (B, H, W, 1), 'index' (B,) int (the
    images' prior slices); optional 'weight' (B,) (0 for padded samples)
    and 'lr_scale'."""
    seg_upd = _optim(cfg.optimizer)[1]
    prior_upd = _optim(cfg.prior_optimizer)[1]
    prior = wrapper.prior_module
    has_prior = prior is not None
    loss_fn = loss_fn or _default_loss_fn(cfg, has_prior)

    def forward(seg_params, prior_batch, seg_state, batch):
        image, feats, grid = batch["image"], batch["features"], batch["grid"]
        if wrapper.seg_stateful:
            seg_logits, new_seg_state = wrapper.segmentation_module.apply(
                seg_params, seg_state, image, feats,
                train=cfg.train_segmentation)
        else:
            seg_logits = wrapper.segmentation_module.apply(seg_params, image,
                                                           feats)
            new_seg_state = seg_state
        seg = wrapper.process_segmentation_output(seg_logits)
        if not has_prior:
            return seg, new_seg_state
        prior_pts = torch.func.vmap(
            lambda pp, g: wrapper.process_prior_output(prior.apply(pp, g)),
            in_dims=(0, 0 if grid.ndim == 3 else None))(prior_batch, grid)
        out = torch.cat([seg, prior_pts.reshape(seg.shape)], dim=-1)
        return out, new_seg_state

    def step(state: JointTrainState, batch):
        idx = torch.as_tensor(batch["index"], dtype=torch.long,
                              device=batch["image"].device)
        lr_scale = batch.get("lr_scale", 1.0)
        weight = batch.get("weight")
        prior_batch = T.tree_map(lambda x: x[idx], state.prior_params)
        prior_opt_batch = T.tree_map(lambda x: x[idx] if x.ndim > 0 else x,
                                     state.prior_opt)
        seg_leaves = T.tree_map(lambda x: x.detach().requires_grad_(True),
                                state.seg_params)
        prior_leaves = T.tree_map(lambda x: x.detach().requires_grad_(True),
                                  prior_batch)
        with torch.enable_grad():
            out, new_seg_state = forward(seg_leaves, prior_leaves,
                                         state.seg_state, batch)
            if weight is not None:
                res = loss_fn(out, batch["target"], weight)
            else:
                res = loss_fn(out, batch["target"])
            if not isinstance(res, dict):
                res = {"loss": res}
            loss = res["loss"]
            wrt = T.tree_leaves(seg_leaves) + T.tree_leaves(prior_leaves)
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(wrt, grads)]
        n_seg = len(T.tree_leaves(seg_leaves))
        seg_g = _unflatten(state.seg_params, grads[:n_seg])
        prior_g = _unflatten(prior_batch, grads[n_seg:])
        metrics = {k: v.detach() for k, v in res.items()}
        ok = torch.isfinite(loss.detach()) if cfg.nan_guard else \
            torch.ones((), dtype=torch.bool, device=loss.device)

        if cfg.train_segmentation:
            new_seg, new_seg_opt = seg_upd(state.seg_params, seg_g,
                                           state.seg_opt, cfg.lr * lr_scale)
            new_seg = T.tree_where(ok, new_seg, state.seg_params)
            new_seg_opt = T.tree_where(ok, new_seg_opt, state.seg_opt)
        else:
            new_seg, new_seg_opt = state.seg_params, state.seg_opt
        metrics["nan_skipped"] = ~ok
        if not has_prior:
            return JointTrainState(new_seg, new_seg_state, new_seg_opt,
                                   state.prior_params, state.prior_opt,
                                   state.step + 1), metrics

        wd = None
        if hasattr(prior, "param_groups"):
            wd = T.tree_map(
                lambda s: cfg.flow_weight_decay if s == "flow" else 0.0,
                prior.param_groups(T.tree_select(prior_batch, 0)))
        new_pb, new_ob = prior_upd(prior_batch, prior_g, prior_opt_batch,
                                   cfg.prior_lr * lr_scale, weight_decay=wd)
        if hasattr(prior, "enforce_convexity"):
            new_pb = prior.enforce_convexity(new_pb)
        keep = ok if weight is None else ok & (weight > 0)
        new_pb = T.tree_where(keep, new_pb, prior_batch)
        new_ob = T.tree_where(keep, new_ob, prior_opt_batch)
        new_prior = T.tree_map(lambda s, v: s.index_copy(0, idx, v),
                               state.prior_params, new_pb)
        new_prior_opt = T.tree_map(
            lambda s, v: s.index_copy(0, idx, v) if s.ndim > 0 else v,
            state.prior_opt, new_ob)
        return JointTrainState(new_seg, new_seg_state, new_seg_opt,
                               new_prior, new_prior_opt,
                               state.step + 1), metrics

    return step


def _unflatten(like: Params, leaves) -> Params:
    it = iter(leaves)
    return T.tree_map(lambda _: next(it), like)


def epoch_batches(num_images: int, batch_size: int, rng
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Permuted batch plan of one epoch: ``(idx_mat, wgt_mat)`` of shape
    (num_batches, batch_size), a permutation of all images with the tail
    batch padded by the front of the permutation at weight 0 (no index
    twice in a batch while batch_size <= num_images)."""
    if batch_size > num_images:
        raise ValueError("batch_size must be <= num_images")
    perm = rng.permutation(num_images)
    n_batches = -(-num_images // batch_size)
    pad = n_batches * batch_size - num_images
    idx = np.concatenate([perm, perm[:pad]]).reshape(n_batches, batch_size)
    wgt = np.ones(n_batches * batch_size, np.float32)
    if pad:
        wgt[-pad:] = 0.0
    return idx.astype(np.int32), wgt.reshape(n_batches, batch_size)


def make_joint_epoch_fn(wrapper, cfg: JointTrainConfig,
                        loss_fn: Optional[Callable] = None) -> Callable:
    """Build ``epoch(state, data, idx_mat, wgt_mat, lr_scale=1.0) ->
    (state, metrics)``: the joint step over the batch plan, each batch
    gathered from the device-resident ``data`` ('image' (T, H, W, C),
    'features', 'target', 'grid' (N, 2) shared or (T, N, 2)); the metrics
    come back stacked, one value per batch."""
    step = make_joint_train_step(wrapper, cfg, loss_fn)

    def epoch(state, data, idx_mat, wgt_mat, lr_scale=1.0):
        dev = data["image"].device
        idx_mat = torch.as_tensor(idx_mat, dtype=torch.long, device=dev)
        wgt_mat = torch.as_tensor(wgt_mat, device=dev)
        per_frame_grid = data["grid"].ndim == 3
        history = []
        for idx, wgt in zip(idx_mat, wgt_mat):
            batch = {
                "image": data["image"][idx],
                "features": data["features"][idx],
                "grid": data["grid"][idx] if per_frame_grid
                else data["grid"],
                "target": data["target"][idx],
                "index": idx, "weight": wgt, "lr_scale": lr_scale,
            }
            state, metrics = step(state, batch)
            history.append(metrics)
        return state, {k: torch.stack([m[k] for m in history])
                       for k in history[0]}

    return epoch
