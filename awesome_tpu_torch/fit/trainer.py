"""Joint training: the segmentation net and the per-image priors in one
step; counterpart of ``awesome_tpu/fit/trainer.py`` (the joint step and
epoch, and the multi-object step and epoch).

The priors of ALL images live in one stacked param tree (a leading image
axis), with their optimizer moments stacked beside them. A step gathers
the batch's slices by ``batch['index']``, applies the prior to each image
(``torch.func.vmap``), computes the joint loss, updates the shared seg
params and the gathered prior slices (the convexity clip after the
update), and scatters the slices back. Nothing in a step waits on the
host: the NaN guard and the padded-sample mask are device tensors
combined with ``torch.where``.

On a mesh (``mesh=``) every rank holds the whole state and gets the whole
batch; it runs the seg net on its block of the batch's images (the 'data'
axis; batch norm over the whole batch) and the priors on their block of
the points (the 'grid' axis). The outputs are gathered so that every rank
computes the single-device loss on the whole batch; each rank's grads
hold its blocks' share, and the seg grads are summed over the data axis
(the grid ranks of a data row hold the same ones), the prior grads over
the grid axis and gathered over the data axis. Every rank then takes the
same update, so the states stay equal.
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
from awesome_tpu_torch.nn.conv import batch_stats_over
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


def _seg_init(wrapper, gen: torch.Generator, cfg: JointTrainConfig,
              seg_init=None):
    """(seg params, seg state or None, seg optimizer state)."""
    if seg_init is not None:
        seg_params, seg_state = seg_init
    elif wrapper.seg_stateful:
        seg_params, seg_state = wrapper.segmentation_module.init(gen)
    else:
        seg_params, seg_state = wrapper.segmentation_module.init(gen), None
    return seg_params, seg_state, _optim(cfg.optimizer)[0](seg_params)


def _seg_forward(wrapper, cfg: JointTrainConfig, seg_params, seg_state,
                 batch, rows=slice(None), mesh=None):
    """The processed segmentation output (B, H, W, C) and the new seg
    state; ``rows``: this rank's block of the batch, its batch norm over
    ``mesh``'s data axis (see ``nn.conv.batch_stats_over``)."""
    image, feats = batch["image"][rows], batch["features"][rows]
    if mesh is not None:
        with batch_stats_over(mesh):
            return _seg_forward(wrapper, cfg, seg_params, seg_state,
                                {"image": image, "features": feats})
    if wrapper.seg_stateful:
        seg_logits, new_seg_state = wrapper.segmentation_module.apply(
            seg_params, seg_state, image, feats,
            train=cfg.train_segmentation)
    else:
        seg_logits = wrapper.segmentation_module.apply(seg_params, image,
                                                       feats)
        new_seg_state = seg_state
    return wrapper.process_segmentation_output(seg_logits), new_seg_state


def joint_train_init(wrapper, generator: Optional[torch.Generator],
                     num_images: int, cfg: JointTrainConfig,
                     seg_init=None, prior_init=None) -> JointTrainState:
    """The train state: seg params (and state) and stacked per-image prior
    params, fresh ones or ``prior_init`` (e.g. the pretrained priors)."""
    gen = make_generator(generator)
    seg_params, seg_state, seg_opt = _seg_init(wrapper, gen, cfg, seg_init)
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


class _Blocks:
    """This rank's blocks of a batch of ``b`` images of ``n`` points on a
    mesh (the whole batch without one), and the collectives of a step."""

    def __init__(self, mesh, b: int, n: int):
        self.mesh = mesh
        self.data_split = mesh is not None and mesh.splits("data", b)
        self.grid_split = mesh is not None and mesh.splits("grid", n)
        self.rows = mesh.local("data", b) if self.data_split else slice(None)
        self.pts = mesh.local("grid", n) if self.grid_split else slice(None)

    def seg_mesh(self):
        """The mesh the seg net's batch norm reduces over, or None."""
        return self.mesh if self.data_split else None

    def points(self, grid: torch.Tensor) -> torch.Tensor:
        """This rank's block of a (N, C) or per-image (B, N, C) grid."""
        if grid.ndim == 3:
            return grid[self.rows, self.pts]
        return grid[self.pts]

    def whole_points(self, out: torch.Tensor) -> torch.Tensor:
        """(b, n_block, ...) prior outputs -> (b, N, ...)."""
        if not self.grid_split:
            return out
        return self.mesh.gather_grad("grid", out, dim=1)

    def whole_batch(self, out: torch.Tensor) -> torch.Tensor:
        if not self.data_split:
            return out
        return self.mesh.gather_grad("data", out, dim=0)

    def seg_grads(self, grads):
        if not self.data_split:
            return grads
        return self.mesh.sum_over_tree("data", grads)

    def prior_grads(self, grads):
        """This block's prior grads -> the whole batch's."""
        if self.grid_split:
            grads = self.mesh.sum_over_tree("grid", grads)
        if self.data_split:
            grads = self.mesh.gather_tree("data", grads)
        return grads


def make_joint_train_step(wrapper, cfg: JointTrainConfig,
                          loss_fn: Optional[Callable] = None,
                          mesh=None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``batch``: 'image' (B, H, W, C), 'features' (B, H, W, F), 'grid' (B, N,
    2) or (N, 2) shared, 'target' (B, H, W, 1), 'index' (B,) int (the
    images' prior slices); optional 'weight' (B,) (0 for padded samples)
    and 'lr_scale'. ``mesh``: see the module docstring."""
    seg_upd = _optim(cfg.optimizer)[1]
    prior_upd = _optim(cfg.prior_optimizer)[1]
    prior = wrapper.prior_module
    has_prior = prior is not None
    loss_fn = loss_fn or _default_loss_fn(cfg, has_prior)

    def forward(seg_params, prior_batch, seg_state, batch, blocks):
        grid = blocks.points(batch["grid"])
        seg, new_seg_state = _seg_forward(wrapper, cfg, seg_params,
                                          seg_state, batch, blocks.rows,
                                          blocks.seg_mesh())
        if not has_prior:
            return blocks.whole_batch(seg), new_seg_state
        prior_pts = torch.func.vmap(
            lambda pp, g: wrapper.process_prior_output(prior.apply(pp, g)),
            in_dims=(0, 0 if grid.ndim == 3 else None))(prior_batch, grid)
        prior_pts = blocks.whole_points(prior_pts)
        out = torch.cat([seg, prior_pts.reshape(seg.shape)], dim=-1)
        return blocks.whole_batch(out), new_seg_state

    def step(state: JointTrainState, batch):
        idx = torch.as_tensor(batch["index"], dtype=torch.long,
                              device=batch["image"].device)
        lr_scale = batch.get("lr_scale", 1.0)
        weight = batch.get("weight")
        blocks = _Blocks(mesh, idx.shape[0], batch["grid"].shape[-2])
        prior_batch = T.tree_map(lambda x: x[idx], state.prior_params)
        prior_opt_batch = T.tree_map(lambda x: x[idx] if x.ndim > 0 else x,
                                     state.prior_opt)
        prior_block = T.tree_map(lambda x: x[blocks.rows], prior_batch)

        def compute_loss(seg_params, prior_params):
            out, new_seg_state = forward(seg_params, prior_params,
                                         state.seg_state, batch, blocks)
            if weight is not None:
                res = loss_fn(out, batch["target"], weight)
            else:
                res = loss_fn(out, batch["target"])
            if not isinstance(res, dict):
                res = {"loss": res}
            return res["loss"], (res, new_seg_state)

        loss, (res, new_seg_state), seg_g, prior_g = _value_and_grads(
            compute_loss, state.seg_params, prior_block)
        seg_g = blocks.seg_grads(seg_g)
        prior_g = blocks.prior_grads(prior_g)
        metrics = {k: v.detach() for k, v in res.items()}
        ok = _finite(loss, cfg)
        new_seg, new_seg_opt = _seg_update(cfg, seg_upd, state, seg_g, ok,
                                           lr_scale)
        metrics["nan_skipped"] = ~ok
        if not has_prior:
            return JointTrainState(new_seg, new_seg_state, new_seg_opt,
                                   state.prior_params, state.prior_opt,
                                   state.step + 1), metrics

        wd = _flow_weight_decay(prior, T.tree_select(prior_batch, 0), cfg)
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


def _finite(loss: torch.Tensor, cfg: JointTrainConfig) -> torch.Tensor:
    """The NaN guard: a device flag, true when the step may update."""
    if cfg.nan_guard:
        return torch.isfinite(loss)
    return torch.ones((), dtype=torch.bool, device=loss.device)


def _seg_update(cfg: JointTrainConfig, seg_upd: Callable, state, seg_g,
                ok: torch.Tensor, lr_scale):
    """The shared seg net's optimizer step, kept only where ``ok``."""
    if not cfg.train_segmentation:
        return state.seg_params, state.seg_opt
    new_seg, new_seg_opt = seg_upd(state.seg_params, seg_g, state.seg_opt,
                                   cfg.lr * lr_scale)
    return (T.tree_where(ok, new_seg, state.seg_params),
            T.tree_where(ok, new_seg_opt, state.seg_opt))


def _flow_weight_decay(child, params: Params, cfg: JointTrainConfig):
    """Per-leaf weight decay of one prior: the flow group's, else 0."""
    if not hasattr(child, "param_groups"):
        return None
    return T.tree_map(lambda s: cfg.flow_weight_decay if s == "flow" else 0.0,
                      child.param_groups(params))


def _unflatten(like: Params, leaves) -> Params:
    it = iter(leaves)
    return T.tree_map(lambda _: next(it), like)


def _value_and_grads(compute_loss: Callable, seg_params: Params,
                     prior_params: Params):
    """``compute_loss(seg, prior) -> (loss, aux)`` and its grads w.r.t.
    both trees (zeros where a leaf does not reach the loss): returns
    ``(loss, aux, seg_grads, prior_grads)``."""
    seg_leaves = T.tree_map(lambda x: x.detach().requires_grad_(True),
                            seg_params)
    prior_leaves = T.tree_map(lambda x: x.detach().requires_grad_(True),
                              prior_params)
    with torch.enable_grad():
        loss, aux = compute_loss(seg_leaves, prior_leaves)
        wrt = T.tree_leaves(seg_leaves) + T.tree_leaves(prior_leaves)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(wrt, grads)]
    n_seg = len(T.tree_leaves(seg_leaves))
    return (loss.detach(), aux, _unflatten(seg_params, grads[:n_seg]),
            _unflatten(prior_params, grads[n_seg:]))


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
                        loss_fn: Optional[Callable] = None,
                        mesh=None) -> Callable:
    """Build ``epoch(state, data, idx_mat, wgt_mat, lr_scale=1.0) ->
    (state, metrics)``: the joint step over the batch plan, each batch
    gathered from the device-resident ``data`` ('image' (T, H, W, C),
    'features', 'target', 'grid' (N, 2) shared or (T, N, 2)); the metrics
    come back stacked, one value per batch."""
    step = make_joint_train_step(wrapper, cfg, loss_fn, mesh)

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


# --- multi-object joint training ---------------------------------------------


class MultiObjectTrainState(NamedTuple):
    """The joint state for multi-object sequences: the shared seg net
    emits one channel per object slot; each frame carries a stack of K
    child priors (``nn.multi_prior.MultiPriorModule``, fixed capacity)
    with per-slot optimizer state (counts (T, K)) and an active mask."""

    seg_params: Params
    seg_state: Any
    seg_opt: Any
    prior_params: Params  # {'children': (T, K, ...)}
    prior_opt: Any  # per (frame, child) slot, count (T, K)
    active: torch.Tensor  # (T, K) bool
    step: torch.Tensor


def multi_object_train_init(wrapper, generator: Optional[torch.Generator],
                            num_images: int, cfg: JointTrainConfig,
                            initial_count: int = 1, seg_init=None,
                            prior_init=None) -> MultiObjectTrainState:
    """``wrapper.prior_module`` is a ``MultiPriorModule`` of capacity
    ``max_priors`` and the seg module emits ``max_priors`` channels. The
    first ``initial_count`` slots of every frame start active."""
    mp = wrapper.prior_module
    gen = make_generator(generator)
    seg_params, seg_state, seg_opt = _seg_init(wrapper, gen, cfg, seg_init)
    prior_params = prior_init if prior_init is not None else \
        T.stack_trees([mp.init(gen) for _ in range(num_images)])
    prior_opt = _optim(cfg.prior_optimizer)[0](
        prior_params["children"], (num_images, mp.max_priors))
    dev = T.tree_leaves(seg_params)[0].device
    active = torch.zeros((num_images, mp.max_priors), dtype=torch.bool,
                         device=dev)
    active[:, :initial_count] = True
    return MultiObjectTrainState(seg_params, seg_state, seg_opt,
                                 prior_params, prior_opt, active,
                                 torch.zeros((), dtype=torch.int32,
                                             device=dev))


def assure_multi_prior_count(wrapper, state: MultiObjectTrainState,
                             cfg: JointTrainConfig, count: int,
                             key) -> MultiObjectTrainState:
    """Set every frame's active child count to ``count``. Inactive slots
    below ``count`` get fresh child params (from ``key``, an int seed or a
    ``torch.Generator``), zeroed moments and count 0, so their Adamax bias
    correction restarts; existing children and their state stay bitwise
    as they were. Shrinking only lowers the active mask. The step masks by
    ``active``, so its graph does not depend on the count."""
    mp = wrapper.prior_module
    if count > mp.max_priors:
        raise ValueError(
            f"count {count} exceeds static capacity {mp.max_priors}")
    t = state.active.shape[0]
    gen = make_generator(key)
    slot = torch.arange(mp.max_priors, device=state.active.device)
    target = torch.broadcast_to(slot < count, state.active.shape)
    need_fresh = ~state.active & target
    fresh = T.stack_trees([mp.init(gen) for _ in range(t)])["children"]
    fresh_opt = _optim(cfg.prior_optimizer)[0](fresh, (t, mp.max_priors))
    keep = ~need_fresh  # (the state's trees first: they keep its key order)
    children = T.tree_where(keep, state.prior_params["children"], fresh)
    prior_opt = T.tree_where(keep, state.prior_opt, fresh_opt)
    return state._replace(
        prior_params=dict(state.prior_params, children=children),
        prior_opt=prior_opt, active=target.clone())


def _object_losses(cfg: JointTrainConfig, seg, prior, tgt, labeled):
    """Each (image, object)'s joint loss (B, K): the sssdms-weighted BCE
    of seg against the object's unaries over the labeled pixels, plus beta
    times the soft-clipped SE of prior against seg. ``seg``, ``prior``,
    ``tgt``: (B, H, W, K); ``labeled``: (B, H, W). The class weights are
    counted per image and object."""
    lab = labeled.to(seg.dtype)[..., None]
    is_bg = (tgt >= 0.5).to(seg.dtype)
    bg_count = (is_bg * lab).sum(dim=(1, 2))
    fg_count = torch.clamp_min(((1.0 - is_bg) * lab).sum(dim=(1, 2)), 1.0)
    w_fg = torch.round(bg_count / fg_count / 10.0) + 1.0  # sssdms
    w = torch.where(is_bg > 0, torch.ones_like(tgt), w_fg[:, None, None]) \
        * lab
    raw = bce(seg, tgt, reduction="none")
    seg_loss = cfg.alpha * (raw * w).sum(dim=(1, 2)) / torch.clamp_min(
        w.sum(dim=(1, 2)), 1.0)
    pen = cfg.beta * torch.mean((prior - seg) ** 2, dim=(1, 2))
    if cfg.clip_penalty:
        scale = torch.where(pen > seg_loss,
                            seg_loss / torch.clamp_min(pen, 1e-12),
                            torch.ones_like(pen)).detach()
        pen = pen * scale
    return seg_loss + pen


def make_multi_object_train_step(wrapper, cfg: JointTrainConfig,
                                 mesh=None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)`` for multi-object
    joint training.

    ``batch``: 'image' (B, H, W, C), 'features' (B, H, W, F), 'grid' (N,
    2) or (B, N, 2), 'target_obj' (B, H, W, K) per-object unaries (fg 0
    per channel), 'labeled' (B, H, W) bool, 'index' (B,); optional
    'weight' (B,) and 'lr_scale'. The loss of each image is the mean of
    its active objects' losses (:func:`_object_losses`), then the
    weighted mean over the batch. Inactive slots, weight-0 samples and a
    non-finite step leave the children and their state as they were.
    ``mesh``: see the module docstring."""
    seg_upd = _optim(cfg.optimizer)[1]
    prior_upd = _optim(cfg.prior_optimizer)[1]
    mp = wrapper.prior_module

    def step(state: MultiObjectTrainState, batch):
        idx = torch.as_tensor(batch["index"], dtype=torch.long,
                              device=batch["image"].device)
        lr_scale = batch.get("lr_scale", 1.0)
        weight = batch.get("weight")
        children = T.tree_map(lambda x: x[idx],
                              state.prior_params["children"])
        opt_batch = T.tree_map(lambda x: x[idx], state.prior_opt)
        active_b = state.active[idx]
        blocks = _Blocks(mesh, idx.shape[0], batch["grid"].shape[-2])
        child_block = T.tree_map(lambda x: x[blocks.rows], children)

        def compute_loss(seg_params, children_):
            seg, new_seg_state = _seg_forward(wrapper, cfg, seg_params,
                                              state.seg_state, batch,
                                              blocks.rows, blocks.seg_mesh())
            prior = blocks.whole_points(wrapper.process_prior_output(
                mp.apply_images(children_, blocks.points(batch["grid"]))))
            seg = blocks.whole_batch(seg)
            prior = blocks.whole_batch(prior.reshape(
                prior.shape[:1] + seg.shape[1:]))
            per_obj = _object_losses(cfg, seg, prior,
                                     batch["target_obj"], batch["labeled"])
            a = active_b.to(per_obj.dtype)
            per = (per_obj * a).sum(dim=1) / torch.clamp_min(a.sum(dim=1),
                                                             1.0)
            if weight is not None:
                loss = (per * weight).sum() / torch.clamp_min(weight.sum(),
                                                              1.0)
            else:
                loss = per.mean()
            return loss, new_seg_state

        loss, new_seg_state, seg_g, child_g = _value_and_grads(
            compute_loss, state.seg_params, child_block)
        seg_g = blocks.seg_grads(seg_g)
        child_g = blocks.prior_grads(child_g)
        ok = _finite(loss, cfg)
        new_seg, new_seg_opt = _seg_update(cfg, seg_upd, state, seg_g, ok,
                                           lr_scale)
        wd = _flow_weight_decay(
            mp.child, T.tree_map(lambda x: x[0, 0], children), cfg)
        new_children, new_opt = prior_upd(children, child_g, opt_batch,
                                          cfg.prior_lr * lr_scale,
                                          weight_decay=wd)
        if hasattr(mp.child, "enforce_convexity"):
            new_children = mp.child.enforce_convexity(new_children)
        keep = active_b & ok
        if weight is not None:
            keep = keep & (weight > 0)[:, None]
        new_children = T.tree_where(keep, new_children, children)
        new_opt = T.tree_where(keep, new_opt, opt_batch)
        scattered = T.tree_map(lambda s, v: s.index_copy(0, idx, v),
                               state.prior_params["children"], new_children)
        scattered_opt = T.tree_map(lambda s, v: s.index_copy(0, idx, v),
                                   state.prior_opt, new_opt)
        return MultiObjectTrainState(
            new_seg, new_seg_state, new_seg_opt,
            dict(state.prior_params, children=scattered), scattered_opt,
            state.active, state.step + 1), {"loss": loss,
                                            "nan_skipped": ~ok}

    return step


def make_multi_object_epoch_fn(wrapper, cfg: JointTrainConfig,
                               mesh=None) -> Callable:
    """Build ``epoch(state, data, idx_mat, wgt_mat, lr_scale=1.0) ->
    (state, metrics)``: the multi-object step over the batch plan, each
    batch gathered from ``data`` ('image' (T, H, W, C), 'features',
    'grid' (N, 2) or (T, N, 2), 'target_obj' (T, H, W, K), 'labeled' (T,
    H, W)); the metrics come back stacked, one value per batch."""
    step = make_multi_object_train_step(wrapper, cfg, mesh)

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
                "target_obj": data["target_obj"][idx],
                "labeled": data["labeled"][idx],
                "index": idx, "weight": wgt, "lr_scale": lr_scale,
            }
            state, metrics = step(state, batch)
            history.append(metrics)
        return state, {k: torch.stack([m[k] for m in history])
                       for k in history[0]}

    return epoch
