"""Pixel-mode training, the convexity benchmark's path; counterpart of
``awesome_tpu/fit/pixel_trainer.py``.

Reference semantics (`awesome/run/awesome_runner.py` 'single' mode +
`awesome/measures/awesome_loss.py:11-63`): every image has its OWN model
(the whole seg+prior wrapper is per-image); each epoch takes one
full-batch optimizer step on that image's scribble pixels with
``crit(seg) + alpha*crit(prior)``; after ``extra_penalty_after_n_epochs``
the loss switches to the extra-penalty phase (0.1x base + 100x
prior-to-thresholded-seg alignment on random pixels), optionally dropping
the LR; convexity is clipped after every step; training stops when the
plateau LR decays under the watchdog threshold.

All images train at once: their params are one stacked tree (a leading
image axis) and an epoch is one ``torch.func.vmap``-ed value-and-grad over
that axis, so a fused ICNN prior makes one K4 and one K5 launch per epoch
for all images. The JAX package runs a segment as ``jit(vmap(scan))``;
here a segment is a Python loop over its epochs that never waits on the
device: the extra-penalty switch (decided by the absolute epoch), the NaN
guard, the validation-holdout ``trainable`` mask, the plateau and the
``lr_stop_scale`` freeze are all ``torch.where``s on device tensors, and
the loss history stays on the device until the caller reads it, once per
segment. Variable pixel counts are padded, with masks (weight 0).

On a mesh (``mesh=``) the segment functions take and return the whole
batch and state on every rank; each rank trains its block of the images
(the 'data' axis) on its block of their pixels (the 'grid' axis, where the
loss is a sum over pixels: the default masked AwesomeLoss). The scribble
and random-pixel counts, each epoch's losses and grads are summed over
the grid group; the shared seg net's mean over images and its grads over
the whole mesh. The states come back together once per segment.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.fit import optim
from awesome_tpu_torch.measures.losses import bce
from awesome_tpu_torch.nn.module import make_generator
from awesome_tpu_torch.parallel.mesh import sum_trees

Params = Any


@dataclasses.dataclass(frozen=True)
class PixelTrainConfig:
    """Defaults mirror `config/convexity/sequential/*.yaml` (3000 epochs,
    Adam lr 0.02, AwesomeLoss alpha=1)."""

    num_epochs: int = 3000
    lr: float = 0.02
    optimizer: str = "adam"
    alpha: float = 1.0
    # extra-penalty scales: AwesomeLoss uses (0.1, 100); the joint loss
    # passes (gamma, beta) from its config
    pen_base_scale: float = 0.1
    pen_align_scale: float = 100.0
    extra_penalty_after: Optional[int] = None  # epoch index or None
    extra_penalty_lr_factor: float = 1.0  # reduce_lr_in_extra_penalty
    plateau_patience: int = 200
    plateau_factor: float = 0.5
    use_plateau: bool = False
    lr_stop_scale: float = 0.0
    nan_guard: bool = True
    # segmentation_training_mode 'none' (`awesome/run/awesome_runner.py:448`
    # exclude_segmentation_model): the seg subtree is excluded from updates.
    train_segmentation: bool = True
    # split_params_in_param_groups + weight_decay_on_weight_norm_modules
    # (`awesome/run/awesome_runner.py:427-444`): decay ONLY weight-norm
    # magnitude leaves ('g') by this factor. 0 = off.
    wn_weight_decay: float = 0.0


class PixelTrainState(NamedTuple):
    """Resumable train state: per-image (stacked) params, optimizer state
    and plateau schedule, and the absolute epoch counter ((B,) int32 per
    image; () in the shared-seg mode).

    Training in SEGMENTS lets the runner fire the reference's
    between-epoch handles (eval cadence, best-model checks, image dumps,
    checkpoints, `awesome/run/awesome_runner.py:294-475`) with one host
    visit per cadence tick, not per epoch.
    """

    params: Params
    opt_state: Any
    sched: Any
    epoch: torch.Tensor


def masked_awesome_loss(output, target, scribble_mask, random_mask,
                        alpha: float, extra_penalty,
                        pen_base_scale: float = 0.1,
                        pen_align_scale: float = 100.0,
                        n_scr=None, n_rnd=None):
    """AwesomeLoss with explicit pixel-role masks (padding-safe).

    output (N, 2): [seg, prior] probabilities; target (N, 1); masks (N,).
    Base: mean-BCE over scribble pixels of seg + alpha * same for prior.
    Extra-penalty phase (`awesome_loss.py:55-61`): pen_base_scale * base +
    pen_align_scale * mean((prior - (seg > .5))^2) over random pixels.
    ``extra_penalty`` is a bool or a bool tensor. ``n_scr``, ``n_rnd``:
    the image's scribble and random-pixel counts when these N pixels are
    one block of them (a mesh's grid axis): the loss is then this block's
    share, and the blocks' shares sum to the image's loss.
    """
    sw = scribble_mask.to(output.dtype)[:, None]
    if n_scr is None:
        n_scr = sw.sum()
    n_scr = torch.clamp_min(n_scr, 1.0)

    def mbce(pred):
        raw = bce(pred, target, reduction="none")
        return (raw * sw).sum() / n_scr

    base = mbce(output[:, 0:1]) + alpha * mbce(output[:, 1:2])

    rw = random_mask.to(output.dtype)[:, None]
    if n_rnd is None:
        n_rnd = rw.sum()
    n_rnd = torch.clamp_min(n_rnd, 1.0)
    hard_seg = (output[:, 0:1] > 0.5).to(output.dtype).detach()
    align = ((output[:, 1:2] - hard_seg) ** 2 * rw).sum() / n_rnd
    with_pen = pen_base_scale * base + pen_align_scale * align
    return torch.where(torch.as_tensor(extra_penalty, device=base.device),
                       with_pen, base)


def _pixel_optim(cfg: PixelTrainConfig):
    return {
        "adam": (optim.adam_init, optim.adam_update),
        "adamax": (optim.adamax_init, optim.adamax_update),
    }[cfg.optimizer]


def _extra_flag(cfg: PixelTrainConfig, epoch: torch.Tensor) -> torch.Tensor:
    if cfg.extra_penalty_after is None:
        return torch.zeros_like(epoch, dtype=torch.bool)
    return epoch >= cfg.extra_penalty_after


def _lr(cfg: PixelTrainConfig, sched, extra: torch.Tensor):
    """The step's learning rate: the plateau scale and the extra-penalty
    drop applied, per image where they are per image."""
    lr = cfg.lr * sched.scale if cfg.use_plateau else cfg.lr
    if cfg.extra_penalty_after is not None:
        lr = torch.where(extra, lr * cfg.extra_penalty_lr_factor,
                         torch.as_tensor(lr, device=extra.device))
    return lr


def _ok(cfg: PixelTrainConfig, loss: torch.Tensor, sched) -> torch.Tensor:
    """The NaN guard and the ``lr_stop_scale`` freeze: a device flag (one
    per image), true where the step may update."""
    ok = torch.isfinite(loss) if cfg.nan_guard else \
        torch.ones_like(loss, dtype=torch.bool)
    if cfg.use_plateau and cfg.lr_stop_scale > 0.0:
        ok = ok & (sched.scale > cfg.lr_stop_scale)
    return ok


def _weight_decay(cfg: PixelTrainConfig, params: Params):
    if cfg.wn_weight_decay > 0.0:
        return optim.wn_param_groups(params, cfg.wn_weight_decay)
    return None


def _split_seg_state(params: Params, stateful_seg: bool):
    """``(optimized params, seg state)``: with a stateful seg net
    (``params['seg']`` a ``(seg_params, seg_state)`` pair, the UNet's
    batch norm) the state is split off; it is not optimized."""
    if not stateful_seg:
        return params, None
    seg_params, seg_state = params["seg"]
    return dict(params, seg=seg_params), seg_state


def _make_pixel_step(wrapper, cfg: PixelTrainConfig,
                     loss_impl: Optional[Callable] = None,
                     stateful_seg: bool = False) -> Callable:
    """One training epoch for ALL images: ``(carry, epoch (B,), px, gt,
    smask, rmask, trainable (B,)) -> (carry, loss (B,))``.

    ``stateful_seg``: ``params['seg']`` is a ``(seg_params, seg_state)``
    pair and ``loss_impl(params, seg_state, px, gt, smask, rmask, extra)``
    returns ``(loss, new_seg_state)``; the new state is kept where the
    image's step is."""
    _, update_fn = _pixel_optim(cfg)
    with_counts = loss_impl is None
    if with_counts:

        def loss_impl(params, px, gt, smask, rmask, extra_penalty, n_scr,
                      n_rnd):
            out = wrapper.apply(params, px)
            return masked_awesome_loss(
                out, gt, smask, rmask, cfg.alpha, extra_penalty,
                pen_base_scale=cfg.pen_base_scale,
                pen_align_scale=cfg.pen_align_scale, n_scr=n_scr,
                n_rnd=n_rnd)

    vgv = torch.func.vmap(torch.func.grad_and_value(loss_impl,
                                                    has_aux=stateful_seg))
    has_clip = hasattr(wrapper, "enforce_convexity")

    def step(carry, epoch, px, gt, smask, rmask, trainable, grid_sum=None):
        """``grid_sum``: ``px`` holds one block of the images' pixels; the
        scribble and random-pixel counts, and each image's loss and grads,
        are summed over the blocks."""
        params, opt_state, sched = carry
        extra = _extra_flag(cfg, epoch)
        opt_params, seg_state = _split_seg_state(params, stateful_seg)
        if stateful_seg:
            grads, (loss, new_seg_state) = vgv(opt_params, seg_state, px,
                                               gt, smask, rmask, extra)
        else:
            counts = (_pixel_counts(smask, rmask, px.dtype, grid_sum)
                      if with_counts else ())
            grads, loss = vgv(opt_params, px, gt, smask, rmask, extra,
                              *counts)
            if grid_sum is not None:
                loss, grads = sum_trees(grid_sum, loss, grads)
        new_params, new_opt = update_fn(
            opt_params, grads, opt_state, _lr(cfg, sched, extra),
            weight_decay=_weight_decay(cfg, opt_params))
        if has_clip:
            new_params = wrapper.enforce_convexity(new_params)
        if not cfg.train_segmentation and isinstance(new_params, dict) and (
                "seg" in new_params):
            # segmentation_training_mode 'none': seg subtree excluded from
            # optimization (`awesome/run/awesome_runner.py:448-457`)
            new_params = dict(new_params, seg=opt_params["seg"])
        if stateful_seg:
            new_params = dict(new_params,
                              seg=(new_params["seg"], new_seg_state))
        # validation holdout: a non-trainable (val) image's params are
        # NEVER stepped; its loss is a pure forward measurement (the
        # reference's no-grad val phase, `agent/torch_agent.py:233-243`)
        ok = _ok(cfg, loss, sched) & trainable
        params = T.tree_where(ok, new_params, params)
        opt_state = T.tree_where(ok, new_opt, opt_state)
        if cfg.use_plateau:
            sched = optim.plateau_update(sched, loss,
                                         factor=cfg.plateau_factor,
                                         patience=cfg.plateau_patience)
        return (params, opt_state, sched), loss.detach()

    return step


def pixel_train_init(wrapper, stacked_params: Params,
                     cfg: PixelTrainConfig,
                     stateful_seg: bool = False) -> PixelTrainState:
    """Initial stacked train state for the per-image segment engine (a
    stateful seg net's state gets no optimizer state)."""
    del wrapper
    init_fn, _ = _pixel_optim(cfg)
    first = T.tree_leaves(stacked_params)[0]
    batch, dev = first.shape[0], first.device
    return PixelTrainState(
        params=stacked_params,
        opt_state=init_fn(_split_seg_state(stacked_params, stateful_seg)[0],
                          (batch,)),
        sched=optim.plateau_init(torch.float32, (batch,), dev),
        epoch=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def _run_segment(step: Callable, state: PixelTrainState, segment_len: int,
                 batch_args: Tuple, trainable, **step_kw
                 ) -> Tuple[PixelTrainState, dict]:
    carry = (state.params, state.opt_state, state.sched)
    hist = []
    for i in range(segment_len):
        carry, loss = step(carry, state.epoch + i, *batch_args, trainable,
                           **step_kw)
        hist.append(loss)
    params, opt_state, sched = carry
    new_state = PixelTrainState(params, opt_state, sched,
                                state.epoch + segment_len)
    # per-image history (B, L)
    return new_state, {"loss_hist": torch.stack(hist, dim=-1),
                       "lr_scale": sched.scale}


def _all_trainable(gt: torch.Tensor, trainable) -> torch.Tensor:
    if trainable is None:
        return torch.ones((gt.shape[0],), dtype=torch.bool, device=gt.device)
    return torch.as_tensor(trainable, device=gt.device)


def _pixel_blocks(mesh, gt: torch.Tensor, split_pixels: bool):
    """(image block, pixel block, grid sum or None) of this rank."""
    b, n = gt.shape[:2]
    if not split_pixels:
        return mesh.local("data", b), slice(0, n), None
    return (mesh.local("data", b), mesh.local("grid", n),
            mesh.reducer("grid", n))


def _pixel_counts(smask: torch.Tensor, rmask: torch.Tensor, dtype,
                  grid_sum: Optional[Callable] = None) -> torch.Tensor:
    """(2, B) scribble and random-pixel counts of the images (exact
    integers), summed over the pixel blocks by ``grid_sum``."""
    counts = torch.stack([smask.sum(dim=-1), rmask.sum(dim=-1)]).to(dtype)
    return counts if grid_sum is None else grid_sum(counts)


def make_pixel_segment_fn(wrapper, cfg: PixelTrainConfig, segment_len: int,
                          loss_impl: Optional[Callable] = None,
                          stateful_seg: bool = False,
                          mesh=None) -> Callable:
    """Build ``segment(state, px, gt, smask, rmask, trainable) -> (state,
    aux)``: ``segment_len`` epochs for ALL images, resumable across calls
    (absolute epoch, optimizer moments and plateau state live in the
    state). ``trainable`` (B,) bool: False = validation holdout, the
    image's params stay frozen and its loss is forward-only.
    ``aux['loss_hist']`` is (B, segment_len), ``aux['lr_scale']`` (B,),
    both on the device. ``stateful_seg``: see :func:`_make_pixel_step`.
    ``mesh``: the images over 'data' and, with the default loss, the
    pixels over 'grid' (a custom ``loss_impl``, e.g. image mode's conv
    net, sees whole images: the grid axis replicates)."""
    step = _make_pixel_step(wrapper, cfg, loss_impl, stateful_seg)

    def segment(state, px, gt, smask, rmask, trainable=None):
        trainable = _all_trainable(gt, trainable)
        if mesh is None:
            return _run_segment(step, state, segment_len,
                                (px, gt, smask, rmask), trainable)
        ds, gs, grid_sum = _pixel_blocks(mesh, gt, loss_impl is None)
        local = T.tree_map(lambda x: x[ds], state)
        new_state, aux = _run_segment(
            step, local, segment_len,
            tuple(x[ds, gs] for x in (px, gt, smask, rmask)), trainable[ds],
            grid_sum=grid_sum)
        if not mesh.splits("data", gt.shape[0]):
            return new_state, aux
        return (mesh.gather_tree("data", new_state),
                mesh.gather_tree("data", aux))

    return segment


def make_pixel_train_fn(wrapper, cfg: PixelTrainConfig) -> Callable:
    """Build ``train(params, px, gt, scribble_mask, random_mask) ->
    (params, aux)`` for ONE image (:func:`train_pixel_models` trains a
    stacked batch)."""

    def train(params, px, gt, smask, rmask):
        stacked = T.tree_map(lambda x: x[None], params)
        out, aux = train_pixel_models(wrapper, stacked, px[None], gt[None],
                                      smask[None], rmask[None], cfg)
        return T.tree_select(out, 0), {k: v[0] for k, v in aux.items()}

    return train


def shared_pixel_train_init(wrapper, generator, num_images: int,
                            cfg: PixelTrainConfig,
                            params: Optional[Params] = None
                            ) -> PixelTrainState:
    """State for segmentation_training_mode='multi': ONE shared seg net +
    stacked per-image priors (`awesome/run/awesome_config.py:98-106`).
    ``params`` reuses an existing {'seg', 'prior'} tree (e.g. pretrained
    priors) instead of fresh inits drawn from ``generator``."""
    if params is None:
        gen = make_generator(generator)
        params = {"seg": wrapper.segmentation_module.init(gen)}
        if wrapper.prior_module is not None:
            params["prior"] = T.stack_trees(
                [wrapper.prior_module.init(gen) for _ in range(num_images)])
    init_fn, _ = _pixel_optim(cfg)
    dev = T.tree_leaves(params)[0].device
    return PixelTrainState(
        params=params,
        opt_state=init_fn(params),
        sched=optim.plateau_init(torch.float32, (), dev),
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
    )


def make_shared_pixel_segment_fn(wrapper, cfg: PixelTrainConfig,
                                 segment_len: int, mesh=None) -> Callable:
    """Segment engine for the shared-seg ('multi') mode: the seg net sees
    every image each epoch (mean loss over images -> averaged grads, the
    full-batch analogue of the reference's per-image steps), priors stay
    per-image.

    ``trainable`` (B,) bool implements the validation holdout: val images
    contribute NOTHING to the shared-seg gradient (the mean is weighted by
    the trainable mask) and their per-image priors stay frozen; their
    losses are still computed (forward-only). ``aux['loss_hist']`` is
    per-image (B, L). ``mesh``: the images over 'data' and their pixels
    over 'grid'; the per-image losses and prior grads are summed over the
    grid group, the mean over trainable images and the seg grads over
    the whole mesh."""
    _, update_fn = _pixel_optim(cfg)
    prior = wrapper.prior_module
    has_clip = prior is not None and hasattr(prior, "enforce_convexity")

    def per_image(seg_p, prior_p, px_i, gt_i, sm_i, rm_i, extra, n_scr,
                  n_rnd):
        p = {"seg": seg_p}
        if prior_p is not None:
            p["prior"] = prior_p
        out = wrapper.apply(p, px_i)
        if prior_p is None:
            sw = sm_i.to(out.dtype)[:, None]
            raw = bce(out[:, 0:1], gt_i, reduction="none")
            return (raw * sw).sum() / torch.clamp_min(n_scr, 1.0)
        return masked_awesome_loss(
            out, gt_i, sm_i, rm_i, cfg.alpha, extra,
            pen_base_scale=cfg.pen_base_scale,
            pen_align_scale=cfg.pen_align_scale, n_scr=n_scr, n_rnd=n_rnd)

    with_prior = torch.func.vmap(per_image,
                                 in_dims=(None, 0, 0, 0, 0, 0, None, 0, 0))
    no_prior = torch.func.vmap(
        lambda s, *a: per_image(s, None, *a),
        in_dims=(None, 0, 0, 0, 0, None, 0, 0))

    def loss_for_grad(params, px, gt, smask, rmask, extra, tw, counts,
                      tw_total):
        if "prior" in params:
            losses = with_prior(params["seg"], params["prior"], px, gt,
                                smask, rmask, extra, *counts)
        else:
            losses = no_prior(params["seg"], px, gt, smask, rmask, extra,
                              *counts)
        # trainable-weighted mean: held-out images carry weight 0
        train_loss = (losses * tw).sum() / torch.clamp_min(tw_total, 1.0)
        return train_loss, losses

    gv = torch.func.grad_and_value(loss_for_grad, has_aux=True)

    def step(carry, epoch, px, gt, smask, rmask, trainable, grid_sum=None,
             data_sum=None):
        """``grid_sum``: ``px`` holds one block of the images' pixels (the
        counts, per-image losses and prior grads are summed over the
        blocks); ``data_sum``: one block of the images (the mean over
        trainable images and the seg grads are summed over the blocks)."""
        params, opt_state, sched = carry
        tw = trainable.to(px.dtype)
        extra = _extra_flag(cfg, epoch)
        counts = _pixel_counts(smask, rmask, px.dtype, grid_sum)
        tw_total = tw.sum() if data_sum is None else data_sum(tw.sum())
        grads, (loss, losses) = gv(params, px, gt, smask, rmask, extra, tw,
                                   counts, tw_total)
        if grid_sum is not None:
            loss, losses, grads = sum_trees(grid_sum, loss, losses, grads)
        if data_sum is not None:
            loss, seg_g = sum_trees(data_sum, loss, grads["seg"])
            grads = dict(grads, seg=seg_g)
        new_params, new_opt = update_fn(
            params, grads, opt_state, _lr(cfg, sched, extra),
            weight_decay=_weight_decay(cfg, params))
        if has_clip:
            new_params = dict(new_params,
                              prior=prior.enforce_convexity(
                                  new_params["prior"]))
        if "prior" in params:
            # per-image priors of held-out images stay bit-identical
            # (their grads are zero through the weighted mean, but the
            # optimizer would still move them with its moments)
            new_params = dict(new_params, prior=T.tree_where(
                trainable, new_params["prior"], params["prior"]))
        if not cfg.train_segmentation:
            new_params = dict(new_params, seg=params["seg"])
        ok = _ok(cfg, loss, sched)
        params = T.tree_where(ok, new_params, params)
        opt_state = T.tree_where(ok, new_opt, opt_state)
        if cfg.use_plateau:
            sched = optim.plateau_update(sched, loss,
                                         factor=cfg.plateau_factor,
                                         patience=cfg.plateau_patience)
        return (params, opt_state, sched), losses.detach()

    def segment(state, px, gt, smask, rmask, trainable=None):
        trainable = _all_trainable(gt, trainable)
        if mesh is None:
            return _run_segment(step, state, segment_len,
                                (px, gt, smask, rmask), trainable)
        b = gt.shape[0]
        ds, gs, grid_sum = _pixel_blocks(mesh, gt, True)
        local = _shared_prior_map(state, lambda x: x[ds])
        new_state, aux = _run_segment(
            step, local, segment_len,
            tuple(x[ds, gs] for x in (px, gt, smask, rmask)), trainable[ds],
            grid_sum=grid_sum, data_sum=mesh.reducer("data", b))
        if not mesh.splits("data", b):
            return new_state, aux
        return (_shared_prior_map(new_state,
                                  lambda x: mesh.gather("data", x)),
                dict(aux, loss_hist=mesh.gather("data", aux["loss_hist"])))

    return segment


def _shared_prior_map(state: PixelTrainState, fn: Callable
                      ) -> PixelTrainState:
    """``fn`` on every per-image leaf of a shared-seg state: the 'prior'
    subtree of the params and of the optimizer's moments (the seg net,
    the step counts and the schedule are shared)."""
    def prior_of(tree):
        if isinstance(tree, dict) and "prior" in tree:
            return dict(tree, prior=T.tree_map(fn, tree["prior"]))
        return tree

    opt = state.opt_state
    opt = type(opt)(*[prior_of(x) for x in opt])
    return state._replace(params=prior_of(state.params), opt_state=opt)


def train_pixel_models(wrapper, stacked_params: Params, px: torch.Tensor,
                       gt: torch.Tensor, scribble_mask: torch.Tensor,
                       random_mask: torch.Tensor, cfg: PixelTrainConfig
                       ) -> Tuple[Params, dict]:
    """Train ALL per-image wrapper models at once for ``cfg.num_epochs``:
    px (B, N, C), gt (B, N, 1), masks (B, N)."""
    state = pixel_train_init(wrapper, stacked_params, cfg)
    segment = make_pixel_segment_fn(wrapper, cfg, cfg.num_epochs)
    state, aux = segment(state, px, gt, scribble_mask, random_mask)
    return state.params, aux
