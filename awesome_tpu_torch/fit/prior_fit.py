"""The prior-fit engine; counterpart of ``awesome_tpu/fit/prior_fit.py``.

Per image: ``num_steps`` Adamax steps of ``sigmoid(prior(points))`` against
the unaries with a weighted SE, a flow weight-decay group, the convexity
clip AFTER each step, ReduceLROnPlateau and a NaN guard. The JAX package
runs the steps as one ``lax.scan``; here they are a Python loop that never
waits on the device: the learning rate, the plateau state, the NaN guard,
the ``active`` mask and ``lr_stop_scale`` are all device tensors combined
with ``torch.where``, and ``loss_hist`` stays on the device until the end.

Batches of images carry a leading image axis on every tensor (the stacked
param tree); each image keeps its own plateau and NaN-guard state, as JAX's
``vmap`` over the single-image fit does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from awesome_tpu_torch.core import grids as G
from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.fit import optim
from awesome_tpu_torch.measures.losses import unaries_weight
from awesome_tpu_torch.measures.metrics import iou
from awesome_tpu_torch.nn.module import make_generator
from awesome_tpu_torch.parallel.mesh import sum_trees

Params = Any


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Static configuration of a prior fit; the fields of the JAX
    package's ``FitConfig``. ``unroll`` has no effect here (there is no
    scan to unroll). ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the
    model math in that type, with FP32 master params, optimizer state and
    loss: the fused route takes the kernel's bf16 build, the autograd
    route casts params and points (:func:`apply_in_dtype`)."""

    num_steps: int = 2000
    lr: float = 1e-3
    optimizer: str = "adamax"  # 'adamax' | 'adam'
    flow_weight_decay: float = 1e-5
    use_sigmoid: bool = True
    weight_mode: str = "none"  # unaries_weight mode
    fg_weight: Optional[float] = None  # how-to fg/bg weighting
    plateau_patience: int = 200
    plateau_factor: float = 0.5
    # updates freeze once the plateau scale decays below this
    lr_stop_scale: float = 0.0
    nan_guard: bool = True
    # also require every gradient to be finite (autograd path only)
    nan_guard_grads: bool = True
    gate_threshold: Optional[float] = None  # IoU acceptance gate
    gate_retries: int = 1
    dtype: Any = torch.float32
    unroll: int = 1
    compute_dtype: Any = None
    # the whole loss+grad of a step in one CUDA kernel (flagship models)
    fused: bool = False


def make_point_weights(target_points: torch.Tensor, cfg: FitConfig,
                       point_mask: Optional[torch.Tensor] = None,
                       grid_sum: Optional[Callable] = None) -> torch.Tensor:
    """Per-point loss weights W so that loss = sum(W * se).

    UnariesWeightedLoss(mode) with mean reduction gives W = class_w / N;
    the how-to ``fg_weight`` scheme gives fg_w / fg_count on fg points and
    (1 - fg_w) / bg_count on bg. ``point_mask`` (N,) bool: padded points
    get weight 0 and are left out of every count. ``grid_sum``: the points
    are this rank's block of the image's (a mesh's grid axis) and every
    count is summed over the blocks, so the weights are the whole image's.
    """
    total = grid_sum or (lambda c: c)
    t = target_points
    m = None
    if point_mask is not None:
        m = torch.broadcast_to(
            point_mask.to(cfg.dtype).reshape(t.shape[:-1] + (1,)), t.shape)
    if cfg.fg_weight is not None:
        bg = (t >= 0.5).to(cfg.dtype)
        if m is not None:
            is_bg = bg * m
            not_bg = (1.0 - bg) * m
        else:
            is_bg = bg
            not_bg = 1.0 - bg
        bg_count = torch.clamp_min(total(is_bg.sum()), 1.0)
        fg_count = torch.clamp_min(total(not_bg.sum()), 1.0)
        w = torch.where(t >= 0.5, (1.0 - cfg.fg_weight) / bg_count,
                        cfg.fg_weight / fg_count)
        return w if m is None else w * m
    w = unaries_weight(t, mode=cfg.weight_mode, mask=m, count_sum=grid_sum)
    if m is None:
        return w / total(torch.tensor(t.numel()))
    return w / torch.clamp_min(total(m.sum()), 1.0)


def _optim_fns(cfg: FitConfig):
    if cfg.optimizer == "adamax":
        return optim.adamax_init, optim.adamax_update
    if cfg.optimizer == "adam":
        return optim.adam_init, optim.adam_update
    raise ValueError(f"Unknown optimizer {cfg.optimizer}")


def make_weight_decay_tree(model, params: Params, cfg: FitConfig) -> Params:
    """Flow leaves get ``flow_weight_decay``, everything else 0."""
    if hasattr(model, "param_groups"):
        return T.tree_map(
            lambda s: cfg.flow_weight_decay if s == "flow" else 0.0,
            model.param_groups(params))
    return T.tree_map(lambda _: 0.0, params)


def _all_finite(grads: Params, batch_shape: Tuple[int, ...]) -> torch.Tensor:
    flags = [torch.isfinite(g).reshape(batch_shape + (-1,)).all(dim=-1)
             for g in T.tree_leaves(grads)]
    return torch.stack(flags).all(dim=0)


def run_fit_loop(loss_grad: Callable, params: Params, cfg: FitConfig,
                 weight_decay: Params, clip: Callable, active=True,
                 batch_shape: Tuple[int, ...] = (),
                 check_grads: bool = False, group_mean: bool = False):
    """The step loop shared by every fit engine.

    ``loss_grad(params) -> (loss, grads)``; the loss has ``batch_shape``
    (one value per image). ``group_mean``: one optimizer/plateau state for
    the whole group, driven by the mean loss (the grouped fused fit).
    Returns ``(params, loss_hist (steps, *batch_shape), lr_scale)``. Adds
    the steps it ran to ``run_fit_loop.steps``.
    """
    init_fn, update_fn = _optim_fns(cfg)
    dev = T.tree_leaves(params)[0].device
    state_shape = () if group_mean else batch_shape
    opt_state = init_fn(params, state_shape)
    sched = optim.plateau_init(cfg.dtype, state_shape, dev)
    active = torch.as_tensor(active, device=dev)
    hist = []
    for _ in range(cfg.num_steps):
        loss_vec, grads = loss_grad(params)
        loss = loss_vec.mean() if group_mean else loss_vec
        lr = cfg.lr * sched.scale
        new_params, new_opt = update_fn(params, grads, opt_state, lr,
                                        weight_decay=weight_decay)
        new_params = clip(new_params)
        if cfg.nan_guard:
            ok = torch.isfinite(loss_vec)
            if group_mean:
                ok = ok.all()
            if check_grads:
                ok = ok & _all_finite(grads, batch_shape)
        else:
            ok = torch.ones(state_shape, dtype=torch.bool, device=dev)
        if cfg.lr_stop_scale > 0.0:
            ok = ok & (sched.scale > cfg.lr_stop_scale)
        ok = ok & active
        params = T.tree_where(ok, new_params, params)
        opt_state = T.tree_where(ok, new_opt, opt_state)
        sched = optim.plateau_update(sched, loss, factor=cfg.plateau_factor,
                                     patience=cfg.plateau_patience)
        hist.append(loss_vec)
    run_fit_loop.steps += cfg.num_steps
    if hist:
        loss_hist = torch.stack(hist)
    else:
        loss_hist = torch.zeros((0,) + batch_shape, device=dev)
    return params, loss_hist, sched.scale


run_fit_loop.steps = 0


def summed_over_points(loss_grad: Callable,
                       grid_sum: Optional[Callable]) -> Callable:
    """``loss_grad`` whose loss and grads, partial sums over this rank's
    block of the points, are summed over the blocks (a mesh's grid axis)
    in ONE reduction; ``loss_grad`` itself without ``grid_sum``."""
    if grid_sum is None:
        return loss_grad

    def summed(p):
        return sum_trees(grid_sum, *loss_grad(p))

    return summed


def apply_in_dtype(model, params: Params, points: torch.Tensor,
                   dtype) -> torch.Tensor:
    """``model.apply`` with params and points cast to ``dtype`` and the
    output cast back to float32, as the JAX package's autograd route does
    under ``compute_dtype``; the grads reach the FP32 params through the
    casts.

    A fused ICNN (K4/K5) on the card follows the JAX kernel on a TPU
    instead: its FP32 kernels take the params and points rounded to
    ``dtype``. (On the CPU, like the JAX package off the TPU, it runs its
    plain version in ``dtype``.)"""
    from awesome_tpu_torch.ops.mlp import fused_icnn

    if points.device.type == "cuda" and fused_icnn(model):
        def rnd(t):
            return t.to(dtype).to(torch.float32)

        return model.apply(T.tree_map(rnd, params), rnd(points))
    out = model.apply(T.tree_map(lambda p: p.to(dtype), params),
                      points.to(dtype))
    return out.to(torch.float32)


def _default_loss(model, cfg: FitConfig) -> Callable:
    def loss_fn(params, points, target, weights):
        if cfg.compute_dtype is not None:
            out = apply_in_dtype(model, params, points, cfg.compute_dtype)
        else:
            out = model.apply(params, points)
        prob = torch.sigmoid(out) if cfg.use_sigmoid else out
        return torch.sum(weights * (prob - target) ** 2)

    return loss_fn


def make_fit_fn(model, cfg: FitConfig,
                loss_fn: Optional[Callable] = None) -> Callable:
    """Build ``fit(params, points, target_points, active=True,
    point_mask=None) -> (params, aux)`` for one image.

    ``points``: (N, C); ``target_points``: (N, 1) unaries.
    ``loss_fn(params, points, target, weights) -> scalar`` may replace the
    default weighted SE on the sigmoid output. ``cfg.fused`` (and no
    ``loss_fn``) routes to the fused CUDA kernel.
    """
    if cfg.fused and loss_fn is None:
        from awesome_tpu_torch.fit.fused_fit import make_fused_fit_fn

        return make_fused_fit_fn(model, cfg)
    loss_fn = loss_fn or _default_loss(model, cfg)
    clip = getattr(model, "enforce_convexity", lambda p: p)
    gv = torch.func.grad_and_value(loss_fn)

    def fit(params, points, target_points, active=True, point_mask=None):
        weights = make_point_weights(target_points, cfg, point_mask)
        wd = make_weight_decay_tree(model, params, cfg)

        def loss_grad(p):
            grads, loss = gv(p, points, target_points, weights)
            return loss, grads

        params, hist, scale = run_fit_loop(
            loss_grad, params, cfg, wd, clip, active,
            check_grads=cfg.nan_guard_grads)
        return params, {"loss_hist": hist, "lr_scale": scale}

    return fit


def _make_batched_engine(model, cfg: FitConfig, per_image_points: bool,
                         loss_fn: Optional[Callable]) -> Callable:
    """``engine(stacked_params, points, targets, active (B,),
    point_masks=None, grid_sum=None) -> (params, aux)`` with ``loss_hist``
    (B, steps) and ``lr_scale`` (B,) — what ``vmap`` of the single-image
    fit returns. ``grid_sum``: the points are this rank's block (see
    :func:`make_point_weights`); the loss and grads are summed over the
    blocks every step."""
    if cfg.fused and loss_fn is None:
        from awesome_tpu_torch.fit.fused_fit import make_batched_fused_fit_fn

        return make_batched_fused_fit_fn(model, cfg)
    loss_fn = loss_fn or _default_loss(model, cfg)
    clip = getattr(model, "enforce_convexity", lambda p: p)
    vgv = torch.func.vmap(torch.func.grad_and_value(loss_fn),
                          in_dims=(0, 0 if per_image_points else None, 0, 0))

    def engine(stacked, points, targets, active, point_masks=None,
               grid_sum=None):
        weights = _stacked_weights(targets, cfg, point_masks, grid_sum)
        wd = make_weight_decay_tree(model, T.tree_select(stacked, 0), cfg)

        def loss_grad(p):
            grads, loss = vgv(p, points, targets, weights)
            return loss, grads

        params, hist, scale = run_fit_loop(
            summed_over_points(loss_grad, grid_sum), stacked, cfg, wd, clip,
            active,
            batch_shape=(targets.shape[0],),
            check_grads=cfg.nan_guard_grads)
        return params, {"loss_hist": hist.T, "lr_scale": scale}

    return engine


def _stacked_weights(targets: torch.Tensor, cfg: FitConfig,
                     point_masks: Optional[torch.Tensor],
                     grid_sum: Optional[Callable] = None) -> torch.Tensor:
    return torch.stack([
        make_point_weights(targets[b], cfg,
                           None if point_masks is None else point_masks[b],
                           grid_sum)
        for b in range(targets.shape[0])
    ])


def fit_prior(model, params: Params, points: torch.Tensor,
              target_points: torch.Tensor, cfg: FitConfig,
              loss_fn: Optional[Callable] = None) -> Tuple[Params, dict]:
    """Single-image prior fit."""
    return make_fit_fn(model, cfg, loss_fn)(params, points, target_points)


def _gate_iou(out, target_points, cfg: FitConfig,
              point_mask=None, grid_sum=None) -> torch.Tensor:
    """Acceptance IoU of the thresholded prior output ``out`` against the
    thresholded unaries, scored on foreground (fg encoded as 0, hence the
    inversion). Padded points count as agreeing background. ``grid_sum``:
    the intersection and union of this rank's block of the points are
    summed over the blocks first."""
    prob = torch.sigmoid(out) if cfg.use_sigmoid else out
    target = target_points
    if point_mask is not None:
        m = point_mask.reshape(target.shape[:-1] + (1,))
        prob = torch.where(m, prob, torch.ones_like(prob))
        target = torch.where(m, target, torch.ones_like(target))
    return iou(prob > 0.5, target > 0.5, invert=True, count_sum=grid_sum)


def _init_fresh(model, retry_keys: Sequence) -> Params:
    """Fresh stacked params, one per retry key (an int seed or a
    ``torch.Generator``)."""
    return T.stack_trees([model.init(make_generator(k))
                          for k in retry_keys])


def make_gate_retry_fn(model, cfg: FitConfig, per_image_points: bool = False,
                       with_point_masks: bool = False,
                       loss_fn: Optional[Callable] = None) -> Callable:
    """``gr(fitted, points, targets, valid_mask, retry_keys=None,
    point_masks=None, grid_sum=None) -> (fitted, scores)``: scores every
    fit's gate IoU (NaN counts as failed) and, given ``retry_keys``,
    refits the failures from fresh inits for the full ``num_steps``,
    keeping the retry. ``grid_sum``: see :func:`_gate_iou`."""
    del with_point_masks
    refit = _make_batched_engine(
        model, dataclasses.replace(cfg, gate_threshold=None),
        per_image_points, loss_fn)

    def scores_of(stacked, points, targets, point_masks, grid_sum):
        # the whole batch's outputs in one vmapped apply (one launch of a
        # fused ICNN kernel), then each image's IoU
        with torch.no_grad():
            outs = torch.func.vmap(
                model.apply, in_dims=(0, 0 if per_image_points else None))(
                    stacked, points)
        return torch.stack([
            _gate_iou(outs[b], targets[b], cfg,
                      None if point_masks is None else point_masks[b],
                      grid_sum)
            for b in range(targets.shape[0])
        ])

    def gr(fitted, points, stacked_targets, valid_mask, retry_keys=None,
           point_masks=None, grid_sum=None):
        scores = scores_of(fitted, points, stacked_targets, point_masks,
                           grid_sum)
        if (retry_keys is None or cfg.gate_retries <= 0
                or cfg.gate_threshold is None):
            return fitted, scores
        failed = ~(scores >= cfg.gate_threshold) & valid_mask
        fresh = _init_fresh(model, retry_keys)
        refitted, _ = refit(fresh, points, stacked_targets, failed,
                            point_masks, grid_sum=grid_sum)
        retry_scores = scores_of(refitted, points, stacked_targets,
                                 point_masks, grid_sum)
        fitted = T.tree_where(failed, refitted, fitted)
        return fitted, torch.where(failed, retry_scores, scores)

    return gr


def make_batched_fit_fn(model, cfg: FitConfig, per_image_points: bool = False,
                        with_point_masks: bool = False,
                        loss_fn: Optional[Callable] = None,
                        mesh=None) -> Callable:
    """Build the reusable batched fit ``run(stacked_params, points,
    stacked_targets, valid_mask=None, retry_keys=None, point_masks=None)
    -> (fitted, aux)``, with the IoU gate and fresh-init retry when
    ``cfg.gate_threshold`` is set. With ``cfg.fused`` the images are the
    kernel's leading axis; their points are shared, or one set per image
    with ``per_image_points``.

    ``mesh`` (``parallel.mesh.Mesh``): every rank passes the whole batch
    and gets the whole result; each fits its block of the images (the
    'data' axis) on its block of the points (the 'grid' axis), the point
    weights, the per-step loss and grads and the gate's IoU summed over
    the grid axis."""
    engine = _make_batched_engine(model, cfg, per_image_points, loss_fn)
    gate_retry = make_gate_retry_fn(model, cfg, per_image_points,
                                    with_point_masks, loss_fn)

    def run_local(stacked_params, points, stacked_targets, valid_mask,
                  retry_keys, point_masks, grid_sum):
        batch = stacked_targets.shape[0]
        dev = stacked_targets.device
        if valid_mask is None:
            valid_mask = torch.ones((batch,), dtype=torch.bool, device=dev)
        fitted, aux = engine(stacked_params, points, stacked_targets,
                             valid_mask, point_masks, grid_sum=grid_sum)
        gate = torch.ones((batch,), dtype=torch.bool, device=dev)
        if cfg.gate_threshold is not None:
            fitted, scores = gate_retry(fitted, points, stacked_targets,
                                        valid_mask, retry_keys=retry_keys,
                                        point_masks=point_masks,
                                        grid_sum=grid_sum)
            aux["gate_iou"] = scores
            gate = scores >= cfg.gate_threshold
        aux["gate_pass"] = gate
        aux["valid"] = valid_mask
        return fitted, aux

    def run(stacked_params, points, stacked_targets, valid_mask=None,
            retry_keys=None, point_masks=None):
        if mesh is None:
            return run_local(stacked_params, points, stacked_targets,
                             valid_mask, retry_keys, point_masks, None)
        batch, n = stacked_targets.shape[:2]
        ds, gs = mesh.local("data", batch), mesh.local("grid", n)
        fitted, aux = run_local(
            T.tree_map(lambda x: x[ds], stacked_params),
            points[ds, gs] if points.ndim == 3 else points[gs],
            stacked_targets[ds, gs],
            None if valid_mask is None else valid_mask[ds],
            None if retry_keys is None else retry_keys[ds],
            None if point_masks is None else point_masks[ds, gs],
            mesh.reducer("grid", n))
        if not mesh.splits("data", batch):
            return fitted, aux
        return mesh.gather_tree("data", fitted), {
            k: mesh.gather("data", v) if isinstance(v, torch.Tensor) else v
            for k, v in aux.items()}

    return run


def fit_priors_batched(model, stacked_params: Params, points: torch.Tensor,
                       stacked_targets: torch.Tensor, cfg: FitConfig,
                       retry_keys: Optional[Sequence] = None,
                       valid_mask: Optional[torch.Tensor] = None,
                       loss_fn: Optional[Callable] = None,
                       point_masks: Optional[torch.Tensor] = None,
                       mesh=None) -> Tuple[Params, dict]:
    """Fit all images' priors at once: ``stacked_params`` with a leading
    image axis, ``points`` shared (N, C) or per image (B, N, C),
    ``stacked_targets`` (B, N, 1), ``valid_mask`` (B,) bool (invalid
    images pass through), ``retry_keys`` (B,) seeds or generators for the
    gated retry, ``point_masks`` (B, N) bool for padded points. ``mesh``:
    see :func:`make_batched_fit_fn`."""
    run = make_batched_fit_fn(model, cfg,
                              per_image_points=points.ndim == 3,
                              with_point_masks=point_masks is not None,
                              loss_fn=loss_fn, mesh=mesh)
    return run(stacked_params, points, stacked_targets, valid_mask=valid_mask,
               retry_keys=retry_keys, point_masks=point_masks)


def _flat_keys(retry_keys) -> list:
    """(B, K) retry keys (a tensor, an array or nested sequences of seeds
    or generators) -> a flat list of B*K keys."""
    if hasattr(retry_keys, "reshape"):
        return list(retry_keys.reshape(-1).tolist())
    return [k for row in retry_keys for k in row]


def fit_multi_object_priors(child_model, stacked_children: Params,
                            points: torch.Tensor,
                            per_object_targets: torch.Tensor, cfg: FitConfig,
                            retry_keys: Optional[Sequence] = None,
                            valid_mask: Optional[torch.Tensor] = None,
                            loss_fn: Optional[Callable] = None,
                            point_masks: Optional[torch.Tensor] = None
                            ) -> Tuple[Params, dict]:
    """Fit K objects per image at once: the (image x object) axes flatten
    into one batch for the batched engine. ``stacked_children`` carries
    leading (B, K) axes, ``points`` are shared (N, C) or per image
    (B, N, C), ``per_object_targets`` (B, K, N, 1), ``retry_keys`` and
    ``valid_mask`` (B, K) (inactive slots pass through), ``point_masks``
    (B, N). Returns the fitted (B, K, ...) tree and aux reshaped to
    (B, K, ...)."""
    b, k = per_object_targets.shape[:2]

    def flat(x):
        return x.reshape((b * k,) + tuple(x.shape[2:]))

    pts = points.repeat_interleave(k, dim=0) if points.ndim == 3 else points
    fitted, aux = fit_priors_batched(
        child_model, T.tree_map(flat, stacked_children), pts,
        flat(per_object_targets), cfg,
        retry_keys=None if retry_keys is None else _flat_keys(retry_keys),
        valid_mask=None if valid_mask is None else torch.as_tensor(
            valid_mask, device=per_object_targets.device).reshape(b * k),
        loss_fn=loss_fn,
        point_masks=None if point_masks is None else
        point_masks.repeat_interleave(k, dim=0))
    unflat = T.tree_map(lambda x: x.reshape((b, k) + tuple(x.shape[1:])),
                        fitted)
    aux = {key: (v.reshape((b, k) + tuple(v.shape[1:]))
                 if isinstance(v, torch.Tensor) and v.shape[:1] == (b * k,)
                 else v)
           for key, v in aux.items()}
    return unflat, aux


def make_sequential_fit_fn(model, cfg: FitConfig,
                           warm_cfg: Optional[FitConfig] = None,
                           loss_fn: Optional[Callable] = None) -> Callable:
    """Build the sequential (reuse_state) fit ``fit(init_params, points,
    stacked_targets, valid_mask=None, point_masks=None) -> (stacked_params,
    aux)``: image 0 gets a cold fit of ``cfg.num_steps``; each later image
    starts from the previous carry for ``warm_cfg.num_steps`` (default
    200). An invalid image's fit runs with ``active=False``, so its output
    slot holds the carry unchanged, and the carry passes through it. The
    images are a Python loop; no step waits on the host."""
    warm_cfg = warm_cfg or dataclasses.replace(cfg, num_steps=200)
    cold_fit = make_fit_fn(model, cfg, loss_fn)
    warm_fit = make_fit_fn(model, warm_cfg, loss_fn)

    def fit(init_params, points, stacked_targets, valid_mask=None,
            point_masks=None):
        batch = stacked_targets.shape[0]
        dev = stacked_targets.device
        valid = (torch.ones((batch,), dtype=torch.bool, device=dev)
                 if valid_mask is None
                 else torch.as_tensor(valid_mask, device=dev))

        def args(b):
            pts = points[b] if points.ndim == 3 else points
            mask = None if point_masks is None else point_masks[b]
            return pts, stacked_targets[b], valid[b], mask

        carry, aux0 = cold_fit(init_params, *args(0))
        outs, scales = [carry], []
        for b in range(1, batch):
            fitted, aux = warm_fit(carry, *args(b))
            carry = T.tree_where(valid[b], fitted, carry)
            outs.append(fitted)
            scales.append(aux["lr_scale"])
        rest = (torch.stack(scales) if scales
                else torch.zeros((0,), device=dev))
        return T.stack_trees(outs), {"first_aux": aux0,
                                     "warm_lr_scale": rest}

    return fit


def fit_priors_sequential(model, init_params: Params, points: torch.Tensor,
                          stacked_targets: torch.Tensor, cfg: FitConfig,
                          warm_cfg: Optional[FitConfig] = None,
                          valid_mask: Optional[torch.Tensor] = None,
                          loss_fn: Optional[Callable] = None,
                          point_masks: Optional[torch.Tensor] = None
                          ) -> Tuple[Params, dict]:
    """The sequential fit with warm-start carry (``reuse_state``): see
    :func:`make_sequential_fit_fn`. Returns the stacked per-image fitted
    params and aux."""
    fit = make_sequential_fit_fn(model, cfg, warm_cfg, loss_fn)
    return fit(init_params, points, stacked_targets, valid_mask, point_masks)


# --- prefits -----------------------------------------------------------------


def apply_prefits(model, params: Params, points: torch.Tensor,
                  prefit_flow_identity: bool = False,
                  flow_identity_lr: float = 1e-2,
                  flow_identity_weight_decay: float = 1e-5,
                  flow_identity_steps: int = 100,
                  prefit_convex: bool = False, convex_mode: str = "circle",
                  convex_target: Optional[torch.Tensor] = None,
                  grid_shape: Optional[Tuple[int, int]] = None,
                  convex_lr: float = 1e-3, convex_weight_decay: float = 0.0,
                  convex_steps: int = 200, zoo=None,
                  zoo_key: Optional[str] = None) -> Params:
    """The warm-start prefits as one entry point: the flow towards the
    identity on the grid, then the ICNN on a circle approximation or the
    unaries. Models without ``flow_net``/``convex_net`` pass through
    unchanged. With a ``zoo`` (``nn.zoo.Zoo``) the flow prefit is loaded
    from it when cached under ``zoo_key`` (default: the points' shape),
    else fitted and saved there."""
    if not (hasattr(model, "flow_net") and hasattr(model, "convex_net")):
        return params
    if prefit_flow_identity:
        name = zoo_key or f"flow_identity_{tuple(points.shape)}_0"
        cached = None
        if zoo is not None:
            cached, _ = zoo.load_model_state(name, model.flow_net,
                                             params["flow"])
            if cached is not None:
                params = dict(params, flow=cached)
        if cached is None:
            params, _ = learn_flow_identity(
                model, params, points, lr=flow_identity_lr,
                weight_decay=flow_identity_weight_decay,
                max_iter=flow_identity_steps)
            if zoo is not None:
                zoo.save_model_state(name, model.flow_net, params["flow"])
    if prefit_convex and convex_target is not None:
        params, _ = learn_convex_net(
            model, params, points, convex_target, mode=convex_mode,
            grid_shape=grid_shape, lr=convex_lr,
            weight_decay=convex_weight_decay, max_iter=convex_steps)
    return params


def _guarded_loop(loss_grad: Callable, params: Params, update: Callable,
                  state, clip: Callable, steps: int):
    """``steps`` optimizer steps that skip any step whose loss is not
    finite; returns (params, loss history)."""
    hist = []
    for _ in range(steps):
        grads, loss = loss_grad(params)
        new_params, new_state = update(params, grads, state)
        ok = torch.isfinite(loss)
        params = T.tree_where(ok, clip(new_params), params)
        state = T.tree_where(ok, new_state, state)
        hist.append(loss)
    return params, torch.stack(hist)


def learn_flow_identity(model, params: Params, points: torch.Tensor,
                        lr: float = 1e-2, weight_decay: float = 1e-5,
                        max_iter: int = 100) -> Tuple[Params, torch.Tensor]:
    """Prefit the flow (inside its norm wrap) to the identity on the grid:
    SE between flow(x) and x, Adamax with weight decay and a NaN guard.
    Returns the params with the new flow, and the loss history."""

    def flow_apply(fp, x):
        x_in = model.norm.transform(x) if model.norm is not None else x
        y = model.flow_net.apply(fp, x_in)
        return model.norm.inverse_transform(y) if model.norm is not None \
            else y

    def loss_fn(fp, x):
        return torch.mean((flow_apply(fp, x) - x) ** 2)

    gv = torch.func.grad_and_value(loss_fn)
    wd = T.tree_map(lambda _: weight_decay, params["flow"])
    flow, hist = _guarded_loop(
        lambda fp: gv(fp, points), params["flow"],
        lambda p, g, st: optim.adamax_update(p, g, st, lr, weight_decay=wd),
        optim.adamax_init(params["flow"]), lambda p: p, max_iter)
    return dict(params, flow=flow), hist


def learn_convex_net(model, params: Params, points: torch.Tensor,
                     target_points: torch.Tensor, mode: str = "circle",
                     use_deformed_grid: bool = True,
                     grid_shape: Optional[Tuple[int, int]] = None,
                     lr: float = 1e-3, weight_decay: float = 0.0,
                     max_iter: int = 200) -> Tuple[Params, torch.Tensor]:
    """Prefit the ICNN, on the deformed grid (its gradient stopped), to a
    circle with the unaries' fg area and center of mass (``mode='circle'``,
    needs ``grid_shape``) or to the unaries themselves: SE on the sigmoid,
    Adam, the convexity clip after each step, a NaN guard."""
    if mode == "circle":
        if grid_shape is None:
            raise ValueError("grid_shape required for circle mode")
        fg = 1.0 - target_points.reshape(grid_shape)  # fg encoded as 0
        circle = G.unary_circle_approximation(fg)
        y = (1.0 - circle.to(points.dtype)).reshape(-1, 1)
    elif mode == "unaries":
        y = target_points
    else:
        raise ValueError("Mode must be either 'circle' or 'unaries'!")
    with torch.no_grad():
        x = model.deformation(params, points) if use_deformed_grid \
            else points

    def loss_fn(cp, x_, y_):
        prob = torch.sigmoid(model.convex_net.apply(cp, x_))
        return torch.mean((prob - y_) ** 2)

    gv = torch.func.grad_and_value(loss_fn)
    wd = T.tree_map(lambda _: weight_decay, params["convex"])
    convex, hist = _guarded_loop(
        lambda cp: gv(cp, x, y), params["convex"],
        lambda p, g, st: optim.adam_update(p, g, st, lr, weight_decay=wd),
        optim.adam_init(params["convex"]),
        model.convex_net.enforce_convexity, max_iter)
    return dict(params, convex=convex), hist
