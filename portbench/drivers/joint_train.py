"""FBMS joint training: ``make_joint_epoch_fn`` (the joint step over an
epoch's batch plan) on a ``WrapperModule`` of the UNet and one prior per
frame, batch norm stateful, the prior on the frame's clean grid.

Set-up makes the sequence, the UNet and the per-frame priors from the
seed and drives the training state through its first three steps with the
window's own call, one batch of distinct frames each; the window goes on
from that state, an epoch (a new permutation of the frames) per unit. The
check follows those three steps in the reference: each step's loss, the
first step's gradients as the optimizers hold them, and each leaf's
change after the three.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from portbench import counts, inputs
from portbench.drivers import common
from portbench.harness import sync
from portbench.reference import joint as rjoint
from portbench.reference import layout
from portbench.reference import prior as rprior

SETUP_STEPS = 3
B1 = 0.9  # both optimizers' first-moment decay


def _clone(tree):
    return layout.tree_map(lambda t: t.detach().clone(), tree)


def setup(ctx):
    from awesome_tpu_torch.fit.trainer import (
        JointTrainConfig,
        epoch_batches,
        joint_train_init,
        make_joint_epoch_fn,
    )
    from awesome_tpu_torch.nn.seg import UNet
    from awesome_tpu_torch.nn.wrapper import WrapperModule

    cfg, trf, dev = ctx.config, ctx.traffic, ctx.device
    h, w, frames = trf["height"], trf["width"], trf["frames"]
    gen = inputs.generator(ctx.seed, dev)
    wrapper = WrapperModule(
        segmentation_module=UNet(in_chn=cfg["seg_in_chn"],
                                 out_chn=cfg["seg_out_chn"], device=dev),
        prior_module=common.port_prior(cfg, h, w, dev),
        input_mode="image", prior_arg_mode="param_clean_grid",
        seg_stateful=True)
    jcfg = JointTrainConfig(
        lr=cfg["joint_lr"], prior_lr=cfg["joint_prior_lr"],
        optimizer=cfg["joint_optimizer"],
        prior_optimizer=cfg["joint_prior_optimizer"],
        flow_weight_decay=cfg["flow_weight_decay"], alpha=cfg["joint_alpha"],
        beta=cfg["joint_beta"], clip_penalty=cfg["joint_clip_penalty"])
    fg = inputs.moving_ellipse(gen, frames, h, w, trf["motion"], dev)
    data = inputs.joint_frames(gen, fg)
    seg = layout.select(layout.draw(layout.unet(cfg), gen, 1, dev), 0)
    seg_state = layout.unet_state(cfg, dev)
    priors = layout.draw(layout.prior(cfg), gen, frames, dev)
    st = types.SimpleNamespace(
        ctx=ctx, data=data, rng=np.random.default_rng(ctx.seed),
        epoch=make_joint_epoch_fn(wrapper, jcfg), plan=epoch_batches,
        start={"seg": _clone(seg), "seg_state": _clone(seg_state),
               "prior": _clone(priors)})
    state = joint_train_init(wrapper, None, frames, jcfg,
                             seg_init=(seg, seg_state), prior_init=priors)
    idx, wgt = epoch_batches(frames, trf["batch"], st.rng)
    st.rows = idx[:SETUP_STEPS].tolist()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if ctx.control:  # the control: the same steps with TF32 on
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        losses = []
        for k in range(SETUP_STEPS):
            state, m = st.epoch(state, data, idx[k:k + 1], wgt[k:k + 1])
            losses.append(m["loss"][0])
            if k == 0:
                st.first = {
                    "seg": layout.tree_map(lambda t: t / (1 - B1),
                                           _clone(state.seg_opt.m)),
                    "prior": layout.tree_map(lambda t: t / (1 - B1),
                                             _clone(state.prior_opt.m))}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    st.losses = [float(x) for x in losses]
    st.after = {"seg": _clone(state.seg_params),
                "seg_state": _clone(state.seg_state),
                "prior": _clone(state.prior_params)}
    st.state, st.skipped = state, []
    sync(dev)
    return st


def unit(st, index: int) -> dict:
    trf = st.ctx.traffic
    idx, wgt = st.plan(trf["frames"], trf["batch"], st.rng)
    st.state, m = st.epoch(st.state, st.data, idx, wgt)
    sync(st.ctx.device)
    st.skipped.append(m["nan_skipped"].sum())
    steps = len(idx)
    return {"kind": "train", "work": steps, "steps": steps,
            "flops": counts.joint_flops_per_step(
                st.ctx.config, trf["height"], trf["width"], trf["batch"])
            * steps, "attempts": steps}


def bounds(st) -> dict:
    return {}


def release(st) -> None:
    st.state = st.epoch = None


def failed(st) -> int:
    return int(sum(int(s) for s in st.skipped))


def _norms(tree) -> list:
    return [float(torch.linalg.vector_norm(t.to(torch.float32)))
            for t in layout.leaves(tree)]


def norm_gap(prog: list, ref: list, keep: list) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, relative to the larger of the reference's norm of that
    leaf and of the median kept leaf."""
    med = float(np.median([r for r, k in zip(ref, keep) if k]))
    return max(abs(p - r) / max(r, med)
               for p, r, k in zip(prog, ref, keep) if k)


def check(st) -> dict:
    ctx = st.ctx
    trf = ctx.traffic
    model = rprior.model(ctx.config, trf["height"], trf["width"],
                         ctx.device)
    ref = rjoint.follow(ctx.config, model, st.start["seg"],
                        st.start["seg_state"], st.start["prior"], st.data,
                        st.rows)
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(st.losses, ref["losses"]))
    g_ref = _norms(ref["first"]["seg"]) + _norms(ref["first"]["prior"])
    g_prog = _norms(st.first["seg"]) + _norms(st.first["prior"])
    # leaves whose reference gradient is nought to rounding (a conv bias
    # before batch norm) move by round-off alone: left out
    med = float(np.median(g_ref))
    keep = [g >= 1e-3 * med for g in g_ref]

    def change(after, start):
        return _norms(layout.tree_map(lambda a, s: a.to(torch.float32)
                                      - s.to(torch.float32), after, start))

    d_ref = change(ref["seg"], st.start["seg"]) \
        + change(ref["prior"], st.start["prior"])
    d_prog = change(st.after["seg"], st.start["seg"]) \
        + change(st.after["prior"], st.start["prior"])
    s_ref = change(_stats(ref["seg_state"]), _stats(st.start["seg_state"]))
    s_prog = change(_stats(st.after["seg_state"]),
                    _stats(st.start["seg_state"]))
    return {"loss_gap": loss_gap,
            "grad_gap": norm_gap(g_prog, g_ref, keep),
            "step_gap": norm_gap(d_prog + s_prog, d_ref + s_ref,
                                 keep + [True] * len(s_ref))}


def _stats(state) -> dict:
    """The batch-norm running means and variances (not the counts)."""
    return {k: ({"mean": v["mean"], "var": v["var"]} if "mean" in v
                else _stats(v)) for k, v in state.items()}
