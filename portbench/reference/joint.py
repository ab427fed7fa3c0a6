"""The joint FBMS training step in plain PyTorch.

Per step, for the batch's frames: the UNet's sigmoid output and each
frame's own prior's sigmoid output on the frame's pixel grid; per frame the
loss ``alpha * mean(w * BCE(seg, target)) + beta * s * mean((seg -
prior)^2)`` with the sssdms class weights w (foreground, encoded 0,
weighted ``round(bg/fg / 10) + 1``; BCE on probabilities clamped to [1e-7,
1 - 1e-7]) and ``s`` the detached scale that keeps the penalty at most the
segmentation loss; the batch loss is the frames' weighted mean. Adam on
the UNet, Adamax with the flow's weight decay on the batch's priors (each
frame its own moments and count), the convexity clip on the priors; a step
whose loss is not finite changes nothing.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from portbench.reference import fit as rfit
from portbench.reference import unet as runet
from portbench.reference.layout import leaves, rebuild, select


def sssdms_weights(target: torch.Tensor) -> torch.Tensor:
    bg = target >= 0.5
    bg_count = bg.sum().to(torch.float32)
    fg_count = torch.clamp_min((~bg).sum().to(torch.float32), 1.0)
    w_fg = torch.round(bg_count / fg_count / 10.0) + 1.0
    return torch.where(bg, torch.ones_like(target), w_fg)


def bce(p: torch.Tensor, t: torch.Tensor, eps: float = 1e-7):
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))


def frame_loss(seg, prior, target, alpha: float, beta: float, clip: bool):
    seg_loss = alpha * torch.mean(bce(seg, target) * sssdms_weights(target))
    pen = beta * torch.mean((seg - prior) ** 2)
    if clip:
        scale = torch.where(pen > seg_loss,
                            seg_loss / torch.clamp_min(pen, 1e-12),
                            torch.ones_like(pen)).detach()
        pen = pen * scale
    return seg_loss + pen


def follow(cfg: dict, prior_model, seg_p: dict, seg_s: dict, priors: dict,
           data: dict, rows: Sequence[Sequence[int]]) -> dict:
    """The joint steps of ``rows`` (each a batch's frame indices) from
    ``seg_p``, ``seg_s`` and the stacked ``priors``: the losses, the first
    step's gradients as the optimizers get them (the seg net's; each
    prior's plus its weight decay, zero for frames not in the batch), and
    the params and batch-norm state after the last step."""
    h, w = data["target"].shape[1:3]
    grid = data["grid"]
    n_frames = data["target"].shape[0]
    sp = [t.clone() for t in leaves(seg_p)]
    pp = [t.clone() for t in leaves(priors)]
    sm = [torch.zeros_like(t) for t in sp]
    sv = [torch.zeros_like(t) for t in sp]
    pm = [torch.zeros_like(t) for t in pp]
    pu = [torch.zeros_like(t) for t in pp]
    p_count = torch.zeros(n_frames, dtype=torch.int64)
    wd = leaves(prior_model.weight_decay(select(priors, 0),
                                         cfg["flow_weight_decay"]))
    state = seg_s
    losses: List[float] = []
    first = None
    for k, idx in enumerate(rows, start=1):
        idx = list(idx)
        seg_leaves = [t.detach().requires_grad_(True) for t in sp]
        pri_leaves = [t[idx].detach().requires_grad_(True) for t in pp]
        with torch.enable_grad():
            logits, new_state = runet.apply(
                rebuild(seg_p, iter(seg_leaves)), state,
                data["image"][idx], data["features"][idx])
            seg = torch.sigmoid(logits)
            pri_tree = rebuild(priors, iter(pri_leaves))
            total = 0.0
            for j, f in enumerate(idx):
                out = torch.sigmoid(prior_model.apply(select(pri_tree, j),
                                                      grid))
                total = total + frame_loss(
                    seg[j].permute(2, 0, 1), out.reshape(h, w, 1)
                    .permute(2, 0, 1), data["target"][f].permute(2, 0, 1),
                    cfg["joint_alpha"], cfg["joint_beta"],
                    cfg["joint_clip_penalty"])
            loss = total / len(idx)
            grads = torch.autograd.grad(loss, seg_leaves + pri_leaves)
        losses.append(float(loss.detach()))
        if not torch.isfinite(loss):
            continue
        g_seg, g_pri = grads[:len(sp)], grads[len(sp):]
        if first is None:
            first_pri = [torch.zeros_like(t) for t in pp]
            for z, g, p_, d in zip(first_pri, g_pri, pp, wd):
                z[idx] = g + d * p_[idx]
            first = {"seg": rebuild(seg_p, iter(list(g_seg))),
                     "prior": rebuild(priors, iter(first_pri))}
        new = [rfit.adam(p_, g, m, v, k, cfg["joint_lr"], 0.0)
               for p_, g, m, v in zip(sp, g_seg, sm, sv)]
        sp, sm, sv = ([n[0] for n in new], [n[1] for n in new],
                      [n[2] for n in new])
        p_count[idx] += 1
        cnt = p_count[idx].to(torch.float32).to(pp[0].device)
        upd = []
        for p_, g, m, u, d in zip(pp, g_pri, pm, pu, wd):
            c = cnt.reshape((-1,) + (1,) * (g.ndim - 1))
            gg = g + d * p_[idx]
            m_new = 0.9 * m[idx] + 0.1 * gg
            u_new = torch.maximum(0.999 * u[idx], torch.abs(gg) + 1e-8)
            upd.append((p_[idx] - cfg["joint_prior_lr"] / (1.0 - 0.9 ** c)
                        * m_new / u_new, m_new, u_new))
        clipped = leaves(prior_model.clip(rebuild(
            priors, iter([n[0] for n in upd]))))
        for p_, m, u, n, c in zip(pp, pm, pu, upd, clipped):
            p_[idx], m[idx], u[idx] = c, n[1], n[2]
        state = new_state
    return {"losses": losses, "first": first,
            "seg": rebuild(seg_p, iter(sp)), "seg_state": state,
            "prior": rebuild(priors, iter(pp))}
