"""The per-frame pretrain: ``fit_priors_sequential`` on the fused flagship
kernel, a cold fit of the first frame and warm fits of the rest, each from
the previous frame's params.

A unit is one sequence: a moving ellipse over ``frames`` frames with noisy
unaries, and a fresh prior from the seed. The check follows each sampled
sequence's cold fit for three steps in the reference, from the same
params; takes the reference's loss at the cold fit's returned params
against the program's last loss; runs one warm fit of the run, drawn from
the seed, whole in the reference from the program's previous frame's
answer, and compares the losses of the two answers; and scores the warm
frames' masks against their ellipses. (A cold fit of 500 steps from a
drawn prior, with no prefit, has not always found the object, in the
reference as in the program; the warm fits that carry it on have.)
"""
from __future__ import annotations

import types

from portbench import counts, inputs
from portbench.drivers import common
from portbench.harness import sync
from portbench.reference import fit as rfit
from portbench.reference import layout
from portbench.reference import prior as rprior


def setup(ctx):
    from awesome_tpu_torch.fit.prior_fit import fit_priors_sequential

    cfg, trf = ctx.config, ctx.traffic
    h, w = trf["height"], trf["width"]
    st = types.SimpleNamespace(
        ctx=ctx, h=h, w=w, fit=fit_priors_sequential,
        model=common.port_prior(cfg, h, w, ctx.device),
        gen=inputs.generator(ctx.seed, ctx.device),
        pts=inputs.pixel_points(h, w, ctx.device),
        layout=layout.prior(cfg), kept=[])
    st.cfg = common.fit_config(ctx, cfg["num_steps"], fused=True,
                               nan_guard_grads=False)
    st.warm = common.short(st.cfg, cfg["warm_steps"])
    st.steps = cfg["num_steps"] + (trf["frames"] - 1) * cfg["warm_steps"]
    # the cell's shapes, two steps a frame
    init, targets, _ = _draw(st)
    st.fit(st.model, init, st.pts, targets, common.short(st.cfg),
           warm_cfg=common.short(st.warm))
    sync(ctx.device)
    return st


def _draw(st):
    trf = st.ctx.traffic
    fg = inputs.moving_ellipse(st.gen, trf["frames"], st.h, st.w,
                               trf["motion"], st.ctx.device)
    targets = inputs.unaries(st.gen, fg, trf["flip"])
    init = layout.select(layout.draw(st.layout, st.gen, 1, st.ctx.device),
                         0)
    return init, targets, fg


def unit(st, index: int) -> dict:
    init, targets, fg = _draw(st)
    out, aux = st.fit(st.model, init, st.pts, targets, st.cfg,
                      warm_cfg=st.warm)
    sync(st.ctx.device)
    if index >= 0:
        st.kept.append({"init": init, "targets": targets, "fg": fg,
                        "out": out,
                        "hist": aux["first_aux"]["loss_hist"][:3].clone(),
                        "last": aux["first_aux"]["loss_hist"][-1].clone()})
    n = st.h * st.w
    return {"kind": "fit", "work": n * st.steps, "steps": st.steps,
            "flops": counts.fit_flops_per_point_step(st.ctx.config) * n
            * st.steps, "attempts": st.ctx.traffic["frames"]}


def bounds(st) -> dict:
    return {"flagship": counts.flagship_bound_s(
        st.ctx.config, st.h * st.w, 1, bf16=st.ctx.control)[0]}


def release(st) -> None:
    st.model = st.fit = None


def failed(st) -> int:
    return sum(not common.finite(u["hist"], u["last"],
                                 *layout.leaves(u["out"]))
               for u in st.kept)


def check(st) -> dict:
    ctx = st.ctx
    model = rprior.model(ctx.config, st.h, st.w, ctx.device)
    settings = common.reference_fit_settings(ctx.config)
    gaps, dgaps, finals, misses = [], [], [], []
    frames = ctx.traffic["frames"]
    picked = common.sample(ctx.seed, len(st.kept),
                           ctx.traffic["check_units"])
    for i in picked:
        u = st.kept[i]
        gap, dgap, final = common.follow_gaps(
            model, settings, u["init"], st.pts, u["targets"][0],
            u["hist"].tolist(), layout.select(u["out"], 0), float(u["last"]))
        gaps.append(gap)
        dgaps.append(dgap)
        finals.append(final)
        for f in range(1, frames):
            mask = rfit.masks(model, layout.select(u["out"], f), st.pts)
            misses.append(1.0 - rfit.iou(mask, u["fg"][f].reshape(-1)))
    # one warm fit, drawn from the seed, whole from the program's previous
    # answer (its warm_steps never reach the plateau's patience)
    u = st.kept[picked[0]]
    f = 1 + common.sample(ctx.seed + 1, frames - 1, 1)[0]
    warm = common.warm_gap(model, settings, layout.select(u["out"], f - 1),
                           st.pts, u["targets"][f], layout.select(u["out"], f),
                           ctx.config["warm_steps"])
    return {"loss_gap": common.worst(gaps), "dloss_gap": common.worst(dgaps),
            "final_gap": common.worst(finals), "warm_gap": warm,
            "fit_miss": common.worst(misses)}
