"""Batched post-processing fits: ``make_batched_fit_fn`` with the IoU gate
and one retry from fresh inits, on the fused ICNN kernels (K4 forward, K5
backward, one launch each per step for the whole batch).

A unit is one batch of ``images`` seeded convex shapes (ellipses and
polygons) with noisy unaries, fresh priors from the seed and the retry's
keys. The check follows each sampled batch's first three steps in the
reference from the same params; recomputes each image's gate IoU from its
fitted prior, against the program's score and against the gate (every
shape of this traffic is fitted past it); and takes the reference's loss
at each passing image's returned params against the program's last loss.
(The masks are not scored against the shapes: at 500 of the protocol's
2000 steps some shapes are still far from fitted, and sound fits read as
far off as broken ones.)
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
    from awesome_tpu_torch.fit.prior_fit import make_batched_fit_fn

    cfg, trf = ctx.config, ctx.traffic
    h, w = trf["height"], trf["width"]
    st = types.SimpleNamespace(
        ctx=ctx, h=h, w=w, model=common.port_prior(cfg, h, w, ctx.device),
        gen=inputs.generator(ctx.seed, ctx.device),
        pts=inputs.pixel_points(h, w, ctx.device),
        layout=layout.prior(cfg), kept=[])
    st.cfg = common.fit_config(ctx, cfg["num_steps"])
    st.run = make_batched_fit_fn(st.model, st.cfg)
    # the cell's shapes, two steps: every gate fails, so the retry runs
    init, targets, keys = _draw(st)
    make_batched_fit_fn(st.model, common.short(st.cfg))(
        init, st.pts, targets, retry_keys=keys)
    sync(ctx.device)
    return st


def _draw(st):
    trf, dev = st.ctx.traffic, st.ctx.device
    n = trf["images"]
    fg = inputs.shapes(st.gen, n, st.h, st.w, trf["shapes"], dev)
    targets = inputs.unaries(st.gen, fg, trf["flip"])
    init = layout.draw(st.layout, st.gen, n, dev)
    return init, targets, inputs.keys(st.gen, n)


def unit(st, index: int) -> dict:
    init, targets, keys = _draw(st)
    out, aux = st.run(init, st.pts, targets, retry_keys=keys)
    sync(st.ctx.device)
    if index >= 0:
        st.kept.append({"init": init, "targets": targets,
                        "out": out, "hist": aux["loss_hist"][:, :3].clone(),
                        "last": aux["loss_hist"][:, -1].clone(),
                        "gate_iou": aux["gate_iou"].clone()})
    n, g, steps = st.h * st.w, st.ctx.traffic["images"], st.cfg.num_steps
    return {"kind": "fit", "work": n * g * steps, "steps": steps,
            "flops": counts.fit_flops_per_point_step(st.ctx.config) * n * g
            * steps, "attempts": g}


def bounds(st) -> dict:
    cfg, n, g = st.ctx.config, st.h * st.w, st.ctx.traffic["images"]
    return {"icnn_fwd": counts.icnn_bound_s(cfg, n, g, False)[0],
            "icnn_bwd": counts.icnn_bound_s(cfg, n, g, True)[0]}


def release(st) -> None:
    st.model = st.run = None


def failed(st) -> int:
    return sum(not common.finite(u["hist"], u["last"], u["gate_iou"],
                                 *layout.leaves(u["out"]))
               for u in st.kept)


def check(st) -> dict:
    ctx = st.ctx
    model = rprior.model(ctx.config, st.h, st.w, ctx.device)
    settings = common.reference_fit_settings(ctx.config)
    gaps, dgaps, iou_gaps, finals, fails = [], [], [], [], []
    for i in common.sample(ctx.seed, len(st.kept),
                           ctx.traffic["check_units"]):
        u = st.kept[i]
        for b in range(ctx.traffic["images"]):
            gap, dgap, final = common.follow_gaps(
                model, settings, layout.select(u["init"], b), st.pts,
                u["targets"][b], u["hist"][b].tolist(),
                layout.select(u["out"], b), float(u["last"][b]))
            gaps.append(gap)
            dgaps.append(dgap)
            mask = rfit.masks(model, layout.select(u["out"], b), st.pts)
            gate = rfit.iou(mask, u["targets"][b].reshape(-1) <= 0.5)
            iou_gaps.append(abs(float(u["gate_iou"][b]) - gate))
            fails.append(float(gate < ctx.config["gate_threshold"]))
            if not fails[-1]:  # the first fit's answer
                finals.append(final)
    return {"loss_gap": common.worst(gaps), "dloss_gap": common.worst(dgaps),
            "iou_gap": common.worst(iou_gaps),
            # no image passed its gate: no first fit's answer to compare
            "final_gap": common.worst(finals) if finals else 0.0,
            "gate_fail_share": sum(fails) / len(fails)}
