"""The sharded fused fit across cards: ``make_batched_fit_fn(model,
FitConfig(fused=True), mesh=...)`` on a (data, grid) mesh of one rank per
card (NCCL), started by ``parallel/launch.py``. On a (1, C) mesh every
rank fits all frames on its block of each frame's points, so every step
all-reduces the (G, P + 1) losses and grads over the cards.

A unit is one batch of ``frames`` frames of a moving ellipse with noisy
unaries and fresh priors; every rank draws the same whole inputs from the
seed on its own card. Set-up pays the first collectives of every
communicator the run uses. Rank 0 decides when the window ends and the
others follow it. The traced units start after a barrier inside the
profiled region, so no rank's wait for another's profiler start-up is
read as work. The check runs in the calling process once the ranks have
ended: the reference follows each frame's first three steps over the
whole frame, and takes its loss at each frame's returned params against
the program's last loss. (A cold fit of 500 steps from a drawn prior has
not always found the object, so the masks are not scored.)
"""
from __future__ import annotations

import dataclasses
import sys
import time
import types

import torch

from portbench import counts, harness, inputs
from portbench.drivers import common
from portbench.reference import layout
from portbench.reference import prior as rprior


def measure(ctx, seconds: float, trace: bool, start_wall: float):
    from awesome_tpu_torch.parallel.launch import spawn

    results = spawn(rank_main, ctx.chips, (ctx, seconds, trace, start_wall),
                    device=ctx.device)
    return assemble(ctx, results)


def _agree(go: bool, device) -> bool:
    """Rank 0's ``go``, on every rank."""
    import torch.distributed as dist

    flag = torch.tensor([1.0 if go else 0.0], device=device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def rank_main(ctx, seconds: float, trace: bool, start_wall: float) -> dict:
    """One rank's run: set-up, the window, the traced units; rank 0 also
    hands back what the check needs, on the host."""
    import torch.distributed as dist

    from awesome_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(tuple(ctx.traffic["mesh"]))
    rctx = dataclasses.replace(ctx, device=str(mesh.device))
    st = setup(rctx, mesh)
    record = harness.measure(
        sys.modules[__name__], st, rctx, seconds, trace,
        agree=lambda go: _agree(go, mesh.device),
        start=lambda: (mesh.barrier(), harness.sync(rctx.device)))
    record["setup_s"] = st.setup_done - start_wall
    # the window ran here, not in the process that prints the result
    record["forbidden"] = harness.forbidden_modules()
    out = {"record": record}
    if dist.get_rank() == 0:
        out["kept"] = [layout.tree_map(lambda t: t.cpu(), u)
                       for u in st.kept]
    return out


def setup(ctx, mesh):
    from awesome_tpu_torch.fit.prior_fit import make_batched_fit_fn

    cfg, trf = ctx.config, ctx.traffic
    h, w = trf["height"], trf["width"]
    st = types.SimpleNamespace(
        ctx=ctx, h=h, w=w, mesh=mesh,
        model=common.port_prior(cfg, h, w, ctx.device),
        gen=inputs.generator(ctx.seed, ctx.device),
        pts=inputs.pixel_points(h, w, ctx.device),
        layout=layout.prior(cfg), kept=[])
    st.cfg = common.fit_config(ctx, cfg["num_steps"], fused=True,
                               nan_guard_grads=False)
    st.run = make_batched_fit_fn(st.model, st.cfg, mesh=mesh)
    # the cell's shapes for two steps (the grid group's first all_reduce),
    # the world's first broadcast, then every rank at the start line
    init, targets, _ = _draw(st)
    make_batched_fit_fn(st.model, common.short(st.cfg), mesh=mesh)(
        init, st.pts, targets)
    _agree(True, mesh.device)
    mesh.barrier()
    harness.sync(ctx.device)
    st.setup_done = time.time()
    return st


def _draw(st):
    trf, dev = st.ctx.traffic, st.ctx.device
    fg = inputs.moving_ellipse(st.gen, trf["frames"], st.h, st.w,
                               trf["motion"], dev)
    targets = inputs.unaries(st.gen, fg, trf["flip"])
    init = layout.draw(st.layout, st.gen, trf["frames"], dev)
    return init, targets, fg


def unit(st, index: int) -> dict:
    init, targets, fg = _draw(st)
    out, aux = st.run(init, st.pts, targets)
    harness.sync(st.ctx.device)
    if index >= 0:
        st.kept.append({"init": init, "targets": targets, "fg": fg,
                        "out": out,
                        "hist": aux["loss_hist"][:, :3].clone(),
                        "last": aux["loss_hist"][:, -1].clone()})
    n, g, steps = st.h * st.w, st.ctx.traffic["frames"], st.cfg.num_steps
    return {"kind": "fit", "work": n * g * steps, "steps": steps,
            "flops": counts.fit_flops_per_point_step(st.ctx.config) * n * g
            * steps, "attempts": g}


def bounds(st) -> dict:
    """A rank's K2 launch: every frame of its data block, its block of
    each frame's points."""
    data, grid = st.ctx.traffic["mesh"]
    n, g = st.h * st.w // grid, st.ctx.traffic["frames"] // data
    return {"flagship": counts.flagship_bound_s(
        st.ctx.config, n, g, bf16=st.ctx.control)[0]}


def assemble(ctx, results):
    """The run's record from the ranks': rank 0's window, counters and
    trace; the latest set-up, the fullest card's peak, the device's busy
    time averaged over the cards, and every rank's JAX-side modules."""
    record = dict(results[0]["record"])
    ranks = [r["record"] for r in results]
    record["forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    record["setup_s"] = max(r["setup_s"] for r in ranks)
    record["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in ranks)
    if "trace" in record:
        record["trace"] = dict(record["trace"], busy_s=sum(
            r["trace"]["busy_s"] for r in ranks) / len(ranks))
    trf = ctx.traffic
    dev = "cuda:0" if ctx.device.startswith("cuda") else ctx.device
    st = types.SimpleNamespace(
        ctx=dataclasses.replace(ctx, device=dev), h=trf["height"],
        w=trf["width"], pts=inputs.pixel_points(trf["height"], trf["width"],
                                                dev),
        kept=[layout.tree_map(lambda t: t.to(dev), u)
              for u in results[0]["kept"]])
    return record, st


def release(st) -> None:
    """The ranks have ended: nothing of the program is left."""


def failed(st) -> int:
    return sum(not common.finite(u["hist"], u["last"],
                                 *layout.leaves(u["out"]))
               for u in st.kept)


def check(st) -> dict:
    ctx = st.ctx
    model = rprior.model(ctx.config, st.h, st.w, ctx.device)
    settings = common.reference_fit_settings(ctx.config)
    gaps, dgaps, finals = [], [], []
    for i in common.sample(ctx.seed, len(st.kept),
                           ctx.traffic["check_units"]):
        u = st.kept[i]
        for b in range(ctx.traffic["frames"]):
            gap, dgap, final = common.follow_gaps(
                model, settings, layout.select(u["init"], b), st.pts,
                u["targets"][b], u["hist"][b].tolist(),
                layout.select(u["out"], b), float(u["last"][b]))
            gaps.append(gap)
            dgaps.append(dgap)
            finals.append(final)
    return {"loss_gap": common.worst(gaps), "dloss_gap": common.worst(dgaps),
            "final_gap": common.worst(finals)}
