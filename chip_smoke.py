#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (``awesome_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line (any failure exits nonzero):

1. the card's name and power limit (``nvidia-smi``), then the builds of
   ``awesome_tpu_torch/ops/csrc/flagship.cu`` (K1/K2) and ``icnn.cu``
   (K4/K5) with nvcc for sm_90a, side by side (into
   ``build/awesome_tpu_torch/``), each with its time and its ptxas
   register and spill lines;
2. the fused flagship loss+grad kernel against its plain PyTorch version:
   the bench model (flow 32x12, ICNN 130x2), the factory default (flow
   130x6, ICNN 130x2), the bench model with a third ICNN layer or with
   ICNN width 150 (both take the kernel's 32-point instantiation), and
   with ICNN width 50; N = 64*64 and a ragged 4097, G = 1 and 2; loss rtol
   1e-5, grads rtol 5e-4 atol 1e-6; two launches bitwise equal; then
   per-image points (G = 8, N = 64*64 and 4097) at the same tolerances,
   where a shared-point launch must equal, bitwise, the per-image launch
   with the points repeated; then the bf16 build against the plain bf16
   version (bench model at 480x640, G = 1; at 64x64, G = 8; the 3-layer
   ICNN's 32-point instantiation, G = 2): the loss and every packed leaf
   within a tenth of the plain version's bf16-vs-FP32 gap, by
   (norm-)relative error;
3. the ICNN kernels K4 and K5 against their plain versions for the five
   ICNN shapes the port serves and two at K5's tile edges, N = 4096 and
   4097, G = 1 and G = 3 with shared and with per-image points: y rtol
   1e-5 (atol 1e-6 of max|y|, y crosses 0), dx and weight grads rtol
   5e-4, atol 1e-6 of the largest
   grad (the kernels sum in another order than cuBLAS); two K5 launches
   bitwise equal; ``FusedConvexNextNet`` (K4 and the plain VJP) grads
   against the plain model's;
4. K3, ``interleave=True``: the grouped loss+grad against the plain
   version (phase-2 tolerances), then a short grouped fit that must equal
   the ``interleave=False`` fit bitwise, with launches = steps; the same
   in the bf16 build (``compute_dtype=torch.bfloat16``);
5. the flagship main path: ``make_fit_fn(model, FitConfig(fused=True))``
   with the bench model at 480x640 on an ellipse target; launches = steps,
   finite and decreasing loss; ms/step, point-steps/s and IoU;
6. the batched fused flagship fit, 8 images at 64x64 with the IoU gate
   and retry;
7. the convex main path: ``fit_prior(FullyFusedConvexNextNet(
   ConvexNextNet()), ...)`` at 480x640 with the how-to config (Adam, lr
   2e-3, fg_weight 0.4, 2000 steps); K4 = K5 = steps, finite and
   decreasing loss, ms/step, point-steps/s, IoU, and a convexity check of
   the fitted mask (midpoints of fg pairs are fg);
8. the batched convex fit, 8 images at 128x128 with the gate and retry:
   one K5 launch per step for the whole batch, and one K4 per step plus
   one per gate pass;
9. the sequential reuse-state pretrain (4 images at 64x64, one invalid,
   point masks): (a) the bench model with the flow-identity and convex
   prefits and the fused fit (K1), (b) ``FullyFusedConvexNextNet``
   (K4/K5); cold fit 500 steps, warm fits 200; launches and IoUs;
10. the bf16 fused fit (``FitConfig(fused=True,
    compute_dtype=torch.bfloat16)``) at 480x640, 2000 steps: launches of
    the bf16 build = steps, finite and decreasing loss, IoU; and the
    batched bf16 fit with per-image points (8 images at 64x64);
11. the joint path: ``__graft_entry__``'s flagship wrapper (full-width
    UNet(4, 1) plus the bench-model prior, image mode, the clean grid, a
    stateful UNet) trained by ``fit/trainer.py`` with
    ``JointTrainConfig()``: 20 steps over 8 images of 64x64 in batches of
    4 (finite losses that decrease), then 3 steps on 2 images of 480x640;
    ms per step, peak memory and the device's idle share;
12. a ``kernels`` JSON line: per kernel (K1-K5, and the bf16 build of
    K1/K2) its time at its path's shape, its launches on that path, the
    steps, launches per step, its bound on this card, the plain version's
    time, and its error against the plain version at that shape;
13. the card's name and power limit, and last the result line
    ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Phases 5-8 also profile a 20-step window of their fit with
``torch.profiler``: the device's busy ms per step (the sum of its kernels'
device time), its idle share against the unprofiled ms/step, and the
kernels that take the most device time.

Without CUDA it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): FP32 on the CUDA cores,
# dense bf16 on the tensor cores, and HBM3 bandwidth. The FP32 kernels'
# arithmetic is FP32 FMAs; the bf16 build's products are bounded at the
# bf16 tensor-core rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

LOSS_RTOL = 1e-5
STEPS = 2000  # steps of each fit, the protocol's per-image count
K3_STEPS = 200  # steps of the short interleaved grouped fit
BF16_BATCH_STEPS = 500  # steps of the batched bf16 per-image-points fit
PROF_STEPS = 20  # steps of each profiled window
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
# the bf16 build: each error within this share of the bf16-vs-FP32 gap
BF16_GAP_SHARE = 0.1


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def bench_model(shape, device, width=130, layers=2):
    """The bench model (flow 32 x 12, ICNN 130 x 2), or with another ICNN
    width or depth."""
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    return real_nvp_path_connected_net(
        channels=2, hidden_units=32, flow_n_flows=12, flow_output_fn="tanh",
        spatial_shape=shape, convex_net_hidden_units=width,
        convex_net_hidden_layers=layers, device=device)


def default_model(shape, device):
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    return real_nvp_path_connected_net(channels=2, flow_output_fn="tanh",
                                       spatial_shape=shape, device=device)


def ellipse_target(h: int, w: int, device, shift=(0.0, 0.0)):
    """The bench's target: fg (encoded 0) inside an axis-aligned ellipse,
    its center moved by ``shift`` (fractions of the height and width)."""
    import torch

    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h * (0.5 + shift[0]), w * (0.5 + shift[1])
    fg = (((yy - cy) ** 2 / (0.09 * h * h)
           + (xx - cx) ** 2 / (0.05 * w * w)) <= 1.0)
    return torch.tensor(1.0 - fg.astype(np.float32),
                        device=device).reshape(-1, 1)


def perturbed_params(model, seed: int):
    """Init plus noise, so the zero-initialized layers carry signal."""
    import torch

    from awesome_tpu_torch.core import tree as T

    gen = torch.Generator().manual_seed(seed)
    p = model.init(gen)
    return T.tree_map(
        lambda a: a + 0.05 * torch.randn(a.shape, generator=gen).to(a.device),
        p)


def loss_grad_inputs(model, n: int, g: int, seed: int, device,
                     per_image: bool = False):
    """Flat params (g, P), points (n, 2) (or (g, n, 2), each image's
    shifted), targets and weights (g, n)."""
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import FitConfig, make_point_weights
    from awesome_tpu_torch.ops.flagship import (
        FlagshipSpec,
        pack_flagship,
        pack_flat,
    )

    spec = FlagshipSpec.of(model)
    side = int(np.ceil(np.sqrt(n)))
    pts = G.flatten_grid(G.pixel_grid((side, side), device=device))[:n]
    stacked = T.stack_trees([perturbed_params(model, seed + i)
                             for i in range(g)])
    flat = pack_flat(pack_flagship(model, stacked), g).contiguous()
    base = ellipse_target(side, side, device)[:n]
    tgts = torch.stack([torch.roll(base, 3 * i, dims=0) for i in range(g)])
    wts = torch.stack([make_point_weights(t, FitConfig()) for t in tgts])
    if per_image:
        pts = torch.stack([pts + 0.37 * i for i in range(g)])
    return spec, flat, pts.contiguous(), tgts.reshape(g, n).contiguous(), \
        wts.reshape(g, n).contiguous()


def kernel_vs_plain(model, n: int, g: int, seed: int, device,
                    f=None, per_image: bool = False) -> float:
    """Kernel against the plain version on the same inputs; returns the
    largest absolute error over loss and grads. Raises on a mismatch or
    when two launches differ in any bit. Launches made here are taken out
    of the kernel's launch count again. ``f``: the loss+grad to check (by
    default the grouped one of ``model``); ``per_image``: a point set per
    image."""
    import torch

    from awesome_tpu_torch.ops.flagship import (
        FlagshipLossGrad,
        flagship_loss_grad_cuda,
        flagship_loss_grad_plain,
        pack_flat,
        unpack_flat,
    )

    spec, flat, pts, tgt, wts = loss_grad_inputs(model, n, g, seed, device,
                                                 per_image)
    f = f or FlagshipLossGrad(spec, True, g, None)
    before = flagship_loss_grad_cuda.launches
    loss_k, grads_k = f.flat(flat, pts, tgt, wts)
    loss_k2, grads_k2 = f.flat(flat, pts, tgt, wts)
    flagship_loss_grad_cuda.launches = before
    loss_p, grads_p = flagship_loss_grad_plain(
        spec, unpack_flat(spec, flat), pts, tgt, wts)
    grads_p = pack_flat(grads_p, g)
    if device == "cuda":
        torch.cuda.synchronize()
    if not (torch.equal(loss_k, loss_k2) and torch.equal(grads_k, grads_k2)):
        raise AssertionError("two launches on the same inputs differ")
    lk, lp = loss_k.cpu().numpy(), loss_p.cpu().numpy()
    gk, gp = grads_k.cpu().numpy(), grads_p.cpu().numpy()
    if not (np.isfinite(lk).all() and np.isfinite(gk).all()):
        raise AssertionError("non-finite kernel output")
    np.testing.assert_allclose(lk, lp, rtol=LOSS_RTOL)
    np.testing.assert_allclose(gk, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    return float(max(np.abs(lk - lp).max(), np.abs(gk - gp).max()))


def per_image_checks(device) -> None:
    """Per-image points (K2 with an image stride) against the plain
    version, and the shared-point launch against the per-image launch
    with the points repeated (bitwise)."""
    import torch

    from awesome_tpu_torch.ops.flagship import (
        FlagshipLossGrad,
        flagship_loss_grad_cuda,
    )

    model = bench_model((64, 64), device)
    for n in (64 * 64, 4097):
        err = kernel_vs_plain(model, n, 8, 20 + n % 7, device,
                              per_image=True)
        spec, flat, pts, tgt, wts = loss_grad_inputs(model, n, 8,
                                                     20 + n % 7, device)
        f = FlagshipLossGrad(spec, True, 8, None)
        before = flagship_loss_grad_cuda.launches
        shared = f.flat(flat, pts, tgt, wts)
        repeated = f.flat(flat, pts.expand(8, -1, -1).contiguous(), tgt, wts)
        flagship_loss_grad_cuda.launches = before
        if not all(torch.equal(a, b) for a, b in zip(shared, repeated)):
            raise AssertionError("shared points differ from repeated "
                                 "per-image points")
        print(json.dumps({"phase": "kernel_vs_plain", "model": "bench",
                          "points": "per_image", "n": n, "g": 8,
                          "max_abs_err": err, "bitwise_repeat": True,
                          "shared_equals_repeated": True}), flush=True)


def _nrel(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def bf16_vs_plain(model, n: int, g: int, seed: int, device, f=None,
                  per_image: bool = False) -> dict:
    """The bf16 build against the plain bf16 version on the same inputs:
    the loss and every packed leaf within BF16_GAP_SHARE of the plain
    version's bf16-vs-FP32 gap, by (norm-)relative error (a build that
    forgot to round is off by the whole gap); two launches bitwise equal.
    Launches made here are taken out of the count again. Returns the
    largest absolute error, the largest error/gap ratio and the smallest
    gap."""
    import torch

    from awesome_tpu_torch.ops.flagship import (
        PACKED_FIELDS,
        FlagshipLossGrad,
        flagship_loss_grad_cuda,
        flagship_loss_grad_plain,
        unpack_flat,
    )

    spec, flat, pts, tgt, wts = loss_grad_inputs(model, n, g, seed, device,
                                                 per_image)
    f = f or FlagshipLossGrad(spec, True, g, None, use_bf16=True)
    before = flagship_loss_grad_cuda.launches_bf16
    loss_k, grads_k = f.flat(flat, pts, tgt, wts)
    loss_k2, grads_k2 = f.flat(flat, pts, tgt, wts)
    flagship_loss_grad_cuda.launches_bf16 = before
    packed = unpack_flat(spec, flat)
    loss_p, grads_p = flagship_loss_grad_plain(spec, packed, pts, tgt, wts,
                                               use_bf16=True)
    loss_f, grads_f = flagship_loss_grad_plain(spec, packed, pts, tgt, wts)
    torch.cuda.synchronize()
    if not (torch.equal(loss_k, loss_k2) and torch.equal(grads_k, grads_k2)):
        raise AssertionError("two bf16 launches on the same inputs differ")
    if not (torch.isfinite(loss_k).all() and torch.isfinite(grads_k).all()):
        raise AssertionError("non-finite bf16 kernel output")
    grads_k = unpack_flat(spec, grads_k)
    pairs = [("loss", loss_k, loss_p, loss_f)] + [
        (k, grads_k[k], grads_p[k], grads_f[k]) for k in PACKED_FIELDS]
    worst, min_gap, abs_err = 0.0, float("inf"), 0.0
    for name, got, ref, f32 in pairs:
        gap = _nrel(ref, f32)
        err = _nrel(got, ref)
        if not (gap > 0.0 and err <= BF16_GAP_SHARE * gap):
            raise AssertionError(f"bf16 {name}: error {err} against a "
                                 f"bf16-vs-FP32 gap of {gap}")
        worst, min_gap = max(worst, err / gap), min(min_gap, gap)
        abs_err = max(abs_err, float((got - ref).abs().max()))
    return {"max_abs_err": abs_err, "max_err_over_gap": worst,
            "min_gap": min_gap}


def bf16_checks(device) -> None:
    t0 = time.perf_counter()
    for name, shape, make, n, g, tp in (
            ("bench 480x640", (480, 640), bench_model, 480 * 640, 1, 64),
            ("bench 64x64", (64, 64), bench_model, 64 * 64, 8, 64),
            ("deep (3-layer ICNN)", (64, 64),
             functools.partial(bench_model, layers=3), 4097, 2, 32)):
        model = make(shape, device)
        res = bf16_vs_plain(model, n, g, 30 + g, device)
        print(json.dumps(dict({"phase": "bf16_vs_plain", "model": name,
                               "n": n, "g": g, "tp": tp,
                               "bitwise_repeat": True}, **res)), flush=True)
    print(f"bf16_vs_plain: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, after
    one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(spec, n: int, g: int, use_bf16: bool = False,
             per_image: bool = False) -> tuple:
    """Least time the card needs for one fused loss+grad: the larger of
    the operations (3 passes over every matrix, 2 FLOP per MAC;
    elementwise tanh/exp/sigmoid not counted) at the FP32 peak (the bf16
    build: at the dense bf16 tensor-core peak), and the bytes (points,
    targets, weights and params read once, grads and loss written once)
    at the HBM rate."""
    _, p_len = spec.offsets()
    f, h2, w, nl = spec.n_flows, 2 * spec.hidden, spec.icnn_w, spec.n_layers
    macs = f * (h2 * 2 + 4 * h2) + w * 2 + nl * w * (w + 2) + (w + 2)
    flops = 2.0 * 3.0 * macs * n * g
    n_pts = n * g if per_image else n
    nbytes = 4.0 * (2 * n_pts + 2 * g * n + g * p_len + g * (p_len + 1))
    t_ops = flops / (PEAK_BF16_FLOPS if use_bf16 else PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_entry(name, replaces, model, n, g, seed, launches, steps, reps,
                 device, use_bf16=False, per_image=False):
    """Time the kernel (or its bf16 build) and the plain version at one
    shape and hold them against each other there."""
    from awesome_tpu_torch.ops.flagship import (
        FlagshipLossGrad,
        flagship_loss_grad_cuda,
        flagship_loss_grad_plain,
        unpack_flat,
    )

    if use_bf16:
        err = bf16_vs_plain(model, n, g, seed, device,
                            per_image=per_image)["max_abs_err"]
    else:
        err = kernel_vs_plain(model, n, g, seed, device, per_image=per_image)
    spec, flat, pts, tgt, wts = loss_grad_inputs(model, n, g, seed, device,
                                                 per_image)
    f = FlagshipLossGrad(spec, True, g, None, use_bf16=use_bf16)
    before = (flagship_loss_grad_cuda.launches,
              flagship_loss_grad_cuda.launches_bf16)
    ms = cuda_time_ms(lambda: f.flat(flat, pts, tgt, wts), reps)
    (flagship_loss_grad_cuda.launches,
     flagship_loss_grad_cuda.launches_bf16) = before
    packed = unpack_flat(spec, flat)
    plain_ms = cuda_time_ms(
        lambda: flagship_loss_grad_plain(spec, packed, pts, tgt, wts,
                                         use_bf16=use_bf16),
        max(3, reps // 4))
    b_ms, b_by = bound_ms(spec, n, g, use_bf16, per_image)
    return {
        "name": name, "route": "cuda",
        "source": "awesome_tpu_torch/ops/csrc/flagship.cu",
        "replaces": replaces, "launches": launches, "steps": steps,
        "launches_per_step": launches / steps, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": {"n": n, "g": g,
                                      "points": "per_image" if per_image
                                      else "shared"},
    }


def device_profile(run, steps: int, ms_per_step: float) -> dict:
    """Where a fit's step time goes: ``run()`` drives ``steps`` fit steps
    under ``torch.profiler``; the device's busy time is the sum of the
    device time of every kernel (one stream, so they do not overlap). ``ms_per_step`` (the unprofiled run's) gives the
    device's idle share. Reports "not measured" where the profiler sees no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up at this step count
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # kernels only: an op's own row repeats the device time of its kernels
    rows = [(e.key, float(e.self_device_time_total))
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy_us = sum(t for _, t in rows)
    if busy_us <= 0.0:
        return {"device_busy_ms_per_step": "not measured"}
    busy = busy_us / 1e3 / steps
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return {
        "profiled_steps": steps, "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / ms_per_step),
        "top_device_ms_per_step": {k: t / 1e3 / steps for k, t in top},
    }


def main_path(steps: int, device, use_bf16: bool = False):
    """The flagship fused prior fit at 480x640 (bench model); with
    ``use_bf16`` under ``compute_dtype=torch.bfloat16`` (the kernel's bf16
    build)."""
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.fit.prior_fit import FitConfig, make_fit_fn
    from awesome_tpu_torch.measures.metrics import iou

    h, w = 480, 640
    model = bench_model((h, w), device)
    pts = G.flatten_grid(G.pixel_grid((h, w), device=device))
    target = ellipse_target(h, w, device)
    params = model.init(torch.Generator().manual_seed(2))
    cfg = FitConfig(num_steps=steps, lr=1e-3, nan_guard_grads=False,
                    fused=True,
                    compute_dtype=torch.bfloat16 if use_bf16 else None)
    fit = make_fit_fn(model, cfg)
    # warm-up: loads the kernel and picks its launch shape
    make_fit_fn(model, dataclasses.replace(cfg, num_steps=2))(
        params, pts, target)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    fitted, aux = fit(params, pts, target)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k1_bf16, _, _, ran = counts()
    launches = k1_bf16 if use_bf16 else k1
    if (k1 if use_bf16 else k1_bf16) != 0:
        raise AssertionError("the fit launched the other build")
    if ran != steps:
        raise AssertionError(f"the fit ran {ran} steps, asked {steps}")
    if launches != steps:
        raise AssertionError(f"kernel launched {launches} times in "
                             f"{steps} steps")
    hist = aux["loss_hist"].cpu().numpy()
    if not np.isfinite(hist).all():
        raise AssertionError("non-finite loss in the fit")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"loss did not decrease: {hist[0]} -> "
                             f"{hist[-1]}")
    with torch.no_grad():
        prob = torch.sigmoid(model.apply(fitted, pts))
    score = float(iou(prob > 0.5, target > 0.5, invert=True))
    short = make_fit_fn(model, dataclasses.replace(cfg, num_steps=PROF_STEPS))
    return model, launches, ran, {
        "phase": "main_path_bf16" if use_bf16 else "main_path",
        "shape": [h, w], "steps": ran,
        "seconds": dt, "ms_per_step": 1e3 * dt / steps,
        "point_steps_per_s": steps * pts.shape[0] / dt,
        "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
        "iou": score, "kernel_launches": launches,
        "profile": device_profile(lambda: short(params, pts, target),
                                  PROF_STEPS, 1e3 * dt / steps),
    }


def batched_path(steps: int, device):
    """The batched fused fit, 8 images at 64x64, with gate and retry."""
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import (
        FitConfig,
        make_batched_fit_fn,
        run_fit_loop,
    )
    from awesome_tpu_torch.ops.flagship import flagship_loss_grad_cuda

    h = w = 64
    batch = 8
    model = bench_model((h, w), device)
    pts = G.flatten_grid(G.pixel_grid((h, w), device=device))
    targets = torch.stack([ellipse_target(h, w, device)] * batch)
    stacked = T.stack_trees([model.init(torch.Generator().manual_seed(i))
                             for i in range(batch)])
    cfg = FitConfig(num_steps=steps, lr=1e-3, nan_guard_grads=False,
                    fused=True, gate_threshold=0.5)
    run = make_batched_fit_fn(model, cfg)
    retry = list(range(100, 100 + batch))
    torch.cuda.synchronize()
    flagship_loss_grad_cuda.launches = run_fit_loop.steps = 0
    t0 = time.perf_counter()
    fitted, aux = run(stacked, pts, targets, retry_keys=retry)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, ran = flagship_loss_grad_cuda.launches, run_fit_loop.steps
    if ran < steps or launches != ran:
        raise AssertionError(f"batched fit launched the kernel {launches} "
                             f"times in {ran} steps")
    hist = aux["loss_hist"].cpu().numpy()
    if not np.isfinite(hist).all():
        raise AssertionError("non-finite loss in the batched fit")
    gate = aux["gate_iou"].cpu().numpy()
    short = make_batched_fit_fn(model, dataclasses.replace(
        cfg, num_steps=PROF_STEPS, gate_threshold=None))
    return model, launches, ran, {
        "phase": "batched_path", "images": batch, "shape": [h, w],
        "steps": ran, "seconds": dt,
        "point_steps_per_s": launches * batch * pts.shape[0] / dt,
        "gate_iou": [float(v) for v in gate],
        "gate_pass": int((gate >= 0.5).sum()), "kernel_launches": launches,
        "profile": device_profile(lambda: short(stacked, pts, targets),
                                  PROF_STEPS, 1e3 * dt / ran),
    }

def bf16_batched_path(steps: int, device):
    """The batched fused fit in the bf16 build with a point set per image
    (K2's image stride): 8 images at 64x64, each on its own shifted grid,
    with the gate."""
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import FitConfig, fit_priors_batched

    h = w = 64
    batch = 8
    model = bench_model((h, w), device)
    base = G.flatten_grid(G.pixel_grid((h, w), device=device))
    shifts = [(0.02 * i - 0.08, 0.08 - 0.02 * i) for i in range(batch)]
    # image i's (x, y) grid moved by its shift: every image fits the same
    # ellipse target on points of its own
    pts = torch.stack([base + torch.tensor([sx, sy], device=device)
                       for sy, sx in shifts])
    targets = torch.stack([ellipse_target(h, w, device)] * batch)
    stacked = T.stack_trees([model.init(torch.Generator().manual_seed(80 + i))
                             for i in range(batch)])
    cfg = FitConfig(num_steps=steps, lr=1e-3, nan_guard_grads=False,
                    fused=True, gate_threshold=0.5,
                    compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    _, aux = fit_priors_batched(model, stacked, pts, targets, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k1_bf16, _, _, ran = counts()
    if ran != steps or k1_bf16 != steps or k1 != 0:
        raise AssertionError(f"batched bf16 fit: {k1_bf16} bf16 and {k1} "
                             f"FP32 launches in {ran} steps")
    hist = aux["loss_hist"].cpu().numpy()
    for b in range(batch):
        check_hist(hist[b], f"the batched bf16 fit (image {b})")
    gate = aux["gate_iou"].cpu().numpy()
    return model, k1_bf16, ran, {
        "phase": "batched_bf16_per_image_points", "images": batch,
        "shape": [h, w], "steps": ran, "seconds": dt,
        "ms_per_step": 1e3 * dt / ran, "gate_iou": [float(v) for v in gate],
        "gate_pass": int((gate >= 0.5).sum()), "kernel_launches": k1_bf16,
    }


def flagship_wrapper(h: int, w: int, device):
    """``__graft_entry__._flagship`` in the port: a full-width UNet(4, 1)
    and the bench-model prior (flow 32 x 12 with tanh, ICNN 130 x 2) in an
    image-mode WrapperModule on the clean grid, the UNet stateful."""
    from awesome_tpu_torch.nn.seg import UNet
    from awesome_tpu_torch.nn.wrapper import WrapperModule

    return WrapperModule(
        segmentation_module=UNet(in_chn=4, out_chn=1, device=device),
        prior_module=bench_model((h, w), device),
        input_mode="image", prior_arg_mode="param_clean_grid",
        seg_stateful=True)


def joint_data(h: int, w: int, t: int, seed: int, device) -> dict:
    """``t`` images (uniform noise plus a brighter ellipse), features,
    the clean grid and the ellipse targets (fg encoded 0)."""
    import torch

    from awesome_tpu_torch.core import grids as G

    gen = torch.Generator().manual_seed(seed)
    tgt = torch.stack([ellipse_target(h, w, "cpu", (0.02 * i, -0.02 * i))
                       .reshape(h, w, 1) for i in range(t)])
    image = 0.5 * torch.rand((t, h, w, 3), generator=gen) + 0.5 * (1 - tgt)
    feats = torch.rand((t, h, w, 1), generator=gen)
    return {"image": image.to(device), "features": feats.to(device),
            "target": tgt.to(device),
            "grid": G.flatten_grid(G.pixel_grid((h, w), device=device))}


def joint_path(device, small=(64, 64), images=8, batch=4, epochs=10,
               large=(480, 640), large_images=2, large_steps=3):
    """Joint training of the flagship wrapper with ``JointTrainConfig()``:
    ``epochs`` epochs over ``images`` images of ``small`` size in batches
    of ``batch`` (the epoch fn), then ``large_steps`` steps on
    ``large_images`` images of ``large`` size. Finite losses, decreasing
    at the small size (first epoch's mean against the last's)."""
    import numpy as _np
    import torch

    from awesome_tpu_torch.fit.trainer import (
        JointTrainConfig,
        epoch_batches,
        joint_train_init,
        make_joint_epoch_fn,
        make_joint_train_step,
    )

    cfg = JointTrainConfig()
    out = {"phase": "joint_path", "config": dataclasses.asdict(cfg)}
    wrapper = flagship_wrapper(*small, device)
    data = joint_data(*small, images, 3, device)
    state = joint_train_init(wrapper, torch.Generator().manual_seed(4),
                             images, cfg)
    epoch = make_joint_epoch_fn(wrapper, cfg)
    rng = _np.random.default_rng(0)
    plans = [epoch_batches(images, batch, rng) for _ in range(epochs)]
    losses, times = [], []
    for idx, wgt in plans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = epoch(state, data, idx, wgt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(met["loss"].cpu().numpy())
    hist = _np.concatenate(losses)
    if not _np.isfinite(hist).all():
        raise AssertionError("non-finite loss in joint training")
    if not losses[-1].mean() < losses[0].mean():
        raise AssertionError(f"joint loss did not decrease: "
                             f"{losses[0].mean()} -> {losses[-1].mean()}")
    per_epoch = len(plans[0][0])
    ms = 1e3 * sum(times[1:]) / (per_epoch * (len(times) - 1))
    idx, wgt = plans[0]
    out["small"] = {
        "shape": list(small), "images": images, "batch": batch,
        "steps": int(state.step), "loss": [float(v) for v in hist],
        "ms_per_step": ms, "first_epoch_s": times[0],
        "profile": device_profile(lambda: epoch(state, data, idx, wgt),
                                  per_epoch, ms),
    }
    wrapper = flagship_wrapper(*large, device)
    data = joint_data(*large, large_images, 5, device)
    state = joint_train_init(wrapper, torch.Generator().manual_seed(6),
                             large_images, cfg)
    step = make_joint_train_step(wrapper, cfg)
    batch_l = {k: data[k] for k in ("image", "features", "grid", "target")}
    batch_l["index"] = torch.arange(large_images, device=device)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(large_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch_l)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    if not _np.isfinite(losses).all():
        raise AssertionError("non-finite loss in joint training at "
                             f"{large}")
    ms = 1e3 * sum(times[1:]) / max(len(times) - 1, 1)
    out["large"] = {
        "shape": list(large), "images": large_images,
        "steps": int(state.step), "loss": losses, "ms_per_step": ms,
        "first_step_s": times[0],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profile": device_profile(lambda: step(state, batch_l), 1, ms),
    }
    return out


# (what it serves, width, hidden layers, in_features) of the ICNNs the
# fused ICNN kernels take
ICNN_CONFIGS = (
    ("runner default and how-to", 130, 1, 2),
    ("flagship ICNN", 130, 2, 2),
    ("convex teaser", 150, 1, 2),
    ("space-time teaser", 50, 1, 3),
    ("multi-object child", 64, 1, 2),
    # K5's tile edges: its backward-data product's W + C rows take a
    # second 144-row pass, its weight grads' W + C + 1 columns a second
    # 136-column tile
    ("tile edge: W + C > 144", 143, 1, 2),
    ("tile edge: W + C + 1 > 136", 134, 1, 3),
)


def icnn_inputs(width, layers, c, n, g, per_image, seed, device):
    """An ICNN, its stacked params (G images), their (G, P) rows, points
    (N, C) or (G, N, C), and an upstream grad (G, N)."""
    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.ops import mlp

    base = ConvexNextNet(n_hidden=width, in_features=c,
                         n_hidden_layers=layers, device=device)
    stacked = T.stack_trees([perturbed_params(base, seed + i)
                             for i in range(g)])
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((g, n, c) if per_image else (n, c), generator=gen)
    gy = torch.randn((g, n), generator=gen)
    return (mlp.IcnnSpec.of(base), base, stacked,
            mlp.pack_rows(mlp.flat_weights(stacked), g), x.to(device),
            gy.to(device))


def icnn_vs_plain(width, layers, c, n, g, per_image, seed, device):
    """K4 and K5 against the plain versions on the same inputs; returns
    the largest absolute errors (forward, backward). Raises on a mismatch
    or when two K5 launches differ in any bit. The launches made here are
    taken out of the launch counts again."""
    import torch

    from awesome_tpu_torch.ops import mlp

    spec, _, stacked, flat, x, gy = icnn_inputs(width, layers, c, n, g,
                                                per_image, seed, device)
    before = mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches
    y = mlp.icnn_forward_cuda(spec, flat, x)
    dp, dx = mlp.icnn_backward_cuda(spec, flat, x, gy)
    dp2, dx2 = mlp.icnn_backward_cuda(spec, flat, x, gy)
    mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches = before
    ref_y = mlp.icnn_forward_plain(stacked, x)[..., 0]
    ref_tree, ref_dx = mlp.icnn_backward_plain(stacked, x, gy[..., None])
    ref_dp = mlp.pack_rows(mlp.flat_weights(ref_tree), g)
    torch.cuda.synchronize()
    if not (torch.equal(dp, dp2) and torch.equal(dx, dx2)):
        raise AssertionError("two K5 launches on the same inputs differ")
    errs = []
    for got, ref, rtol in ((y, ref_y, LOSS_RTOL), (dp, ref_dp, GRAD_RTOL),
                           (dx, ref_dx, GRAD_RTOL)):
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        if not np.isfinite(got).all():
            raise AssertionError("non-finite ICNN kernel output")
        np.testing.assert_allclose(got, ref, rtol=rtol,
                                   atol=1e-6 * np.abs(ref).max())
        errs.append(float(np.abs(got - ref).max()))
    return errs[0], max(errs[1:])


def fused_vjp_vs_plain(width, layers, c, n, seed, device) -> float:
    """``FusedConvexNextNet`` (K4, then the plain VJP) grads of an SE loss
    against the plain ConvexNextNet's; returns the largest error."""
    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.ops import mlp

    _, base, stacked, _, x, _ = icnn_inputs(width, layers, c, n, 1, False,
                                            seed, device)
    params = T.tree_select(stacked, 0)
    tgt = (x[:, :1] > 0.5).float()

    def loss(model):
        return lambda p: torch.mean((torch.sigmoid(model.apply(p, x))
                                     - tgt) ** 2)

    before = mlp.icnn_forward_cuda.launches
    got = torch.func.grad(loss(mlp.FusedConvexNextNet(base)))(params)
    launched = mlp.icnn_forward_cuda.launches - before
    mlp.icnn_forward_cuda.launches = before
    ref = torch.func.grad(loss(base))(params)
    if launched != 1:
        raise AssertionError(f"FusedConvexNextNet launched K4 {launched} "
                             "times for one grad")
    err = 0.0
    for a, b in zip(T.tree_leaves(got), T.tree_leaves(ref)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=1e-6 * np.abs(b).max())
        err = max(err, float(np.abs(a - b).max()))
    return err


def icnn_checks(device) -> None:
    t0 = time.perf_counter()
    for what, width, layers, c in ICNN_CONFIGS:
        for n in (4096, 4097):
            for g, per_image in ((1, False), (3, False), (3, True)):
                ef, eb = icnn_vs_plain(width, layers, c, n, g, per_image,
                                       width + n % 7 + g, device)
                print(json.dumps({
                    "phase": "icnn_vs_plain", "icnn": what, "width": width,
                    "layers": layers, "in_features": c, "n": n, "g": g,
                    "points": "per_image" if per_image else "shared",
                    "max_abs_err_fwd": ef, "max_abs_err_bwd": eb,
                    "bitwise_repeat": True}), flush=True)
        err = fused_vjp_vs_plain(width, layers, c, 4097, width, device)
        print(json.dumps({"phase": "fused_vjp_vs_plain", "icnn": what,
                          "max_abs_err": err}), flush=True)
    print(f"icnn_vs_plain: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)


def k3_path(steps: int, device, use_bf16: bool = False):
    """K3, ``interleave=True``: the grouped loss+grad against the plain
    version, then a grouped fit that must equal ``interleave=False``; with
    ``use_bf16`` both in the bf16 build (``compute_dtype``)."""
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.fused_fit import make_grouped_fused_fit_fn
    from awesome_tpu_torch.fit.prior_fit import FitConfig
    from awesome_tpu_torch.ops.flagship import make_flagship_loss_grad

    h = w = 64
    model = bench_model((h, w), device)
    f = make_flagship_loss_grad(model, group=2, interleave=True,
                                use_bf16=use_bf16)
    if use_bf16:
        errs = [bf16_vs_plain(model, n, 2, 40 + n % 7, device,
                              f=f)["max_abs_err"] for n in (4096, 4097)]
    else:
        errs = [kernel_vs_plain(model, n, 2, 40 + n % 7, device, f=f)
                for n in (4096, 4097)]
    pts = G.flatten_grid(G.pixel_grid((h, w), device=device))
    targets = torch.stack([ellipse_target(h, w, device, (0.1 * i, -0.1 * i))
                           for i in range(2)])
    stacked = T.stack_trees([model.init(torch.Generator().manual_seed(30 + i))
                             for i in range(2)])
    cfg = FitConfig(num_steps=steps, lr=1e-3, nan_guard_grads=False,
                    compute_dtype=torch.bfloat16 if use_bf16 else None)
    fit_i = make_grouped_fused_fit_fn(model, cfg, group=2, interleave=True)
    fit_p = make_grouped_fused_fit_fn(model, cfg, group=2)
    torch.cuda.synchronize()
    zero_counts()
    got, aux = fit_i(stacked, pts, targets)
    torch.cuda.synchronize()
    k1, k1_bf16, _, _, ran = counts()
    launches = k1_bf16 if use_bf16 else k1
    if ran != steps or launches != steps or k1 + k1_bf16 != steps:
        raise AssertionError(f"interleaved fit: {launches} launches in "
                             f"{ran} steps")
    ref, ref_aux = fit_p(stacked, pts, targets)
    torch.cuda.synchronize()
    same = torch.equal(aux["loss_hist"], ref_aux["loss_hist"]) and all(
        torch.equal(a, b) for a, b in zip(T.tree_leaves(got),
                                          T.tree_leaves(ref)))
    if not same:
        raise AssertionError("interleave=True differs from interleave=False")
    return model, launches, ran, {
        "phase": "k3_interleave_bf16" if use_bf16 else "k3_interleave",
        "g": 2, "shape": [h, w],
        "max_abs_err_4096": errs[0], "max_abs_err_4097": errs[1],
        "steps": ran, "kernel_launches": launches,
        "bitwise_equal_to_interleave_false": True,
    }


def counts():
    """(K1/K2 launches, their bf16 build's launches, K4 launches, K5
    launches, fit steps)."""
    from awesome_tpu_torch.fit.prior_fit import run_fit_loop
    from awesome_tpu_torch.ops import mlp
    from awesome_tpu_torch.ops.flagship import flagship_loss_grad_cuda

    return (flagship_loss_grad_cuda.launches,
            flagship_loss_grad_cuda.launches_bf16,
            mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches,
            run_fit_loop.steps)


def zero_counts() -> None:
    from awesome_tpu_torch.fit.prior_fit import run_fit_loop
    from awesome_tpu_torch.ops import mlp
    from awesome_tpu_torch.ops.flagship import flagship_loss_grad_cuda

    flagship_loss_grad_cuda.launches = run_fit_loop.steps = 0
    flagship_loss_grad_cuda.launches_bf16 = 0
    mlp.icnn_forward_cuda.launches = mlp.icnn_backward_cuda.launches = 0


def check_hist(hist, what: str) -> None:
    if not np.isfinite(hist).all():
        raise AssertionError(f"non-finite loss in {what}")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"{what}: loss did not decrease: {hist[0]} -> "
                             f"{hist[-1]}")


def convexity_check(model, params, pts, seed: int) -> dict:
    """Midpoints of random pairs of fg points (fg is f < 0) must be fg:
    f convex gives f(mid) <= (f(a) + f(b)) / 2. Checked with a rounding
    slack of 1e-4 * (1 + max|f|); any larger excess means the convexity
    clip or the kernel is wrong."""
    import torch

    with torch.no_grad():
        f = model.apply(params, pts)[:, 0]
        fg = torch.nonzero(f < 0)[:, 0]
        if fg.numel() < 2:
            raise AssertionError("the fitted mask has no foreground")
        gen = torch.Generator().manual_seed(seed)
        i = fg[torch.randint(fg.numel(), (8192,), generator=gen)
               .to(fg.device)]
        j = fg[torch.randint(fg.numel(), (8192,), generator=gen)
               .to(fg.device)]
        mid = 0.5 * (pts[i] + pts[j])
        f_mid = model.apply(params, mid)[:, 0]
    avg = 0.5 * (f[i] + f[j])
    slack = 1e-4 * (1.0 + float(f.abs().max()))
    excess = float((f_mid - avg).max())
    fg_mid = int((f_mid < 0).sum())
    if excess > slack or not bool((f_mid < 0)[avg < -slack].all()):
        raise AssertionError(f"fitted mask not convex: excess {excess}, "
                             f"slack {slack}")
    return {"pairs": 8192, "midpoints_fg": fg_mid, "max_excess": excess,
            "slack": slack}


def convex_path(steps: int, device):
    """The convex prior fit at 480x640 through K4 and K5."""
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.fit.prior_fit import FitConfig, fit_prior
    from awesome_tpu_torch.measures.metrics import iou
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.ops.mlp import FullyFusedConvexNextNet

    h, w = 480, 640
    model = FullyFusedConvexNextNet(ConvexNextNet(device=device))
    pts = G.flatten_grid(G.pixel_grid((h, w), device=device))
    target = ellipse_target(h, w, device)
    params = model.init(torch.Generator().manual_seed(5))
    cfg = FitConfig(num_steps=steps, lr=2e-3, optimizer="adam",
                    fg_weight=0.4, plateau_patience=10 ** 6)
    # warm-up: loads the kernels and picks their launch shapes
    fit_prior(model, params, pts, target,
              dataclasses.replace(cfg, num_steps=2))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    fitted, aux = fit_prior(model, params, pts, target, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _, _, k4, k5, ran = counts()
    if not k4 == k5 == ran == steps:
        raise AssertionError(f"convex fit: K4 {k4}, K5 {k5} launches in "
                             f"{ran} steps")
    hist = aux["loss_hist"].cpu().numpy()
    check_hist(hist, "the convex fit")
    with torch.no_grad():
        prob = torch.sigmoid(model.apply(fitted, pts))
    score = float(iou(prob > 0.5, target > 0.5, invert=True))
    convex = convexity_check(model, fitted, pts, 6)
    short = dataclasses.replace(cfg, num_steps=PROF_STEPS)
    return k4, k5, ran, {
        "phase": "convex_path", "shape": [h, w], "steps": ran,
        "seconds": dt, "ms_per_step": 1e3 * dt / steps,
        "point_steps_per_s": steps * pts.shape[0] / dt,
        "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
        "iou": score, "k4_launches": k4, "k5_launches": k5,
        "convexity": convex,
        "profile": device_profile(
            lambda: fit_prior(model, params, pts, target, short),
            PROF_STEPS, 1e3 * dt / steps),
    }


def batched_convex_path(steps: int, device):
    """8 convex fits at 128x128 at once, with the gate and retry."""
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import FitConfig, make_batched_fit_fn
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.ops.mlp import FullyFusedConvexNextNet

    h = w = 128
    batch = 8
    model = FullyFusedConvexNextNet(ConvexNextNet(device=device))
    pts = G.flatten_grid(G.pixel_grid((h, w), device=device))
    targets = torch.stack([
        ellipse_target(h, w, device, (0.03 * i - 0.1, 0.1 - 0.03 * i))
        for i in range(batch)])
    stacked = T.stack_trees([model.init(torch.Generator().manual_seed(50 + i))
                             for i in range(batch)])
    cfg = FitConfig(num_steps=steps, lr=2e-3, optimizer="adam",
                    fg_weight=0.4, gate_threshold=0.5)
    run = make_batched_fit_fn(model, cfg)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    _, aux = run(stacked, pts, targets, retry_keys=list(range(200, 208)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _, _, k4, k5, ran = counts()
    # the fit and the retry pass, and one vmapped K4 per gate pass (the
    # scores and the retry's scores)
    if ran != 2 * steps or k5 != ran or k4 != ran + 2:
        raise AssertionError(f"batched convex fit: K4 {k4}, K5 {k5} "
                             f"launches in {ran} steps")
    hist = aux["loss_hist"].cpu().numpy()
    if not np.isfinite(hist).all():
        raise AssertionError("non-finite loss in the batched convex fit")
    gate = aux["gate_iou"].cpu().numpy()
    short = make_batched_fit_fn(model, dataclasses.replace(
        cfg, num_steps=PROF_STEPS, gate_threshold=None))
    return k4, k5, ran, {
        "phase": "batched_convex_path", "images": batch, "shape": [h, w],
        "steps": ran, "seconds": dt, "ms_per_step": 1e3 * dt / ran,
        "point_steps_per_s": ran * batch * pts.shape[0] / dt,
        "gate_iou": [float(v) for v in gate],
        "gate_pass": int((gate >= 0.5).sum()), "k4_launches": k4,
        "k5_launches": k5, "k5_launches_per_step": k5 / ran,
        "profile": device_profile(lambda: short(stacked, pts, targets),
                                  PROF_STEPS, 1e3 * dt / ran),
    }


def sequential_path(kind: str, device):
    """The runner's reuse-state pretrain on 4 images at 64x64 (image 2
    invalid, 64 padded points per image): cold fit 500 steps, warm 200.
    ``kind`` 'flagship': the bench model with the flow-identity and
    convex ('unaries') prefits and the fused fit (K1); 'convex':
    ``FullyFusedConvexNextNet`` (K4/K5)."""
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import (
        FitConfig,
        apply_prefits,
        fit_priors_sequential,
    )
    from awesome_tpu_torch.measures.metrics import iou
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.ops.mlp import FullyFusedConvexNextNet

    h = w = 64
    b, pad, cold, warm = 4, 64, 500, 200
    base = G.flatten_grid(G.pixel_grid((h, w), device=device))
    pts = torch.stack([torch.cat([base, torch.full((pad, 2), 2.0 + i,
                                                   device=device)])
                       for i in range(b)])
    targets = torch.stack([torch.cat([
        ellipse_target(h, w, device, (0.05 * i, -0.05 * i)),
        torch.zeros((pad, 1), device=device)]) for i in range(b)])
    masks = torch.zeros((b, h * w + pad), dtype=torch.bool, device=device)
    masks[:, :h * w] = True
    valid = torch.tensor([True, True, False, True], device=device)
    gen = torch.Generator().manual_seed(70)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    if kind == "flagship":
        model = bench_model((h, w), device)
        cfg = FitConfig(num_steps=cold, lr=1e-3, fused=True,
                        nan_guard_grads=False)
        params0 = apply_prefits(
            model, model.init(gen), pts[0][masks[0]],
            prefit_flow_identity=True, prefit_convex=True,
            convex_mode="unaries", convex_target=targets[0][masks[0]])
    else:
        model = FullyFusedConvexNextNet(ConvexNextNet(device=device))
        cfg = FitConfig(num_steps=cold, lr=2e-3, optimizer="adam",
                        fg_weight=0.4)
        params0 = model.init(gen)
    fitted, aux = fit_priors_sequential(
        model, params0, pts, targets, cfg,
        warm_cfg=dataclasses.replace(cfg, num_steps=warm),
        valid_mask=valid, point_masks=masks)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, _, k4, k5, ran = counts()
    want = cold + (b - 1) * warm
    launched = k1 if kind == "flagship" else min(k4, k5)
    if ran != want or launched != want or (kind == "convex" and k4 != k5):
        raise AssertionError(f"sequential {kind}: K1 {k1}, K4 {k4}, K5 {k5} "
                             f"launches in {ran} steps")
    check_hist(aux["first_aux"]["loss_hist"].cpu().numpy(),
               f"the sequential {kind} cold fit")
    ious = []
    with torch.no_grad():
        for i in range(b):
            out = model.apply(T.tree_select(fitted, i), pts[i][masks[i]])
            ious.append(float(iou(torch.sigmoid(out) > 0.5,
                                  targets[i][masks[i]] > 0.5, invert=True)))
    return {
        "phase": f"sequential_{kind}", "images": b, "shape": [h, w],
        "valid": [bool(v) for v in valid.cpu()], "cold_steps": cold,
        "warm_steps": warm, "steps": ran, "seconds": dt,
        "launches": {"K1": k1, "K4": k4, "K5": k5}, "iou": ious,
    }


def icnn_bound_ms(spec, n: int, g: int, backward: bool) -> tuple:
    """Least time the card needs for one K4 (or K5) call: the larger of
    the FP32 operations (one pass over every matrix for K4, three for K5:
    recompute, weight grads, data grads; 2 FLOP per MAC) at the FP32 peak,
    and the bytes (points, upstream grads and params read once; outputs
    written once) at the HBM rate."""
    w, nl, c, p_len = spec.width, spec.n_layers, spec.in_features, \
        spec.row_len
    macs = c * w + nl * (w * w + c * w) + w + c
    flops = 2.0 * (3.0 if backward else 1.0) * macs * n * g
    if backward:
        nbytes = 4.0 * (n * c + g * n + 2 * g * p_len + g * n * c)
    else:
        nbytes = 4.0 * (n * c + g * p_len + g * n)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def icnn_entries(launches4, launches5, steps, reps, device) -> list:
    """K4 and K5 at the convex main path's shape (480x640, width 130, one
    hidden layer, G = 1): time, plain time, bound and error."""
    from awesome_tpu_torch.ops import mlp

    n = 480 * 640
    ef, eb = icnn_vs_plain(130, 1, 2, n, 1, False, 13, device)
    spec, _, stacked, flat, x, gy = icnn_inputs(130, 1, 2, n, 1, False, 13,
                                                device)
    before = mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches
    ms4 = cuda_time_ms(lambda: mlp.icnn_forward_cuda(spec, flat, x), reps)
    ms5 = cuda_time_ms(lambda: mlp.icnn_backward_cuda(spec, flat, x, gy),
                       reps)
    mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches = before
    plain4 = cuda_time_ms(lambda: mlp.icnn_forward_plain(stacked, x), reps)
    plain5 = cuda_time_ms(
        lambda: mlp.icnn_backward_plain(stacked, x, gy[..., None]), reps)
    out = []
    for name, line, launches, ms, plain, err, bwd in (
            ("icnn_forward (K4)", 65, launches4, ms4, plain4, ef, False),
            ("icnn_backward (K5)", 186, launches5, ms5, plain5, eb, True)):
        b_ms, b_by = icnn_bound_ms(spec, n, 1, bwd)
        out.append({
            "name": name, "route": "cuda",
            "source": "awesome_tpu_torch/ops/csrc/icnn.cu",
            "replaces": f"awesome_tpu/ops/pallas_mlp.py:{line}",
            "launches": launches, "steps": steps,
            "launches_per_step": launches / steps, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": {"n": n, "g": 1, "width": 130,
                                          "layers": 1},
        })
    return out


def build_all() -> None:
    """Build both kernel libraries side by side (one nvcc each) and print
    each build's time and ptxas register and spill lines."""
    from concurrent.futures import ThreadPoolExecutor

    from awesome_tpu_torch.ops import flagship, mlp

    def build(lib):
        t0 = time.perf_counter()
        path = lib.build()
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        done = list(pool.map(build, (flagship.LIBRARY, mlp.LIBRARY)))
    for path, dt in done:
        print(f"build: {path} in {dt:.1f} s", flush=True)
        for line in path.with_suffix(".build.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from awesome_tpu_torch.ops import flagship

    dev = "cuda"
    smi = nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    build_all()

    t0 = time.perf_counter()
    for name, make, tp in (
            ("bench", bench_model, 64), ("default", default_model, 64),
            ("deep", functools.partial(bench_model, layers=3), 32),
            ("icnn width 50", functools.partial(bench_model, width=50), 64),
            ("icnn width 150", functools.partial(bench_model, width=150),
             32)):
        model = make((64, 64), dev)
        spec = flagship.FlagshipSpec.of(model)
        for n in (64 * 64, 4097):
            for g in (1, 2):
                shape = flagship.launch_shape(spec, n, g, None,
                                              torch.device(dev))
                if shape.tp != tp:
                    raise AssertionError(f"{name}: expected {tp}-point "
                                         f"chunks, launch takes {shape.tp}")
                err = kernel_vs_plain(model, n, g, 10 * g + n % 7, dev)
                print(json.dumps({"phase": "kernel_vs_plain", "model": name,
                                  "n": n, "g": g, "tp": shape.tp,
                                  "smem": shape.smem, "max_abs_err": err,
                                  "bitwise_repeat": True}), flush=True)
    per_image_checks(dev)
    print(f"kernel_vs_plain: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    bf16_checks(dev)
    icnn_checks(dev)
    k3_model, k3_launches, k3_steps, res = k3_path(K3_STEPS, dev)
    print(json.dumps(res), flush=True)
    _, _, _, res = k3_path(K3_STEPS, dev, use_bf16=True)
    print(json.dumps(res), flush=True)

    model, main_launches, main_steps, res = main_path(STEPS, dev)
    print(json.dumps(res), flush=True)
    bmodel, b_launches, b_steps, res = batched_path(STEPS, dev)
    print(json.dumps(res), flush=True)
    k4, k5, convex_steps, res = convex_path(STEPS, dev)
    print(json.dumps(res), flush=True)
    _, _, _, res = batched_convex_path(STEPS, dev)
    print(json.dumps(res), flush=True)
    for kind in ("flagship", "convex"):
        print(json.dumps(sequential_path(kind, dev)), flush=True)
    bf_model, bf_launches, bf_steps, res = main_path(STEPS, dev,
                                                     use_bf16=True)
    print(json.dumps(res), flush=True)
    bb_model, bb_launches, bb_steps, res = bf16_batched_path(
        BF16_BATCH_STEPS, dev)
    print(json.dumps(res), flush=True)
    print(json.dumps(joint_path(dev)), flush=True)

    replaces = "awesome_tpu/ops/pallas_flagship.py:236"
    kernels = [
        kernel_entry("flagship_loss_grad (K1, G=1)", replaces, model,
                     480 * 640, 1, 7, main_launches, main_steps, 20, dev),
        kernel_entry("flagship_loss_grad (K2, G=8)", replaces, bmodel,
                     64 * 64, 8, 9, b_launches, b_steps, 50, dev),
        kernel_entry("flagship_loss_grad interleave=True (K3, G=2; the "
                     "K2 kernel)", "awesome_tpu/ops/pallas_flagship.py:459",
                     k3_model, 64 * 64, 2, 11, k3_launches, k3_steps, 50,
                     dev),
        kernel_entry("flagship_loss_grad use_bf16=True (K1 bf16 build, "
                     "G=1)", replaces, bf_model, 480 * 640, 1, 7,
                     bf_launches, bf_steps, 20, dev, use_bf16=True),
        kernel_entry("flagship_loss_grad use_bf16=True (K2 bf16 build, "
                     "G=8, per-image points)", replaces, bb_model, 64 * 64,
                     8, 9, bb_launches, bb_steps, 50, dev, use_bf16=True,
                     per_image=True),
    ] + icnn_entries(k4, k5, convex_steps, 50, dev)
    print("library: no single PyTorch call computes the fused flagship loss "
          "and gradient, a fused ICNN forward, or its weight grads; "
          "library_ms is null")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
