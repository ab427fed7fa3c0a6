#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (``awesome_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line (any failure exits nonzero):

1. the card's name and power limit (``nvidia-smi``), then the build of
   ``awesome_tpu_torch/ops/csrc/flagship.cu`` with nvcc for sm_90a (into
   ``build/awesome_tpu_torch/``) and its time;
2. the fused loss+grad kernel against its plain PyTorch version on the
   card: the bench model (flow 32x12, ICNN 130x2) and the factory default
   (flow 130x6, ICNN 130x2), and the bench model with a third ICNN layer
   (the kernel's 32-point instantiation); N = 64*64 and a ragged 4097,
   G = 1 and G = 2 with distinct params and targets per image; loss rtol
   1e-5, grads rtol 5e-4 atol 1e-6; two launches bitwise equal;
3. the main path: ``make_fit_fn(model, FitConfig(fused=True, ...))`` with
   the bench model at 480x640 on an ellipse target; the kernel's launch
   count must equal the steps, every loss be finite and the last below the
   first; prints ms/step, point-steps/s and the IoU of the fitted mask;
4. the batched fused fit: ``make_batched_fit_fn`` on 8 images at 64x64
   with the IoU gate (threshold 0.5) and retry; prints gate IoUs and time;
5. a ``kernels`` JSON line: per kernel its time at the path's shape, its
   launches on its path, the steps that path ran and the launches per
   step, its bound on this card, the plain version's time, and its error
   against the plain version at that shape;
6. the card's name and power limit, and last the result line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Without CUDA it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): FP32 on the CUDA cores and
# HBM3 bandwidth. The kernel's arithmetic is plain FP32 FMAs.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

LOSS_RTOL = 1e-5
STEPS = 2000  # steps of each fit, the protocol's per-image count
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def bench_model(shape, device):
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    return real_nvp_path_connected_net(
        channels=2, hidden_units=32, flow_n_flows=12, flow_output_fn="tanh",
        spatial_shape=shape, convex_net_hidden_units=130,
        convex_net_hidden_layers=2, device=device)


def deep_model(shape, device):
    """The bench model with a third ICNN layer: too wide for the kernel's
    64-point chunks, so the launch takes its 32-point instantiation."""
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    return real_nvp_path_connected_net(
        channels=2, hidden_units=32, flow_n_flows=12, flow_output_fn="tanh",
        spatial_shape=shape, convex_net_hidden_units=130,
        convex_net_hidden_layers=3, device=device)


def default_model(shape, device):
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    return real_nvp_path_connected_net(channels=2, flow_output_fn="tanh",
                                       spatial_shape=shape, device=device)


def ellipse_target(h: int, w: int, device):
    """The bench's target: fg (encoded 0) inside an axis-aligned ellipse."""
    import torch

    yy, xx = np.mgrid[0:h, 0:w]
    fg = (((yy - h / 2) ** 2 / (0.09 * h * h)
           + (xx - w / 2) ** 2 / (0.05 * w * w)) <= 1.0)
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


def loss_grad_inputs(model, n: int, g: int, seed: int, device):
    """Flat params (g, P), points (n, 2), targets and weights (g, n)."""
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
    return spec, flat, pts.contiguous(), tgts.reshape(g, n).contiguous(), \
        wts.reshape(g, n).contiguous()


def kernel_vs_plain(model, n: int, g: int, seed: int, device) -> float:
    """Kernel against the plain version on the same inputs; returns the
    largest absolute error over loss and grads. Raises on a mismatch or
    when two launches differ in any bit. Launches made here are taken out
    of the kernel's launch count again."""
    import torch

    from awesome_tpu_torch.ops.flagship import (
        FlagshipLossGrad,
        flagship_loss_grad_cuda,
        flagship_loss_grad_plain,
        pack_flat,
        unpack_flat,
    )

    spec, flat, pts, tgt, wts = loss_grad_inputs(model, n, g, seed, device)
    f = FlagshipLossGrad(spec, True, g, None)
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


def bound_ms(spec, n: int, g: int) -> tuple:
    """Least time the card needs for one fused loss+grad: the larger of
    the FP32 operations (3 passes over every matrix, 2 FLOP per MAC;
    elementwise tanh/exp/sigmoid not counted) at the FP32 peak, and the
    bytes (points, targets, weights and params read once, grads and loss
    written once) at the HBM rate."""
    _, p_len = spec.offsets()
    f, h2, w, nl = spec.n_flows, 2 * spec.hidden, spec.icnn_w, spec.n_layers
    macs = f * (h2 * 2 + 4 * h2) + w * 2 + nl * w * (w + 2) + (w + 2)
    flops = 2.0 * 3.0 * macs * n * g
    nbytes = 4.0 * (2 * n + 2 * g * n + g * p_len + g * (p_len + 1))
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_entry(name, replaces, model, n, g, seed, launches, steps, reps,
                 device):
    """Time the kernel and the plain version at one shape and hold them
    against each other there."""
    from awesome_tpu_torch.ops.flagship import (
        FlagshipLossGrad,
        flagship_loss_grad_cuda,
        flagship_loss_grad_plain,
        unpack_flat,
    )

    err = kernel_vs_plain(model, n, g, seed, device)
    spec, flat, pts, tgt, wts = loss_grad_inputs(model, n, g, seed, device)
    f = FlagshipLossGrad(spec, True, g, None)
    before = flagship_loss_grad_cuda.launches
    ms = cuda_time_ms(lambda: f.flat(flat, pts, tgt, wts), reps)
    flagship_loss_grad_cuda.launches = before
    packed = unpack_flat(spec, flat)
    plain_ms = cuda_time_ms(
        lambda: flagship_loss_grad_plain(spec, packed, pts, tgt, wts),
        max(3, reps // 4))
    b_ms, b_by = bound_ms(spec, n, g)
    return {
        "name": name, "route": "cuda",
        "source": "awesome_tpu_torch/ops/csrc/flagship.cu",
        "replaces": replaces, "launches": launches, "steps": steps,
        "launches_per_step": launches / steps, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": {"n": n, "g": g},
    }


def main_path(steps: int, device):
    """The flagship fused prior fit at 480x640 (bench model)."""
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.fit.prior_fit import (
        FitConfig,
        make_fit_fn,
        run_fit_loop,
    )
    from awesome_tpu_torch.measures.metrics import iou
    from awesome_tpu_torch.ops.flagship import flagship_loss_grad_cuda

    h, w = 480, 640
    model = bench_model((h, w), device)
    pts = G.flatten_grid(G.pixel_grid((h, w), device=device))
    target = ellipse_target(h, w, device)
    params = model.init(torch.Generator().manual_seed(2))
    cfg = FitConfig(num_steps=steps, lr=1e-3, nan_guard_grads=False,
                    fused=True)
    fit = make_fit_fn(model, cfg)
    # warm-up: loads the kernel and picks its launch shape
    make_fit_fn(model, dataclasses.replace(cfg, num_steps=2))(
        params, pts, target)
    torch.cuda.synchronize()
    flagship_loss_grad_cuda.launches = run_fit_loop.steps = 0
    t0 = time.perf_counter()
    fitted, aux = fit(params, pts, target)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, ran = flagship_loss_grad_cuda.launches, run_fit_loop.steps
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
    return model, launches, ran, {
        "phase": "main_path", "shape": [h, w], "steps": ran,
        "seconds": dt, "ms_per_step": 1e3 * dt / steps,
        "point_steps_per_s": steps * pts.shape[0] / dt,
        "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
        "iou": score, "kernel_launches": launches,
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
    return model, launches, ran, {
        "phase": "batched_path", "images": batch, "shape": [h, w],
        "steps": ran, "seconds": dt,
        "point_steps_per_s": launches * batch * pts.shape[0] / dt,
        "gate_iou": [float(v) for v in gate],
        "gate_pass": int((gate >= 0.5).sum()), "kernel_launches": launches,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from awesome_tpu_torch.ops import flagship

    dev = "cuda"
    smi = nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    lib = flagship.build_library()
    log = lib.with_suffix(".build.log").read_text()
    print(f"build: {lib} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    for name, make, tp in (("bench", bench_model, 64),
                           ("default", default_model, 64),
                           ("deep", deep_model, 32)):
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
    print(f"kernel_vs_plain: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)

    model, main_launches, main_steps, res = main_path(STEPS, dev)
    print(json.dumps(res), flush=True)
    bmodel, b_launches, b_steps, res = batched_path(STEPS, dev)
    print(json.dumps(res), flush=True)

    replaces = "awesome_tpu/ops/pallas_flagship.py:236"
    kernels = [
        kernel_entry("flagship_loss_grad (K1, G=1)", replaces, model,
                     480 * 640, 1, 7, main_launches, main_steps, 20, dev),
        kernel_entry("flagship_loss_grad (K2, G=8)", replaces, bmodel,
                     64 * 64, 8, 9, b_launches, b_steps, 50, dev),
    ]
    print("library: no single PyTorch call computes this fused loss and "
          "gradient; library_ms is null")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
