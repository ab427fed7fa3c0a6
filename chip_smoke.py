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
   with the points repeated; K2 at G = 8 x 480x640 at the same tolerances,
   its G x tiles per image at most the card's resident blocks (one wave);
   then the bf16 build against the plain bf16
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
    one FP32 K2 launch a step for the batch's prior grads at both sizes,
    and K2 at G = 2 x 480x640 against its plain version on a step's own
    inputs (the shared grid, the seg output as targets, the penalty's
    per-point weights) at phase 2's tolerances, two launches bitwise
    equal; ms per step, peak memory and the device's idle share;
12. multi-object joint training, the FBMS runner's multi-object stage
    (``train_multi_object``: a full-width UNet(4, 2) and two bench-model
    children per frame, ``JointTrainConfig()``, the children pretrained
    by the fused fit (K2 at G = frames x 2) with the active slots as
    ``valid_mask``, growth from one slot to two with the grown slots
    refitted, the tracker's "Loss", a 'latest' checkpoint every epoch and
    'best' through ``atomic_dir``), under
    ``torch.use_deterministic_algorithms(True)``: (a) 8 frames of 64x64,
    batch 4, 6 epochs, 200 pretrain steps, growth at epoch 2; the
    checkpoint of epoch 3 restored into a fresh state and trained to
    epoch 6 must equal the uninterrupted run bitwise, leaf for leaf, and
    its tracker too; the run and its resume again without the flag (only
    the package's own settings), equal to the flagged run and resumed
    bitwise; finite losses that fall; (b) 4 frames of 480x640,
    batch 2, 2 epochs, 100 pretrain steps, growth at epoch 1; ms/step,
    peak memory and the device's idle share of both;
13. the spatio-temporal fit: one 3-channel FBMS prior for 4 frames of
    480x640 (``sequence_points``), Adamax lr 1e-3, 3 epochs: finite losses,
    a falling epoch loss, ms per frame step and the idle share; and the
    zoo: ``apply_prefits(prefit_flow_identity=True, zoo=...)`` twice, the
    second call loading bitwise what the first fitted;
14. the runner path: ``AwesomeRunner`` as ``python -m
    awesome_tpu_torch.run`` drives it (build, store_config, pretrain with
    the 0.5 IoU gate and one retry, train with metrics and validation
    every 100 epochs, evaluate, the dense refit ``sequential_prior_fit``,
    save_results) at full width (seg ``Net()``, prior
    ``FullyFusedConvexNextNet(ConvexNextNet(130, 1))``, Adam lr 0.02, the
    extra penalty after epoch 200) on 8 synthetic images of the
    convexity-51 shapes, cut to 300 epochs (the protocol has 3000), 500
    pretrain and 500 refit steps (2000 each); K4 and K5 launch once each
    per training epoch for all images (K4 once more per evaluation), the
    loss falls before and with the extra penalty; ms per epoch, pretrain
    ms/step, the idle share of a 20-epoch window, peak memory, gate IoUs
    and metrics; a run to epoch 160 restarted with ``resume=True`` ends
    bitwise where the uninterrupted run's training ended;
15. the FBMS path (``fbms_path``): ``runner/fbms_runner.py`` on a
    synthetic 4-frame sequence at 480x640 (FBMS-59's cars frames) in the
    FBMS-59 layout: ``pretrain_joint_priors`` with the bench prior, a cold
    fit of 500 steps and warm fits of 200 with the flow-identity prefit in
    a zoo, K1 launched once per step (1100), and again from the zoo,
    bitwise equal; ``train_joint`` of the full-width UNet(4, 1), 3 epochs
    in batches of 2 with an evaluation and a checkpoint each epoch
    (finite losses that fall, evaluations in [0, 1]), a run stopped after
    epoch 1 and resumed to epoch 3 bitwise equal to it, ``evaluate_joint``
    on both GT frames, and once more with the CRF (its metrics and
    seconds), one step's ms, peak memory and idle share; the
    spatio-temporal fit and its evaluation, plain and in the noisy family
    with its prefits; ``train_joint_from_config`` on a multi-object config
    (8 frames of 64x64, 2 slots, 3 epochs); ``python -m
    awesome_tpu_torch.run`` in a subprocess on an FBMS config (4 frames of
    64x64), which must exit 0 and leave its run folder's checkpoints;
16. the extra priors (``extra_priors_path``): ``StarShapedNet(150)``,
    ``RotationSymmetricNet(150)``, ``PeriodicNet(200, use_premap=False)``,
    ``ConvexDiffeomorphismNet.create()`` and ``ConvexMLP()``, each fitted
    for 300 steps by the autograd fit engine to the ellipse target at
    480x640 (N = 307,200): ms/step, the device's busy ms/step and idle
    share, first and last loss (finite, falling), IoU, the star prior's
    ``W2_r >= 0``; then the round trip ``inverse(apply(x))`` at 480x640 of
    ``GlowFlow``, ``SplineFlow``, ``NormalizingFlow1D`` and the fitted
    convex-diffeomorphism prior, each below 1e-3;
17. the convexity runner with the convex-diffeomorphism prior
    (``runner_convex_diffeo_path``): a ``NormalizingFlow1D(4, 70)`` in
    front of ``FullyFusedConvexNextNet(ConvexNextNet(130, 1))``, the CRF
    with the metrics and after training, the 8 images of the runner phase
    cut to 100 epochs and 100 pretrain steps: K4 and K5 once per epoch,
    ms/epoch and idle share of a 20-epoch window, the CRF's metric and ms
    per evaluation (one call per image, the shapes differ), and the
    prior's grads at the runner's shape through K4/K5 (the flow's through
    K5's dx) against the plain-ICNN prior's;
18. the dense CRF (``crf_path``): ``dense_crf_batched`` on 4 frames of
    480x640 with the default options (15 iterations), ms per call and per
    image, its device profile, two calls equal in every bit (and a third
    under ``torch.use_deterministic_algorithms(True)``); then ``dense_crf``
    on the card against ``dense_crf_exact`` (the g++-built permutohedral
    lattice) on a clean 40x40 scene, labels agreeing above 0.97;
19. the runner's image mode (``image_runner_path``): the paper table's
    CNNNet cell (``dimension: 3d``, ``CNNNet`` at its default widths, Adam
    lr 1e-3) with ``FullyFusedConvexNextNet(ConvexNextNet(64, 1))`` on the
    runner phase's 8 images padded to one 240x320 bucket, 100 epochs, 100
    pretrain and refit steps: K4 and K5 once each per epoch for all
    images, a falling loss, metrics in [0, 1], ms/epoch, the idle share of
    a 20-epoch window, peak memory; the window under
    ``torch.use_deterministic_algorithms(True)`` equal to it bitwise; one
    epoch's grads by ``vmap`` (grouped convs) against a loop over the
    images; a 'featxy' epoch beside the 'xy' one; then a full-width UNet
    per image (2 images, 5 epochs, its batch-norm state per image);
20. the device spectral solve (``spectral_path``): the 'spectral_device'
    SSS proxy on a 480x640 image (solved at 120x160) and on the
    two-region test scene: ms per call, the device's busy ms, bitwise
    repeats, the nontrivial eigenvectors at cos >= 0.999 (largest
    principal angle) from float64 ``eigsh`` on the same stencil, the host
    proxy's ms, no fallback to the host;
21. the paper table (``paper_table_path``): ``python -m
    awesome_tpu_torch.scripts.run_paper_table`` in a subprocess on 4 cells
    (CNNNet xy with the prior, CNNNet featxy without, Net feat and FCNet
    featxy with) with the 'spectral_device' proxy, 12 images of 64x64, 320
    epochs, the script's global floors: exit 0, the table written, each
    cell's MIOUs and seconds;
22. the data and utilities (``data_utils_path``): ``fit_prior_fused``
    with the bench model at 480x640, 200 steps timed by ``DeviceTimer``
    (one K1 launch per step, a falling loss, params bitwise equal to
    ``make_fused_fit_fn``'s, a 5-step ``trace`` written; its ms/step
    printed beside the main path's K1 ms); the convexity runner at full
    width with the reference's ``SISBOSIDataset`` type on the runner
    phase's 8 images, augmented, 40 epochs and 100 pretrain steps (K4
    and K5 once per epoch, metrics in [0, 1], two builds with one seed
    equal bit for bit, the checkpoint saves timed apart, a 20-epoch
    window timed and profiled); a
    ``PriorCache`` of its fitted priors on the card with a bitwise
    save/load; ``assert_finite`` on the fitted trees and a backward NaN
    trapped by ``debug_guard``; the ``PhaseTimer`` report (run folders in
    ``build/smoke_data/``); the checkpoint saves carry the in-memory
    samples as one binary ``samples.npz`` each;
23. the device mesh (``mesh_path``): two ranks (``parallel/launch.py``)
    on the backend rule's choice, gloo on the one card (NCCL, a card
    each, on a machine with more): the batched fused fit (bench model, 4
    images at 480x640, the gate, 200 steps) on meshes (2, 1) and (1, 2)
    against the single-process fit (on each, one step at the inits and
    at the fitted params with each rank's K2 on its block of the images
    and points within rtol 1e-5 in the loss and 5e-4 in the grads, the
    first 30 steps' losses within rtol 1e-5, the final ones within 1e-2,
    the same gate outcomes; (2, 1) bitwise where K2 tiles an image alike
    at G = 2 and 4), K2 launches per rank, ms/step and the grid
    ``all_reduce``'s share; the convexity runner on [2, 1] and [1, 2], 40
    epochs, loss histories within rtol 2e-3, atol 2e-4 of one process,
    one K4 and one K5 launch per rank per epoch; ``run_sharded --spawn``
    with two workers; ``dryrun_multichip(2)``; every rank's backend and
    card as its mesh holds them, by the rule (run folders in
    ``build/smoke_mesh/``);
24. the teaser harness (``teaser_path``, ``runner/teaser.py``): a
    synthetic reference tree (``tools/teaser_tree.py``, 240x320 images,
    60x80 temporal masks) under ``build/smoke_teaser/``; the nine
    protocols at steps scale 0.002, the restart ensembles with 2 restarts,
    then the convex tomato at 210 of its 700 steps, which must beat its
    naive input; each a finite loss, masks of the reference's shape, its seconds
    and IoU; no kernel launched (the protocols fit the plain models, as
    the JAX package does); one ``minibatch_fit`` at the convex teaser's
    shape on the card and on the CPU with the same draws, loss histories
    within rtol 2e-4;
25. a ``kernels`` JSON line: per kernel (K1-K5, and the bf16 build of
    K1/K2) its time at its path's shape, its launches on that path, the
    steps, launches per step, its bound on this card, the plain version's
    time, and its error against the plain version at that shape; K2 also
    at the multi-object paths' shapes (G = 16 at 64x64, G = 8 at 480x640)
    and at the joint step's (G = 2 x 480x640 on a step's own inputs,
    ``"path": "joint"``),
    K4/K5 at the runner's and at the convex-diffeomorphism runner's (G =
    8, per-image points), at the image-mode runner's (width 64, G = 8,
    per-image points), K1 at the FBMS pretrain's (480x640, G = 1), and K2,
    K4 and K5 at a mesh rank's shapes (``"path": "mesh"``), each printed
    as a ``kernel_vs_plain`` line too;
26. the card's name and power limit, and last the result line
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
import os
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
                    f=None, per_image: bool = False, inputs=None) -> float:
    """Kernel against the plain version on the same inputs; returns the
    largest absolute error over loss and grads. Raises on a mismatch or
    when two launches differ in any bit. Launches made here are taken out
    of the kernel's launch count again. ``f``: the loss+grad to check (by
    default the grouped one of ``model``); ``per_image``: a point set per
    image; ``inputs``: (spec, flat, points, targets, weights) to check on
    in place of :func:`loss_grad_inputs`'."""
    import torch

    from awesome_tpu_torch.ops.flagship import (
        FlagshipLossGrad,
        flagship_loss_grad_cuda,
        flagship_loss_grad_plain,
        pack_flat,
        unpack_flat,
    )

    spec, flat, pts, tgt, wts = inputs or loss_grad_inputs(
        model, n, g, seed, device, per_image)
    f = f or FlagshipLossGrad(spec, True, g, None)
    before = flagship_loss_grad_cuda.launches
    loss_k, grads_k = f.flat(flat, pts, tgt, wts)
    loss_k2, grads_k2 = f.flat(flat, pts, tgt, wts)
    flagship_loss_grad_cuda.launches = before
    loss_p, grads_p = flagship_loss_grad_plain(
        spec, unpack_flat(spec, flat), pts, tgt, wts, f.use_sigmoid)
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


def full_resolution_k2_check(device) -> None:
    """K2 at G = 8 x 480x640 (the multi-object children's fit at full
    resolution) against the plain version, and its launch in one wave: G
    x tiles per image at most the card's SMs x resident blocks per SM."""
    import torch

    from awesome_tpu_torch.ops import flagship

    n, g = 480 * 640, 8
    model = bench_model((480, 640), device)
    spec = flagship.FlagshipSpec.of(model)
    shape = flagship.launch_shape(spec, n, g, None, torch.device(device))
    per_sm = flagship.LIBRARY.get().flagship_blocks_per_sm(
        torch.cuda.current_device(), shape.tp, 0, shape.smem)
    slots = torch.cuda.get_device_properties(0).multi_processor_count * per_sm
    if g * shape.n_tiles > slots:
        raise AssertionError(f"K2 at G={g} x {n}: {g * shape.n_tiles} "
                             f"blocks for {slots} resident slots")
    err = kernel_vs_plain(model, n, g, 18, device)
    print(json.dumps({"phase": "kernel_vs_plain", "model": "bench", "n": n,
                      "g": g, "tp": shape.tp, "chunks": shape.chunks,
                      "n_tiles": shape.n_tiles, "blocks": g * shape.n_tiles,
                      "resident_slots": slots, "max_abs_err": err,
                      "bitwise_repeat": True}), flush=True)


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
                 device, use_bf16=False, per_image=False, f=None,
                 inputs=None):
    """Time the kernel (or its bf16 build) and the plain version at one
    shape and hold them against each other there; ``f`` and ``inputs``
    (FP32 only): a path's own loss+grad and its inputs, as
    :func:`kernel_vs_plain` takes them."""
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
        err = kernel_vs_plain(model, n, g, seed, device, f, per_image,
                              inputs)
    spec, flat, pts, tgt, wts = inputs or loss_grad_inputs(
        model, n, g, seed, device, per_image)
    f = f or FlagshipLossGrad(spec, True, g, None, use_bf16=use_bf16)
    before = (flagship_loss_grad_cuda.launches,
              flagship_loss_grad_cuda.launches_bf16)
    ms = cuda_time_ms(lambda: f.flat(flat, pts, tgt, wts), reps)
    (flagship_loss_grad_cuda.launches,
     flagship_loss_grad_cuda.launches_bf16) = before
    packed = unpack_flat(spec, flat)
    plain_ms = cuda_time_ms(
        lambda: flagship_loss_grad_plain(spec, packed, pts, tgt, wts,
                                         f.use_sigmoid, use_bf16),
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
    # kernels only: an op's own row repeats the device time of its kernels,
    # and a span's (``utils.profiling.span``) the time of those inside it
    rows = [(e.key, float(e.self_device_time_total))
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]
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


def joint_k2_call(step, state, batch) -> tuple:
    """The K2 call of one joint step (``step(state, batch)``, its result
    dropped): the step's ``FlagshipLossGrad`` and its inputs, the flat
    prior rows (B, P), the grid, the seg output as targets (B, N) and the
    penalty's per-point weights (B, N). Its launch is taken out of the
    count again."""
    from awesome_tpu_torch.ops.flagship import (
        FlagshipLossGrad,
        flagship_loss_grad_cuda,
    )

    seen = []
    real = FlagshipLossGrad.flat

    def keep(self, *args):
        seen.append((self,) + tuple(a.detach().clone() for a in args))
        return real(self, *args)

    before = flagship_loss_grad_cuda.launches
    FlagshipLossGrad.flat = keep
    try:
        step(state, batch)
    finally:
        FlagshipLossGrad.flat = real
    flagship_loss_grad_cuda.launches = before
    if len(seen) != 1:
        raise AssertionError(f"a joint step called K2 {len(seen)} times")
    f, flat, pts, tgt, wts = seen[0]
    return f, (f.spec, flat, pts, tgt, wts)


def joint_path(device, small=(64, 64), images=8, batch=4, epochs=10,
               large=(480, 640), large_images=2, large_steps=3):
    """Joint training of the flagship wrapper with ``JointTrainConfig()``:
    ``epochs`` epochs over ``images`` images of ``small`` size in batches
    of ``batch`` (the epoch fn), then ``large_steps`` steps on
    ``large_images`` images of ``large`` size. Finite losses, decreasing
    at the small size (first epoch's mean against the last's); one K2
    launch a step for the batch's prior grads at both sizes, and K2 at
    the large size timed and held against its plain version on a step's
    own inputs (``large["k2_kernel"]``, an entry of the kernels line)."""
    import numpy as _np
    import torch

    from awesome_tpu_torch.fit.trainer import (
        JointTrainConfig,
        epoch_batches,
        joint_train_init,
        make_joint_epoch_fn,
        make_joint_train_step,
    )
    from awesome_tpu_torch.ops import flagship

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
    zero_counts()
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
    small_k2 = _check_joint_k2(per_epoch * epochs, f"{small}")
    ms = 1e3 * sum(times[1:]) / (per_epoch * (len(times) - 1))
    idx, wgt = plans[0]
    out["small"] = {
        "shape": list(small), "images": images, "batch": batch,
        "steps": int(state.step), "k2_launches": small_k2,
        "loss": [float(v) for v in hist],
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
    zero_counts()
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
    large_k2 = _check_joint_k2(large_steps, f"{large}")
    f, inputs = joint_k2_call(step, state, batch_l)
    n = large[0] * large[1]
    k2 = kernel_entry(
        f"flagship_loss_grad (K2, G={large_images} at {large[0]}x"
        f"{large[1]}, the joint step's prior grads)",
        "awesome_tpu/ops/pallas_flagship.py:236", None, n, large_images, 0,
        large_k2, large_steps, 10, device, f=f, inputs=inputs)
    shape = flagship.launch_shape(f.spec, n, large_images, f.tile_n,
                                  inputs[2].device)
    print(json.dumps({"phase": "kernel_vs_plain", "model": "bench",
                      "path": "joint", "n": n, "g": large_images,
                      "tp": shape.tp, "chunks": shape.chunks,
                      "n_tiles": shape.n_tiles,
                      "max_abs_err": k2["max_abs_err"],
                      "bitwise_repeat": True}), flush=True)
    ms = 1e3 * sum(times[1:]) / max(len(times) - 1, 1)
    out["large"] = {
        "shape": list(large), "images": large_images,
        "steps": int(state.step), "k2_kernel": dict(k2, path="joint"),
        "loss": losses, "ms_per_step": ms,
        "first_step_s": times[0],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profile": device_profile(lambda: step(state, batch_l), 1, ms),
    }
    return out


def _check_joint_k2(steps: int, where: str) -> int:
    """One FP32 K2 launch a joint step, and nothing else launched."""
    k1, k1_bf16, k4, k5, _ = counts()
    if k1 != steps or k1_bf16 or k4 or k5:
        raise AssertionError(f"joint training at {where}: K2 launched {k1} "
                             f"times in {steps} steps (bf16 {k1_bf16}, K4 "
                             f"{k4}, K5 {k5})")
    return k1


def multi_object_data(h: int, w: int, t: int, seed: int, device, k: int = 2,
                      labeled_share: float = 0.1):
    """``t`` frames of uniform noise with ``k`` ellipses (the objects,
    drifting apart) brighter on top; features; the clean grid; the
    per-object unaries (T, H, W, K), fg encoded 0 per channel; a sparse
    labeled mask (T, H, W); and the children's point targets (T, K, N, 1)
    with unlabeled points as bg, as the FBMS runner builds them."""
    import torch

    from awesome_tpu_torch.core import grids as G

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tgt = np.ones((t, h, w, k), np.float32)
    for i in range(t):
        for j in range(k):
            cy = h * (0.3 + 0.4 * j / max(k - 1, 1) + 0.01 * i)
            cx = w * (0.3 + 0.4 * j / max(k - 1, 1) - 0.01 * i)
            inside = (((yy - cy) / (0.14 * h)) ** 2
                      + ((xx - cx) / (0.12 * w)) ** 2) <= 1.0
            tgt[i, :, :, j] = 1.0 - inside
    fg = (tgt < 0.5).any(-1)
    image = 0.5 * rng.uniform(size=(t, h, w, 3)) + 0.5 * fg[..., None]
    feats = rng.uniform(size=(t, h, w, 1))
    labeled = rng.uniform(size=(t, h, w)) < labeled_share
    pt_tgt = np.where(labeled[:, None], np.moveaxis(tgt, -1, 1), 1.0)

    def dev(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)

    data = {"image": dev(image), "features": dev(feats),
            "grid": G.flatten_grid(G.pixel_grid((h, w), device=device)),
            "target_obj": dev(tgt), "labeled": dev(labeled, torch.bool)}
    return data, dev(pt_tgt.reshape(t, k, h * w, 1))


def multi_object_wrapper(h: int, w: int, device, max_objects: int = 2):
    """The FBMS multi-object stage's model (``runner/fbms_runner.py``): a
    full-width UNet(4, K) with one channel per object slot and, per
    frame, K children of the FBMS prior (channels 2, flow 32 x 12 with
    tanh, ICNN 130 x 2: the bench model), on the clean grid."""
    from awesome_tpu_torch.nn.multi_prior import MultiPriorModule
    from awesome_tpu_torch.nn.seg import UNet
    from awesome_tpu_torch.nn.wrapper import WrapperModule

    return WrapperModule(
        segmentation_module=UNet(in_chn=4, out_chn=max_objects,
                                 device=device),
        prior_module=MultiPriorModule(bench_model((h, w), device),
                                      max_priors=max_objects),
        input_mode="image", prior_arg_mode="param_clean_grid",
        seg_stateful=True)


def train_multi_object(wrapper, data, pt_targets, cfg, epochs: int,
                       batch: int, pretrain_steps: int, grow_at: dict,
                       ckdir: str, seed: int = 0, resume_from=None,
                       after_epoch=None):
    """The multi-object stage of the FBMS runner
    (``runner/fbms_runner.py:_train_joint_multi_object_impl``) at LR scale
    1: the state from ``seed`` with one active slot; the children's
    pretrain (``pretrain_steps`` fused steps on the active slots); per
    epoch, growth at the epochs of ``grow_at`` ({epoch: count}: fresh
    slots, then refitted as long), the epoch fn over the seeded batch
    plan, the tracker's train "Loss", 'best' when it improves and 'latest'
    after every epoch, each through ``atomic_dir``. With ``resume_from``
    the state, epoch and tracker come from ``restore_resumable`` (before
    the pretrain, which a restored state already holds) and the plan
    stream is fast-forwarded past the trained epochs. Returns (state,
    tracker, per-epoch losses, per-epoch seconds of the epoch fn)."""
    import torch

    from awesome_tpu_torch.fit.checkpoint import (
        AgentCheckpoint,
        atomic_dir,
        restore_resumable,
        save_pytree,
    )
    from awesome_tpu_torch.fit.prior_fit import (
        FitConfig,
        fit_multi_object_priors,
    )
    from awesome_tpu_torch.fit.tracker import Tracker
    from awesome_tpu_torch.fit.trainer import (
        assure_multi_prior_count,
        epoch_batches,
        make_multi_object_epoch_fn,
        multi_object_train_init,
    )

    t = data["image"].shape[0]
    child = wrapper.prior_module.child
    state = multi_object_train_init(
        wrapper, torch.Generator().manual_seed(seed), t, cfg,
        initial_count=1)
    tracker = Tracker(primary_metric="Loss", primary_mode="train")
    start = 0
    if resume_from is not None:
        res = restore_resumable(resume_from, "multi", state, epochs)
        state, start, tracker = res["state"], res["epoch"], res["tracker"]

    def fit_children(st, slots):
        # 'equal' class weights: the per-object targets are sparse points
        fitted, _ = fit_multi_object_priors(
            child, st.prior_params["children"], data["grid"], pt_targets,
            FitConfig(num_steps=pretrain_steps, lr=1e-3, weight_mode="equal",
                      nan_guard_grads=False, fused=True),
            valid_mask=slots)
        return st._replace(prior_params=dict(st.prior_params,
                                             children=fitted))

    def save(st, tag, epoch):
        with atomic_dir(os.path.join(ckdir, tag)) as tmp:
            AgentCheckpoint(
                f"fbms_joint_{tag}",
                {"seg": st.seg_params, "prior": st.prior_params},
                tracker=tracker.to_dict(), config={},
                extra={"epoch": epoch, "state_kind": "multi",
                       "stopped_early": False}).save(tmp)
            save_pytree(tuple(st), os.path.join(tmp, "train_state"))

    if pretrain_steps and start == 0:
        state = fit_children(state, state.active)
    epoch_fn = make_multi_object_epoch_fn(wrapper, cfg)
    rng = np.random.default_rng(seed)
    for _ in range(start):
        epoch_batches(t, batch, rng)
    losses, seconds = [], []
    for e in range(start, epochs):
        if e in grow_at:
            prev = state.active
            state = assure_multi_prior_count(wrapper, state, cfg, grow_at[e],
                                             seed + 1000 + e)
            state = fit_children(state, state.active & ~prev)
        idx, wgt = epoch_batches(t, batch, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = epoch_fn(state, data, idx, wgt)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(met["loss"].cpu().numpy())
        tracker.epoch = e + 1
        tracker.epoch_metric("Loss", float(losses[-1].mean()), "train")
        if tracker.is_current_state_best_model():
            save(state, "best", e + 1)
        save(state, "latest", e + 1)
        if after_epoch is not None:
            after_epoch(e + 1)
    return state, tracker, losses, seconds


def first_difference(a, b):
    """The key path of the first leaf where two states differ in dtype or
    in any bit ('structure' when their leaves differ), else None."""
    import torch

    from awesome_tpu_torch.core import tree as T

    pa = dict(T.tree_flatten_with_path(a))
    pb = dict(T.tree_flatten_with_path(b))
    if pa.keys() != pb.keys():
        return "structure"
    for path, x in pa.items():
        y = pb[path]
        if x is None and y is None:
            continue
        if (x is None or y is None or x.dtype != y.dtype
                or not torch.equal(x, y)):
            return "/".join(path)
    return None


def multi_object_path(device, shape, frames: int, batch: int, epochs: int,
                      pretrain_steps: int, grow_at: dict, resume_at=None,
                      falling: bool = True) -> dict:
    """Multi-object joint training at ``shape`` (see
    :func:`train_multi_object`), with ``JointTrainConfig()``, under
    ``torch.use_deterministic_algorithms(True)`` (a nondeterministic op
    raises). K2 launches = fused pretrain steps, at G = frames x slots.
    With ``resume_at``: the checkpoint directory as it stood after that
    epoch is restored into a fresh state and trained to the end, and every
    leaf of the final state must equal the uninterrupted run's bitwise,
    and so must the tracker; then the run and its resume again without
    the flag, with only the settings of the package's import (what a
    user's script gets), which must equal the flagged run bitwise and
    resume bitwise too. Finite losses; with ``falling`` the last
    epoch's mean below the first's. ms/step (the epoch fn's, after the
    first epoch), peak memory and the device's idle share."""
    import shutil
    import tempfile

    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.trainer import (
        JointTrainConfig,
        epoch_batches,
        make_multi_object_epoch_fn,
    )

    cfg = JointTrainConfig()
    wrapper = multi_object_wrapper(*shape, device)
    data, pt_targets = multi_object_data(*shape, frames, 8, device)
    k = wrapper.prior_module.max_priors
    root = tempfile.mkdtemp(prefix="multi_object_")
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        def snapshot_to(tag):
            def snapshot(epoch):
                if epoch == resume_at:
                    shutil.copytree(os.path.join(root, tag),
                                    os.path.join(root, tag + "_preempted"))
            return snapshot

        def resumed_equal(state, tracker, tag):
            resumed, rtracker, rlosses, _ = train_multi_object(
                wrapper, data, pt_targets, cfg, epochs, batch,
                pretrain_steps, grow_at, os.path.join(root, tag + "_resumed"),
                resume_from=os.path.join(root, tag + "_preempted"))
            diff = first_difference(state, resumed)
            if diff is not None:
                raise AssertionError(f"resume from epoch {resume_at} is not "
                                     f"bitwise ({tag}): first difference "
                                     f"at {diff}")
            if rtracker.to_dict() != tracker.to_dict():
                raise AssertionError(f"the resumed tracker differs ({tag})")
            return {"from_epoch": resume_at, "epochs_trained": len(rlosses),
                    "leaves_bitwise_equal":
                        len(T.tree_flatten_with_path(state)),
                    "tracker_equal": True}

        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        state, tracker, losses, secs = train_multi_object(
            wrapper, data, pt_targets, cfg, epochs, batch, pretrain_steps,
            grow_at, os.path.join(root, "run"), after_epoch=snapshot_to("run"))
        wall = time.perf_counter() - t0
        k2, _, _, _, ran = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = pretrain_steps * (1 + len(grow_at))
        if not k2 == ran == want:
            raise AssertionError(f"multi-object path: K2 launched {k2} "
                                 f"times in {ran} fit steps, want {want}")
        hist = np.concatenate(losses)
        if not np.isfinite(hist).all():
            raise AssertionError("non-finite loss in multi-object training")
        if falling and not losses[-1].mean() < losses[0].mean():
            raise AssertionError(f"multi-object loss did not decrease: "
                                 f"{losses[0].mean()} -> "
                                 f"{losses[-1].mean()}")
        steps = int(state.step)
        per_epoch = steps // epochs
        timed = secs[1:] or secs
        ms = 1e3 * sum(timed) / (per_epoch * len(timed))
        out = {
            "phase": "multi_object_path", "shape": list(shape),
            "frames": frames, "slots": k, "batch": batch, "epochs": epochs,
            "grow_at": {str(e): c for e, c in grow_at.items()},
            "steps": steps, "loss": [float(v) for v in hist],
            "epoch_loss": [float(v.mean()) for v in losses],
            "ms_per_step": ms, "first_epoch_ms_per_step":
                1e3 * secs[0] / per_epoch,
            "wall_s": wall, "peak_memory_gib": peak,
            "k2_launches": k2, "k2_group": frames * k,
            "pretrain_steps": pretrain_steps,
            "active_slots": int(state.active.sum()),
            "deterministic_algorithms": True,
        }
        if resume_at is not None:
            out["resume"] = resumed_equal(state, tracker, "run")
            # the same without the flag, with only what the package's
            # import sets: equal to the flagged run, and resumed bitwise
            torch.use_deterministic_algorithms(False)
            dstate, dtracker, _, _ = train_multi_object(
                wrapper, data, pt_targets, cfg, epochs, batch,
                pretrain_steps, grow_at, os.path.join(root, "default"),
                after_epoch=snapshot_to("default"))
            diff = first_difference(state, dstate)
            if diff is not None:
                raise AssertionError(
                    f"the run with only the package's settings differs from "
                    f"the flagged run: first difference at {diff}")
            out["resume_default_settings"] = dict(
                resumed_equal(dstate, dtracker, "default"),
                equal_to_flagged_run=True)
            torch.use_deterministic_algorithms(True)
        epoch_fn = make_multi_object_epoch_fn(wrapper, cfg)
        idx, wgt = epoch_batches(frames, batch, np.random.default_rng(1))
        out["profile"] = device_profile(
            lambda: epoch_fn(state, data, idx, wgt), per_epoch, ms)
    finally:
        torch.use_deterministic_algorithms(det)
        shutil.rmtree(root, ignore_errors=True)
    return out


def spatiotemporal_path(device, shape=(480, 640), frames: int = 4,
                        epochs: int = 3) -> dict:
    """One shared (x, y, t) prior for a sequence: the 3-channel FBMS prior
    (flow 32 x 12 with tanh, ICNN 130 x 2; its norm fitted on the (100, H,
    W) grid), ``frames`` frames at ``shape`` from ``sequence_points`` on
    drifting ellipse unaries with 10% of the points labeled,
    ``FitConfig(optimizer='adamax', lr=1e-3)``, ``epochs`` epochs: finite
    losses and a falling epoch loss; ms per frame step and the device's
    idle share."""
    import torch

    from awesome_tpu_torch.fit.prior_fit import FitConfig
    from awesome_tpu_torch.fit.spatiotemporal import (
        make_spatiotemporal_fit_fn,
        sequence_points,
    )
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    h, w = shape
    model = real_nvp_path_connected_net(
        channels=3, hidden_units=32, flow_n_flows=12, flow_output_fn="tanh",
        spatial_shape=shape, convex_net_hidden_units=130,
        convex_net_hidden_layers=2, device=device)
    pts = sequence_points(shape, frames, device=device)
    tgt = torch.stack([ellipse_target(h, w, device, (0.0, 0.03 * f))
                       for f in range(frames)])
    labeled = (torch.rand((frames, h * w),
                          generator=torch.Generator().manual_seed(12))
               < 0.1).to(device)
    params = model.init(torch.Generator().manual_seed(13))
    cfg = FitConfig(optimizer="adamax", lr=1e-3)
    one = make_spatiotemporal_fit_fn(model, cfg, 1)
    one(params, pts, tgt, labeled)  # warm-up
    fit = make_spatiotemporal_fit_fn(model, cfg, epochs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, aux = fit(params, pts, tgt, labeled)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hist = aux["epoch_loss"].cpu().numpy()
    check_hist(hist, "the spatio-temporal fit")
    ms = 1e3 * dt / (epochs * frames)
    return {
        "phase": "spatiotemporal_path", "shape": list(shape),
        "frames": frames, "epochs": epochs, "epoch_loss":
            [float(v) for v in hist], "ms_per_frame_step": ms,
        "seconds": dt,
        "profile": device_profile(lambda: one(params, pts, tgt, labeled),
                                  frames, ms),
    }


def zoo_check(device) -> dict:
    """``apply_prefits(prefit_flow_identity=True, zoo=Zoo(tmp))`` twice on
    the bench model at 64x64: the first call fits the flow and caches it,
    the second loads it, bitwise the same."""
    import tempfile

    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import apply_prefits
    from awesome_tpu_torch.nn.zoo import Zoo

    model = bench_model((64, 64), device)
    pts = G.flatten_grid(G.pixel_grid((64, 64), device=device))
    params = model.init(torch.Generator().manual_seed(14))
    with tempfile.TemporaryDirectory() as root:
        zoo = Zoo(root)
        t0 = time.perf_counter()
        first = apply_prefits(model, params, pts, prefit_flow_identity=True,
                              zoo=zoo)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        entries = len(os.listdir(root))
        again = apply_prefits(model, params, pts, prefit_flow_identity=True,
                              zoo=zoo)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    fitted = any(not torch.equal(a, b) for a, b in zip(
        T.tree_leaves(first["flow"]), T.tree_leaves(params["flow"])))
    if not (fitted and entries == 3 and first_difference(first, again)
            is None):
        raise AssertionError("the zoo's second prefit is not the first's")
    return {"phase": "zoo", "zoo_files": entries, "fit_s": t1 - t0,
            "load_s": t2 - t1, "bitwise_equal": True}


# The runner phase: the convexity-51 shapes of the repo's full protocol
# (PARITY.md:371-376), and its cuts from the paper protocol
RUNNER_SHAPES = ((160, 224), (160, 224), (192, 256), (192, 256),
                 (224, 288), (224, 288), (240, 320), (240, 320))
RUNNER_EPOCHS = 300  # the protocol has 3000
RUNNER_PRETRAIN = 500  # the protocol has 2000
RUNNER_REFIT = 500  # the protocol has 2000
RUNNER_RESUME_AT = 160


def runner_config(folder: str, device, **kw):
    """The convexity benchmark's config at the default widths: seg
    ``Net()`` (5 -> 130 -> 130 -> 1), the prior
    ``FullyFusedConvexNextNet(ConvexNextNet(130, 1))``, Adam lr 0.02,
    AwesomeLoss alpha 1 with the extra penalty after epoch 200, a 6/2
    train/val split, metrics and validation every 100 epochs, pretrain
    with the 0.5 IoU gate and one retry; synthetic images in memory."""
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.runner.config import AwesomeConfig

    base = dict(
        name_experiment="smoke_runner", device=device,
        dataset_args={"shapes": [list(s) for s in RUNNER_SHAPES],
                      "split_ratio": 0.75},
        prior_model_type="awesome_tpu_torch.ops.mlp.FullyFusedConvexNextNet",
        prior_model_args={"base": ConvexNextNet(n_hidden=130,
                                                n_hidden_layers=1,
                                                device=device)},
        optimizer_type="adam", optimizer_args={"lr": 0.02},
        loss_args={"alpha": 1.0}, use_extra_penalty_hook=True,
        extra_penalty_after_n_epochs=200, num_epochs=RUNNER_EPOCHS,
        compute_metrics_during_training_nth_epoch=100,
        validation_each_nth_epoch=100,
        pretrain_args={"num_epochs": RUNNER_PRETRAIN,
                       "proper_prior_fit_retrys": 1},
        runs_path=folder, output_folder=folder, seed=0)
    base.update(kw)
    return AwesomeConfig(**base)


def _evals(runner) -> int:
    s = runner.tracker.series.get(("MeanForegroundBinaryMIOU", "epoch",
                                   "eval"))
    return 0 if s is None else len(s.values)


def runner_path(device, root: str) -> dict:
    """The port's run entry point as ``python -m awesome_tpu_torch.run``
    drives it (``AwesomeRunner``: build, store_config, pretrain, train,
    evaluate, then the dense refit ``sequential_prior_fit`` and
    ``save_results``) at full width on 8 synthetic images of the
    convexity-51 shapes; the launch counts of K4/K5 on the path (one each
    per training epoch for all images); a 20-epoch window timed and
    profiled; then the resume check of ``tests/test_resume.py``: a second
    run to ``RUNNER_RESUME_AT`` epochs restarted with ``resume=True`` must
    end bitwise where the first run's training ended."""
    import shutil

    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.pixel_trainer import (
        make_pixel_segment_fn,
        pixel_train_init,
    )
    from awesome_tpu_torch.runner.runner import AwesomeRunner

    epochs, resume_at = RUNNER_EPOCHS, RUNNER_RESUME_AT
    shutil.rmtree(root, ignore_errors=True)
    first = os.path.join(root, "run")
    t_all = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    runner = AwesomeRunner(runner_config(first, device))
    runner.build()
    runner.store_config()
    n_pad = int(runner._batch["px"].shape[1])
    t0 = time.perf_counter()
    pre = runner.pretrain()
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    _, _, k4_pre, k5_pre, _ = counts()
    evals0 = _evals(runner)
    t0 = time.perf_counter()
    res = runner.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _, _, k4_tr, k5_tr, _ = counts()
    k4_tr, k5_tr = k4_tr - k4_pre, k5_tr - k5_pre
    evals = _evals(runner) - evals0
    if k5_tr != epochs or k4_tr != epochs + evals:
        raise AssertionError(f"runner training: K4 {k4_tr}, K5 {k5_tr} "
                             f"launches in {epochs} epochs and {evals} "
                             "evaluations")
    trained = T.tree_map(torch.clone, runner.stacked_params)
    hist = res["loss_hist"]
    train_idx = runner.train_indices
    if not np.isfinite(hist).all():
        raise AssertionError("non-finite loss in the runner's training")
    # the extra penalty changes the loss function at its epoch (0.1 x the
    # base loss + 100 x the prior's misalignment): it falls in each phase
    curve = hist[train_idx].mean(axis=0)
    switch = runner.config.extra_penalty_after_n_epochs
    phases = [curve[:switch], curve[switch:]]
    for part, name in zip(phases, ("before", "with")):
        if len(part) > 1:
            check_hist(part, f"the runner's training {name} the extra "
                       "penalty")
    t0 = time.perf_counter()
    refit = runner.sequential_prior_fit(num_steps=RUNNER_REFIT)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    metrics = runner.evaluate()
    out = runner.save_results()
    _, _, k4_all, k5_all, _ = counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ("config.yaml", "tracker.json", "params.npz",
                 "treedef.txt"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"the run folder lacks {name}")

    # a 20-epoch window of the training segment, from the trained state
    tcfg = runner._train_cfg(PROF_STEPS)
    segment = make_pixel_segment_fn(runner.wrapper, tcfg, PROF_STEPS)
    state = pixel_train_init(runner.wrapper, trained, tcfg)
    b = runner._dev_batch
    batch = (b["px"], b["gt"], b["scr_mask"], b["rnd_mask"])

    def window():
        return segment(state, *batch)

    window()
    torch.cuda.synchronize()
    _, _, w4, w5, _ = counts()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    ms_epoch = 1e3 * (time.perf_counter() - t0) / PROF_STEPS
    _, _, w4b, w5b, _ = counts()
    if (w4b - w4, w5b - w5) != (PROF_STEPS, PROF_STEPS):
        raise AssertionError(f"{PROF_STEPS} epochs launched K4 {w4b - w4} "
                             f"and K5 {w5b - w5} times")
    profile = device_profile(window, PROF_STEPS, ms_epoch)

    # preempted at resume_at, restarted with resume=True
    second = os.path.join(root, "resumed")
    state_path = pre["path"]
    part = AwesomeRunner(runner_config(
        second, device, num_epochs=resume_at,
        pretrain_state_path=state_path))
    part.build()
    part.pretrain()
    part.train()
    resumed = AwesomeRunner(runner_config(
        second, device, pretrain_state_path=state_path, resume=True))
    resumed.build()
    resumed.pretrain()
    res2 = resumed.train()
    diff = first_difference(trained, resumed.stacked_params)
    tail = hist[:, resume_at:]
    if diff is not None or not np.array_equal(res2["loss_hist"], tail):
        raise AssertionError(f"the resumed run differs from the "
                             f"uninterrupted one: {diff}")
    torch.cuda.synchronize()
    return {
        "phase": "runner_path", "images": len(RUNNER_SHAPES),
        "shapes": [list(s) for s in RUNNER_SHAPES], "padded_points": n_pad,
        "cuts": {"epochs": [epochs, 3000], "pretrain_steps":
                 [RUNNER_PRETRAIN, 2000], "refit_steps": [RUNNER_REFIT,
                                                          2000]},
        "train_images": list(train_idx), "val_images":
            list(runner.val_indices),
        "pretrain_s": pre_s, "pretrain_ms_per_step":
            1e3 * pre_s / RUNNER_PRETRAIN,
        "train_s": train_s, "train_ms_per_epoch_incl_evals":
            1e3 * train_s / epochs,
        "ms_per_epoch": ms_epoch, "refit_s": refit_s,
        "launches": {
            "pretrain": {"K4": k4_pre, "K5": k5_pre},
            "train": {"K4": k4_tr, "K5": k5_tr, "epochs": epochs,
                      "evaluations": evals},
            "per_epoch": {"K4": (w4b - w4) / PROF_STEPS,
                          "K5": (w5b - w5) / PROF_STEPS},
            "refit_and_eval": {"K4": k4_all - k4_pre - k4_tr,
                               "K5": k5_all - k5_pre - k5_tr}},
        "gate_iou": [float(v) for v in pre["gate_iou"]],
        "refit_gate_iou": [float(v) for v in refit["gate_iou"]],
        "metrics_after_train": res["final_metrics"],
        "metrics_after_refit": metrics,
        "train_loss_first_last": {
            name: [float(part[0]), float(part[-1])]
            for part, name in zip(phases, ("base", "extra_penalty"))
            if len(part)},
        "peak_memory_gib": peak / 2 ** 30,
        "resume": {"at": resume_at, "bitwise_equal": True,
                   "loss_epochs_equal": int(tail.shape[1])},
        "profile": profile, "k4": k4_tr, "k5": k5_tr,
        "seconds": time.perf_counter() - t_all,
    }


# The FBMS phase: a synthetic sequence at the frame size of FBMS-59's cars
# sequences (cars3 among them), the per-frame pretrain's step counts of
# the joint configs' reuse-state protocol, cut from 4000/400 to 500/200
FBMS_SHAPE = (480, 640)
FBMS_FRAMES = 4
FBMS_COLD, FBMS_WARM = 500, 200
FBMS_EPOCHS = 3
FBMS_RESUME_AT = 1


def _keep_cold_history():
    """Wrap ``prior_fit.fit_priors_sequential`` so the cold fit's loss
    history of the next pretrain is kept; returns (restore, kept)."""
    from awesome_tpu_torch.fit import prior_fit

    real = prior_fit.fit_priors_sequential
    kept = {}

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        kept["hist"] = out[1]["first_aux"]["loss_hist"].cpu().numpy()
        return out

    prior_fit.fit_priors_sequential = keep

    def restore():
        prior_fit.fit_priors_sequential = real

    return restore, kept


def _in_unit(metrics: dict, what: str) -> None:
    for k, v in metrics.items():
        if k != "num_gt_frames" and not 0.0 <= v <= 1.0:
            raise AssertionError(f"{what}: {k} = {v} is outside [0, 1]")


def fbms_path(device, root: str) -> dict:
    """The FBMS experiments through ``runner/fbms_runner.py`` as ``python
    -m awesome_tpu_torch.run`` drives them, on a synthetic 4-frame 480x640
    sequence in the FBMS-59 layout (``write_synthetic_fbms_sequence``):
    (1) ``pretrain_joint_priors`` with the flow-identity prefit cached in
    a zoo, ``FBMSExperimentConfig()``'s bench prior (flow 32 x 12, ICNN
    130 x 2), a cold fit of 500 steps and warm fits of 200: K1 launched
    once per step, 1100 times; the same again from the zoo, bitwise equal;
    (2) ``train_joint`` of the full-width ``UNet(4, 1)`` with those priors,
    3 epochs in batches of 2, an evaluation and a checkpoint every epoch:
    finite losses, the last epoch's mean below the first's, evaluations in
    [0, 1]; a run stopped after epoch 1 and resumed to epoch 3 equals it
    bitwise in every leaf and in its losses; ``evaluate_joint`` finds both
    GT frames, and with ``compute_crf=True`` adds the CRF's metrics; one
    joint step's ms, peak memory and the device's idle
    share; (3) the spatio-temporal ``pretrain`` + ``evaluate``, plain and
    in the noisy family (half the frames' unaries noise, the flow-identity
    and convex prefits); (4) ``train_joint_from_config`` on a
    ``multiple_objects`` config: 8 frames of 64x64, 2 slots, 3 epochs, a
    100-step children pretrain; (5) ``python -m awesome_tpu_torch.run`` in
    a subprocess on an FBMS config of a 4-frame 64x64 sequence: exit 0,
    its run folder and checkpoints."""
    import shutil

    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.data.synthetic import (
        write_synthetic_fbms_sequence,
    )
    from awesome_tpu_torch.fit.checkpoint import find_resumable
    from awesome_tpu_torch.fit.trainer import (
        JointTrainConfig,
        make_joint_train_step,
    )
    from awesome_tpu_torch.nn.zoo import Zoo
    from awesome_tpu_torch.runner.config import AwesomeConfig
    from awesome_tpu_torch.runner.fbms_runner import (
        FBMSExperimentConfig,
        FBMSRunner,
    )

    shutil.rmtree(root, ignore_errors=True)
    t_all = time.perf_counter()
    h, w = FBMS_SHAPE
    seq = write_synthetic_fbms_sequence(root, name="cars99",
                                        n_frames=FBMS_FRAMES, h=h, w=w,
                                        seed=0)
    out = {"phase": "fbms_path", "shape": [h, w], "frames": FBMS_FRAMES}

    def runner():
        return FBMSRunner(FBMSExperimentConfig(dataset_path=seq),
                          device=device).build()

    # (1) the per-frame pretrain on K1
    zoo = Zoo(os.path.join(root, "zoo"))
    pre_kw = dict(num_steps=FBMS_COLD, reuse_state_steps=FBMS_WARM,
                  prefit_flow_identity=True, zoo=zoo)
    want = FBMS_COLD + (FBMS_FRAMES - 1) * FBMS_WARM
    first = runner()
    restore, kept = _keep_cold_history()
    try:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        pre = first.pretrain_joint_priors(**pre_kw)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        k1, _, _, _, ran = counts()
        if not k1 == ran == want:
            raise AssertionError(f"FBMS pretrain: K1 launched {k1} times in "
                                 f"{ran} fit steps, want {want}")
        cold = kept["hist"]
        check_hist(cold, "the FBMS pretrain's cold fit")
        again = runner()
        t0 = time.perf_counter()
        again.pretrain_joint_priors(**pre_kw)  # the flow from the zoo
        torch.cuda.synchronize()
        zoo_s = time.perf_counter() - t0
    finally:
        restore()
    diff = first_difference(first.joint_prior_init, again.joint_prior_init)
    if diff is not None:
        raise AssertionError(f"the FBMS pretrain from the zoo differs at "
                             f"{diff}")
    out["pretrain"] = {
        "cold_steps": FBMS_COLD, "warm_steps": FBMS_WARM,
        "k1_launches": k1, "fit_steps": ran, "seconds": pre_s,
        "seconds_flow_from_zoo": zoo_s,
        "ms_per_step_flow_from_zoo": 1e3 * zoo_s / want,
        "cold_loss_first_last": [float(cold[0]), float(cold[-1])],
        "cold_loss": pre["cold_loss"], "zoo_rerun_bitwise_equal": True}

    # (2) joint training from those priors, and its resume
    ck = os.path.join(root, "joint", "checkpoints")
    train_kw = dict(num_epochs=FBMS_EPOCHS, batch_size=2, eval_nth_epoch=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = first.train_joint(checkpoint_dir=ck, **train_kw)
    torch.cuda.synchronize()
    joint_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = np.asarray(res["loss"])
    per_epoch = len(loss) // FBMS_EPOCHS
    epochs = loss.reshape(FBMS_EPOCHS, per_epoch).mean(axis=1)
    if not np.isfinite(loss).all() or not epochs[-1] < epochs[0]:
        raise AssertionError(f"FBMS joint losses: {loss.tolist()}")
    series = first.joint_tracker.series
    evals = {name: [float(v) for v in series[(name, "epoch", "eval")].values]
             for name in ("MeanForegroundBinaryMIOU",
                          "PriorMeanForegroundBinaryMIOU")}
    for name, vals in evals.items():
        if len(vals) != FBMS_EPOCHS or not all(0 <= v <= 1 for v in vals):
            raise AssertionError(f"FBMS joint evaluations {name}: {vals}")
    final = first.evaluate_joint()
    _in_unit(final, "evaluate_joint")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with_crf = first.evaluate_joint(compute_crf=True)
    torch.cuda.synchronize()
    crf_s = time.perf_counter() - t0
    _in_unit(with_crf, "evaluate_joint(compute_crf=True)")
    if "CRFMeanForegroundBinaryMIOU" not in with_crf:
        raise AssertionError(f"evaluate_joint(compute_crf=True): {with_crf}")
    if final["num_gt_frames"] != 2:
        raise AssertionError(f"evaluate_joint found "
                             f"{final['num_gt_frames']} GT frames, want 2")
    found = find_resumable(ck, "joint")
    if found is None or found[0] != FBMS_EPOCHS:
        raise AssertionError(f"no resumable checkpoint of epoch "
                             f"{FBMS_EPOCHS} under {ck}: {found}")
    ck2 = os.path.join(root, "resumed", "checkpoints")
    part = runner()
    part.joint_prior_init = first.joint_prior_init
    part.train_joint(checkpoint_dir=ck2, **dict(train_kw,
                                                num_epochs=FBMS_RESUME_AT))
    resumed = runner()
    resumed.joint_prior_init = first.joint_prior_init
    res2 = resumed.train_joint(checkpoint_dir=ck2, resume=True, **train_kw)
    diff = first_difference(first.joint_state, resumed.joint_state)
    tail = res["loss"][FBMS_RESUME_AT * per_epoch:]
    if diff is not None or res2["loss"] != tail:
        raise AssertionError(f"the resumed FBMS joint run differs from the "
                             f"uninterrupted one: {diff}")
    # one joint step at 480x640 on frames 0 and 1: ms and idle share
    imgs, fts = first._frames_and_features([0, 1])
    batch = {"image": first._tensor(imgs), "features": first._tensor(fts),
             "grid": first._grid(), "target": first._tensor(
                 first._joint_frame_targets()[:2]),
             "index": torch.arange(2, device=device)}
    step = make_joint_train_step(first.joint_wrapper, JointTrainConfig())
    state = first.joint_state
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 3
    out["joint"] = {
        "epochs": FBMS_EPOCHS, "batch": 2, "steps": len(loss),
        "loss": loss.tolist(), "epoch_loss": epochs.tolist(),
        "evaluations": evals, "evaluate_joint": final,
        "evaluate_joint_crf": {"metrics": with_crf, "seconds": crf_s},
        "seconds_incl_evals_and_checkpoints": joint_s,
        "ms_per_step": ms, "peak_memory_gib": peak,
        "profile": device_profile(lambda: step(state, batch), 1, ms),
        "resume": {"from_epoch": FBMS_RESUME_AT, "leaves_bitwise_equal":
                   len(T.tree_flatten_with_path(first.joint_state)),
                   "losses_equal": len(tail)}}

    # (3) spatio-temporal, plain and noisy with the prefits
    st = {}
    for name, pa in (
            ("plain", {}),
            ("noisy", {"noisy_percentage": 0.5,
                       "prefit_flow_net_identity": True,
                       "prefit_flow_net_identity_num_epochs": 20,
                       "prefit_convex_net": True,
                       "prefit_convex_net_num_epochs": 20})):
        cfg = AwesomeConfig(
            device=device, seed=0, num_epochs=2, pretrain_args=pa,
            optimizer_args={"lr": 1e-3},
            dataset_args={"dataset": {"dataset_path": seq}},
            prior_model_args={"channels": 3})
        st_runner = FBMSRunner.from_awesome_config(cfg).build()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = st_runner.pretrain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ev = st_runner.evaluate()
        if not np.isfinite(fit["epoch_loss"]).all():
            raise AssertionError(f"spatio-temporal ({name}) loss: "
                                 f"{fit['epoch_loss']}")
        _in_unit(ev, f"spatio-temporal ({name}) evaluate")
        if ev["num_gt_frames"] != 2:
            raise AssertionError(f"spatio-temporal ({name}) evaluate found "
                                 f"{ev['num_gt_frames']} GT frames")
        st[name] = {"epoch_loss": fit["epoch_loss"].tolist(),
                    "seconds_incl_prefits": dt, "evaluate": ev,
                    "noisy_frames": st_runner.config.frame_noise_percentage}
    out["spatiotemporal"] = st

    # (4) multi-object from its config
    seq8 = write_synthetic_fbms_sequence(root, name="multi99", n_frames=8,
                                         h=64, w=64, seed=1)
    mcfg = AwesomeConfig(
        device=device, seed=0, num_epochs=3,
        dataset_args={"dataset": {"dataset_path": seq8,
                                  "label_mode": "multiple_objects",
                                  "max_objects": 2,
                                  "training_batch_size": 2}},
        pretrain_args={"num_epochs": 100},
        compute_metrics_during_training_nth_epoch=1,
        output_folder=os.path.join(root, "multi"))
    mrunner = FBMSRunner.from_awesome_config(mcfg).build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mres = mrunner.train_joint_from_config()
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    mloss = np.asarray(mres["loss"])
    mev = mrunner.evaluate_multi_object()
    if not np.isfinite(mloss).all() or len(mloss) != 3 * 4:
        raise AssertionError(f"FBMS multi-object losses: {mloss.tolist()}")
    for per in mev.values():
        _in_unit(per, "evaluate_multi_object")
    if find_resumable(os.path.join(root, "multi", "checkpoints"),
                      "multi") is None:
        raise AssertionError("the multi-object run left no checkpoint")
    out["multi_object"] = {
        "shape": [64, 64], "frames": 8, "slots": 2, "epochs": 3,
        "pretrain_steps": 100, "loss": mloss.tolist(),
        "seconds_incl_pretrain_and_evals": multi_s,
        "evaluate_multi_object": {k: {str(o): v for o, v in d.items()}
                                  for k, d in mev.items()}}

    # (5) the CLI in a subprocess
    seq_cli = write_synthetic_fbms_sequence(root, name="cli99", n_frames=4,
                                            h=64, w=64, seed=2)
    runs = os.path.join(root, "runs")
    args = [sys.executable, "-m", "awesome_tpu_torch.run",
            "--name-experiment", "fbms_cli", "--runs-path", runs,
            "--dataset-type", "awesome_tpu.data.fbms.FBMSSequenceDataset",
            "--dataset-args",
            f"{{dataset: {{dataset_path: {seq_cli}, "
            "training_batch_size: 2}}",
            "--num-epochs", "2",
            "--compute-metrics-during-training-nth-epoch", "1",
            "--pretrain-args", "{num_epochs: 100, reuse_state_epochs: 40}"]
    t0 = time.perf_counter()
    cli = subprocess.run(args, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if cli.returncode != 0:
        raise AssertionError(f"python -m awesome_tpu_torch.run exited "
                             f"{cli.returncode}:\n{cli.stderr[-3000:]}")
    folders = [d for d in os.listdir(runs) if d.endswith("_fbms_cli")]
    if len(folders) != 1 or find_resumable(
            os.path.join(runs, folders[0], "checkpoints"), "joint") is None:
        raise AssertionError(f"the CLI's run folder lacks its checkpoints: "
                             f"{folders}")
    out["cli"] = {"returncode": 0, "seconds": cli_s,
                  "run_folder": os.path.join(runs, folders[0]),
                  "checkpoints": sorted(os.listdir(
                      os.path.join(runs, folders[0], "checkpoints")))}
    out["k1"] = k1
    out["seconds"] = time.perf_counter() - t_all
    return out


# The extra-priors phase: the teaser widths at the FBMS frame size, the
# fit engine's default Adamax
EXTRA_SHAPE = (480, 640)
EXTRA_STEPS = 300
ROUND_TRIP_MAX = 1e-3  # .claude/skills/verify/SKILL.md's invertibility check


def centered_grid(h: int, w: int, device):
    """Pixel centres scaled to [-0.5, 0.5), (N, 2) as (x, y). No point sits
    at 0: there the radius's square root gives the symmetry prior's offset
    a NaN gradient, and the fit's NaN guard would reject every step."""
    import torch

    yy, xx = np.mgrid[0:h, 0:w]
    pts = np.stack([(xx + 0.5) / w - 0.5, (yy + 0.5) / h - 0.5], -1)
    return torch.tensor(pts.reshape(-1, 2), dtype=torch.float32,
                        device=device)


def extra_priors_path(device) -> dict:
    """Each extra prior fitted by the autograd fit engine (``fit_prior``,
    Adamax lr 1e-3, the projection after the step) to the ellipse target
    at 480x640: ms/step, the device's busy ms/step and idle share, first
    and last loss (finite, falling), the fitted mask's IoU; the star
    prior's ``W2_r >= 0`` after the fit. Then the round trip
    ``inverse(apply(x))`` at 480x640 of three flows (seeded params plus
    noise) and of the fitted convex-diffeomorphism prior's deformation,
    each below ``ROUND_TRIP_MAX``."""
    import torch

    from awesome_tpu_torch.fit.prior_fit import FitConfig, fit_prior
    from awesome_tpu_torch.measures.metrics import iou
    from awesome_tpu_torch.nn.convex_diffeo import ConvexDiffeomorphismNet
    from awesome_tpu_torch.nn.convex_modules import ConvexMLP
    from awesome_tpu_torch.nn.flows import NormalizingFlow1D
    from awesome_tpu_torch.nn.flows_extra import GlowFlow, SplineFlow
    from awesome_tpu_torch.nn.priors_extra import (
        PeriodicNet,
        RotationSymmetricNet,
        StarShapedNet,
    )

    h, w = EXTRA_SHAPE
    pts = centered_grid(h, w, device)
    target = ellipse_target(h, w, device)
    cfg = FitConfig(num_steps=EXTRA_STEPS)
    short = dataclasses.replace(cfg, num_steps=PROF_STEPS)
    out = {"phase": "extra_priors", "shape": [h, w], "steps": EXTRA_STEPS,
           "fits": {}, "round_trip_max_abs_err": {}}
    fitted_cd = None
    for name, model in (
            ("StarShapedNet(150)", StarShapedNet(150, device=device)),
            ("RotationSymmetricNet(150)",
             RotationSymmetricNet(150, device=device)),
            ("PeriodicNet(200, use_premap=False)",
             PeriodicNet(200, use_premap=False, device=device)),
            ("ConvexDiffeomorphismNet.create()",
             ConvexDiffeomorphismNet.create(device=device)),
            ("ConvexMLP()", ConvexMLP(device=device))):
        params = model.init(torch.Generator().manual_seed(11))
        fit_prior(model, params, pts, target,
                  dataclasses.replace(cfg, num_steps=2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fitted, aux = fit_prior(model, params, pts, target, cfg)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / EXTRA_STEPS
        hist = aux["loss_hist"].cpu().numpy()
        check_hist(hist, f"the {name} fit")
        with torch.no_grad():
            prob = torch.sigmoid(model.apply(fitted, pts))
        res = {"ms_per_step": ms, "loss_first": float(hist[0]),
               "loss_last": float(hist[-1]),
               "iou": float(iou(prob > 0.5, target > 0.5, invert=True)),
               "profile": device_profile(
                   lambda m=model, p=params: fit_prior(m, p, pts, target,
                                                       short),
                   PROF_STEPS, ms)}
        if isinstance(model, StarShapedNet):
            w2r = float(fitted["W2_r"]["w"].min())
            if w2r < 0.0:
                raise AssertionError(f"StarShapedNet: W2_r min {w2r} < 0 "
                                     "after the fit")
            res["W2_r_min"] = w2r
        if isinstance(model, ConvexDiffeomorphismNet):
            fitted_cd = (model, fitted)
        out["fits"][name] = res
    trips = []
    for seed, (name, flow) in enumerate((
            ("GlowFlow(2, 64, 4)", GlowFlow(2, 64, 4, device=device)),
            ("SplineFlow(2, 32, 4, 8 bins)",
             SplineFlow(2, 32, 4, num_bins=8, device=device)),
            ("NormalizingFlow1D(4, 130)",
             NormalizingFlow1D(4, 130, device=device)))):
        params = perturbed_params(flow, 30 + seed)
        trips.append((name, flow.apply, flow.inverse, params))
    model, fitted = fitted_cd
    trips.append(("ConvexDiffeomorphismNet.create(), fitted",
                  model.deformation, model.inverse, fitted))
    for name, fwd, inv, params in trips:
        with torch.no_grad():
            err = float((inv(params, fwd(params, pts)) - pts).abs().max())
        if not err < ROUND_TRIP_MAX:
            raise AssertionError(f"{name}: round trip {err} >= "
                                 f"{ROUND_TRIP_MAX}")
        out["round_trip_max_abs_err"][name] = err
    return out


def prior_grads_vs_plain(fused, stacked, pts, tgt, wts) -> dict:
    """The prior's fit-loss grads (the weighted SE of the sigmoid) of G
    images with their own points, one ``vmap`` of ``torch.func.grad``,
    through ``fused`` (a ConvexDiffeomorphismNet whose convex part is a
    ``FullyFusedConvexNextNet``: one K4 and one K5 launch) against the same
    prior with the plain ``ConvexNextNet``. Every element within rtol 5e-4,
    atol 1e-6 of the largest grad (as the kernels' own checks), or within
    twice the plain version's own error against a float64 run of the plain
    version there (an element past both counts in
    ``beyond_float64_rule``). The
    launches made here are taken out of the launch counts again."""
    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.nn.convex_diffeo import ConvexDiffeomorphismNet
    from awesome_tpu_torch.ops import mlp

    plain = ConvexDiffeomorphismNet(fused.in_features, flow=fused.flow,
                                    convex=fused.convex.base,
                                    device=fused.device)

    def grads(model, args):
        def loss(p, x, t, wt):
            prob = torch.sigmoid(model.apply(p, x)[..., 0])
            return torch.sum(wt * (prob - t) ** 2)

        return torch.func.vmap(torch.func.grad(loss))(*args)

    before = mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches
    got = grads(fused, (stacked, pts, tgt, wts))
    launches = {"K4": mlp.icnn_forward_cuda.launches - before[0],
                "K5": mlp.icnn_backward_cuda.launches - before[1]}
    mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches = before
    ref = grads(plain, (stacked, pts, tgt, wts))
    ref64 = grads(plain, T.tree_map(lambda a: a.double(),
                                    (stacked, pts, tgt, wts)))
    past = beyond = 0
    err = err64 = plain64 = 0.0
    largest = max(float(p.abs().max()) for p in T.tree_leaves(ref))
    for k, p, r in zip(T.tree_leaves(got), T.tree_leaves(ref),
                       T.tree_leaves(ref64)):
        k, p = k.double(), p.double()
        off = (k - p).abs() > GRAD_RTOL * p.abs() + GRAD_ATOL * largest
        past += int(off.sum())
        beyond += int((off & ((k - r).abs() > 2.0 * (p - r).abs())).sum())
        err = max(err, float((k - p).abs().max()))
        err64 = max(err64, float((k - r).abs().max()))
        plain64 = max(plain64, float((p - r).abs().max()))
    return {"launches": launches, "leaves": len(T.tree_leaves(got)),
            "elements": sum(a.numel() for a in T.tree_leaves(got)),
            "max_abs_err": err, "past_tolerance": past,
            "beyond_float64_rule": beyond,
            "max_abs_err_vs_float64": err64,
            "plain_max_abs_err_vs_float64": plain64}


def convex_diffeo_prior(device):
    """The runner's convex-diffeomorphism prior: ``NormalizingFlow1D`` of 4
    couplings of width 70 in front of ``FullyFusedConvexNextNet(
    ConvexNextNet(130, 1))`` (``ConvexDiffeomorphismNet.create()``'s
    widths with the fused ICNN)."""
    from awesome_tpu_torch.nn.convex_diffeo import ConvexDiffeomorphismNet
    from awesome_tpu_torch.nn.flows import NormalizingFlow1D
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.ops.mlp import FullyFusedConvexNextNet

    return ConvexDiffeomorphismNet(
        flow=NormalizingFlow1D(num_coupling=4, width=70, device=device),
        convex=FullyFusedConvexNextNet(ConvexNextNet(
            n_hidden=130, n_hidden_layers=1, device=device)),
        device=device)


def convex_diffeo_grads_vs_plain(device, g: int, n: int, seed: int) -> dict:
    """:func:`prior_grads_vs_plain` on seeded inputs: G perturbed inits,
    uniform points per image, ellipse-like targets, weights 1/n."""
    import torch

    from awesome_tpu_torch.core import tree as T

    model = convex_diffeo_prior(device)
    stacked = T.stack_trees([perturbed_params(model, seed + i)
                             for i in range(g)])
    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand((g, n, 2), generator=gen)
    tgt = (((pts[..., 0] - 0.5) ** 2 / 0.09 + (pts[..., 1] - 0.5) ** 2
            / 0.05) > 1.0).float()
    wts = torch.full((g, n), 1.0 / n)
    return prior_grads_vs_plain(model, stacked, pts.to(device),
                                tgt.to(device), wts.to(device))


# The convex-diffeomorphism runner phase: RUNNER_SHAPES at the published
# widths, cut from 3000 epochs and 2000 pretrain steps
CD_EPOCHS = 100
CD_PRETRAIN = 100
CD_PENALTY_AT = 67  # the extra penalty's share of the runner phase's run


def runner_convex_diffeo_path(device, root: str) -> dict:
    """The convexity runner (as ``python -m awesome_tpu_torch.run`` drives
    it) with the prior ``ConvexDiffeomorphismNet(flow=NormalizingFlow1D(4,
    70), convex=FullyFusedConvexNextNet(ConvexNextNet(130, 1)))`` and
    ``compute_crf_with_metrics`` and ``compute_crf_after_training``: the 8
    ``RUNNER_SHAPES`` images, ``CD_EPOCHS`` epochs and ``CD_PRETRAIN``
    pretrain steps. K4 and K5 launch once each per training epoch (K4 once
    more per evaluation); a 20-epoch window timed and profiled; the CRF's
    ms per evaluation (mixed shapes: one call per image) and its metric;
    the prior's grads at the runner's shape through K4/K5 against the
    plain ICNN prior's (:func:`prior_grads_vs_plain`)."""
    import shutil

    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.pixel_trainer import (
        make_pixel_segment_fn,
        pixel_train_init,
    )
    from awesome_tpu_torch.runner.runner import AwesomeRunner

    shutil.rmtree(root, ignore_errors=True)
    t_all = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts()
    prior = convex_diffeo_prior(device)
    runner = AwesomeRunner(runner_config(
        root, device, prior_model_type="awesome_tpu_torch.nn.convex_diffeo."
        "ConvexDiffeomorphismNet",
        prior_model_args={"flow": prior.flow, "convex": prior.convex},
        compute_crf_with_metrics=True, compute_crf_after_training=True,
        num_epochs=CD_EPOCHS, extra_penalty_after_n_epochs=CD_PENALTY_AT,
        compute_metrics_during_training_nth_epoch=50,
        validation_each_nth_epoch=50,
        pretrain_args={"num_epochs": CD_PRETRAIN,
                       "proper_prior_fit_retrys": 1}))
    runner.build()
    n_pad = int(runner._batch["px"].shape[1])
    t0 = time.perf_counter()
    pre = runner.pretrain()
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    _, _, k4_pre, k5_pre, _ = counts()
    evals0 = _evals(runner)
    t0 = time.perf_counter()
    res = runner.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _, _, k4_tr, k5_tr, _ = counts()
    k4_tr, k5_tr = k4_tr - k4_pre, k5_tr - k5_pre
    evals = _evals(runner) - evals0
    if k5_tr != CD_EPOCHS or k4_tr != CD_EPOCHS + evals:
        raise AssertionError(f"convex-diffeo runner: K4 {k4_tr}, K5 {k5_tr} "
                             f"launches in {CD_EPOCHS} epochs and {evals} "
                             "evaluations")
    hist = res["loss_hist"]
    if not np.isfinite(hist).all():
        raise AssertionError("non-finite loss in the convex-diffeo runner")
    curve = hist[runner.train_indices].mean(axis=0)
    for part, name in ((curve[:CD_PENALTY_AT], "before"),
                       (curve[CD_PENALTY_AT:], "with")):
        check_hist(part, f"the convex-diffeo runner {name} the extra "
                   "penalty")
    final = res["final_metrics"]
    crf_iou = final.get("CRFMeanForegroundBinaryMIOU")
    if crf_iou is None or not 0.0 <= crf_iou <= 1.0:
        raise AssertionError(f"the runner's CRF metric: {crf_iou}")
    trained = T.tree_map(torch.clone, runner.stacked_params)

    # a 20-epoch window of the training segment
    tcfg = runner._train_cfg(PROF_STEPS)
    segment = make_pixel_segment_fn(runner.wrapper, tcfg, PROF_STEPS)
    state = pixel_train_init(runner.wrapper, trained, tcfg)
    b = runner._dev_batch
    batch = (b["px"], b["gt"], b["scr_mask"], b["rnd_mask"])

    def window():
        return segment(state, *batch)

    window()
    torch.cuda.synchronize()
    _, _, w4, w5, _ = counts()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    ms_epoch = 1e3 * (time.perf_counter() - t0) / PROF_STEPS
    _, _, w4b, w5b, _ = counts()
    per_epoch = {"K4": (w4b - w4) / PROF_STEPS, "K5": (w5b - w5) / PROF_STEPS}
    if per_epoch != {"K4": 1.0, "K5": 1.0}:
        raise AssertionError(f"convex-diffeo runner window: {per_epoch} "
                             "launches per epoch")
    profile = device_profile(window, PROF_STEPS, ms_epoch)

    # the CRF's share of an evaluation
    times = {}
    for crf in (False, True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = runner.evaluate(compute_crf=crf)
        torch.cuda.synchronize()
        times.setdefault(crf, []).append(time.perf_counter() - t0)
    crf_ms = 1e3 * (min(times[True]) - min(times[False]))

    # the prior's grads on this path through K4/K5 against the plain ICNN
    valid = b["valid"].to(torch.float32)
    grads = prior_grads_vs_plain(
        runner.wrapper.prior_module, trained["prior"], b["px"][..., 0:2],
        b["gt"][..., 0], valid / valid.sum(dim=1, keepdim=True))
    if grads["launches"] != {"K4": 1, "K5": 1} or \
            grads["beyond_float64_rule"]:
        raise AssertionError(f"convex-diffeo prior grads through K4/K5: "
                             f"{grads}")
    torch.cuda.synchronize()
    return {
        "phase": "runner_convex_diffeo", "images": len(RUNNER_SHAPES),
        "padded_points": n_pad,
        "cuts": {"epochs": [CD_EPOCHS, 3000],
                 "pretrain_steps": [CD_PRETRAIN, 2000],
                 "extra_penalty_after": [CD_PENALTY_AT, 200]},
        "pretrain_s": pre_s, "gate_iou": [float(v) for v in pre["gate_iou"]],
        "train_s": train_s,
        "train_ms_per_epoch_incl_crf_evals": 1e3 * train_s / CD_EPOCHS,
        "ms_per_epoch": ms_epoch, "profile": profile,
        "launches": {"train": {"K4": k4_tr, "K5": k5_tr,
                               "epochs": CD_EPOCHS, "evaluations": evals},
                     "per_epoch": per_epoch},
        "final_metrics": final, "metrics_with_crf": metrics,
        "crf_ms_per_evaluation": crf_ms,
        "crf_ms_per_image": crf_ms / len(RUNNER_SHAPES),
        "evaluate_ms": {"with_crf": 1e3 * min(times[True]),
                        "without": 1e3 * min(times[False])},
        "prior_grads_vs_plain": grads,
        "k4": k4_tr, "k5": k5_tr,
        "seconds": time.perf_counter() - t_all,
    }


def crf_frames(b: int, h: int, w: int, seed: int):
    """``b`` noisy two-colour frames with an ellipse object each, and
    noisy background probabilities (fg = 0)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    imgs, unaries = [], []
    for i in range(b):
        fg = ((yy - h * (0.4 + 0.05 * i)) ** 2 / (0.06 * h * h)
              + (xx - w * 0.5) ** 2 / (0.04 * w * w)) <= 1.0
        img = np.where(fg[..., None], [0.8, 0.3, 0.2], [0.1, 0.4, 0.6])
        imgs.append(np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1))
        unaries.append(np.clip(np.where(fg, 0.2, 0.8)
                               + rng.normal(0, 0.25, fg.shape), 0, 1))
    return np.stack(imgs).astype(np.float32), np.stack(unaries).astype(
        np.float32)


def crf_agreement(device="cuda") -> dict:
    """``dense_crf`` on the card against ``dense_crf_exact`` (the g++-built
    permutohedral lattice, host) on the clean 40x40 scene of
    ``tests/test_permutohedral.py::test_xla_crf_agrees_with_native``: the
    share of pixels whose labels agree."""
    from awesome_tpu_torch.ops.crf import CRFOptions, dense_crf
    from awesome_tpu_torch.ops.permutohedral import dense_crf_exact

    rng = np.random.default_rng(0)
    h = w = 40
    img = np.zeros((h, w, 3), np.float32) + 0.1
    obj = np.zeros((h, w), bool)
    obj[10:30, 10:30] = True
    img[obj] = 0.9
    probs2 = np.where(obj, 0.8, 0.2).astype(np.float32)
    probs2 = np.where(rng.random(obj.shape) < 0.08, 1.0 - probs2, probs2)
    exact = dense_crf_exact(img, np.stack([probs2, 1 - probs2], -1),
                            gaussian_sdims=(3, 3), bilateral_sdims=(10, 10),
                            iterations=5)[..., 0]
    grid = dense_crf(img, probs2[..., None], device=device,
                     options=CRFOptions(max_iterations=5,
                                        gaussian_sdims=(3, 3),
                                        bilateral_sdims=(10, 10)))[..., 0]
    return {"label_agreement": float(((exact > 0.5) == (grid > 0.5))
                                     .mean())}


def crf_path(device) -> dict:
    """``dense_crf_batched`` on 4 frames at the FBMS frame size with the
    default ``CRFOptions`` (15 iterations): ms per call and per image, two
    calls equal in every bit (and a third under
    ``torch.use_deterministic_algorithms(True)``); then the agreement with
    the exact CRF (above 0.97)."""
    import torch

    from awesome_tpu_torch.ops.crf import CRFOptions, dense_crf_batched

    h, w = FBMS_SHAPE
    imgs, unaries = crf_frames(4, h, w, 0)
    opts = CRFOptions()
    first = dense_crf_batched(imgs, unaries, options=opts, device=device)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = dense_crf_batched(imgs, unaries, options=opts, device=device)
        times.append(time.perf_counter() - t0)
        if not np.array_equal(first, again):
            raise AssertionError("two CRF calls on the same input differ")
    torch.use_deterministic_algorithms(True)
    try:
        flagged = dense_crf_batched(imgs, unaries, options=opts,
                                    device=device)
    finally:
        torch.use_deterministic_algorithms(False)
    if not np.array_equal(first, flagged):
        raise AssertionError("the CRF differs under deterministic "
                             "algorithms")
    if not np.isfinite(first).all():
        raise AssertionError("non-finite CRF output")
    fg = unaries < 0.5
    agree = crf_agreement(device)
    if not agree["label_agreement"] > 0.97:
        raise AssertionError(f"CRF against the exact CRF: {agree}")
    ms = 1e3 * min(times)
    return {"phase": "crf", "frames": 4, "shape": [h, w],
            "iterations": opts.max_iterations, "ms_per_call": ms,
            "ms_per_image": ms / 4,
            "profile": device_profile(
                lambda: dense_crf_batched(imgs, unaries, options=opts,
                                          device=device), 1, ms),
            "bitwise_repeat": True,
            "bitwise_under_deterministic_algorithms": True,
            "labels_changed_share": float(((first[..., 0] < 0.5) != fg)
                                          .mean()),
            "exact_crf": agree}


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


# The image-mode runner phase: the paper table's CNNNet cell (image mode,
# the CNNNet's default widths, Adam lr 1e-3, no extra penalty) with the
# fused prior, on the runner phase's 8 mixed shapes padded to one
# (240, 320) bucket; cut from 3000 epochs and 2000 pretrain/refit steps
IMAGE_EPOCHS = 100
IMAGE_PRETRAIN = 100
IMAGE_REFIT = 100
UNET_SHAPES = ((160, 224), (192, 256))
UNET_EPOCHS = 5
# the paper-table phase: 4 cells of the grid at the script's n and size,
# the epochs cut from 800 (and from 400 to make room for the teaser phase)
PAPER_TABLE_CELLS = ("cnnnet+xy+prior", "cnnnet+featxy+noprior",
                     "net+feat+prior", "fcnet+featxy+prior")
PAPER_TABLE_EPOCHS = 320


def image_runner_config(folder: str, device, **kw):
    """The paper table's CNNNet cell (``dimension: 3d``, ``CNNNet`` at its
    default width and depth, ``in_chn`` from the xytype; Adam lr 1e-3; no
    extra penalty) with the prior ``FullyFusedConvexNextNet(ConvexNextNet(
    64, 1))`` on the ``RUNNER_SHAPES`` images; metrics and validation every
    50 epochs; pretrain with the 0.5 IoU gate and one retry."""
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.runner.config import AwesomeConfig

    base = dict(
        name_experiment="smoke_image", device=device,
        dataset_args={"shapes": [list(s) for s in RUNNER_SHAPES],
                      "dimension": "3d", "xytype": "xy"},
        segmentation_model_type="awesome_tpu_torch.nn.seg.CNNNet",
        segmentation_model_args={},
        prior_model_type="awesome_tpu_torch.ops.mlp.FullyFusedConvexNextNet",
        prior_model_args={"base": ConvexNextNet(n_hidden=64,
                                                n_hidden_layers=1,
                                                device=device)},
        optimizer_type="adam", optimizer_args={"lr": 1e-3},
        use_extra_penalty_hook=False, num_epochs=IMAGE_EPOCHS,
        compute_metrics_during_training_nth_epoch=50,
        validation_each_nth_epoch=50,
        pretrain_args={"num_epochs": IMAGE_PRETRAIN,
                       "proper_prior_fit_retrys": 1},
        runs_path=folder, output_folder=folder, seed=0)
    base.update(kw)
    return AwesomeConfig(**base)


def _image_window(runner, params, epochs: int):
    """``epochs`` training epochs of the runner's segment engine from
    ``params``: ``(run, state)``, ``run()`` returning the segment's
    output."""
    from awesome_tpu_torch.fit.pixel_trainer import (
        make_pixel_segment_fn,
        pixel_train_init,
    )

    tcfg = runner._train_cfg(epochs)
    segment = make_pixel_segment_fn(runner.wrapper, tcfg, epochs,
                                    loss_impl=runner._make_loss_impl(),
                                    stateful_seg=runner.seg_stateful)
    state = pixel_train_init(runner.wrapper, params, tcfg,
                             stateful_seg=runner.seg_stateful)
    b = runner._dev_batch
    batch = (b["px"], b["gt"], b["scr_mask"], b["rnd_mask"])
    return lambda: segment(state, *batch)


def _timed_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def image_runner_path(device, root: str) -> dict:
    """The runner's image mode as ``python -m awesome_tpu_torch.run``
    drives it (build, pretrain, train, the dense refit, evaluate,
    save_results) with :func:`image_runner_config`: K4 and K5 once each
    per training epoch for all 8 images (K4 once more per evaluation);
    a falling loss and metrics in [0, 1]; ms/epoch, the idle share of a
    20-epoch window and peak memory; the window again under
    ``torch.use_deterministic_algorithms(True)`` (the per-image conv
    weights under ``vmap`` make grouped convs), equal to it in every bit;
    one epoch's grads as the ``vmap`` computes them against a loop over
    the images; a 'featxy' runner's epoch beside the 'xy' one; then a
    full-width UNet in image mode (2 images, ``UNET_EPOCHS`` epochs)."""
    import shutil

    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.runner.runner import AwesomeRunner

    shutil.rmtree(root, ignore_errors=True)
    t_all = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    runner = AwesomeRunner(image_runner_config(root, device))
    runner.build()
    n_pad = int(runner._batch["px"].shape[1])
    t0 = time.perf_counter()
    pre = runner.pretrain()
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    _, _, k4_pre, k5_pre, _ = counts()
    evals0 = _evals(runner)
    t0 = time.perf_counter()
    res = runner.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _, _, k4_tr, k5_tr, _ = counts()
    k4_tr, k5_tr = k4_tr - k4_pre, k5_tr - k5_pre
    evals = _evals(runner) - evals0
    if k5_tr != IMAGE_EPOCHS or k4_tr != IMAGE_EPOCHS + evals:
        raise AssertionError(f"image-mode runner: K4 {k4_tr}, K5 {k5_tr} "
                             f"launches in {IMAGE_EPOCHS} epochs and "
                             f"{evals} evaluations")
    hist = res["loss_hist"]
    check_hist(hist.mean(axis=0), "the image-mode runner's training")
    _in_unit(res["final_metrics"], "the image-mode runner")
    trained = T.tree_map(torch.clone, runner.stacked_params)
    t0 = time.perf_counter()
    refit = runner.sequential_prior_fit(num_steps=IMAGE_REFIT)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    metrics = runner.evaluate()
    _in_unit(metrics, "the image-mode runner after the refit")
    runner.save_results()
    peak = torch.cuda.max_memory_allocated()

    # a 20-epoch window from the trained state: launches and idle share
    window = _image_window(runner, trained, PROF_STEPS)
    window()
    torch.cuda.synchronize()
    _, _, w4, w5, _ = counts()
    t0 = time.perf_counter()
    _, aux = window()
    torch.cuda.synchronize()
    ms_epoch = 1e3 * (time.perf_counter() - t0) / PROF_STEPS
    _, _, w4b, w5b, _ = counts()
    per_epoch = {"K4": (w4b - w4) / PROF_STEPS, "K5": (w5b - w5) / PROF_STEPS}
    if per_epoch != {"K4": 1.0, "K5": 1.0}:
        raise AssertionError(f"image-mode runner window: {per_epoch} "
                             "launches per epoch")
    profile = device_profile(window, PROF_STEPS, ms_epoch)
    torch.use_deterministic_algorithms(True)
    try:
        _, aux_det = window()
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    if not torch.equal(aux["loss_hist"], aux_det["loss_hist"]):
        raise AssertionError("the image-mode window differs under "
                             "torch.use_deterministic_algorithms(True)")

    # one epoch's grads: the vmap (grouped convs) against a per-image loop
    loss_impl = runner._make_loss_impl()
    b = runner._dev_batch
    args = (b["px"], b["gt"], b["scr_mask"], b["rnd_mask"])
    extra = torch.zeros((len(RUNNER_SHAPES),), dtype=torch.bool,
                        device=device)
    vgv = torch.func.vmap(torch.func.grad_and_value(loss_impl))
    gv = torch.func.grad_and_value(loss_impl)
    vmap_ms = _timed_ms(lambda: vgv(trained, *args, extra), 10)
    loop_ms = _timed_ms(lambda: [
        gv(T.tree_select(trained, i), *(a[i] for a in args), extra[i])
        for i in range(len(RUNNER_SHAPES))], 10)

    # the 'featxy' encoding (host spectral proxy) beside 'xy'
    t0 = time.perf_counter()
    feat_runner = AwesomeRunner(image_runner_config(
        os.path.join(root, "featxy"), device, dataset_args={
            "shapes": [list(s) for s in RUNNER_SHAPES], "dimension": "3d",
            "xytype": "featxy"}))
    feat_runner.build()
    feat_build_s = time.perf_counter() - t0
    feat_window = _image_window(feat_runner, feat_runner.stacked_params,
                                PROF_STEPS)
    feat_ms = _timed_ms(feat_window, 1) / PROF_STEPS
    unet = unet_image_path(device, os.path.join(root, "unet"))
    torch.cuda.synchronize()
    return {
        "phase": "image_runner", "images": len(RUNNER_SHAPES),
        "bucket": list(runner._shape), "padded_points": n_pad,
        "cuts": {"epochs": [IMAGE_EPOCHS, 3000],
                 "pretrain_steps": [IMAGE_PRETRAIN, 2000],
                 "refit_steps": [IMAGE_REFIT, 2000]},
        "pretrain_s": pre_s, "gate_iou": [float(v) for v in pre["gate_iou"]],
        "train_s": train_s,
        "train_ms_per_epoch_incl_evals": 1e3 * train_s / IMAGE_EPOCHS,
        "refit_s": refit_s,
        "refit_gate_iou": [float(v) for v in refit["gate_iou"]],
        "ms_per_epoch": ms_epoch, "profile": profile,
        "deterministic_window_bitwise_equal": True,
        "grads_ms": {"vmap": vmap_ms, "loop_over_images": loop_ms},
        "featxy": {"build_s": feat_build_s, "ms_per_epoch": feat_ms,
                   "xy_ms_per_epoch": ms_epoch},
        "launches": {"train": {"K4": k4_tr, "K5": k5_tr,
                               "epochs": IMAGE_EPOCHS, "evaluations": evals},
                     "per_epoch": per_epoch},
        "train_loss_first_last": [float(hist.mean(axis=0)[0]),
                                  float(hist.mean(axis=0)[-1])],
        "metrics_after_train": res["final_metrics"],
        "metrics_after_refit": metrics,
        "peak_memory_gib": peak / 2 ** 30, "unet": unet,
        "k4": k4_tr, "k5": k5_tr,
        "seconds": time.perf_counter() - t_all,
    }


def unet_image_path(device, root: str) -> dict:
    """A full-width UNet per image in image mode (its batch-norm state per
    image): 2 images, ``UNET_EPOCHS`` epochs, a falling finite loss, ms
    per epoch and peak memory."""
    import torch

    from awesome_tpu_torch.runner.runner import AwesomeRunner

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner = AwesomeRunner(image_runner_config(
        root, device, segmentation_model_type="awesome_tpu_torch.nn.seg.UNet",
        dataset_args={"shapes": [list(s) for s in UNET_SHAPES],
                      "dimension": "3d", "xytype": "xy"},
        num_epochs=UNET_EPOCHS,
        compute_metrics_during_training_nth_epoch=None,
        validation_each_nth_epoch=None,
        pretrain_args={"num_epochs": 20, "proper_prior_fit_retrys": 0}))
    runner.build()
    runner.pretrain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner.train()
    torch.cuda.synchronize()
    hist = res["loss_hist"]
    for i, row in enumerate(hist):
        check_hist(row, f"the image-mode UNet, image {i}")
    _in_unit(res["final_metrics"], "the image-mode UNet")
    counts_bn = runner.stacked_params["seg"][1]["inc"]["bn1"]["count"]
    if counts_bn.tolist() != [UNET_EPOCHS] * len(UNET_SHAPES):
        raise AssertionError(f"UNet batch-norm updates: {counts_bn}")
    return {"shapes": [list(s) for s in UNET_SHAPES], "epochs": UNET_EPOCHS,
            "train_ms_per_epoch_incl_evals":
                1e3 * (time.perf_counter() - t0) / UNET_EPOCHS,
            "loss_first_last": [[float(r[0]), float(r[-1])] for r in hist],
            "final_metrics": res["final_metrics"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def two_region_image(h: int = 96, w: int = 128, noise: float = 0.03,
                     seed: int = 0) -> np.ndarray:
    """The two-region test scene of ``tests/test_sss.py``: an ellipse of
    one colour on another, with Gaussian noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[...] = [0.2, 0.3, 0.8]
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((yy - h // 2) ** 2 / 900 + (xx - w // 2) ** 2 / 1600) < 1.0
    img[blob] = [0.8, 0.5, 0.1]
    img += rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def stencil_csr(stencil: np.ndarray):
    """The (H, W, 5, 5) stencil operator as a scipy CSR matrix."""
    from scipy import sparse

    h, w = stencil.shape[:2]
    idx = np.arange(h * w).reshape(h, w)
    rows, cols, vals = [], [], []
    for dy in range(5):
        for dx in range(5):
            oy, ox = dy - 2, dx - 2
            y0, y1 = max(0, -oy), min(h, h - oy)
            x0, x1 = max(0, -ox), min(w, w - ox)
            rows.append(idx[y0:y1, x0:x1].ravel())
            cols.append(idx[y0 + oy:y1 + oy, x0 + ox:x1 + ox].ravel())
            vals.append(stencil[y0:y1, x0:x1, dy, dx].ravel())
    return sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                     np.concatenate(cols))),
                             shape=(h * w, h * w))


def _cos_largest_angle(a: np.ndarray, b: np.ndarray) -> float:
    qa, _ = np.linalg.qr(a)
    qb, _ = np.linalg.qr(b)
    return float(np.linalg.svd(qa.T @ qb, compute_uv=False).min())


def spectral_path(device) -> dict:
    """``spectral_soft_segments_device`` (the 'spectral_device' SSS proxy,
    ``ops/spectral.py``) on a 480x640 synthetic image (downscaled to
    120x160) and on the two-region test scene: ms per call (the first
    includes the solver's set-up), the device's busy ms in a second,
    profiled call, the two calls equal in every bit, the eigensolve's
    tensors on the card, and the cosine of the largest principal angle between its
    nontrivial eigenvectors and float64 ``eigsh`` on the same stencil
    operator (>= 0.999); the host 'spectral' proxy's ms beside it; the
    extractor's fallbacks to the host, which must be 0."""
    import torch
    from scipy import ndimage
    from scipy.sparse.linalg import eigsh
    from torch.profiler import ProfilerActivity, profile

    from awesome_tpu_torch.data.synthetic import make_sample
    from awesome_tpu_torch.ops import spectral as S
    from awesome_tpu_torch.runner import sss_extractor as X

    out = {"phase": "spectral_device"}
    ex = X.SemanticSoftSegmentationExtractor(
        "/nonexistent", proxy="spectral_device", device=device)
    for name, img in (("480x640", make_sample(0, 480, 640).image),
                      ("two_region_96x128", two_region_image())):
        h, w = img.shape[:2]
        scale = min(1.0, 160 / max(h, w))
        small = np.clip(ndimage.zoom(img, (scale, scale, 1), order=1),
                        0.0, 1.0) if scale < 1.0 else img
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = ex.proxy_features(img)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            second = S.spectral_soft_segments_device(img, 2, device=device)
            torch.cuda.synchronize()
        if not np.array_equal(first, second):
            raise AssertionError(f"spectral_device {name}: two calls "
                                 "differ")
        busy = sum(float(e.self_device_time_total)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")) / 1e3
        small_t = torch.as_tensor(np.asarray(small), dtype=torch.float64,
                                  device=device)
        stencil = S.matting_stencil(small_t, eps=1e-4)
        vecs = S.smallest_eigenvectors(stencil, 3, image=small_t)
        if stencil.device.type != "cuda" or vecs.device.type != "cuda":
            raise AssertionError(f"the eigensolve ran on {vecs.device}")
        lap = stencil_csr(stencil.cpu().numpy())
        n = lap.shape[0]
        t0 = time.perf_counter()
        ref = eigsh(lap, k=3, sigma=0, which="LM",
                    v0=np.full(n, 1 / np.sqrt(n)))[1]
        eigsh_ms = 1e3 * (time.perf_counter() - t0)
        cos = _cos_largest_angle(vecs.cpu().numpy().reshape(n, 3)[:, 1:],
                                 ref[:, 1:])
        if cos < 0.999:
            raise AssertionError(f"spectral_device {name}: cos of the "
                                 f"largest principal angle {cos} < 0.999")
        t0 = time.perf_counter()
        X.spectral_soft_segments(img, 2)
        host_ms = 1e3 * (time.perf_counter() - t0)
        out[name] = {"solve_shape": list(small.shape[:2]),
                     "ms": ms, "device_busy_ms": busy,
                     "device_idle_share": max(0.0, 1.0 - busy / ms),
                     "bitwise_repeat": True,
                     "cos_largest_angle_vs_eigsh": cos,
                     "eigsh_float64_ms": eigsh_ms, "host_spectral_ms": host_ms}
    if ex.fallbacks:
        raise AssertionError(f"{ex.fallbacks} device solves fell back to "
                             "the host")
    out["fallbacks"] = ex.fallbacks
    return out


def paper_table_path(root: str) -> dict:
    """``python -m awesome_tpu_torch.scripts.run_paper_table`` in a
    subprocess on 4 cells of the grid (``PAPER_TABLE_CELLS``) with the
    'spectral_device' proxy, the script's n = 12 and 64x64 and its global
    floors, the epochs cut to ``PAPER_TABLE_EPOCHS``: exit 0, the table
    written; each cell's seg and prior MIOU and seconds."""
    import re
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "awesome_tpu_torch.scripts.run_paper_table",
         "--out", root, "--epochs", str(PAPER_TABLE_EPOCHS),
         "--sss-proxy", "spectral_device", "--cells", *PAPER_TABLE_CELLS],
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("the paper table failed:\n"
                             + proc.stdout[-3000:] + proc.stderr[-3000:])
    if not os.path.exists(os.path.join(root, "paper_table.md")):
        raise AssertionError("the paper table wrote no paper_table.md")
    cells = {}
    for m in re.finditer(r"^(\S+): MIOU (\S+) prior MIOU (\S+) seconds (\S+)",
                         proc.stdout, re.M):
        cells[m.group(1)] = {
            "seg_miou": float(m.group(2)),
            "prior_miou": None if m.group(3) == "-" else float(m.group(3)),
            "seconds": float(m.group(4))}
    if sorted(cells) != sorted(PAPER_TABLE_CELLS):
        raise AssertionError(f"paper table cells: {sorted(cells)}")
    with open(os.path.join(root, "floors.json")) as f:
        best = json.load(f)["cells"]
    return {"phase": "paper_table", "cells": cells, "best_selection": best,
            "epochs": [PAPER_TABLE_EPOCHS, 800], "seconds": seconds}


# The data and utilities slice: the single-image fused fit at the main
# path's shape, SISBOSI through the convexity runner, the prior cache
FUSED_STEPS = 200
TRACE_STEPS = 5
# 40 epochs cross two checkpoint epochs (the runner's every 20th) and one
# evaluation tick; each checkpoint's config snapshot carries the 8
# in-memory samples, so its saves are timed apart
SISBOSI_EPOCHS = 40
SISBOSI_EVAL_NTH = 20
SISBOSI_PRETRAIN = 100
SISBOSI_TYPE = "awesome.dataset.sisbosi_dataset.SISBOSIDataset"


def _same_samples(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(getattr(x, f), getattr(y, f))
        for x, y in zip(a, b)
        for f in ("image", "gt", "fg_mask", "bg_mask"))


def data_utils_path(device, root: str) -> dict:
    """The data and utilities slice on the card: (1) ``fit_prior_fused``
    with the bench model at 480x640 on the ellipse target,
    ``FUSED_STEPS`` steps timed by ``DeviceTimer`` (the phases by
    ``PhaseTimer``): one K1 launch per step, a falling loss, params
    bitwise equal to ``make_fused_fit_fn``'s, and a ``trace`` of
    ``TRACE_STEPS`` steps written; (2) ``AwesomeRunner`` at full width
    with the reference's ``SISBOSIDataset`` type (through
    ``TYPE_TRANSLATION``) on the runner phase's 8 images, augmented,
    ``SISBOSI_EPOCHS`` epochs and ``SISBOSI_PRETRAIN`` pretrain steps: K4
    and K5 once per epoch (K4 once more per evaluation), metrics in [0,
    1], two builds with one seed giving the same samples bit for bit, the
    checkpoint saves timed apart from the training, a 20-epoch window
    timed and profiled; (3) ``PriorCache`` holding the
    runner's fitted priors: extract/apply on the card, a bitwise
    save/load, ``assert_finite`` on the fitted trees, and a NaN made in a
    backward inside ``debug_guard`` raising."""
    import shutil

    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.data.awesome_dataset import PriorCache
    from awesome_tpu_torch.data.sisbosi import SISBOSIDataset
    from awesome_tpu_torch.data.synthetic import make_sample
    from awesome_tpu_torch.fit.fused_fit import (
        fit_prior_fused,
        make_fused_fit_fn,
    )
    from awesome_tpu_torch.fit.prior_fit import FitConfig
    from awesome_tpu_torch.runner.runner import AwesomeRunner
    from awesome_tpu_torch.utils.profiling import (
        PhaseTimer,
        assert_finite,
        debug_guard,
        trace,
    )
    from awesome_tpu_torch.utils.timer import DeviceTimer

    shutil.rmtree(root, ignore_errors=True)
    t_all = time.perf_counter()
    phases = PhaseTimer()

    # (1) the single-image fused fit
    h, w = 480, 640
    model = bench_model((h, w), device)
    pts = G.flatten_grid(G.pixel_grid((h, w), device=device))
    target = ellipse_target(h, w, device)
    params = model.init(torch.Generator().manual_seed(2))
    cfg = FitConfig(num_steps=FUSED_STEPS, lr=1e-3, nan_guard_grads=False)
    fit_prior_fused(model, params, pts, target,
                    dataclasses.replace(cfg, num_steps=2))  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    with phases.phase("fit_prior_fused"), DeviceTimer() as timer:
        fitted, aux = fit_prior_fused(model, params, pts, target, cfg)
        timer.wait_for(fitted)
    k1, k1_bf16, _, _, ran = counts()
    if (k1, k1_bf16, ran) != (FUSED_STEPS, 0, FUSED_STEPS):
        raise AssertionError(f"fit_prior_fused: K1 {k1} (bf16 {k1_bf16}) "
                             f"launches in {ran} of {FUSED_STEPS} steps")
    hist = aux["loss_hist"].cpu().numpy()
    check_hist(hist, "fit_prior_fused")
    with phases.phase("make_fused_fit_fn", wait_on=aux):
        ref, ref_aux = make_fused_fit_fn(model, cfg)(params, pts, target)
    diff = first_difference(fitted, ref)
    if diff is not None or not torch.equal(aux["loss_hist"],
                                           ref_aux["loss_hist"]):
        raise AssertionError(f"fit_prior_fused differs from "
                             f"make_fused_fit_fn: {diff}")
    assert_finite(fitted, "fit_prior_fused params")
    trace_dir = os.path.join(root, "trace")
    with phases.phase("trace"), trace(trace_dir):
        fit_prior_fused(model, params, pts, target,
                        dataclasses.replace(cfg, num_steps=TRACE_STEPS))
        torch.cuda.synchronize()
    traced = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
    if not traced:
        raise AssertionError(f"trace wrote nothing under {trace_dir}")
    fused = {"shape": [h, w], "steps": FUSED_STEPS, "k1_launches": k1,
             "seconds": timer.elapsed,
             "ms_per_step": 1e3 * timer.elapsed / FUSED_STEPS,
             "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
             "bitwise_equal_to_make_fused_fit_fn": True,
             "trace_files": traced,
             "trace_bytes": sum(os.path.getsize(os.path.join(trace_dir, f))
                                for f in traced)}

    # (2) SISBOSI through the convexity runner
    samples = [make_sample(i, h=sh, w=sw)
               for i, (sh, sw) in enumerate(RUNNER_SHAPES)]
    dargs = {"samples": samples, "augmentation": True, "seed": 0,
             "split_ratio": 0.75}

    def config(folder):
        return runner_config(
            folder, device, name_experiment="smoke_sisbosi",
            dataset_type=SISBOSI_TYPE, dataset_args=dargs,
            num_epochs=SISBOSI_EPOCHS,
            compute_metrics_during_training_nth_epoch=SISBOSI_EVAL_NTH,
            validation_each_nth_epoch=SISBOSI_EVAL_NTH,
            pretrain_args={"num_epochs": SISBOSI_PRETRAIN,
                           "proper_prior_fit_retrys": 1})

    torch.cuda.synchronize()
    zero_counts()
    runner = AwesomeRunner(config(os.path.join(root, "sisbosi")))
    with phases.phase("sisbosi_build"):
        runner.build()
    if not isinstance(runner.dataset, SISBOSIDataset):
        raise AssertionError(f"{SISBOSI_TYPE} built {type(runner.dataset)}")
    again = AwesomeRunner(config(os.path.join(root, "sisbosi_again")))
    if not _same_samples(runner.samples, again.build_dataset()):
        raise AssertionError("two SISBOSI builds with one seed differ")
    if _same_samples(runner.samples, samples):
        raise AssertionError("SISBOSI augmentation changed no sample")
    with phases.phase("sisbosi_pretrain"):
        pre = runner.pretrain()
        torch.cuda.synchronize()
    _, _, k4_pre, k5_pre, _ = counts()
    evals0 = _evals(runner)
    saves = []
    save_checkpoint = runner.save_checkpoint

    def timed_save(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = save_checkpoint(*args, **kwargs)
        saves.append(time.perf_counter() - t)
        return out

    runner.save_checkpoint = timed_save
    t0 = time.perf_counter()
    with phases.phase("sisbosi_train"):
        res = runner.train()
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    runner.save_checkpoint = save_checkpoint
    _, _, k4_tr, k5_tr, _ = counts()
    k4_tr, k5_tr = k4_tr - k4_pre, k5_tr - k5_pre
    evals = _evals(runner) - evals0
    if k5_tr != SISBOSI_EPOCHS or k4_tr != SISBOSI_EPOCHS + evals:
        raise AssertionError(f"SISBOSI runner: K4 {k4_tr}, K5 {k5_tr} "
                             f"launches in {SISBOSI_EPOCHS} epochs and "
                             f"{evals} evaluations")
    check_hist(res["loss_hist"][runner.train_indices].mean(axis=0),
               "the SISBOSI runner's training")
    metrics = runner.evaluate()
    for name, v in metrics.items():
        if ("IOU" in name.upper() or "Accuracy" in name) and \
                not 0.0 <= v <= 1.0:
            raise AssertionError(f"SISBOSI runner metric {name} = {v}")
    trained = T.tree_map(torch.clone, runner.stacked_params)

    window = _image_window(runner, trained, PROF_STEPS)
    window()
    torch.cuda.synchronize()
    _, _, w4, w5, _ = counts()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    ms_epoch = 1e3 * (time.perf_counter() - t0) / PROF_STEPS
    _, _, w4b, w5b, _ = counts()
    per_epoch = {"K4": (w4b - w4) / PROF_STEPS, "K5": (w5b - w5) / PROF_STEPS}
    if per_epoch != {"K4": 1.0, "K5": 1.0}:
        raise AssertionError(f"SISBOSI runner window: {per_epoch} launches "
                             "per epoch")
    profile = device_profile(window, PROF_STEPS, ms_epoch)
    # each checkpoint's config snapshot carries the in-memory samples
    ck_dir = os.path.join(runner.output_folder, "checkpoints")
    ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, names in os.walk(ck_dir) for f in names)
    sisbosi = {"images": len(samples),
               "padded_points": int(runner._dev_batch["px"].shape[1]),
               "cuts": {"epochs": [SISBOSI_EPOCHS, 3000],
                        "pretrain_steps": [SISBOSI_PRETRAIN, 2000]},
               "gate_iou": [float(v) for v in pre["gate_iou"]],
               "train_s": train_s,
               "checkpoint_saves": len(saves),
               "checkpoint_s": sum(saves),
               "train_ms_per_epoch_without_checkpoints_incl_evals":
                   1e3 * (train_s - sum(saves)) / SISBOSI_EPOCHS,
               "ms_per_epoch": ms_epoch, "profile": profile,
               "launches": {"pretrain": {"K4": k4_pre, "K5": k5_pre},
                            "train": {"K4": k4_tr, "K5": k5_tr,
                                      "epochs": SISBOSI_EPOCHS,
                                      "evaluations": evals},
                            "per_epoch": per_epoch},
               "metrics": metrics, "checkpoint_bytes": ck_bytes,
               "augmented_builds_bitwise_equal": True}

    # (3) the prior cache on the card, and the numerics guards
    assert_finite(trained, "the SISBOSI runner's params")
    cache = PriorCache(runner.wrapper.prior_module, len(samples), key=0)
    cache.set_state(trained["prior"])
    one = cache.extract_prior(3)
    cache.apply_prior(5, T.tree_map(lambda t: t * 0.5, one))
    leaves = T.tree_leaves(one) + T.tree_leaves(cache.get_state())
    if any(leaf.device.type != torch.device(device).type
           for leaf in leaves):
        raise AssertionError(f"PriorCache moved a leaf off {device}")
    path = os.path.join(root, "prior_cache")
    cache.save(path)
    loaded = PriorCache(runner.wrapper.prior_module, len(samples), key=1)
    loaded.load(path)
    diff = first_difference(loaded.get_state(), cache.get_state())
    if diff is not None or any(leaf.device.type != torch.device(device).type
                               for leaf in T.tree_leaves(loaded.get_state())):
        raise AssertionError(f"PriorCache save/load is not bitwise on "
                             f"{device}: {diff}")
    x = torch.tensor([-1.0, 4.0], device=device, requires_grad=True)
    try:
        with debug_guard():
            torch.sqrt(x).sum().backward()
    except RuntimeError as e:
        trapped = str(e).splitlines()[0]
    else:
        raise AssertionError("debug_guard let a backward NaN through")
    torch.cuda.synchronize()
    return {"phase": "data_utils", "fit_prior_fused": fused,
            "sisbosi_runner": sisbosi,
            "prior_cache": {"entries": cache.num_entries,
                            "leaves_on": device,
                            "save_load_bitwise": True},
            "debug_guard_trapped": trapped,
            "phase_seconds": phases.report(),
            "seconds": time.perf_counter() - t_all}


MESH_SHAPE = (480, 640)
MESH_SHIFTS = ((0.0, 0.0), (0.1, -0.05), (-0.08, 0.06), (0.05, 0.1))
MESH_STEPS = 200
# the fused fit is chaotic in the order of its sums: reordering the points
# of a single-process fit moves its losses by ~1e-6 relative over the
# first 100 steps and by ~1e-3 by step 200 (``tools/mesh_drift.py``); the
# sharded fit is held step for step at the kernel's tolerance over these
# first steps, and every step at fixed params
MESH_EXACT_STEPS = 30
MESH_RUNNER_EPOCHS = 40
MESH_RUNNER_PRETRAIN = 100
MESH_RANKS = 2
MESH_RUNNER_RTOL, MESH_RUNNER_ATOL = 2e-3, 2e-4


def _mesh_fit_inputs(device, shape):
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T

    h, w = shape
    model = bench_model(shape, device)
    pts = G.flatten_grid(G.pixel_grid(shape, device=device))
    targets = torch.stack([ellipse_target(h, w, device, shift=sh)
                           for sh in MESH_SHIFTS])
    stacked = T.stack_trees([model.init(torch.Generator().manual_seed(30 + i))
                             for i in range(len(MESH_SHIFTS))])
    return model, pts, targets, stacked


def _mesh_fit_cfg(steps: int):
    from awesome_tpu_torch.fit.prior_fit import FitConfig

    return FitConfig(num_steps=steps, lr=1e-3, fused=True,
                     gate_threshold=0.5, nan_guard_grads=False)


def mesh_fit(device, mesh=None, shape=MESH_SHAPE, steps=MESH_STEPS
             ) -> dict:
    """The batched fused fit of the mesh phase: the bench model on
    ``len(MESH_SHIFTS)`` ellipses at ``shape`` with the 0.5 IoU gate and
    one retry, ``steps`` steps; on ``mesh`` when given (the images over
    'data', the points over 'grid'). Returns host arrays, this process's
    K2 launches in the fit and the synchronised seconds."""
    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import fit_priors_batched

    model, pts, targets, stacked = _mesh_fit_inputs(device, shape)
    cfg = _mesh_fit_cfg(steps)
    keys = [40 + i for i in range(len(MESH_SHIFTS))]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    fitted, aux = fit_priors_batched(model, stacked, pts, targets, cfg,
                                     retry_keys=keys, mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"params": [x.cpu().numpy() for x in T.tree_leaves(fitted)],
            "loss_hist": aux["loss_hist"].cpu().numpy(),
            "gate_iou": aux["gate_iou"].cpu().numpy(),
            "k2": counts()[0], "seconds": seconds, "steps": steps}


def mesh_steps(device, mesh, at, shape=MESH_SHAPE) -> dict:
    """One K2 loss+grad step of the mesh fit at the inits and at ``at``
    (host leaves of fitted params). On ``mesh`` each rank launches K2 on
    its block of the images and of their points, with the weights and the
    sums over the grid axis; the images' rows are gathered over 'data'."""
    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.fused_fit import _FlatFit
    from awesome_tpu_torch.fit.prior_fit import _stacked_weights

    model, pts, targets, stacked = _mesh_fit_inputs(device, shape)
    cfg = _mesh_fit_cfg(1)
    out = {}
    b, n = targets.shape[:2]
    ds, gs = slice(0, b), slice(0, n)
    grid_sum = None
    if mesh is not None:
        ds, gs = mesh.local("data", b), mesh.local("grid", n)
        grid_sum = mesh.reducer("grid", n)
    eng = _FlatFit(model, cfg, None)
    wts = _stacked_weights(targets[ds, gs], cfg, None, grid_sum)
    it = iter(at)
    trees = {"init": stacked, "fitted": T.tree_map(
        lambda x: torch.as_tensor(next(it), device=x.device), stacked)}
    for name, tree in trees.items():
        loss, grads = eng.fused.flat(
            eng.pack(T.tree_map(lambda x: x[ds], tree)), pts[gs].contiguous(),
            targets[ds, gs, 0].contiguous(), wts[..., 0].contiguous())
        if grid_sum is not None:
            loss, grads = grid_sum(loss), grid_sum(grads)
        if mesh is not None and mesh.splits("data", b):
            loss, grads = mesh.gather("data", loss), mesh.gather("data", grads)
        out[f"step_{name}"] = (loss.cpu().numpy(), grads.cpu().numpy())
    return out


def mesh_runner(device, folder: str, mesh_shape=None,
                epochs: int = MESH_RUNNER_EPOCHS,
                pretrain: int = MESH_RUNNER_PRETRAIN) -> dict:
    """The convexity runner (``runner_config``'s widths) for ``epochs``
    epochs after a ``pretrain``-step pretrain, on ``mesh_shape`` when
    given: the per-image loss history and this process's K4 and K5
    launches in the training alone."""
    import shutil

    import torch

    from awesome_tpu_torch.runner.runner import AwesomeRunner

    shutil.rmtree(folder, ignore_errors=True)
    runner = AwesomeRunner(runner_config(
        folder, device, num_epochs=epochs, mesh_shape=mesh_shape,
        pretrain_args={"num_epochs": pretrain,
                       "proper_prior_fit_retrys": 1}))
    runner.build()
    runner.pretrain()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = runner.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _, _, k4, k5, _ = counts()
    return {"loss_hist": res["loss_hist"], "k4": k4, "k5": k5,
            "evals": _evals(runner), "seconds": seconds,
            "padded_points": int(runner._dev_batch["px"].shape[1]),
            "mesh": None if runner.mesh is None else dict(runner.mesh.shape)}


def allreduce_ms(mesh, rows: int, cols: int, reps: int = 50) -> float:
    """ms of one grid-axis ``all_reduce`` of a (rows, cols) float32 row
    block (K2's loss and grads), synchronised on both ends."""
    import torch

    buf = torch.ones((rows, cols), device=mesh.device)
    mesh.sum_over("grid", buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.sum_over("grid", buf)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _where(mesh) -> dict:
    """The mesh's backend and this rank's device, as the mesh holds them."""
    return {"backend": mesh.backend, "device": str(mesh.device)}


def _check_where(where: list, what: str) -> list:
    """The backend rule (``parallel.mesh.backend_for``) on this machine:
    every rank on a card and on the backend the rule names for their
    number, NCCL with a card of its own per rank, gloo where they share
    cards (the one-card machine)."""
    import torch

    from awesome_tpu_torch.parallel.mesh import backend_for

    backend = backend_for(torch.device("cuda"), len(where))
    cards = [w["device"] for w in where]
    if any(w["backend"] != backend or not w["device"].startswith("cuda:")
           for w in where) or (backend == "nccl"
                               and len(set(cards)) != len(cards)):
        how = "on a card each" if backend == "nccl" else "on the cards"
        raise AssertionError(f"{what}: ranks on {where}, not {backend} "
                             f"{how}")
    return where


def _collectives(where: list) -> str:
    """Which case of the backend rule a mesh ran (:func:`_check_where`)."""
    cards = len({w["device"] for w in where})
    if where[0]["backend"] == "nccl":
        return f"NCCL between {len(where)} processes on {cards} cards"
    return (f"gloo between {len(where)} processes on {cards} "
            f"card{'s' if cards > 1 else ''}, not NCCL across cards")


def mesh_rank(root: str, go: str) -> dict:
    """A rank of the mesh phase: once the file ``go`` exists (the single
    process's references are done; it holds their fitted params), the
    fused fit on (2, 1) and (1, 2) with the step at those params, then
    the runner on [2, 1] and [1, 2]. Rank 0 sends the params and
    histories; every rank its launches and seconds."""
    import torch.distributed as dist

    from awesome_tpu_torch.ops.flagship import FlagshipSpec
    from awesome_tpu_torch.parallel import make_mesh

    root_rank = dist.get_rank() == 0
    # the card is the single process's until then
    while not os.path.exists(go):
        time.sleep(0.05)
    with np.load(go) as f:
        at = [f[f"a{i}"] for i in range(len(f.files))]
    out = {}
    for shape in ((MESH_RANKS, 1), (1, MESH_RANKS)):
        mesh = make_mesh(shape)
        res = mesh_fit("cuda", mesh)
        res.update(mesh_steps("cuda", mesh, at))
        res["where"] = _where(mesh)
        if shape[1] > 1:
            spec = FlagshipSpec.of(bench_model(MESH_SHAPE, "cuda"))
            res["allreduce_ms"] = allreduce_ms(
                mesh, len(MESH_SHIFTS), spec.offsets()[1] + 1)
        if not root_rank:
            res = {k: v for k, v in res.items()
                   if k in ("k2", "seconds", "allreduce_ms", "where")}
        out[f"fit_{shape[0]}x{shape[1]}"] = res
    for shape in ([MESH_RANKS, 1], [1, MESH_RANKS]):
        res = mesh_runner("cuda", os.path.join(root, f"runner_{shape[0]}x"
                                                     f"{shape[1]}"), shape)
        out[f"runner_{shape[0]}x{shape[1]}"] = res
    return out


def _write_sharded_configs(folder: str, device, n: int = 3) -> str:
    """``n`` tiny convexity configs for ``run_sharded``."""
    from awesome_tpu_torch.runner.config import AwesomeConfig
    from awesome_tpu_torch.serialization.jsonconv import save_yaml

    cfg_dir = os.path.join(folder, "cfgs")
    os.makedirs(cfg_dir, exist_ok=True)
    for i in range(n):
        save_yaml(AwesomeConfig(
            name_experiment=f"smoke_shard_{i}",
            dataset_args={"n": 2, "h": 32, "w": 32},
            segmentation_model_args={"n_hidden": 12},
            prior_model_args={"n_hidden": 8, "n_hidden_layers": 1},
            optimizer_args={"lr": 0.02}, num_epochs=10,
            do_pretraining=False,
            compute_metrics_during_training_nth_epoch=None,
            validation_each_nth_epoch=0, seed=i, device=device),
            os.path.join(cfg_dir, f"c{i}.yaml"))
    return cfg_dir


def _background(fn, *args):
    """``fn(*args)`` in a thread of this process (its work is in child
    processes); the thread's ``result``, ``error`` (what ``fn`` raised,
    a ``SystemExit`` included) and ``seconds`` are read after
    :func:`_joined`."""
    import threading

    def run():
        t0 = time.perf_counter()
        try:
            thread.result = fn(*args)
        except (Exception, SystemExit) as err:  # reported by _joined
            thread.error = err
        thread.seconds = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.result = thread.error = thread.seconds = None
    thread.start()
    return thread


def _joined(thread, what: str, timeout: float = 300.0):
    thread.join(timeout=timeout)
    if thread.is_alive() or thread.error is not None:
        raise AssertionError(f"{what}: {thread.error!r}")
    return thread


def _check_sharded_runs(runs: str, shards: int = 2, configs: int = 3
                        ) -> dict:
    """``run_sharded``'s manifests: ``configs`` configs dealt round robin
    to ``shards`` workers, disjoint, none failed, each worker on a card;
    one ``comparison.md`` naming every run."""
    m = [json.load(open(os.path.join(runs, f"shard_{i}.json")))
         for i in range(shards)]
    jobs = [set(x["jobs"]) for x in m]
    dealt = [len(range(i, configs, shards)) for i in range(shards)]
    if any(x["failures"] for x in m) or [len(j) for j in jobs] != dealt \
            or len(set().union(*jobs)) != configs or any(
                not x["device"].startswith("cuda") for x in m):
        raise AssertionError(f"run_sharded shards: {m}")
    table = open(os.path.join(runs, "comparison.md")).read()
    if not all(f"smoke_shard_{i}" in table for i in range(configs)):
        raise AssertionError("run_sharded: comparison.md lacks a run")
    return {"shards": [sorted(os.path.basename(p) for p in j)
                       for j in jobs], "devices": [x["device"] for x in m],
            "comparison_bytes": len(table)}


def mesh_path(device, root: str) -> dict:
    """The device mesh (``parallel/mesh.py``): two ranks on the backend
    that ``backend_for`` names here, gloo on one card (they share
    ``cuda:0``), NCCL on a machine with two cards or more (``cuda:0`` and
    ``cuda:1``). (a) The batched fused
    fit (bench model, 4 images at 480x640, the gate, ``MESH_STEPS``
    steps) on (2, 1) and (1, 2) against the single-process fit: on each,
    a step at the inits and at the fitted params (each rank's K2 on its
    block of the images and points) within ``LOSS_RTOL`` in the loss and
    5e-4 in the grads, the first ``MESH_EXACT_STEPS`` losses within
    ``LOSS_RTOL``, the final ones within 1e-2, the same gate outcomes;
    (2, 1) bitwise where K2's launch tiles an image as at G = 4; K2
    launches per rank = the steps (plus the retry's), the grid
    ``all_reduce``'s share of a step; every rank on the rule's backend
    and a card (:func:`_check_where`). (b) The convexity runner on
    [2, 1] and [1, 2], ``MESH_RUNNER_EPOCHS`` epochs: loss histories
    within rtol 2e-3, atol 2e-4 of the single-process run, one K4 and one
    K5 launch per rank per epoch. (c) ``run_sharded --spawn`` with two
    workers on the cards and 3 tiny configs: disjoint shards, one
    ``comparison.md``. (d) ``dryrun_multichip(2)``. (c) and (d) run beside
    the ranks. The record's ``collectives`` says which backend ran."""
    import shutil

    import torch

    from awesome_tpu_torch.parallel.launch import start

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_all = time.perf_counter()
    # the ranks start up (~8 s each) while this process takes the
    # single-process references; they wait for `go` to touch the card
    go = os.path.join(root, "go.npz")
    pending = start(mesh_rank, MESH_RANKS, (root, go), device="cuda")
    try:
        single = mesh_fit(device)
        at = single["params"]
        single.update(mesh_steps(device, None, at))
        single_runner = mesh_runner(device,
                                    os.path.join(root, "runner_single"))
        torch.cuda.synchronize()
        np.savez(go + ".tmp.npz", **{f"a{i}": a for i, a in enumerate(at)})
        os.rename(go + ".tmp.npz", go)
    except BaseException:
        pending.stop()
        raise
    # (c) and (d) beside the ranks: the sweep's two workers and the dry
    # run's two ranks start up (~8 s each) and run their tiny configs
    # while the ranks fit (so the ranks' ms/step include their load)
    from awesome_tpu_torch.parallel.dryrun import dryrun_multichip
    from awesome_tpu_torch.scripts import run_sharded

    folder = os.path.join(root, "sharded")
    runs = os.path.join(folder, "runs")
    sweep = _background(run_sharded.main, [
        "--config-dir", _write_sharded_configs(folder, device),
        "--num-shards", "2", "--spawn", "--device", "cuda",
        "--runs-path", runs])
    dry = _background(dryrun_multichip, MESH_RANKS)
    try:
        return _mesh_checks(device, pending.join(), single, single_runner,
                            sweep, dry, runs, t_all)
    finally:
        # their child processes end before this returns
        sweep.join(timeout=300)
        dry.join(timeout=300)


def mesh_fit_entry(single, ranks, shape, n: int, steps: int,
                   bitwise_expected: bool) -> dict:
    """The checks of the mesh fit on ``shape`` = (data, grid) against the
    single-process fit (see :func:`mesh_path`) and its record. ``ranks``:
    every rank's results, under ``fit_{data}x{grid}`` (rank 0's with its
    params, histories and steps); ``n``: the points of an image;
    ``bitwise_expected``: K2 tiles an image on a rank as in the single
    fit, so the params must be equal in every bit."""
    d, g = shape
    key = f"fit_{d}x{g}"
    b = len(single["gate_iou"])
    # the gate's retry refits (the failed images only) for the full steps
    launched = single["k2"]
    if launched != 2 * steps:
        raise AssertionError(f"single fit: {launched} K2 launches for "
                             f"{steps} steps and the retry's")
    res = ranks[0][key]
    k2 = [r[key]["k2"] for r in ranks]
    if any(x != launched for x in k2):
        raise AssertionError(f"{key}: K2 launches per rank {k2}, the "
                             f"single fit's {launched}")
    diff = max(float(np.abs(a - r).max())
               for a, r in zip(res["params"], single["params"]))
    entry = {"where": _check_where([r[key]["where"] for r in ranks], key),
             "k2_per_rank": k2, "local_images": b // d if b % d == 0 else b,
             "local_points": n // g if n % g == 0 else n,
             "seconds": max(r[key]["seconds"] for r in ranks),
             "max_param_diff": diff,
             "max_loss_rel_diff": float(np.max(
                 np.abs(res["loss_hist"] - single["loss_hist"])
                 / np.abs(single["loss_hist"]))),
             "gate_iou": [float(v) for v in res["gate_iou"]]}
    entry["ms_per_step"] = 1e3 * entry["seconds"] / launched
    if g == 1:
        entry["bitwise_expected"] = bool(bitwise_expected)
        entry["bitwise"] = diff == 0.0
        if bitwise_expected and diff != 0.0:
            raise AssertionError(f"{key}: K2 tiles an image as at G={b}, "
                                 f"yet params differ by {diff}")
    # step for step at fixed params (each rank's K2 on its block of the
    # images and points), the kernel's tolerances
    for at_name in ("init", "fitted"):
        (l1, g1), (lm, gm) = (single[f"step_{at_name}"],
                              res[f"step_{at_name}"])
        np.testing.assert_allclose(lm, l1, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gm, g1, rtol=5e-4,
                                   atol=1e-6 * np.abs(g1).max())
        entry[f"step_{at_name}_loss_rel_diff"] = float(np.max(
            np.abs(lm - l1) / np.abs(l1)))
    # the trajectory, before the sums' order has been amplified
    np.testing.assert_allclose(
        res["loss_hist"][:, :MESH_EXACT_STEPS],
        single["loss_hist"][:, :MESH_EXACT_STEPS], rtol=LOSS_RTOL)
    np.testing.assert_allclose(res["loss_hist"][:, -1],
                               single["loss_hist"][:, -1], rtol=1e-2)
    if not np.array_equal(res["gate_iou"] >= 0.5,
                          single["gate_iou"] >= 0.5):
        raise AssertionError(f"{key}: gate {res['gate_iou']} "
                             f"against {single['gate_iou']}")
    entry["exact_steps"] = MESH_EXACT_STEPS
    if g > 1:
        entry["allreduce_ms"] = [r[key]["allreduce_ms"] for r in ranks]
        entry["allreduce_share"] = (
            max(entry["allreduce_ms"]) / entry["ms_per_step"])
    return entry


def mesh_runner_entry(single_runner, ranks, shape, epochs: int) -> dict:
    """The checks of the mesh runner on ``shape`` against the
    single-process run (loss histories within ``MESH_RUNNER_RTOL`` and
    ``MESH_RUNNER_ATOL``, one K4 and one K5 launch per rank per epoch and
    K4 once more per evaluation) and its record. ``ranks``: every rank's
    results, under ``runner_{data}x{grid}``."""
    key = f"runner_{shape[0]}x{shape[1]}"
    res = ranks[0][key]
    if res["mesh"] != {"data": shape[0], "grid": shape[1]}:
        raise AssertionError(f"{key}: the runner's mesh {res['mesh']}")
    np.testing.assert_allclose(res["loss_hist"], single_runner["loss_hist"],
                               rtol=MESH_RUNNER_RTOL, atol=MESH_RUNNER_ATOL)
    k45 = [(r[key]["k4"], r[key]["k5"]) for r in ranks]
    for k4, k5 in k45:
        if k5 != epochs or k4 != epochs + res["evals"]:
            raise AssertionError(f"{key}: K4/K5 launches per rank {k45} in "
                                 f"{epochs} epochs, {res['evals']} "
                                 "evaluations")
    return {"k4_k5_per_rank": k45, "evals": res["evals"],
            "seconds": max(r[key]["seconds"] for r in ranks),
            "max_loss_diff": float(np.abs(
                res["loss_hist"] - single_runner["loss_hist"]).max())}


def _mesh_checks(device, ranks, single, single_runner, sweep, dry, runs,
                 t_all) -> dict:
    """The mesh phase's checks and record (see :func:`mesh_path`)."""
    import torch

    from awesome_tpu_torch.ops.flagship import FlagshipSpec, launch_shape

    where = _check_where([r[f"fit_{MESH_RANKS}x1"]["where"]
                          for r in ranks], "mesh_rank")
    out = {"phase": "mesh", "ranks": MESH_RANKS,
           "collectives": _collectives(where),
           "fit": {"shape": list(MESH_SHAPE), "images": len(MESH_SHIFTS),
                   "steps": MESH_STEPS, "single_s": single["seconds"],
                   "single_ms_per_step": 1e3 * single["seconds"]
                   / single["k2"], "single_k2": single["k2"],
                   "gate_iou": [float(v) for v in single["gate_iou"]]}}
    spec = FlagshipSpec.of(bench_model(MESH_SHAPE, device))
    n = MESH_SHAPE[0] * MESH_SHAPE[1]
    b = len(MESH_SHIFTS)
    dev = torch.device(device)
    for d, g in ((MESH_RANKS, 1), (1, MESH_RANKS)):
        same = g == 1 and launch_shape(spec, n, b // d, None, dev) == \
            launch_shape(spec, n, b, None, dev)
        out["fit"][f"fit_{d}x{g}"] = mesh_fit_entry(
            single, ranks, (d, g), n, MESH_STEPS, same)
    out["runner"] = {"epochs": MESH_RUNNER_EPOCHS,
                     "pretrain_steps": MESH_RUNNER_PRETRAIN,
                     "single_s": single_runner["seconds"],
                     "padded_points": single_runner["padded_points"]}
    for shape in ((MESH_RANKS, 1), (1, MESH_RANKS)):
        out["runner"][f"runner_{shape[0]}x{shape[1]}"] = mesh_runner_entry(
            single_runner, ranks, shape, MESH_RUNNER_EPOCHS)

    dry = _joined(dry, "dryrun_multichip")
    _check_where(dry.result["ranks"], "dryrun_multichip")
    out["dryrun_multichip"] = dict(dry.result, seconds=dry.seconds)
    sweep = _joined(sweep, "run_sharded --spawn")
    out["run_sharded"] = dict(_check_sharded_runs(runs),
                              seconds=sweep.seconds)
    out["seconds"] = time.perf_counter() - t_all
    return out


# The teaser harness (runner/teaser.py) on a synthetic reference tree
# (tools/teaser_tree.py): every protocol at a small step
# scale (the path-connected ones keep their 100 prefit steps), then the
# convex tomato at 210 of its 700 steps
TEASER_SHAPE = (240, 320)
TEASER_FRAMES = (60, 80)  # the temporal teaser's masks
TEASER_SCALE = 0.002
TEASER_TOMATO_SCALE = 0.3
TEASER_RESTARTS = 2
TEASER_FIT_STEPS = 50
TEASER_FIT_RTOL = 2e-4  # the fit tolerance of tests/test_fused_fit.py:37


def teaser_fit_card_vs_cpu(device, steps: int = TEASER_FIT_STEPS) -> dict:
    """One ``minibatch_fit`` at the convex teaser's shape (ConvexNextNet
    150 x 1, 2000 points a class a step, Adam lr 1e-2, the concatenated
    mean) on the card and on the CPU from one init with the same draws
    (drawn once on the CPU): the loss histories within
    ``TEASER_FIT_RTOL``, step by step."""
    import torch

    from awesome_tpu_torch.core.tree import tree_map
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.runner import teaser as T

    h, w = 480, 640
    inside = ellipse_target(h, w, "cpu").reshape(-1).numpy() < 0.5
    pts = T.centered_points(h, w, "cpu")
    sel = torch.as_tensor(inside)
    pts0, pts1 = pts[sel], pts[~sel]
    draws = T._draw_indices(torch.Generator().manual_seed(5), steps, 2000,
                            len(pts0), len(pts1))
    cpu_model = ConvexNextNet(n_hidden=150, n_hidden_layers=1, device="cpu")
    init = cpu_model.init(torch.Generator().manual_seed(0))
    own = T._draw_indices
    T._draw_indices = lambda gen, *a: tuple(d.to(gen.device) for d in draws)
    hists, secs = {}, {}
    try:
        for where in (device, "cpu"):
            model = ConvexNextNet(n_hidden=150, n_hidden_layers=1,
                                  device=where)
            params = tree_map(lambda a, w=where: a.to(w), init)
            t0 = time.perf_counter()
            _, hist = T.minibatch_fit(model, params, pts0.to(where),
                                      pts1.to(where), steps=steps,
                                      n_sample=2000, lr=1e-2, loss="se",
                                      concat_mean=True)
            hists[str(where)] = hist.cpu().numpy()
            secs[str(where)] = time.perf_counter() - t0
    finally:
        T._draw_indices = own
    card, cpu = hists[str(device)], hists["cpu"]
    check_hist(card, "the teaser's minibatch fit on the card")
    err = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    if not err <= TEASER_FIT_RTOL:
        raise AssertionError(f"minibatch_fit card vs CPU: loss histories "
                             f"differ by {err} > rtol {TEASER_FIT_RTOL}")
    return {"steps": steps, "max_rel_diff": err, "rtol": TEASER_FIT_RTOL,
            "loss_first": float(card[0]), "loss_last": float(card[-1]),
            "seconds": secs}


def teaser_path(device, root: str) -> dict:
    """The nine teaser protocols on a synthetic reference tree
    (``TEASER_SHAPE`` images, ``TEASER_FRAMES`` temporal masks) written
    under ``root``: each at ``TEASER_SCALE``, the two restart ensembles
    with ``TEASER_RESTARTS`` restarts, then the convex tomato at
    ``TEASER_TOMATO_SCALE`` of its 700 steps, which must beat its naive
    input (``tests/test_reference_images.py:34-36``); each a finite loss
    and masks of the reference's shape, its seconds and IoU printed; then
    :func:`teaser_fit_card_vs_cpu`."""
    import shutil

    from awesome_tpu_torch.runner import teaser as T
    from tools.teaser_tree import write_tree

    shutil.rmtree(root, ignore_errors=True)
    write_tree(root, *TEASER_SHAPE, frame_shape=TEASER_FRAMES)
    paths = (T.REFERENCE_ROOT, T.TEASER_DIR, T.HOWTO_DIR)
    T.REFERENCE_ROOT = root
    T.TEASER_DIR = os.path.join(root, "notebooks", "icml_teaser_code")
    T.HOWTO_DIR = os.path.join(root, "notebooks", "how_to", "data")
    t_all = time.perf_counter()
    out = {"phase": "teaser", "shape": list(TEASER_SHAPE),
           "frames": list(TEASER_FRAMES), "protocols": {}}
    try:
        runs = [(name, TEASER_SCALE) for name in T.TEASERS]
        runs.append(("convex_tomato", TEASER_TOMATO_SCALE))
        for name, scale in runs:
            t0 = time.perf_counter()
            kw = ({"n_restarts": TEASER_RESTARTS}
                  if name in ("repeating", "connectedness_cat") else {})
            r = T.TEASERS[name](steps_scale=scale, device=device, **kw)
            seconds = time.perf_counter() - t0
            if not np.isfinite(r.extra["loss"]):
                raise AssertionError(f"teaser {name}: loss {r.extra['loss']}")
            if r.mask.shape != r.ref_mask.shape or r.mask.dtype != bool:
                raise AssertionError(f"teaser {name}: mask {r.mask.shape} "
                                     f"{r.mask.dtype}, reference "
                                     f"{r.ref_mask.shape}")
            res = {"steps_scale": scale, "seconds": seconds, "iou": r.iou,
                   **{k: v for k, v in r.extra.items()
                      if isinstance(v, (int, float, str))}}
            print(json.dumps({"phase": "teaser_protocol", "name": name,
                              **res}), flush=True)
            out["protocols"][f"{name}@{scale}"] = res
        tomato = out["protocols"][f"convex_tomato@{TEASER_TOMATO_SCALE}"]
        if not tomato["iou"] > tomato["naive_iou"]:
            raise AssertionError(f"the convex tomato does not beat its "
                                 f"naive input: {tomato}")
    finally:
        T.REFERENCE_ROOT, T.TEASER_DIR, T.HOWTO_DIR = paths
    out["minibatch_fit_card_vs_cpu"] = teaser_fit_card_vs_cpu(device)
    out["seconds"] = time.perf_counter() - t_all
    return out


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


def icnn_bound_ms(spec, n: int, g: int, backward: bool,
                  per_image: bool = False) -> tuple:
    """Least time the card needs for one K4 (or K5) call: the larger of
    the FP32 operations (one pass over every matrix for K4, three for K5:
    recompute, weight grads, data grads; 2 FLOP per MAC) at the FP32 peak,
    and the bytes (points, shared or one set per image, upstream grads and
    params read once; outputs written once) at the HBM rate."""
    w, nl, c, p_len = spec.width, spec.n_layers, spec.in_features, \
        spec.row_len
    macs = c * w + nl * (w * w + c * w) + w + c
    flops = 2.0 * (3.0 if backward else 1.0) * macs * n * g
    x_bytes = n * c * (g if per_image else 1)
    if backward:
        nbytes = 4.0 * (x_bytes + g * n + 2 * g * p_len + g * n * c)
    else:
        nbytes = 4.0 * (x_bytes + g * p_len + g * n)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def icnn_entries(launches4, launches5, steps, reps, device, n=480 * 640,
                 g=1, per_image=False, tag="", seed=13, width=130) -> list:
    """K4 and K5 at one path's shape (``width``, one hidden layer; the
    convex main path: width 130, N = 480x640, G = 1), on the inputs of
    ``seed``: time, plain time, bound and error against the plain version.
    ``tag`` follows the kernel's letter in the entry's name."""
    from awesome_tpu_torch.ops import mlp

    ef, eb = icnn_vs_plain(width, 1, 2, n, g, per_image, seed, device)
    spec, _, stacked, flat, x, gy = icnn_inputs(width, 1, 2, n, g,
                                                per_image, seed, device)
    before = mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches
    ms4 = cuda_time_ms(lambda: mlp.icnn_forward_cuda(spec, flat, x), reps)
    ms5 = cuda_time_ms(lambda: mlp.icnn_backward_cuda(spec, flat, x, gy),
                       reps)
    mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches = before
    plain4 = cuda_time_ms(lambda: mlp.icnn_forward_plain(stacked, x), reps)
    plain5 = cuda_time_ms(
        lambda: mlp.icnn_backward_plain(stacked, x, gy[..., None]), reps)
    points = "per_image" if per_image else "shared"
    out = []
    for name, line, launches, ms, plain, err, bwd in (
            ("icnn_forward (K4", 65, launches4, ms4, plain4, ef, False),
            ("icnn_backward (K5", 186, launches5, ms5, plain5, eb, True)):
        b_ms, b_by = icnn_bound_ms(spec, n, g, bwd, per_image)
        out.append({
            "name": f"{name}{tag})", "route": "cuda",
            "source": "awesome_tpu_torch/ops/csrc/icnn.cu",
            "replaces": f"awesome_tpu/ops/pallas_mlp.py:{line}",
            "launches": launches, "steps": steps,
            "launches_per_step": launches / steps, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": {"n": n, "g": g, "width": width,
                                          "layers": 1, "points": points},
        })
    return out


def mesh_kernel_entries(mesh: dict, device) -> list:
    """K2 at each mesh fit's per-rank shape and K4/K5 at each mesh
    runner's, their launches those of rank 0 in the mesh phase, each held
    against its plain version there (``"path": "mesh"``)."""
    n = MESH_SHAPE[0] * MESH_SHAPE[1]
    b = len(MESH_SHIFTS)
    model = bench_model(MESH_SHAPE, device)
    out = []
    for d, g in ((MESH_RANKS, 1), (1, MESH_RANKS)):
        fit = mesh["fit"][f"fit_{d}x{g}"]
        entry = kernel_entry(
            f"flagship_loss_grad (K2, G={b // d} x {n // g} points per "
            f"rank, mesh ({d}, {g}))", "awesome_tpu/ops/pallas_flagship.py"
            ":236", model, n // g, b // d, 25 + d, fit["k2_per_rank"][0],
            mesh["fit"]["single_k2"], 10, device)
        out.append(dict(entry, path="mesh"))
    pts = mesh["runner"]["padded_points"]
    images = len(RUNNER_SHAPES)
    for d, g in ((MESH_RANKS, 1), (1, MESH_RANKS)):
        run = mesh["runner"][f"runner_{d}x{g}"]
        k4, k5 = run["k4_k5_per_rank"][0]
        local_n = pts // g if pts % g == 0 else pts
        out += [dict(e, path="mesh") for e in icnn_entries(
            k4, k5, MESH_RUNNER_EPOCHS, 50, device, n=local_n,
            g=images // d, per_image=True,
            tag=f", G={images // d} x {local_n} points per rank, runner "
            f"mesh ({d}, {g})", seed=27 + d)]
    for entry in out:
        print(json.dumps({"phase": "kernel_vs_plain", "kernel":
                          entry["name"], "path": "mesh",
                          "n": entry["shape"]["n"],
                          "g": entry["shape"]["g"],
                          "max_abs_err": entry["max_abs_err"],
                          "bitwise_repeat": True}), flush=True)
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
    full_resolution_k2_check(dev)
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
    main_ms_per_step = res["ms_per_step"]
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
    joint = joint_path(dev)
    print(json.dumps(joint), flush=True)
    mo_small = multi_object_path(dev, (64, 64), 8, 4, 6, 200, {2: 2},
                                 resume_at=3)
    print(json.dumps(mo_small), flush=True)
    mo_large = multi_object_path(dev, (480, 640), 4, 2, 2, 100, {1: 2},
                                 falling=False)
    print(json.dumps(mo_large), flush=True)
    print(json.dumps(spatiotemporal_path(dev)), flush=True)
    print(json.dumps(zoo_check(dev)), flush=True)
    run = runner_path(dev, os.path.join("build", "smoke_runner"))
    print(json.dumps(run), flush=True)
    fbms = fbms_path(dev, os.path.join("build", "smoke_fbms"))
    print(json.dumps(fbms), flush=True)
    print(json.dumps(extra_priors_path(dev)), flush=True)
    cd = runner_convex_diffeo_path(dev, os.path.join("build", "smoke_cd"))
    print(json.dumps(cd), flush=True)
    print(json.dumps(crf_path(dev)), flush=True)
    img = image_runner_path(dev, os.path.join("build", "smoke_image"))
    print(json.dumps(img), flush=True)
    print(json.dumps(spectral_path(dev)), flush=True)
    print(json.dumps(paper_table_path(
        os.path.join("build", "smoke_paper_table"))), flush=True)
    data = data_utils_path(dev, os.path.join("build", "smoke_data"))
    print(json.dumps(data), flush=True)
    mesh = mesh_path(dev, os.path.join("build", "smoke_mesh"))
    print(json.dumps(mesh), flush=True)
    zero_counts()
    teaser = teaser_path(dev, os.path.join("build", "smoke_teaser"))
    teaser["kernel_launches"] = dict(zip(("K1/K2", "K1/K2 bf16", "K4", "K5"),
                                         counts()[:4]))
    if any(teaser["kernel_launches"].values()):
        raise AssertionError("the teaser protocols launched a kernel: "
                             f"{teaser['kernel_launches']}")
    print(json.dumps(teaser), flush=True)

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
    runner_kernels = icnn_entries(
        run["k4"], run["k5"], run["launches"]["train"]["epochs"], 50, dev,
        n=run["padded_points"], g=len(RUNNER_SHAPES), per_image=True,
        tag=f", G={len(RUNNER_SHAPES)}, runner, per-image points", seed=21)
    for entry in runner_kernels:
        print(json.dumps({"phase": "kernel_vs_plain", "kernel":
                          entry["name"], "path": "runner",
                          "n": run["padded_points"],
                          "g": len(RUNNER_SHAPES), "points": "per_image",
                          "max_abs_err": entry["max_abs_err"],
                          "bitwise_repeat": True}), flush=True)
    kernels += runner_kernels
    cd_kernels = icnn_entries(
        cd["k4"], cd["k5"], CD_EPOCHS, 50, dev, n=cd["padded_points"],
        g=len(RUNNER_SHAPES), per_image=True,
        tag=f", G={len(RUNNER_SHAPES)}, convex-diffeomorphism runner, "
        "per-image points", seed=21)
    for entry in cd_kernels:
        print(json.dumps({"phase": "kernel_vs_plain", "kernel":
                          entry["name"], "path": "runner_convex_diffeo",
                          "n": cd["padded_points"],
                          "g": len(RUNNER_SHAPES), "points": "per_image",
                          "max_abs_err": entry["max_abs_err"],
                          "bitwise_repeat": True}), flush=True)
    kernels += cd_kernels
    img_kernels = icnn_entries(
        img["k4"], img["k5"], IMAGE_EPOCHS, 50, dev, n=img["padded_points"],
        g=len(RUNNER_SHAPES), per_image=True,
        tag=f", G={len(RUNNER_SHAPES)}, image mode, per-image points",
        seed=23, width=64)
    for entry in img_kernels:
        print(json.dumps({"phase": "kernel_vs_plain", "kernel":
                          entry["name"], "path": "image_runner",
                          "n": img["padded_points"],
                          "g": len(RUNNER_SHAPES), "points": "per_image",
                          "max_abs_err": entry["max_abs_err"],
                          "bitwise_repeat": True}), flush=True)
    kernels += img_kernels
    for mo, (h, w), seed, reps in ((mo_small, (64, 64), 15, 50),
                                   (mo_large, (480, 640), 17, 10)):
        entry = kernel_entry(
            f"flagship_loss_grad (K2, G={mo['k2_group']} at {h}x{w}, "
            "multi-object children)", replaces, bench_model((h, w), dev),
            h * w, mo["k2_group"], seed, mo["k2_launches"],
            mo["k2_launches"], reps, dev)
        print(json.dumps({"phase": "kernel_vs_plain", "model": "bench",
                          "path": "multi_object", "n": h * w,
                          "g": mo["k2_group"],
                          "max_abs_err": entry["max_abs_err"],
                          "bitwise_repeat": True}), flush=True)
        kernels.append(entry)
    kernels.append(joint["large"]["k2_kernel"])
    h, w = FBMS_SHAPE
    entry = kernel_entry(
        "flagship_loss_grad (K1, G=1, FBMS per-frame pretrain)", replaces,
        bench_model(FBMS_SHAPE, dev), h * w, 1, 19, fbms["k1"],
        fbms["pretrain"]["fit_steps"], 20, dev)
    print(json.dumps({"phase": "kernel_vs_plain", "model": "bench",
                      "path": "fbms", "n": h * w, "g": 1,
                      "max_abs_err": entry["max_abs_err"],
                      "bitwise_repeat": True}), flush=True)
    kernels.append(entry)
    kernels += mesh_kernel_entries(mesh, dev)
    print(json.dumps({
        "phase": "fit_prior_fused_vs_main_path",
        "fit_prior_fused_ms_per_step": data["fit_prior_fused"]["ms_per_step"],
        "main_path_ms_per_step": main_ms_per_step,
        "main_path_k1_ms": kernels[0]["ms"]}), flush=True)
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
