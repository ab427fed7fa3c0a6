"""Where the flagship kernel's time goes, phase by phase, on the card.

    python3 -m tools.flagship_phases [--h 480] [--w 640]
        [--model bench|default] [--bf16] [--root DIR]

Builds ``awesome_tpu_torch/ops/csrc/flagship.cu`` with
``-DFLAGSHIP_PROFILE`` (per-phase ``clock64`` counters of block (0, 0),
each phase closed by a barrier), runs one fused loss+grad on random params
at the given image size through that build, then times the plain build
(``chip_smoke.cuda_time_ms`` over REPS launches), and prints one JSON
line: the card, the launch shape, the plain build's ms per call, and each
phase's cycles and share. The barriers the counters add make the profiled
kernel a little slower than the plain build; the shares are what to read.
``--bf16`` runs the bf16 build (``use_bf16``) instead of the FP32 one.

``--root`` takes the package from another checkout (e.g. an earlier
commit unpacked with ``git archive``), so that two versions of the kernel
can be compared in one run on one card.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import cuda_time_ms, nvidia_smi_line

# PHASE(k) ids of csrc/flagship.cu
PHASES = (
    "load + translate", "flow fwd: s|t", "flow fwd: coupling",
    "icnn fwd", "loss", "icnn out-layer bwd", "icnn weight grads (wln)",
    "icnn skip/bias grads + dx", "icnn bwd data", "icnn input-layer bwd",
    "flow bwd: ds|dt", "flow bwd: h and dh", "flow bwd: weight grads, dz",
    "translate bwd",
)
REPS = 20  # timed launches of the plain build


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=int, default=480)
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--model", choices=("bench", "default"), default="bench")
    ap.add_argument("--bf16", action="store_true",
                    help="profile the bf16 build (use_bf16)")
    ap.add_argument("--root", default=None,
                    help="checkout whose awesome_tpu_torch to build and run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flagship_phases needs a CUDA card")
    if args.root is not None:
        sys.path.insert(0, str(Path(args.root).resolve()))
    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )
    from awesome_tpu_torch.ops import flagship as F
    from awesome_tpu_torch.ops.build import check
    kw = dict(hidden_units=32, flow_n_flows=12) if args.model == "bench" \
        else {}
    model = real_nvp_path_connected_net(
        flow_output_fn="tanh", spatial_shape=(args.h, args.w), **kw)
    gen = torch.Generator().manual_seed(0)
    params = T.tree_map(
        lambda a: a + 0.05 * torch.randn(a.shape, generator=gen).to(a.device),
        model.init(gen))
    spec = F.FlagshipSpec.of(model)
    flat = F.pack_flat(F.pack_flagship(
        model, T.tree_map(lambda a: a[None], params)), 1).contiguous()
    x = G.flatten_grid(G.pixel_grid((args.h, args.w))).contiguous()
    n = x.shape[0]
    tgt = (torch.rand((1, n), generator=gen) > 0.5).float().cuda()
    wpt = torch.full((1, n), 1.0 / n, device="cuda")
    # the wrapper loads its library once; hand it the profiled build
    lib = F.LIBRARY.load(F.LIBRARY.build(("-DFLAGSHIP_PROFILE",)))
    lib.flagship_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.flagship_phase_cycles.restype = ctypes.c_int
    F.LIBRARY.use(lib)
    shape = F.launch_shape(spec, n, 1, None, x.device, use_bf16=args.bf16)

    def run():
        F.flagship_loss_grad_cuda(spec, flat, x, tgt, wpt, True, shape,
                                  use_bf16=args.bf16)

    run()
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 16)()
    check(lib.flagship_phase_cycles(None, 1), "reset counters")
    run()
    torch.cuda.synchronize()
    check(lib.flagship_phase_cycles(ctypes.addressof(counts), 0),
             "read counters")
    cycles = np.array(counts[:len(PHASES)], dtype=np.float64)
    total = float(cycles.sum())
    F.LIBRARY.use(F.LIBRARY.load(F.LIBRARY.build()))
    ms = cuda_time_ms(run, REPS)
    print(json.dumps({
        "card": nvidia_smi_line(),
        "root": str(Path(F.__file__).resolve().parents[2]),
        "model": args.model, "bf16": args.bf16, "shape": [args.h, args.w],
        "launch": dataclasses.asdict(shape), "ms": ms,
        "block0_cycles": total,
        "phases": [{"phase": name, "cycles": float(c),
                    "share": float(c) / total}
                   for name, c in zip(PHASES, cycles)],
    }))


if __name__ == "__main__":
    main()
