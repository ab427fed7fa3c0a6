"""Where the ICNN kernels' time goes, phase by phase, on the card.

    python3 -m tools.icnn_phases [--root DIR] [--reps 50] [--no-phases]
        [--width 130] [--layers 1]

Builds ``awesome_tpu_torch/ops/csrc/icnn.cu`` with ``-DICNN_PROFILE``
(per-phase ``clock64`` counters of block (0, 0), each phase closed by a
barrier), runs K5 (the backward) and K4 (the forward) once each through
that build on the convex main path's shape (480x640 points, G = 1; width
130 and one hidden layer unless ``--width``/``--layers`` say otherwise),
then times the plain build
(``chip_smoke.cuda_time_ms`` over ``--reps`` launches) at that shape and
at the batched convex shape (G = 8 images of 128x128 points). It prints
one JSON line: the card, the checkout, each shape's launch shape and ms,
and each phase's cycles and share. The barriers the counters add make the
profiled kernels a little slower than the plain build; the shares are
what to read.

``--root`` takes the package from another checkout (e.g. the parent
commit unpacked with ``git archive`` under ``build/``), so that two
versions of the kernels can be compared in one run on one card. A
checkout whose ``icnn.cu`` has no counters is only timed, as is every one
with ``--no-phases``. The line also carries the plain build's ptxas
registers and spills per kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import sys
from pathlib import Path

import torch

from chip_smoke import cuda_time_ms, icnn_inputs, nvidia_smi_line

# PHASE(k) ids of csrc/icnn.cu, per kernel, as the source names them
PHASES = {
    "K5": ("load chunk", "recompute: input layer",
           "recompute: hidden layers", "output layer grads, dz_L",
           "hidden weight grads (wln | wsk | bln)",
           "hidden bwd data (+ dx rows)", "input-layer grads",
           "input-layer dx"),
    "K4": ("load chunk", "input layer", "hidden layers but the last",
           "last hidden layer and y"),
}
# (name, points per image, images) of the timed shapes
SHAPES = (("480x640", 480 * 640, 1), ("8 x 128x128", 128 * 128, 8))
C = 2  # in_features: points in the plane


def phase_split(lib, kernel: str, run) -> dict:
    """Cycles of block (0, 0) per phase of one call of ``run``."""
    from awesome_tpu_torch.ops.build import check

    counts = (ctypes.c_ulonglong * 16)()
    torch.cuda.synchronize()
    check(lib.icnn_phase_cycles(None, 1), "reset counters")
    run()
    torch.cuda.synchronize()
    check(lib.icnn_phase_cycles(ctypes.addressof(counts), 0),
          "read counters")
    names = PHASES[kernel]
    total = float(sum(counts[:len(names)]))
    return {"block0_cycles": total,
            "phases": [{"phase": name, "cycles": float(c),
                        "share": float(c) / total}
                       for name, c in zip(names, counts)]}


def ptxas_lines(build_log: Path) -> dict:
    """Registers and spills of each kernel instantiation in a build's
    ``-Xptxas -v`` report."""
    out, kernel = {}, None
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            # icnn_bwd<64, true> mangles to ...icnn_bwdILi64ELb1EE...
            m = re.search(r"(icnn_(?:fwd|bwd))ILi(\d+)E(?:Lb(\d))?", line)
            kernel = (f"{m.group(1)}<{m.group(2)}"
                      f"{', ' + m.group(3) if m.group(3) else ''}>"
                      if m else None)
        elif kernel and ("registers" in line or "spill" in line):
            out.setdefault(kernel, []).append(
                line.split("ptxas info")[-1].strip(" :"))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose awesome_tpu_torch to build and run")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-phases", action="store_true",
                    help="time the plain build only")
    ap.add_argument("--width", type=int, default=130)
    ap.add_argument("--layers", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("icnn_phases needs a CUDA card")
    if args.root is not None:
        sys.path.insert(0, str(Path(args.root).resolve()))
    from awesome_tpu_torch.ops import mlp as M
    from awesome_tpu_torch.ops.build import CSRC

    res = {"card": nvidia_smi_line(),
           "root": str(Path(M.__file__).resolve().parents[2]),
           "width": args.width, "layers": args.layers, "in_features": C,
           "ptxas": ptxas_lines(M.LIBRARY.build().with_suffix(".build.log"))}
    spec, _, _, flat, x, gy = icnn_inputs(args.width, args.layers, C,
                                          SHAPES[0][1], 1, False, 13, "cuda")
    # the wrappers load their library once; hand them the profiled build
    if not args.no_phases and \
            "ICNN_PROFILE" in (CSRC / M.LIBRARY.source).read_text():
        lib = M.LIBRARY.load(M.LIBRARY.build(("-DICNN_PROFILE",)))
        lib.icnn_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.icnn_phase_cycles.restype = ctypes.c_int
        M.LIBRARY.use(lib)
        M.icnn_backward_cuda(spec, flat, x, gy)  # warm-up
        res["K5_phases"] = phase_split(
            lib, "K5", lambda: M.icnn_backward_cuda(spec, flat, x, gy))
        res["K4_phases"] = phase_split(
            lib, "K4", lambda: M.icnn_forward_cuda(spec, flat, x))
        M.LIBRARY.use(M.LIBRARY.load(M.LIBRARY.build()))
    for name, n, g in SHAPES:
        spec, _, _, flat, x, gy = icnn_inputs(args.width, args.layers, C, n,
                                              g, False, 13, "cuda")
        entry = {"n": n, "g": g}
        for kernel, kind, fn in (
                ("K5", M.BACKWARD,
                 lambda: M.icnn_backward_cuda(spec, flat, x, gy)),
                ("K4", M.FORWARD, lambda: M.icnn_forward_cuda(spec, flat, x))):
            shape = M.launch_shape(kind, args.width, args.layers, n, g,
                                   torch.cuda.current_device())
            entry[kernel] = {"launch": dataclasses.asdict(shape),
                             "ms": cuda_time_ms(fn, args.reps)}
        res[name] = entry
    print(json.dumps(res))


if __name__ == "__main__":
    main()
