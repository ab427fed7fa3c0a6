"""The flagship kernel of this checkout against another checkout's, on one
card: the FP32 build's outputs within the kernel tolerances of each other,
the bf16 build's within the gap rule, and each one's time.

    python3 -m tools.flagship_vs_parent --parent DIR

``DIR`` holds another checkout (e.g. the parent commit, unpacked with
``git archive HEAD | tar -x -C build/parent``). Each package runs in a
process of its own, in the order parent, this, this, parent, on the same
seeded inputs (``chip_smoke.loss_grad_inputs``). FP32 build: the bench
model at 480x640 (G = 1), at 480x640 with G = 8 (the multi-object
children's K2), at 64x64 with G = 8 and G = 2 (shared points; the smoke's
K2 and K3 shapes), and with a third ICNN layer (the 32-point
instantiation, G = 2). bf16 build (``use_bf16``): the bench model at
480x640, at 64x64 with G = 8 and per-image points (the smoke's K2 bf16
shape), and the 32-point instantiation. It prints one JSON line per run
(ms per call over REPS launches, by CUDA events) and a last line that
says, per shape, whether the two packages' outputs are equal in every bit,
whether each package's two runs are, the ratio of their mean times, for
the FP32 shapes whether this checkout's outputs are within the kernel
tolerances of the other's (loss rtol ``chip_smoke.LOSS_RTOL``, grads rtol
``GRAD_RTOL`` atol ``GRAD_ATOL``: a kernel that sums in another order, or
cuts the points into other tiles, moves the last bits, so bitwise
equality holds only between two runs of one kernel; the loss, which only
the forward reaches, is also compared bit for bit), and for the bf16
shapes each package's largest error/gap ratio: the loss's and every packed
leaf's norm-relative error against the plain bf16 version over that
version's bf16-vs-FP32 gap (``chip_smoke.BF16_GAP_SHARE`` is the limit).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPS = 20
# (name, points, images, ICNN layers, bf16 build, per-image points)
SHAPES = (("K1 480x640", 480 * 640, 1, 2, False, False),
          ("K2 G=8 480x640", 480 * 640, 8, 2, False, False),
          ("K2 G=8 64x64", 64 * 64, 8, 2, False, False),
          ("K3 G=2 64x64", 64 * 64, 2, 2, False, False),
          ("TP32 deep G=2", 4097, 2, 3, False, False),
          ("K1 bf16 480x640", 480 * 640, 1, 2, True, False),
          ("K2 bf16 G=8 64x64 per-image", 64 * 64, 8, 2, True, True),
          ("TP32 bf16 deep G=2", 4097, 2, 3, True, False))
SEED = 7


def run_one(root: str, out: str) -> None:
    """Run the kernel of the package under ``root``; save its outputs."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from chip_smoke import bench_model, cuda_time_ms, loss_grad_inputs
    from awesome_tpu_torch.ops import flagship as F

    res, outs = {"root": root}, {}
    for name, n, g, layers, bf16, per_image in SHAPES:
        model = bench_model((64, 64), "cuda", layers=layers)
        spec, flat, pts, tgt, wts = loss_grad_inputs(model, n, g, SEED,
                                                     "cuda", per_image)
        f = F.FlagshipLossGrad(spec, True, g, None, use_bf16=bf16)
        loss, grads = f.flat(flat, pts, tgt, wts)
        outs[name] = torch.cat([grads, loss[:, None]], dim=1).cpu()
        res[name] = cuda_time_ms(lambda: f.flat(flat, pts, tgt, wts), REPS)
    res["package"] = str(Path(F.__file__).resolve().parents[2])
    torch.save(outs, out)
    print(json.dumps(res), flush=True)


def gap_ratios(runs) -> dict:
    """Per bf16 shape, the largest error/gap ratio of each run's outputs
    against this checkout's plain bf16 version."""
    import torch

    from chip_smoke import _nrel, bench_model, loss_grad_inputs
    from awesome_tpu_torch.ops import flagship as F

    ratios = {}
    for name, n, g, layers, bf16, per_image in SHAPES:
        if not bf16:
            continue
        model = bench_model((64, 64), "cuda", layers=layers)
        spec, flat, pts, tgt, wts = loss_grad_inputs(model, n, g, SEED,
                                                     "cuda", per_image)
        packed = F.unpack_flat(spec, flat)
        refs = [F.flagship_loss_grad_plain(spec, packed, pts, tgt, wts,
                                           use_bf16=b) for b in (True, False)]
        (loss_p, grads_p), (loss_f, grads_f) = refs
        _, p_len = spec.offsets()
        ratios[name] = []
        for _, outs in runs:
            out = outs[name].cuda()
            got = F.unpack_flat(spec, out[:, :p_len].contiguous())
            pairs = [(out[:, p_len], loss_p, loss_f)] + [
                (got[k], grads_p[k], grads_f[k]) for k in F.PACKED_FIELDS]
            ratios[name].append(max(_nrel(a, ref) / _nrel(ref, f32)
                                    for a, ref, f32 in pairs))
        torch.cuda.synchronize()
    return ratios


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_one(args.run, args.save)
        return
    import torch

    from chip_smoke import (
        BF16_GAP_SHARE,
        GRAD_ATOL,
        GRAD_RTOL,
        LOSS_RTOL,
        nvidia_smi_line,
    )

    here = str(Path(__file__).resolve().parents[1])
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for i, root in enumerate((args.parent, here, here, args.parent)):
            save = f"{tmp}/run{i}.pt"
            line = subprocess.run(
                [sys.executable, "-m", "tools.flagship_vs_parent", "--run",
                 root, "--save", save], check=True, capture_output=True,
                text=True, cwd=here).stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append((json.loads(line), torch.load(save)))
    ratios = gap_ratios(runs)
    summary = {"card": nvidia_smi_line()}
    for name, *_ in SHAPES:
        same = all(torch.equal(r[1][name], runs[0][1][name]) for r in runs)
        parent_ms = (runs[0][0][name] + runs[3][0][name]) / 2
        this_ms = (runs[1][0][name] + runs[2][0][name]) / 2
        summary[name] = {
            "bitwise_equal": same, "parent_ms": parent_ms,
            "this_ms": this_ms, "ratio": this_ms / parent_ms,
            "repeat_bitwise_equal": (
                torch.equal(runs[1][1][name], runs[2][1][name])
                and torch.equal(runs[0][1][name], runs[3][1][name]))}
        if name in ratios:
            r = ratios[name]
            summary[name].update(
                parent_err_over_gap=max(r[0], r[3]),
                this_err_over_gap=max(r[1], r[2]),
                within_gap_rule=max(r) <= BF16_GAP_SHARE)
        else:
            this, parent = runs[1][1][name], runs[0][1][name]
            loss_ok = torch.allclose(this[:, -1], parent[:, -1],
                                     rtol=LOSS_RTOL, atol=0.0)
            grads_ok = torch.allclose(this[:, :-1], parent[:, :-1],
                                      rtol=GRAD_RTOL, atol=GRAD_ATOL)
            summary[name].update(
                within_kernel_tolerance=bool(loss_ok and grads_ok),
                loss_bitwise_equal=torch.equal(this[:, -1], parent[:, -1]),
                max_abs_diff=float((this - parent).abs().max()))
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
