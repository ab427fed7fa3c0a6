"""The FP32 flagship kernel of this checkout against another checkout's, on
one card: bitwise equal outputs, and each one's time.

    python3 -m tools.flagship_vs_parent --parent DIR

``DIR`` holds another checkout (e.g. the parent commit, unpacked with
``git archive HEAD | tar -x -C build/parent``). Each package runs in a
process of its own, in the order parent, this, this, parent, on the same
seeded inputs (``chip_smoke.loss_grad_inputs``): the bench model at
480x640 (G = 1), at 64x64 with G = 8 and G = 2 (shared points; the
smoke's K2 and K3 shapes), and with a third ICNN layer (the 32-point
instantiation, G = 2). It prints one JSON line per
run (ms per call over REPS launches, by CUDA events) and a last line that
says, per shape, whether the two packages' outputs are equal in every bit
and the ratio of their mean times.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPS = 20
SHAPES = (("K1 480x640", 480 * 640, 1, 2), ("K2 G=8 64x64", 64 * 64, 8, 2),
          ("K3 G=2 64x64", 64 * 64, 2, 2), ("TP32 deep G=2", 4097, 2, 3))


def run_one(root: str, out: str) -> None:
    """Run the kernel of the package under ``root``; save its outputs."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from chip_smoke import bench_model, cuda_time_ms, loss_grad_inputs
    from awesome_tpu_torch.ops import flagship as F

    res, outs = {"root": root}, {}
    for name, n, g, layers in SHAPES:
        model = bench_model((64, 64), "cuda", layers=layers)
        spec, flat, pts, tgt, wts = loss_grad_inputs(model, n, g, 7, "cuda")
        f = F.FlagshipLossGrad(spec, True, g, None)
        loss, grads = f.flat(flat, pts, tgt, wts)
        outs[name] = torch.cat([grads, loss[:, None]], dim=1).cpu()
        res[name] = cuda_time_ms(lambda: f.flat(flat, pts, tgt, wts), REPS)
    res["package"] = str(Path(F.__file__).resolve().parents[2])
    torch.save(outs, out)
    print(json.dumps(res), flush=True)


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

    from chip_smoke import nvidia_smi_line

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
    summary = {"card": nvidia_smi_line()}
    for name, *_ in SHAPES:
        same = all(torch.equal(r[1][name], runs[0][1][name]) for r in runs)
        parent_ms = (runs[0][0][name] + runs[3][0][name]) / 2
        this_ms = (runs[1][0][name] + runs[2][0][name]) / 2
        summary[name] = {"bitwise_equal": same, "parent_ms": parent_ms,
                         "this_ms": this_ms, "ratio": this_ms / parent_ms}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
