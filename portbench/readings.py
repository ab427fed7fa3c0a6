"""The readings a cell's correctness limits are set from: the compared
numbers of the program over many seeds, and of the control (the
configuration's next lower precision) over a few, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 ...
        --control-seeds 7 8 9 --seconds 10 [--out FILE]

One JSON line per run (``program`` or ``control``, the seed, every number
with its limit, ``correct``), then the largest reading of the program and
the smallest of the control for each number.
"""
import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness, spec  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out")
    args = p.parse_args()
    cell = spec.cell(spec.benchmark(), args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(
        cell["traffic"])
    limits = spec.limits(cell["name"])
    out = open(args.out, "a") if args.out else None
    found = {"program": {}, "control": {}}
    runs = [("program", s) for s in args.seeds] + \
        [("control", s) for s in args.control_seeds]
    for kind, seed in runs:
        rec = harness.run_cell(cell, config, traffic, limits, seed,
                               args.seconds, False, "cuda",
                               time.perf_counter(), control=kind == "control")
        line = {"cell": cell["name"], "kind": kind, "seed": seed,
                "correct": rec["correct"], "failed": rec["failed"],
                "units": rec["units"], "checks": rec["checks"]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        for name, c in rec["checks"].items():
            found[kind].setdefault(name, []).append(c["value"])
    summary = {"cell": cell["name"],
               "program_max": {k: max(v) for k, v in
                               found["program"].items()},
               "control_min": {k: min(v) for k, v in
                               found["control"].items()}}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
