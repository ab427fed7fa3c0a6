"""The port's spans in a device trace: for each span of the program (a
``record_function`` range whose name starts with ``fit.`` or ``joint.``,
``awesome_tpu_torch/utils/profiling.py:span``), its count and host seconds,
its self seconds (less the program spans nested in it), the device seconds
of the ops it launched, and the idle seconds it leaves the card.

    python3 portbench/spans.py --workload <cell> --seed <n> [--units U]

runs the cell's set-up, then ``U`` units (default: the traffic's
``trace_units``) under ``torch.profiler``, and prints one JSON line: the
traced window, the card's busy seconds, and each span's numbers in total
and per step (a step is a ``fit.loss_grad`` or a ``joint.step``). A
checkout whose port has no spans prints an empty table. Cells whose
driver runs its own ranks (the mesh) are refused: their spans are in the
ranks' processes.

A device op belongs to every span whose interval holds its launch: the
runtime call (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) with the
op's correlation id, on whatever thread made it, so the autograd
engine's launches during ``joint.backward`` count there. A span's device
seconds are the union of its ops' intervals; its idle seconds the idle
gaps of the window whose middle lies in it while it is the innermost
program span there.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Callable, Dict, List, Sequence, Tuple

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import trace as tr  # noqa: E402

PREFIXES = ("fit.", "joint.")
RUNTIME = re.compile(r"^cu(da)?(Launch|Memcpy|Memset|GraphLaunch)")
Span = Tuple[str, float, float]  # name, start s, end s
DeviceOp = Tuple[str, float, float, int, int]  # ... stream, correlation


def capture(run: Callable[[], None]) -> dict:
    """Run ``run`` (which ends in a device synchronize) under the profiler;
    its device ops with their correlation ids, the runtime calls' host
    start by correlation id, the program's spans and the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tr.WINDOW):
            run()
            torch.cuda.synchronize()
    device, launches, program, window = [], {}, [], None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            if name != tr.WINDOW and not ev.is_user_annotation():
                device.append((name, s, e, int(ev.device_resource_id()),
                               int(ev.correlation_id())))
        elif name == tr.WINDOW:
            window = (s, e)
        elif name.startswith(PREFIXES):
            program.append((name, s, e))
        elif RUNTIME.match(name):
            launches[int(ev.correlation_id())] = s
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return {"device_ops": device, "launches": launches, "spans": program,
            "window": window}


def nesting(program: Sequence[Span]):
    """For spans that nest (each holds, or lies apart from, any other):
    each span's parent (the innermost span holding it, or -1), and the
    innermost span at each time as steps: from ``times[i]`` on, span
    ``owner[i]`` (-1: none)."""
    order = sorted(range(len(program)),
                   key=lambda k: (program[k][1], -program[k][2]))
    parent = [-1] * len(program)
    times, owner, stack = [], [], []

    def close(until: float) -> None:
        while stack and program[stack[-1]][2] <= until:
            end = program[stack.pop()][2]
            times.append(end)
            owner.append(stack[-1] if stack else -1)

    for k in order:
        close(program[k][1])
        parent[k] = stack[-1] if stack else -1
        stack.append(k)
        times.append(program[k][1])
        owner.append(k)
    close(float("inf"))
    return parent, times, owner


def spans(device_ops: Sequence[DeviceOp], launches: Dict[int, float],
          program: Sequence[Span], lo: float, hi: float) -> Dict[str, dict]:
    """Per span name: ``count``, ``host_s``, ``self_s``, ``device_s`` and
    ``idle_s`` (see the module docstring); device ops without a launch in
    the trace are left out. The window [lo, hi] bounds the idle gaps."""
    import numpy as np

    if not program:  # a port without spans
        return {}
    out = {n: {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
               "idle_s": 0.0} for n in sorted({n for n, _, _ in program})}
    parent, times, owner = nesting(program)
    for k, (n, s, e) in enumerate(program):
        out[n]["count"] += 1
        out[n]["host_s"] += e - s
        out[n]["self_s"] += e - s
        if parent[k] >= 0:
            out[program[parent[k]][0]]["self_s"] -= e - s
    times, owner = np.array(times), np.array(owner, dtype=np.int64)

    def innermost(t):
        i = np.searchsorted(times, t, side="right") - 1
        return np.where(i >= 0, owner[np.maximum(i, 0)], -1)

    def chain(k: int) -> set:
        names = set()
        while k >= 0:
            names.add(program[k][0])
            k = parent[k]
        return names

    launched = [(launches[o[4]], o[1], o[2]) for o in device_ops
                if o[4] in launches]
    if launched:
        ks = innermost(np.array([x[0] for x in launched]))
        ops: Dict[str, list] = {n: [] for n in out}
        for k in np.unique(ks[ks >= 0]):
            mine = [launched[i][1:] for i in np.flatnonzero(ks == k)]
            for n in chain(int(k)):
                ops[n].extend(mine)
        for n, ivs in ops.items():
            out[n]["device_s"] = sum(e - s for s, e in
                                     tr.merged(ivs, -np.inf, np.inf))
    idle = tr.gaps(device_ops, lo, hi)
    if idle:
        ks = innermost(np.array([0.5 * (s + e) for s, e in idle]))
        for (s, e), k in zip(idle, ks):
            if k >= 0:
                out[program[k][0]]["idle_s"] += e - s
    return out


def per_step(table: Dict[str, dict]) -> Dict[str, dict]:
    """Each span's numbers over the steps: ``fit.loss_grad``'s count in a
    fit, ``joint.step``'s in training, in milliseconds."""
    for step in ("joint.step", "fit.loss_grad"):
        n = table.get(step, {}).get("count", 0)
        if n:
            return {name: {k: 1e3 * v / n for k, v in row.items()
                           if k != "count"}
                    for name, row in table.items()}
    return {}


def main(argv: List[str] = None) -> int:
    from portbench import harness, spec

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int)
    args = p.parse_args(argv)
    cell = spec.cell(spec.benchmark(), args.workload)
    traffic = spec.traffic(cell["traffic"])
    driver = spec.driver(traffic["driver"])
    if hasattr(driver, "measure"):
        print(f"portbench: {cell['name']} runs its units in other processes",
              file=sys.stderr)
        return 2
    ctx = harness.Context(spec.config(cell["config"]), traffic, args.seed,
                          "cuda", cell.get("chips", 1))
    state = driver.setup(ctx)
    units = args.units or traffic.get("trace_units", 1)

    def run():
        for i in range(units):
            driver.unit(state, -1 - i)

    cap = capture(run)
    lo, hi = cap["window"]
    table = spans(cap["device_ops"], cap["launches"], cap["spans"], lo, hi)
    ops = cap["device_ops"]
    print(json.dumps({
        "cell": cell["name"], "seed": args.seed, "units": units,
        "window_s": hi - lo, "busy_s": tr.busy_seconds(ops, lo, hi),
        # the device seconds whose launch the trace does not hold
        "unlaunched_s": sum(o[2] - o[1] for o in ops
                            if o[4] not in cap["launches"]),
        "spans": table, "per_step_ms": per_step(table)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
