"""One run of one cell: set-up, the measured window, the traced units,
the check against the plain reference, the metrics and the result line.

The window runs whole units of the cell's work (a fit, a batch of fits, a
training epoch), each ended by a device synchronize, from the first
unit's start to the end of the last unit that began before ``seconds``
ran out. With ``trace`` the metrics are the per-layer ones: the counters
and rates of that window, and what the profiler shows of further units run
after it under ``torch.profiler``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from portbench import counts, spec
from portbench import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "awesome_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is, whole, one of FORBIDDEN
    (``awesome_tpu_torch`` is not ``awesome_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's configuration and traffic, the seed,
    the device, the chips, and whether to run the control (the
    configuration's next lower precision) instead of the program as the
    configuration states it."""

    config: dict
    traffic: dict
    seed: int
    device: str
    chips: int = 1
    control: bool = False


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def counters() -> Dict[str, int]:
    """The port's launch and step counters."""
    from awesome_tpu_torch.fit.prior_fit import run_fit_loop
    from awesome_tpu_torch.ops.flagship import flagship_loss_grad_cuda
    from awesome_tpu_torch.ops.mlp import (
        icnn_backward_cuda,
        icnn_forward_cuda,
    )

    return {"flagship": flagship_loss_grad_cuda.launches,
            "flagship_bf16": flagship_loss_grad_cuda.launches_bf16,
            "icnn_fwd": icnn_forward_cuda.launches,
            "icnn_bwd": icnn_backward_cuda.launches,
            "fit_steps": run_fit_loop.steps}


def run_cell(cell: dict, config: dict, traffic: dict, limits: Dict[str, float],
             seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, control: bool = False) -> dict:
    """Set up, measure, trace, check. Returns the run's record: the window,
    the counters, the trace, the compared numbers with their limits, and
    ``correct``. A driver with its own ``measure`` (one that runs its
    window in other processes) does the first three itself."""
    t_start = time.perf_counter() if t_start is None else t_start
    driver = spec.driver(traffic["driver"])
    ctx = Context(config, traffic, seed, device, cell.get("chips", 1),
                  control)
    if hasattr(driver, "measure"):
        record, state = driver.measure(ctx, seconds, trace,
                                       time.time() - (time.perf_counter()
                                                      - t_start))
    else:
        state = driver.setup(ctx)
        sync(device)
        setup_s = time.perf_counter() - t_start
        record = measure(driver, state, ctx, seconds, trace)
        record["setup_s"] = setup_s
    record["cell"] = cell["name"]
    return judge(driver, state, record, limits)


def measure(driver, state, ctx: Context, seconds: float, trace: bool,
            agree: Callable[[bool], bool] = lambda go: go,
            start: Optional[Callable[[], Any]] = None) -> dict:
    """The window of whole units, its counters and peak memory, then the
    traced units. ``agree`` makes every rank of a mesh take rank 0's
    decision to start another unit; ``start`` runs under the profiler just
    before the traced units (a mesh's barrier)."""
    import torch

    record: Dict[str, Any] = {"chips": ctx.chips}
    before = counters()
    units: List[dict] = []
    t0 = time.perf_counter()
    while not units or agree(time.perf_counter() - t0 < seconds):
        units.append(driver.unit(state, len(units)))
    record["window_s"] = time.perf_counter() - t0
    after = counters()
    record["counters"] = {k: after[k] - before[k] for k in after}
    for key in ("work", "steps", "flops", "attempts"):
        record[key] = sum(u[key] for u in units)
    record["kind"] = units[0]["kind"]
    record["units"] = len(units)
    record["bounds"] = driver.bounds(state)
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if ctx.device.startswith("cuda") else 0)
    t1 = time.perf_counter()
    if trace:
        record["trace"] = traced(driver, state, ctx.traffic, start)
    record["trace_phase_s"] = time.perf_counter() - t1
    return record


def judge(driver, state, record: dict, limits: Dict[str, float]) -> dict:
    """Note the JAX-side modules loaded here (beside those a mesh's ranks
    found in theirs), drop the program's state, then compare what it
    produced with the reference: the numbers, their limits, ``failed`` and
    ``correct``."""
    import torch

    record["forbidden"] = sorted(set(record.get("forbidden", []))
                                 | set(forbidden_modules()))
    driver.release(state)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    record["failed"] = driver.failed(state)
    found = driver.check(state)
    record["phases_s"] = {"setup": record["setup_s"],
                          "window": record["window_s"],
                          "trace": record["trace_phase_s"],
                          "check": time.perf_counter() - t2}
    record["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in found.items()}
    record["correct"] = bool(found) and all(
        math.isfinite(v) and v <= limits[k] for k, v in found.items()) \
        and record["failed"] == 0
    return record


def traced(driver, state, traffic: dict,
           start: Optional[Callable[[], Any]] = None) -> dict:
    """``trace_units`` more units under the profiler: the device's busy
    seconds in the traced window, each kernel's launches and seconds,
    NCCL's seconds, and the breakdown."""
    def run():
        for i in range(traffic.get("trace_units", 1)):
            driver.unit(state, -1 - i)

    cap = tr.capture(run, start)
    lo, hi = cap["window"]
    ops = cap["device_ops"]
    return {"window_s": hi - lo, "busy_s": tr.busy_seconds(ops, lo, hi),
            "kernels": counts.per_kernel(ops),
            "nccl_s": sum(e - s for n, s, e, _ in ops
                          if counts.kernel_of(n) == "nccl"),
            "breakdown": tr.breakdown(ops, cap["host_ops"], lo, hi)}


def metrics(bench: dict, record: dict, trace: bool) -> Dict[str, dict]:
    out = {}
    for m in spec.metrics_of(bench, record["cell"], trace):
        value = spec.reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench: dict, record: dict, trace: bool, kind: str) -> dict:
    device = {"platform": "gpu", "kind": kind, "count": record["chips"],
              "memory_peak_bytes": int(record["memory_peak_bytes"])}
    line = {"correct": record["correct"], "attempted": record["attempts"],
            "failed": record["failed"],
            "metrics": metrics(bench, record, trace), "device": device}
    if trace:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
        line["breakdown"] = record["trace"]["breakdown"]
    line["checks"] = record["checks"]
    return line


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None,
         run: Callable[..., dict] = run_cell) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA card", 3)
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{cell['name']} needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} found", 3)
    record = run(cell, config, traffic, limits, args.seed, args.seconds,
                 bool(args.trace), "cuda", t_start)
    bad = sorted(set(record["forbidden"]) | set(forbidden_modules()))
    if bad:
        return fail(f"modules of the JAX side loaded: {', '.join(bad)}", 4)
    line = result_line(bench, record, bool(args.trace),
                       torch.cuda.get_device_name(0))
    print("phases " + " ".join(f"{k} {v:.1f} s" for k, v in
                               record["phases_s"].items()), file=sys.stderr)
    for name, c in record["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
