"""Per-protocol time of the teaser harness (``awesome_tpu_torch/runner/
teaser.py``) on the card: steps, seconds, ms per step and the device's
idle share.

    python -m tools.teaser_profile --root TREE [--steps-scale 0.002]
        [--n-restarts 2] [--names N ...] [--results RESULTS.json
        --results-scale 1.0 [--skip-profile]]

For each protocol at ``--steps-scale`` (small: the profiler's trace of a
protocol holds every launch of every step): one run to warm up, one timed
run (host clock around synchronised work), then
``chip_smoke.device_profile`` (a warm-up and a run under
``torch.profiler``): the device's busy time is the sum of its kernels'
device time, the idle share 1 - busy / wall. The times cover the whole
protocol call (loading, the fits, the final evaluation and scoring). A
step is one optimizer step of any of the protocol's fits (the
flow-identity prefits' 100 included). With ``--results`` (a
``run_teasers`` results.json made at ``--results-scale``, 8 restarts) it
also prints that run's seconds, steps, ms per step and IoUs
(``--skip-profile``: only those). One JSON line per protocol; the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def protocol_steps(name: str, scale: float, n_restarts: int = 8) -> int:
    """The optimizer steps of one protocol call at ``scale``."""
    from awesome_tpu_torch.runner.teaser import _scaled

    s = lambda n: _scaled(n, scale)  # noqa: E731
    return {
        "convex_tomato": s(700),
        "star": s(1000) + s(9000),
        "rotation_symmetric": s(500) + s(9500),
        "repeating": n_restarts * s(10000),
        "convex_depth": s(5000),
        "connectedness_cat": n_restarts * s(6000),
        "howto_convexity": s(2000),
        "howto_path_connectedness": 100 + s(4000),
        "temporal_connectedness": 100 + 8 * s(2000),
    }[name]


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True,
                   help="the reference tree (AWESOME_REFERENCE_ROOT)")
    p.add_argument("--steps-scale", type=float, default=0.002)
    p.add_argument("--n-restarts", type=int, default=2)
    p.add_argument("--names", nargs="*", default=None)
    p.add_argument("--results", default=None)
    p.add_argument("--results-scale", type=float, default=1.0)
    p.add_argument("--skip-profile", action="store_true")
    args = p.parse_args(argv)

    import torch

    import chip_smoke
    from awesome_tpu_torch.runner import teaser as T

    if not torch.cuda.is_available():
        raise SystemExit("teaser_profile: no CUDA card")
    T.REFERENCE_ROOT = args.root
    T.TEASER_DIR = os.path.join(args.root, "notebooks", "icml_teaser_code")
    T.HOWTO_DIR = os.path.join(args.root, "notebooks", "how_to", "data")
    print(f"card: {chip_smoke.nvidia_smi_line()}", flush=True)
    full = {}
    if args.results:
        with open(args.results) as f:
            full = json.load(f)
    for name in args.names or T.TEASERS:
        out = {"name": name}
        if name in full and "seconds" in full[name]:
            n = protocol_steps(name, args.results_scale)
            out["full_run"] = {
                "steps_scale": args.results_scale, "steps": n,
                "seconds": full[name]["seconds"],
                "ms_per_step": 1e3 * full[name]["seconds"] / n,
                **{k: full[name][k] for k in (
                    "iou", "fill", "ref_fill", "naive_iou", "input_iou",
                    "naive_vs_ours_iou",
                    "phase_aligned_iou", "loss") if k in full[name]}}
        if not args.skip_profile:
            out.update(profile(T, name, args))
        print(json.dumps(out), flush=True)


def profile(T, name: str, args) -> dict:
    """One protocol at ``args.steps_scale``: warm-up, a timed run, then
    ``chip_smoke.device_profile``."""
    import torch

    import chip_smoke

    def run():
        kw = ({"n_restarts": args.n_restarts}
              if name in ("repeating", "connectedness_cat") else {})
        T.TEASERS[name](steps_scale=args.steps_scale, device="cuda", **kw)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    seconds = time.perf_counter() - t0
    steps = protocol_steps(name, args.steps_scale, args.n_restarts)
    ms = 1e3 * seconds / steps
    prof = chip_smoke.device_profile(run, steps, ms)
    prof.pop("top_device_ms_per_step", None)
    return {"steps_scale": args.steps_scale, "n_restarts": args.n_restarts,
            "steps": steps, "seconds": seconds, "ms_per_step": ms, **prof}


if __name__ == "__main__":
    main()
