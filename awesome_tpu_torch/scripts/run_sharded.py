"""Experiment fan-out: shard a directory of configs across processes or
hosts; counterpart of ``scripts/run_sharded.py``.

The reference scales out by writing SLURM job files
(`awesome/run/multi_runner.py:106-236`). Here a device mesh parallelizes
ONE experiment (``mesh_shape``); across processes or hosts this script
shards the job list deterministically (``runner/multi.py:shard_jobs``):
no scheduler files, no shared queue, and any shard can be re-run.

Modes
-----
worker (default)::

    python -m awesome_tpu_torch.scripts.run_sharded --config-dir CFGS \\
        --num-shards 4 --shard-id 1 --runs-path runs/sweep

  runs this shard's configs in this process (on ``cuda:{shard %
  device_count}``, or the CPU with ``--device cpu``), writes each run
  under ``--runs-path`` and the shard manifest ``shard_1.json``.

local fan-out::

    python -m awesome_tpu_torch.scripts.run_sharded --config-dir CFGS \\
        --num-shards 2 --spawn --runs-path runs/sweep

  starts ``--num-shards`` worker processes on disjoint shards (CUDA
  processes share a card), waits, then aggregates.

multi-host (one worker per host)::

    python -m awesome_tpu_torch.scripts.run_sharded ... \\
        --coordinator host:1234 --num-processes 4 --process-id $ID

  the shard id defaults to the process id; the workers meet at a "workers
  done" barrier on a ``torch.distributed.TCPStore`` served by process 0
  (no process group: the default group stays free for a job's own mesh),
  then process 0 aggregates.

aggregate::

    python -m awesome_tpu_torch.scripts.run_sharded --runs-path runs/sweep \\
        --aggregate-only

  merges every finished run under ``--runs-path`` into one
  ``ResultComparison`` table, ``comparison.md``.
"""
from __future__ import annotations

import argparse
import datetime
import glob
import json
import os
import subprocess
import sys
from typing import Optional

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_config_file(path: str, device: Optional[str] = None):
    """A config YAML (this package's, the JAX package's, or an unmodified
    reference YAML), read as ``python -m awesome_tpu_torch.run`` reads
    it."""
    from awesome_tpu_torch.run import get_config

    argv = ["--config-path", path]
    if device is not None:
        argv += ["--device", device]
    return get_config(argv)


def run_worker(args) -> dict:
    """Run this shard's configs; a failing config is recorded and the
    shard goes on (the reference's job files are independent)."""
    from awesome_tpu_torch import run as run_mod
    from awesome_tpu_torch.runner.multi import MultiConfigRunner, shard_jobs

    device = "cpu"
    if args.device != "cpu":
        import torch

        torch.cuda.set_device(args.shard_id % torch.cuda.device_count())
        device = f"cuda:{torch.cuda.current_device()}"
    jobs = MultiConfigRunner(args.config_dir).create_jobs()
    mine = shard_jobs(jobs, args.num_shards, args.shard_id)
    manifest = {"shard_id": args.shard_id, "num_shards": args.num_shards,
                "device": device, "jobs": [], "failures": []}
    os.makedirs(args.runs_path, exist_ok=True)
    for _, argv in mine:
        cfg_path = argv[argv.index("--config-path") + 1]
        try:
            cfg = load_config_file(
                cfg_path, "cpu" if args.device == "cpu" else None)
            cfg.runs_path = args.runs_path
            run_mod.main(cfg)
            manifest["jobs"].append(cfg_path)
        except Exception as e:  # noqa: BLE001
            manifest["failures"].append({"config": cfg_path,
                                         "error": repr(e)})
    out = os.path.join(args.runs_path, f"shard_{args.shard_id}.json")
    with open(out, "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def aggregate(runs_path: str) -> str:
    """Merge every finished run directory into one ``ResultComparison``
    markdown table (last- and best-epoch selections)."""
    from awesome_tpu_torch.analytics.result_model import (
        ResultComparison,
        ResultModel,
    )

    run_dirs = sorted(
        os.path.dirname(p)
        for p in glob.glob(os.path.join(runs_path, "*", "tracker.json")))
    results = [ResultModel.from_path(d, device="cpu") for d in run_dirs]
    out = os.path.join(runs_path, "comparison.md")
    with open(out, "w") as f:
        f.write(f"# Sharded sweep results ({len(results)} runs)\n\n")
        for selection in ("last", "best"):
            f.write(f"## {selection}-epoch selection\n\n")
            if results:
                table = ResultComparison(results).table(selection=selection)
                f.write(table.to_markdown(index=False))
            f.write("\n\n")
    return out


def spawn_local(args) -> None:
    """One worker process per shard, on disjoint job sets."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _PACKAGE_ROOT + os.pathsep + env.get("PYTHONPATH",
                                                             "")
    base = [sys.executable, "-m", "awesome_tpu_torch.scripts.run_sharded",
            "--config-dir", args.config_dir,
            "--num-shards", str(args.num_shards),
            "--runs-path", args.runs_path, "--device", args.device,
            "--no-aggregate"]
    procs = [subprocess.Popen(base + ["--shard-id", str(sid)], env=env)
             for sid in range(args.num_shards)]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise SystemExit(f"worker shard(s) failed: rcs={rcs}")


def workers_done_barrier(coordinator: str, num_processes: int,
                         process_id: int, timeout_hours: float = 12.0
                         ) -> None:
    """Block until every process has finished its shard: each sets its
    key on process 0's ``TCPStore`` and waits for all keys; process 0
    (the store's server) leaves last, once every other has seen them."""
    import torch.distributed as dist

    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(
        host, int(port), world_size=num_processes,
        is_master=process_id == 0,
        timeout=datetime.timedelta(hours=timeout_hours))
    store.set(f"done_{process_id}", "1")
    store.wait([f"done_{i}" for i in range(num_processes)])
    if process_id == 0:
        store.wait([f"left_{i}" for i in range(1, num_processes)])
    else:
        store.set(f"left_{process_id}", "1")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config-dir", type=str, default=None)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--shard-id", type=int, default=None)
    p.add_argument("--runs-path", type=str, default="runs/sharded")
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="the workers' device: the cards round robin, or "
                        "the CPU")
    p.add_argument("--spawn", action="store_true",
                   help="fan out --num-shards local worker processes")
    p.add_argument("--aggregate-only", action="store_true")
    p.add_argument("--no-aggregate", action="store_true")
    # multi-host coordinates: process 0 serves the barrier's TCPStore
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)

    if args.aggregate_only:
        print("wrote", aggregate(args.runs_path))
        return
    if args.coordinator:
        if args.shard_id is None:
            args.shard_id = args.process_id
        if args.num_shards == 1:
            args.num_shards = args.num_processes
    if args.spawn:
        spawn_local(args)
        if not args.no_aggregate:
            print("wrote", aggregate(args.runs_path))
        return
    if args.shard_id is None:
        args.shard_id = 0
    manifest = run_worker(args)
    print(json.dumps({k: manifest[k] for k in ("shard_id", "jobs",
                                               "failures")}))
    if args.coordinator:
        workers_done_barrier(args.coordinator, args.num_processes,
                             args.process_id)
        if not args.no_aggregate and args.process_id == 0:
            print("wrote", aggregate(args.runs_path))
    elif (not args.no_aggregate and args.shard_id == 0
          and args.num_shards == 1):
        print("wrote", aggregate(args.runs_path))


if __name__ == "__main__":
    main()
