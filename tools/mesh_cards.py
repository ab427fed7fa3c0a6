"""The device mesh across cards: one rank per card over NCCL, held to one
process at the smoke's tolerances (``chip_smoke.mesh_path``'s rules).

    python3 -m tools.mesh_cards --cards 4 [--out FILE.jsonl]
    CUDA_VISIBLE_DEVICES=0,1 python3 -m tools.mesh_cards --cards 2
    python3 -m tools.mesh_cards --cards 4 --cases run_spawn run_torchrun

The matrix, for ``--cards`` C (2 or 4), each case one JSON line:

- ``ranks``: C ranks started by ``parallel.launch.spawn``, one per card.
  Each builds the kernel libraries first (on a cold checkout every rank
  compiles, as a cold ``torchrun`` start does: ``build``). Rank 0 takes
  the single-process references on card 0 while the others wait. Then
  every rank runs the smoke's sharded fused fit (bench model, 4 x
  480x640, the gate, ``MESH_STEPS`` steps; K2 per rank) on each mesh of
  ``MESHES[C]`` and one K2 step at the inits and at the fitted params,
  times the grid ``all_reduce`` of its (G, P + 1) row and sums a seeded
  row over each axis twice (every rank of a group must hold the same
  bits, and so must the two calls), holds K2 at its shape against the
  plain version on its card and times both; the convexity runner on the
  same meshes (K4/K5 per rank, timed and checked on the rank's card
  likewise); and a (C // 2, 2) joint-step run saved after 2 of 4 steps,
  loaded and stepped on, which must equal the uninterrupted run in every
  bit.
- ``dryrun``: ``dryrun_multichip(C)``.
- ``run_spawn`` and ``run_torchrun``: ``python -m awesome_tpu_torch.run
  --mesh-shape "[C // 2, 2]"``, started by the entry point and by
  ``torchrun --standalone``; each writes one run folder.
- ``run_sharded``: ``run_sharded --spawn`` with C workers on C configs:
  disjoint shards on C cards, one ``comparison.md``.
- with ``--cards 2`` also ``smoke``: the smoke's own mesh phase (two
  ranks) and its kernel entries.

Every case checks the backend rule: NCCL, a card of its own per rank
(``chip_smoke._check_where``), and, but for ``smoke``, nvidia-smi's view
while it runs (:meth:`CardWatch.check`): never more CUDA contexts on the
machine than ranks (so none in this process, which never touches a
card, and no rank's on another card) and the C cards in use. The tool
exits non-zero when fewer cards are present than ``--cards`` asks for,
or when any check fails. The cards' name and power limit come first.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

MESHES = {2: ((2, 1), (1, 2)), 4: ((4, 1), (2, 2), (1, 4))}
PROFILE_STEPS = 20  # steps of the profiled fit on the first mesh
K2_REPLACES = "awesome_tpu/ops/pallas_flagship.py:236"


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The fit's image shape and steps, the runner's epochs and pretrain
    steps, and the timing repeats of K2 (the smoke's by default)."""
    fit_shape: tuple = cs.MESH_SHAPE
    steps: int = cs.MESH_STEPS
    epochs: int = cs.MESH_RUNNER_EPOCHS
    pretrain: int = cs.MESH_RUNNER_PRETRAIN
    k2_reps: int = 10


def _digest(arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


# a card holding a CUDA context shows at least this much memory in use
BUSY_MIB = 200.0


def _number(text: str) -> Optional[float]:
    try:
        return float(text)
    except ValueError:  # "[N/A]" where the machine hides it
        return None


def card_view() -> dict:
    """What ``nvidia-smi`` sees now: the compute processes on the machine
    (each process once per card it holds a context on), and per card
    (by index) its memory in use and, where nvidia-smi can name the card
    of a process (its UUID), that card's processes (else ``None``)."""
    def query(what):
        res = subprocess.run(["nvidia-smi", f"--query-{what}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        if res.returncode != 0:
            raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
        return [[x.strip() for x in line.split(",")]
                for line in res.stdout.splitlines() if line.strip()]

    cards = query("gpu=index,uuid,memory.used")
    apps = [row[0] for row in query("compute-apps=gpu_uuid")]
    named = len({u for _, u, _ in cards}) == len(cards) and all(
        a in {u for _, u, _ in cards} for a in apps)
    return {"processes": len(apps), "cards": {
        int(i): {"used_mib": _number(m),
                 "processes": apps.count(u) if named else None}
        for i, u, m in cards}}


class CardWatch:
    """Samples :func:`card_view` about once a second while a case runs."""

    def __init__(self):
        self.views: List[dict] = []
        self.error: Optional[Exception] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                self.views.append(card_view())
            except (RuntimeError, subprocess.TimeoutExpired) as err:
                self.error = err  # raised by check
                return
            self._stop.wait(1.0)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=120)

    def check(self, cards: int, what: str, all_at_once: bool = False
              ) -> dict:
        """One CUDA context per rank on a card of its own: never more
        compute processes on the machine than ``cards`` (so none of this
        process and no rank's second context; exactly ``cards`` at some
        sample with ``all_at_once``), no card holding two at once where
        nvidia-smi names their cards, and the first ``cards`` cards, and
        only they, in use at some sample (where it shows memory)."""
        if self.error is not None:
            raise AssertionError(f"{what}: {self.error!r}")
        if not self.views:
            raise AssertionError(f"{what}: no nvidia-smi sample")
        most = max(v["processes"] for v in self.views)
        cells = [(c, x) for v in self.views for c, x in v["cards"].items()]
        named = all(x["processes"] is not None for _, x in cells)
        shown = all(x["used_mib"] is not None for _, x in cells)
        # a card is in use when it holds a process, or, where nvidia-smi
        # does not name a process's card, when its memory is in use
        busy = sorted({c for c, x in cells if (
            x["processes"] > 0 if named else
            shown and x["used_mib"] >= BUSY_MIB)})
        peak = {c: (max(x["processes"] or 0 for d, x in cells if d == c),
                    max(x["used_mib"] or 0.0 for d, x in cells if d == c))
                for c, _ in cells}
        if most > cards or (all_at_once and most != cards) or any(
                (x["processes"] or 0) > 1 for _, x in cells) or (
                    (named or shown) and busy != list(range(cards))):
            raise AssertionError(
                f"{what}: at most {most} compute processes at once, cards "
                f"in use {busy}; per card the most processes and MiB "
                f"{peak} over {len(self.views)} samples")
        return {"most_processes_at_once": most, "cards_in_use": busy,
                "cards_of_processes_shown": named,
                "most_processes_and_mib_per_card": {
                    str(c): v for c, v in peak.items()},
                "samples": len(self.views)}


# --- one rank of the ``ranks`` case ------------------------------------------


def _builds() -> dict:
    """Each kernel library's load time in this process, and whether this
    process compiled it (no build of its source and flags existed)."""
    from awesome_tpu_torch.ops import build, flagship, mlp

    out = {}
    for lib in (flagship.LIBRARY, mlp.LIBRARY):
        cold = not build.library_path(lib.source).exists()
        t0 = time.perf_counter()
        lib.get()
        out[lib.source] = {"cold": cold,
                           "seconds": time.perf_counter() - t0}
    return out


def _peak_gib(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def _single(root: str, sizes: Sizes, device: str) -> dict:
    """The single-process references, on this process's card."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    fit = cs.mesh_fit(device, None, shape=sizes.fit_shape,
                      steps=sizes.steps)
    fit["peak_gib"] = _peak_gib(None)
    _again(fit, cs.mesh_fit(device, None, shape=sizes.fit_shape,
                            steps=sizes.steps))
    fit.update(cs.mesh_steps(device, None, fit["params"],
                             shape=sizes.fit_shape))
    torch.cuda.reset_peak_memory_stats()
    runner = cs.mesh_runner(device, os.path.join(root, "runner_single"),
                            epochs=sizes.epochs, pretrain=sizes.pretrain)
    runner["peak_gib"] = _peak_gib(None)
    return {"fit": fit, "runner": runner}


def _again(first: dict, again: dict) -> None:
    """Record a second fit of the same inputs beside the first: its
    seconds, and whether its params are the first's in every bit."""
    first["again_seconds"] = again["seconds"]
    first["repeat_bitwise"] = all(
        np.array_equal(a, b) for a, b in zip(first["params"],
                                             again["params"]))


def _reductions(mesh, rows: int, cols: int) -> dict:
    """Per mesh axis of more than one rank: the digests of two sums of a
    (rows, cols) float32 row seeded by this rank, and the group's id (the
    other axis's coordinate)."""
    import torch

    out = {}
    for axis, other in (("data", "grid"), ("grid", "data")):
        if mesh.shape[axis] == 1:
            continue
        gen = torch.Generator(device=mesh.device).manual_seed(
            1000 + mesh.rank)
        row = torch.randn((rows, cols), generator=gen, device=mesh.device)
        sums = [mesh.sum_over(axis, row).cpu().numpy() for _ in range(2)]
        out[axis] = {"group": mesh.coords[other],
                     "digests": [_digest([s]) for s in sums]}
    return out


def _fit_case(shape, at, sizes: Sizes, root_rank: bool, device: str,
              profile: bool = False) -> dict:
    import torch

    from awesome_tpu_torch.ops.flagship import FlagshipSpec, launch_shape
    from awesome_tpu_torch.parallel import make_mesh

    mesh = make_mesh(shape)
    dev = mesh.device
    d, g = shape
    torch.cuda.reset_peak_memory_stats(dev)
    res = cs.mesh_fit(device, mesh, shape=sizes.fit_shape, steps=sizes.steps)
    res["peak_gib"] = _peak_gib(dev)
    # the first fit pays each new communicator's first collectives
    _again(res, cs.mesh_fit(device, mesh, shape=sizes.fit_shape,
                            steps=sizes.steps))
    if profile:
        steps = PROFILE_STEPS
        res["profile"] = cs.device_profile(
            lambda: cs.mesh_fit(device, mesh, shape=sizes.fit_shape,
                                steps=steps), 2 * steps,
            1e3 * res["again_seconds"] / (2 * sizes.steps))
    res.update(cs.mesh_steps(device, mesh, at, shape=sizes.fit_shape))
    res["where"] = cs._where(mesh)
    res["digest"] = _digest(res["params"] + [res["loss_hist"],
                                             res["gate_iou"]])
    model = cs.bench_model(sizes.fit_shape, device)
    spec = FlagshipSpec.of(model)
    b, n = len(cs.MESH_SHIFTS), sizes.fit_shape[0] * sizes.fit_shape[1]
    bl = b // d if mesh.splits("data", b) else b
    nl = n // g if mesh.splits("grid", n) else n
    cols = spec.offsets()[1] + 1
    if g > 1:
        res["allreduce_ms"] = cs.allreduce_ms(mesh, bl, cols)
    res["reductions"] = _reductions(mesh, bl, cols)
    res["bitwise_expected"] = g == 1 and launch_shape(
        spec, n, bl, None, dev) == launch_shape(spec, n, b, None, dev)
    res["K2"] = cs.kernel_entry(
        f"flagship_loss_grad (K2, G={bl} x {nl} points per rank, mesh "
        f"({d}, {g}), {dev})", K2_REPLACES, model, nl, bl, 25 + d,
        res["k2"], res["k2"], sizes.k2_reps, device)
    if not root_rank:
        res = {k: v for k, v in res.items()
               if k not in ("params", "loss_hist", "gate_iou", "step_init",
                            "step_fitted")}
    return res


def _runner_case(root: str, shape, sizes: Sizes, device: str) -> dict:
    import torch

    d, g = shape
    torch.cuda.reset_peak_memory_stats()
    res = cs.mesh_runner(device, os.path.join(root, f"runner_{d}x{g}"),
                         list(shape), sizes.epochs, sizes.pretrain)
    res["peak_gib"] = _peak_gib(None)
    res["digest"] = _digest([res["loss_hist"]])
    card = (f"cuda:{torch.cuda.current_device()}" if device == "cuda"
            else device)
    pts, images = res["padded_points"], len(cs.RUNNER_SHAPES)
    local_n = pts // g if pts % g == 0 else pts
    local_g = images // d if images % d == 0 else images
    res["K4_K5"] = cs.icnn_entries(
        res["k4"], res["k5"], sizes.epochs, 50, device, n=local_n,
        g=local_g, per_image=True,
        tag=f", G={local_g} x {local_n} points per rank, runner mesh "
        f"({d}, {g}), {card}", seed=27 + d)
    return res


def _resume_case(root: str, shape) -> dict:
    """A (data, grid) joint-step run (the dry run's) saved after 2 of 4
    steps by rank 0, loaded on every rank and stepped on, against the
    uninterrupted run."""
    import torch

    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.checkpoint import AgentCheckpoint
    from awesome_tpu_torch.fit.trainer import make_joint_train_step
    from awesome_tpu_torch.parallel import make_mesh
    from awesome_tpu_torch.parallel.dryrun import joint_step_inputs

    mesh = make_mesh(shape)
    wrapper, cfg, state0, batch = joint_step_inputs(shape[0], mesh.device)
    step = make_joint_train_step(wrapper, cfg, mesh=mesh)
    s = state0
    for _ in range(4):
        s, _ = step(s, batch)
    straight = T.tree_leaves(s)
    s = state0
    for _ in range(2):
        s, _ = step(s, batch)
    ck = os.path.join(root, "resume_ck")
    if mesh.is_root:
        AgentCheckpoint("resume", params=s).save(ck)
    mesh.barrier()
    s = AgentCheckpoint.load(ck, params_template=state0,
                             device=mesh.device).params
    for _ in range(2):
        s, _ = step(s, batch)
    resumed = T.tree_leaves(s)
    return {"shape": list(shape), "leaves": len(resumed),
            "differing_leaves": [i for i, (a, b) in enumerate(
                zip(straight, resumed)) if not torch.equal(a, b)],
            "digest": _digest([x.cpu().numpy() for x in straight])}


def rank_cases(root: str, cards: int, sizes: Sizes, device: str = "cuda"
               ) -> dict:
    """One rank of the ``ranks`` case (see the module's docstring), on the
    card the launch made current (``device``: its kind)."""
    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {"pid": os.getpid(), "build": _builds()}
    go = os.path.join(root, "go.npz")
    if rank == 0:
        out["single"] = _single(root, sizes, device)
        at = out["single"]["fit"]["params"]
        np.savez(go + ".tmp.npz", **{f"a{i}": a for i, a in enumerate(at)})
        os.rename(go + ".tmp.npz", go)
    while not os.path.exists(go):  # card 0 is the references' until then
        time.sleep(0.05)
    with np.load(go) as f:
        at = [f[f"a{i}"] for i in range(len(f.files))]
    for i, shape in enumerate(MESHES[cards]):
        out[f"fit_{shape[0]}x{shape[1]}"] = _fit_case(
            shape, at, sizes, rank == 0, device, profile=i == 0)
    for shape in MESHES[cards]:
        out[f"runner_{shape[0]}x{shape[1]}"] = _runner_case(root, shape,
                                                            sizes, device)
    out["resume"] = _resume_case(root, (cards // 2, 2))
    out["peak_gib"] = _peak_gib(torch.cuda.current_device())
    return out


# --- the checks, in this process (which never touches a card) ----------------


def check_placement(ranks: List[dict], cards: int) -> list:
    """Rank r on ``cuda:r`` over NCCL, by the backend rule."""
    key = "fit_%dx%d" % MESHES[cards][0]
    where = cs._check_where([r[key]["where"] for r in ranks], "ranks")
    if where != [{"backend": "nccl", "device": f"cuda:{r}"}
                 for r in range(cards)]:
        raise AssertionError(f"ranks: {where}, not rank r on cuda:r over "
                             "NCCL")
    return where


def check_same_bits(ranks: List[dict], key: str) -> str:
    """Every rank's ``key`` digest is rank 0's."""
    digests = [r[key]["digest"] for r in ranks]
    if len(set(digests)) != 1:
        raise AssertionError(f"{key}: the ranks' results differ: {digests}")
    return digests[0]


def check_reductions(ranks: List[dict], key: str) -> dict:
    """Within every group of every axis, one sum in every bit, and two
    calls alike."""
    groups: Dict[tuple, set] = {}
    for r in ranks:
        for axis, red in r[key]["reductions"].items():
            a, b = red["digests"]
            if a != b:
                raise AssertionError(f"{key}: two {axis} sums differ")
            groups.setdefault((axis, red["group"]), set()).add(a)
    if any(len(d) != 1 for d in groups.values()):
        raise AssertionError(f"{key}: ranks of a group hold different "
                             f"sums: {groups}")
    return {"groups": len(groups), "bitwise_on_every_rank": True,
            "bitwise_repeat": True}


def check_fits(ranks: List[dict], cards: int, sizes: Sizes) -> dict:

    single = ranks[0]["single"]["fit"]
    n = sizes.fit_shape[0] * sizes.fit_shape[1]
    out = {"shape": list(sizes.fit_shape), "images": len(cs.MESH_SHIFTS),
           "steps": sizes.steps, "single_s": single["seconds"],
           "single_ms_per_step": 1e3 * single["seconds"] / single["k2"],
           "single_again_ms_per_step": 1e3 * single["again_seconds"]
           / single["k2"], "single_peak_gib": single["peak_gib"]}
    _check_repeat(single, "single fit")
    for shape in MESHES[cards]:
        key = f"fit_{shape[0]}x{shape[1]}"
        entry = cs.mesh_fit_entry(single, ranks, shape, n, sizes.steps,
                                  ranks[0][key]["bitwise_expected"])
        entry["same_bits_on_every_rank"] = bool(check_same_bits(ranks, key))
        entry["reductions"] = check_reductions(ranks, key)
        for r in ranks:
            _check_repeat(r[key], key)
        entry["again_ms_per_step"] = 1e3 * max(
            r[key]["again_seconds"] for r in ranks) / single["k2"]
        entry["speedup"] = out["single_ms_per_step"] / entry["ms_per_step"]
        entry["again_speedup"] = (out["single_again_ms_per_step"]
                                  / entry["again_ms_per_step"])
        if "profile" in ranks[0][key]:
            entry["rank0_profile"] = ranks[0][key]["profile"]
        entry["peak_gib_per_card"] = [r[key]["peak_gib"] for r in ranks]
        entry["K2_per_card"] = [_kernel_record(r[key]["K2"])
                                for r in ranks]
        out[key] = entry
    return out


def _check_repeat(res: dict, what: str) -> None:
    if not res["repeat_bitwise"]:
        raise AssertionError(f"{what}: a second fit of the same inputs "
                             "differs from the first")


def check_runners(ranks: List[dict], cards: int, sizes: Sizes) -> dict:

    single = ranks[0]["single"]["runner"]
    out = {"epochs": sizes.epochs, "pretrain_steps": sizes.pretrain,
           "single_s": single["seconds"],
           "padded_points": single["padded_points"]}
    for shape in MESHES[cards]:
        key = f"runner_{shape[0]}x{shape[1]}"
        entry = cs.mesh_runner_entry(single, ranks, shape, sizes.epochs)
        entry["same_bits_on_every_rank"] = bool(check_same_bits(ranks, key))
        entry["peak_gib_per_card"] = [r[key]["peak_gib"] for r in ranks]
        entry["K4_K5_per_card"] = [[_kernel_record(e) for e in r[key]
                                    ["K4_K5"]] for r in ranks]
        out[key] = entry
    return out


def check_resume(ranks: List[dict]) -> dict:
    res = ranks[0]["resume"]
    for r in ranks:
        if r["resume"]["differing_leaves"]:
            raise AssertionError(f"resume: leaves "
                                 f"{r['resume']['differing_leaves']} differ "
                                 "from the uninterrupted run")
    check_same_bits(ranks, "resume")
    return {"shape": res["shape"], "leaves": res["leaves"],
            "bitwise": True, "same_bits_on_every_rank": True}


def _kernel_record(e: dict) -> dict:
    return {k: e[k] for k in ("name", "launches", "max_abs_err", "ms",
                              "plain_ms", "bound_ms", "bound_by")}


def run_ranks(cards: int, root: str, sizes: Sizes = Sizes()) -> List[dict]:
    """Start the ``ranks`` case's ``cards`` ranks in a fresh ``root``;
    their results."""
    from awesome_tpu_torch.parallel.launch import spawn

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return spawn(rank_cases, cards, (root, cards, sizes), device="cuda")


# --- the cases that start their own processes --------------------------------


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _entry_config(path: str, runs: str) -> None:
    from awesome_tpu_torch.runner.config import AwesomeConfig
    from awesome_tpu_torch.serialization.jsonconv import save_yaml

    save_yaml(AwesomeConfig(
        name_experiment="mesh_cards", dataset_args={"n": 4, "h": 16,
                                                    "w": 16},
        segmentation_model_args={"n_hidden": 16},
        prior_model_args={"n_hidden": 12, "n_hidden_layers": 1},
        optimizer_type="adam", optimizer_args={"lr": 0.02}, num_epochs=20,
        pretrain_args={"num_epochs": 10}, runs_path=runs, seed=5,
        device="cuda"), path)


def _run(cmd: List[str], what: str, timeout: float = 900.0) -> tuple:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: rc {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
    return proc, time.perf_counter() - t0


def entry_point_case(root: str, cards: int, torchrun: bool) -> dict:
    """``python -m awesome_tpu_torch.run`` on a (cards // 2, 2) mesh,
    started by the entry point itself or by ``torchrun --standalone``:
    NCCL with a card per rank, one run folder, its training losses."""
    from awesome_tpu_torch.analytics.result_model import ResultModel

    shape = (cards // 2, 2)
    name = "torchrun" if torchrun else "spawn"
    runs = os.path.join(root, f"run_{name}")
    path = os.path.join(root, f"run_{name}.yaml")
    spawned = os.path.join(root, "run_spawn.json")
    shutil.rmtree(runs, ignore_errors=True)
    if not torchrun and os.path.exists(spawned):
        os.remove(spawned)
    os.makedirs(root, exist_ok=True)
    _entry_config(path, runs)
    cmd = [sys.executable, "-m", "awesome_tpu_torch.run", "--config-path",
           path, "--mesh-shape", f"[{shape[0]}, {shape[1]}]"]
    if torchrun:
        cmd[1:1] = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(cards)]
    with CardWatch() as watch:
        proc, seconds = _run(cmd, f"run ({name})")
    want = (f"mesh: (data={shape[0]}, grid={shape[1]}) on nccl (a card per "
            "rank)")
    if want not in proc.stdout:
        raise AssertionError(f"run ({name}): no '{want}' in its output")
    folders = os.listdir(runs)
    if len(folders) != 1:
        raise AssertionError(f"run ({name}): run folders {folders}")
    _, losses = ResultModel.from_path(os.path.join(runs, folders[0]),
                                      device="cpu").metric_series(
                                          "Loss", "train")
    losses = np.asarray(losses, dtype=np.float64)
    if len(losses) != 20 or not np.isfinite(losses).all():
        raise AssertionError(f"run ({name}): training losses {losses}")
    out = {"case": f"run_{name}", "mesh": list(shape), "seconds": seconds,
           "run_folders": 1, "losses": losses.tolist(),
           "cards": watch.check(cards, f"run ({name})")}
    if not torchrun:
        with open(spawned, "w") as f:
            json.dump(out["losses"], f)
    elif os.path.exists(spawned):
        # the same mesh on the same cards: the spawned run's losses
        with open(spawned) as f:
            other = np.asarray(json.load(f))
        np.testing.assert_allclose(losses, other, rtol=cs.MESH_RUNNER_RTOL,
                                   atol=cs.MESH_RUNNER_ATOL)
        out["bitwise_equal_to_spawn"] = bool(np.array_equal(losses, other))
    return out


def dryrun_case(cards: int) -> dict:
    from awesome_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    with CardWatch() as watch:
        res = dryrun_multichip(cards)
    where = cs._check_where(res.pop("ranks"), "dryrun_multichip")
    if where[0]["backend"] != "nccl":
        raise AssertionError(f"dryrun_multichip: {where}")
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"dryrun_multichip: {res}")
    return dict(res, case="dryrun", where=where,
                seconds=time.perf_counter() - t0,
                cards=watch.check(cards, "dryrun_multichip"))


def run_sharded_case(root: str, cards: int) -> dict:

    folder = os.path.join(root, "sharded")
    runs = os.path.join(folder, "runs")
    cfgs = cs._write_sharded_configs(folder, "cuda", n=cards)
    with CardWatch() as watch:
        _, seconds = _run([sys.executable, "-m",
                           "awesome_tpu_torch.scripts.run_sharded",
                           "--config-dir", cfgs, "--num-shards", str(cards),
                           "--spawn", "--device", "cuda", "--runs-path",
                           runs], "run_sharded --spawn")
    res = cs._check_sharded_runs(runs, cards, cards)
    if res["devices"] != [f"cuda:{i}" for i in range(cards)]:
        raise AssertionError(f"run_sharded: workers on {res['devices']}")
    return dict(res, case="run_sharded", seconds=seconds,
                cards=watch.check(cards, "run_sharded --spawn"))


def smoke_case(device: str, root: str) -> dict:
    """The smoke's mesh phase and its kernel entries on this machine."""

    mesh = cs.mesh_path(device, root)
    kernels = cs.mesh_kernel_entries(mesh, device)
    return {"case": "smoke", "collectives": mesh["collectives"],
            "seconds": mesh["seconds"], "fit": mesh["fit"],
            "runner": mesh["runner"],
            "dryrun_where": mesh["dryrun_multichip"]["ranks"],
            "run_sharded_devices": mesh["run_sharded"]["devices"],
            "kernels": [_kernel_record(e) for e in kernels]}


def card_lines() -> List[str]:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--cards", type=int, choices=sorted(MESHES), default=4)
    p.add_argument("--out", default=None,
                   help="also append each JSON line to this file")
    p.add_argument("--cases", nargs="+", default=None,
                   choices=("ranks", "dryrun", "run_spawn", "run_torchrun",
                            "run_sharded", "smoke"),
                   help="run only these cases (default: all)")
    args = p.parse_args(argv)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < args.cards:
        print(f"mesh_cards: {args.cards} cards asked for, {found} present",
              file=sys.stderr)
        return 1
    root = os.path.join(REPO, "build", f"mesh_cards_{args.cards}")
    out = open(args.out, "a") if args.out else None

    def emit(record: dict) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    sizes = Sizes()
    cards = card_lines()
    emit({"case": "cards", "asked": args.cards, "present": found,
          "cards": cards})
    t0 = time.perf_counter()

    def ranks_case():
        with CardWatch() as watch:
            ranks = run_ranks(args.cards, os.path.join(root, "ranks"), sizes)
        return {"case": "ranks", "seconds": time.perf_counter() - t0,
                "where": check_placement(ranks, args.cards),
                "cards_watched": watch.check(args.cards, "ranks",
                                             all_at_once=True),
                "build": [r["build"] for r in ranks],
                "peak_gib_per_card": [r["peak_gib"] for r in ranks],
                "fit": check_fits(ranks, args.cards, sizes),
                "runner": check_runners(ranks, args.cards, sizes),
                "resume": check_resume(ranks)}

    cases = [("ranks", ranks_case),
             ("dryrun", lambda: dryrun_case(args.cards)),
             ("run_spawn", lambda: entry_point_case(root, args.cards,
                                                    torchrun=False)),
             ("run_torchrun", lambda: entry_point_case(root, args.cards,
                                                       torchrun=True)),
             ("run_sharded", lambda: run_sharded_case(root, args.cards))]
    if args.cards == 2:
        cases.append(("smoke", lambda: smoke_case(
            "cuda", os.path.join(root, "smoke"))))
    failed = []
    cases = [(n, c) for n, c in cases if args.cases is None
             or n in args.cases]
    for name, case in cases:  # a failing case does not stop the others
        try:
            emit(case())
        except Exception as err:  # noqa: BLE001 - reported, then rc 1
            traceback.print_exc()
            emit({"case": name, "error": repr(err)[-2000:]})
            failed.append(name)
    emit({"case": "done", "ok": not failed, "failed": failed,
          "cards": cards, "seconds": time.perf_counter() - t0})
    return 1 if failed else 0

if __name__ == "__main__":
    sys.exit(main())
