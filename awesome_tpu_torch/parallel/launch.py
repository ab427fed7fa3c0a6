"""Starting the ranks of a mesh: one process per mesh position.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``
(the spawn method), joins them into one process group and runs ``fn(*args)``
in each; what each rank returns comes back to the caller in rank order.
The ranks take the cards round robin (``cuda:{rank % device_count}``;
under ``torchrun`` ``LOCAL_RANK`` takes the place of the rank) or the
CPU; the backend follows :func:`awesome_tpu_torch.parallel.mesh.
backend_for` (NCCL with a card per rank, gloo otherwise) and is never
swapped for another when a collective fails. ``fn`` must be importable by
the children (a module-level function).
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from awesome_tpu_torch.parallel.mesh import (
    backend_for,
    rank_device,
    set_rank_device,
)


def init_rank(rank: int, world: int, init_method: str, device: str,
              threads: Optional[int] = None, timeout_s: float = 1800.0,
              local_rank: Optional[int] = None,
              local_world: Optional[int] = None) -> torch.device:
    """Join the process group as ``rank`` of ``world`` and return this
    rank's device. On CUDA the rank's card is made current before anything
    touches CUDA, and NCCL starts its communicator on that card at once.
    ``local_rank`` and ``local_world``: the rank's index among the ranks
    of its host and their number (torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``; by default one host runs the whole world).
    ``threads`` sets ``torch.set_num_threads`` (default: the cores shared
    out among the host's ranks)."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    torch.set_num_threads(threads or max(1, (os.cpu_count() or 1)
                                         // local_world))
    dev = rank_device(torch.device(device).type, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    set_rank_device(dev)
    backend = backend_for(dev, local_world)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dev


def _rank_main(rank: int, world: int, init_method: str, device: str,
               threads: Optional[int], timeout_s: float, fn: Callable,
               args: Sequence[Any], out_dir: str) -> None:
    """A spawned rank: join the group, run ``fn(*args)``, save its result
    for the caller and end the process at once (the interpreter's
    shutdown of the group's threads can take seconds; an error still
    takes the normal way out, with its traceback)."""
    import sys

    init_rank(rank, world, init_method, device, threads, timeout_s)
    result = fn(*args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    if dist.get_backend() != "nccl":
        dist.barrier()  # no rank leaves while another still needs it
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


class Ranks:
    """Ranks started by :func:`start`; :meth:`join` waits for them."""

    def __init__(self, context, world: int, base: str):
        self.context, self.world, self.base = context, world, base

    def join(self) -> List[Any]:
        """The ranks' results in rank order. A failing rank raises here
        with its traceback (the others are stopped)."""
        try:
            while not self.context.join():
                pass
            return [torch.load(os.path.join(self.base, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(self.world)]
        finally:
            shutil.rmtree(self.base, ignore_errors=True)

    def stop(self) -> None:
        """End the ranks now (the caller failed before it joined them)."""
        for p in self.context.processes:
            if p.is_alive():
                p.terminate()
        for p in self.context.processes:
            p.join()
        shutil.rmtree(self.base, ignore_errors=True)


def start(fn: Callable, world: int, args: Sequence[Any] = (),
          device: str = "cuda", threads: Optional[int] = None,
          timeout_s: float = 1800.0) -> Ranks:
    """Start ``fn(*args)`` on ``world`` ranks and return at once (the
    caller may work meanwhile); :meth:`Ranks.join` collects them."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a card; pass device='cpu' to "
                           "run the ranks on the CPU")
    base = tempfile.mkdtemp(prefix="awesome_mesh_")
    init_method = "file://" + os.path.join(base, "rendezvous")
    context = mp.start_processes(
        _rank_main, args=(world, init_method, device, threads, timeout_s,
                          fn, tuple(args), base),
        nprocs=world, join=False, start_method="spawn")
    return Ranks(context, world, base)


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          device: str = "cuda", threads: Optional[int] = None,
          timeout_s: float = 1800.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks; returns their results in rank
    order (:func:`start`, then :meth:`Ranks.join`)."""
    return start(fn, world, args, device, threads, timeout_s).join()


def in_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()
