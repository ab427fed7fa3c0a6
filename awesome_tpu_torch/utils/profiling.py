"""Profiling & numerics guards; counterpart of
``awesome_tpu/utils/profiling.py`` (SURVEY.md §5.1/§5.2: the reference has
only wall-clock timers and a NaN abort).

- :func:`trace` — a ``torch.profiler`` window writing a trace that
  TensorBoard and Perfetto read,
- :func:`span` — a named phase of the program in a running profiler's
  trace (and nothing without one),
- :class:`PhaseTimer` — named phase wall-clock accounting with device
  sync, reportable as a dict,
- :func:`debug_guard` — autograd's anomaly mode as the NaN tripwire,
- :func:`assert_finite` — host-side finite check over a param tree (the
  explicit fit-loop guard; inside the fit loops the engines' masked NaN
  guard is used instead).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from awesome_tpu_torch.utils.timer import wait_until_ready


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body (host ops, and the card's kernels when there is
    one) and write the trace as ``<host>_<pid>.<time>.pt.trace.json``
    under ``log_dir``, also when the body raises."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class _Span:
    """A ``record_function`` range that also adds its host seconds to
    ``span.totals``."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        total = span.totals.setdefault(self.name, [0, 0.0])
        total[0] += 1
        total[1] += time.perf_counter() - self.t0
        return self.range.__exit__(*exc)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("fit.update"): ...`` marks a phase of the program in the
    trace of a running profiler (:func:`trace`, ``torch.profiler.profile``,
    or nsys under ``emit_nvtx``): a ``record_function`` range, an event of
    the same capture as the card's ops and on their clock. Without a
    profiler it is a null context, at the cost of one flag check.

    While a profiler runs, each span also adds its count and host seconds
    to ``span.totals[name]`` (``[count, seconds]``), so that a caller reads
    the phases of a profiled window without parsing its trace."""
    if torch._C._autograd._profiler_enabled():
        return _Span(name)
    return _NO_SPAN


span.totals = {}


class PhaseTimer:
    """with timer.phase('pretrain'): ... -> timer.report()"""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, wait_on: Optional[Any] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if wait_on is not None:
                wait_until_ready(wait_on)
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> Dict[str, float]:
        return dict(self.times)


@contextlib.contextmanager
def debug_guard(nans: bool = True, infs: bool = False):
    """Raise at the first NaN that autograd's backward makes
    (``torch.autograd.set_detect_anomaly(check_nan=nans)``), restoring
    the earlier anomaly state on exit.

    JAX's ``jax_debug_nans`` traps the first NaN of ANY op; torch has no
    such switch. A NaN made in a forward pass, or in code that autograd
    does not record (``torch.no_grad``, the kernels' own fused backward,
    optimizer updates), is not caught here; use :func:`assert_finite` on
    those results. Torch has no inf trap either, so ``infs=True`` raises
    ``NotImplementedError``."""
    if infs:
        raise NotImplementedError(
            "torch has no trap for infs; check results with assert_finite")
    with torch.autograd.set_detect_anomaly(nans, check_nan=nans):
        yield


def _leaves(tree: Any) -> list:
    """Leaves in the JAX package's order: dict keys sorted, ``None`` an
    empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first leaf with a NaN or an
    inf (the JAX package's message; tensors are checked on their device)."""
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            bad = int((~torch.isfinite(leaf)).sum())
            shape = tuple(leaf.shape)
        else:
            arr = np.asarray(leaf)
            bad = int(np.count_nonzero(~np.isfinite(arr)))
            shape = arr.shape
        if bad:
            raise FloatingPointError(
                f"non-finite values in {name} leaf {i} "
                f"(shape {shape}): {bad} bad entries"
            )
