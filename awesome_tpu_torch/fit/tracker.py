"""Metric tracking: scoped (batch/epoch) x mode (train/val/eval) metric
series with the primary-metric best-model gate; counterpart of
``awesome_tpu/fit/tracker.py``.

Host-side bookkeeping in plain Python and numpy, not a hot path. The
persisted form (``to_dict``, ``tracker.json``) is the JAX package's, so a
file written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _host(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass
class MetricSeries:
    """Append-only series of (step, value) for one (name, scope, mode)."""

    name: str
    scope: str  # 'batch' | 'epoch'
    mode: str  # 'train' | 'val' | 'eval'
    steps: List[int] = dataclasses.field(default_factory=list)
    values: List[float] = dataclasses.field(default_factory=list)

    def add(self, step: int, value: float) -> None:
        self.steps.append(int(step))
        self.values.append(float(value))

    @property
    def last(self) -> Optional[float]:
        return self.values[-1] if self.values else None

    def at(self, step: int) -> Optional[float]:
        """Value recorded at exactly ``step`` (None when absent)."""
        try:
            return self.values[self.steps.index(int(step))]
        except ValueError:
            return None

    def best(self, maximize: bool) -> Optional[Tuple[int, float]]:
        if not self.values:
            return None
        arr = np.asarray(self.values)
        i = int(arr.argmax() if maximize else arr.argmin())
        return self.steps[i], float(arr[i])


class Tracker:
    """Counters + metric series + best-model gate.

    Tags are assembled ``{mode}/{scope}/{Name}``.
    """

    def __init__(
        self,
        primary_metric: str = "Loss",
        primary_mode: str = "val",
        maximize_primary: bool = False,
    ):
        self.series: Dict[Tuple[str, str, str], MetricSeries] = {}
        self.global_step = 0
        self.epoch = 0
        self.primary_metric = primary_metric
        self.primary_mode = primary_mode
        self.maximize_primary = maximize_primary
        self._best_primary: Optional[float] = None

    def _get(self, name: str, scope: str, mode: str) -> MetricSeries:
        key = (name, scope, mode)
        if key not in self.series:
            self.series[key] = MetricSeries(name, scope, mode)
        return self.series[key]

    def step_metric(self, name: str, value, mode: str = "train") -> None:
        self._get(name, "batch", mode).add(self.global_step, float(value))

    def epoch_metric(self, name: str, value, mode: str = "train") -> None:
        self._get(name, "epoch", mode).add(self.epoch, float(value))

    def tick_step(self) -> None:
        self.global_step += 1

    def tick_epoch(self) -> None:
        self.epoch += 1

    def tag(self, name: str, scope: str, mode: str) -> str:
        return f"{mode}/{scope}/{name}"

    def is_current_state_best_model(self) -> bool:
        """True iff the latest primary metric beats all previous values
        (what gates the 'best' checkpoint)."""
        s = self._get(self.primary_metric, "epoch", self.primary_mode)
        if s.last is None:
            return False
        better = (
            s.last > (self._best_primary if self._best_primary is not None
                      else -np.inf)
            if self.maximize_primary
            else s.last < (self._best_primary if self._best_primary is not None
                           else np.inf)
        )
        if better:
            self._best_primary = s.last
        return better

    def get_best_performance(self) -> Optional[Tuple[int, float]]:
        s = self._get(self.primary_metric, "epoch", self.primary_mode)
        return s.best(self.maximize_primary)

    # --- persistence -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "global_step": self.global_step,
            "epoch": self.epoch,
            "primary_metric": self.primary_metric,
            "primary_mode": self.primary_mode,
            "maximize_primary": self.maximize_primary,
            # best-model gate state: without it a resumed run would re-save
            # 'best' on the first post-resume tick even when worse
            "best_primary": self._best_primary,
            "series": [dataclasses.asdict(s) for s in self.series.values()],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Tracker":
        t = cls(
            primary_metric=d.get("primary_metric", "Loss"),
            primary_mode=d.get("primary_mode", "val"),
            maximize_primary=d.get("maximize_primary", False),
        )
        t.global_step = d.get("global_step", 0)
        t.epoch = d.get("epoch", 0)
        t._best_primary = d.get("best_primary")
        for s in d.get("series", []):
            ms = MetricSeries(**s)
            t.series[(ms.name, ms.scope, ms.mode)] = ms
        return t

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "Tracker":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def log_loss_terms(
    tracker: "Tracker",
    terms: Dict[str, Any],
    mode: str = "train",
    scope: str = "epoch",
    prefix: str = "",
) -> None:
    """Log named sub-loss terms recursively with path-joined names
    (nested criteria give 'Parent/Child' tags). Losses return their
    sub-term dicts; this is the one place that walks them into the
    tracker. Values may be tensors on any device."""
    for key, value in terms.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            log_loss_terms(tracker, value, mode, scope, name)
            continue
        record = (
            tracker.epoch_metric if scope == "epoch" else tracker.step_metric
        )
        record(name, float(_host(value)), mode)


class DataTracker:
    """Per-epoch accumulation of raw tensors (losses, predictions, labels,
    indices) for post-hoc analysis.

    Values are staged on the host (a tensor is copied once per
    append) and stacked on ``epoch_end``.
    """

    def __init__(self):
        self.current: Dict[str, List[np.ndarray]] = {}
        self.epochs: List[Dict[str, np.ndarray]] = []

    def append(self, **tensors) -> None:
        for k, v in tensors.items():
            self.current.setdefault(k, []).append(_host(v))

    def epoch_end(self) -> Dict[str, np.ndarray]:
        done = {
            k: (np.stack(v) if v and v[0].shape == v[-1].shape
                else np.asarray(v, dtype=object))
            for k, v in self.current.items()
        }
        self.epochs.append(done)
        self.current = {}
        return done

    def last_epoch(self) -> Optional[Dict[str, np.ndarray]]:
        return self.epochs[-1] if self.epochs else None
