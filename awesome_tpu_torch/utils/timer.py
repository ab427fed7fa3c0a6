"""Wall-clock timing context (spec: `awesome/util/timer.py:5`) plus a
device-aware variant that waits for the card before stopping; counterpart
of ``awesome_tpu/utils/timer.py``. CUDA ops return before the card has
run them, so without the wait a timer measures the enqueue, not the
work."""
from __future__ import annotations

import time
from typing import Any, Optional

import torch

from awesome_tpu_torch.core import tree as T


def wait_until_ready(tree: Any) -> None:
    """Wait until the card has made every CUDA tensor of ``tree``: one
    ``torch.cuda.synchronize`` per device they lie on (the counterpart of
    ``jax.block_until_ready``). CPU tensors are done when their op
    returns, and other leaves need nothing."""
    devices = {leaf.device for leaf in T.tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


class Timer:
    def __init__(self, name: str = ""):
        self.name = name
        self.start: Optional[float] = None
        self.elapsed: float = 0.0

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self.start

    @property
    def delta(self) -> float:
        if self.start is not None and self.elapsed == 0.0:
            return time.perf_counter() - self.start
        return self.elapsed


class DeviceTimer(Timer):
    """Timer that waits for the given tensors' device before stopping."""

    def __init__(self, name: str = ""):
        super().__init__(name)
        self._wait_on: Any = None

    def wait_for(self, tree: Any) -> None:
        self._wait_on = tree

    def __exit__(self, *exc) -> None:
        if self._wait_on is not None:
            wait_until_ready(self._wait_on)
        super().__exit__(*exc)
