"""TensorBoard logging adapter; counterpart of
``awesome_tpu/utils/tensorboard.py``.

Behavior port of `awesome/util/tensorboard.py:28-428`: subscribes to the
runner's epoch events and logs losses, eval metrics, LR scales, images and
the config as markdown, with the same tag scheme ``{mode}/{scope}/{Name}``.

Uses torch.utils.tensorboard when it imports (it needs the tensorboard
package); degrades to a JSONL event log otherwise, so headless runs never
fail on logging.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


class Tensorboard:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._writer = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir)
        except ImportError:
            self._jsonl = open(
                os.path.join(log_dir, "events.jsonl"), "a", buffering=1
            )

    def log_value(self, value: float, tag: str, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)
        else:
            self._jsonl.write(
                json.dumps({"tag": tag, "value": float(value), "step": step})
                + "\n"
            )

    def log_metric_entry(
        self, name: str, value: float, step: int, mode: str = "train",
        scope: str = "epoch",
    ) -> None:
        """Tag scheme parity: `awesome/agent/util/tracker.py:378`."""
        self.log_value(value, f"{mode}/{scope}/{name}", step)

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: (H, W, C) float [0,1]."""
        if self._writer is not None:
            self._writer.add_image(
                tag, np.moveaxis(image, -1, 0), step
            )
        else:
            path = os.path.join(
                self.log_dir, f"{tag.replace('/', '_')}_{step}.npy"
            )
            np.save(path, image)

    def log_config_markdown(self, config: Any, step: int = 0) -> None:
        """Config-as-markdown table. Spec: `util/tensorboard.py:230-311`."""
        import dataclasses

        rows = []
        if dataclasses.is_dataclass(config):
            for f in dataclasses.fields(config):
                rows.append(f"| {f.name} | `{getattr(config, f.name)}` |")
        else:
            for k, v in vars(config).items():
                rows.append(f"| {k} | `{v}` |")
        md = "| field | value |\n|---|---|\n" + "\n".join(rows)
        if self._writer is not None:
            self._writer.add_text("config", md, step)
        else:
            with open(os.path.join(self.log_dir, "config.md"), "w") as f:
                f.write(md)

    def attach_to_tracker(self, tracker) -> None:
        """Flush every series the tracker currently holds."""
        for (name, scope, mode), series in tracker.series.items():
            for s, v in zip(series.steps, series.values):
                self.log_metric_entry(name, v, s, mode, scope)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
        if self._jsonl is not None:
            self._jsonl.close()
