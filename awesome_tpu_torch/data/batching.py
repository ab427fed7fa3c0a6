"""Pad-to-bucket batching with validity masks; counterpart of
``awesome_tpu/data/batching.py``.

The reference feeds variable-length pixel lists (N_i, 5) per image. Here
all images of a batch share one point axis, so one launch of a kernel
(K4/K5 with G = images) serves them all: N is rounded up to a bucket size
and padded rows carry weight 0 in every loss.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def bucket_size(n: int, granularity: int = 1024) -> int:
    """Round up to the next multiple of ``granularity`` (lane-friendly)."""
    return int(np.ceil(n / granularity) * granularity)


def pad_points(
    px: np.ndarray, target: int, pad_value: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (N, C) to (target, C); returns (padded, mask (target,))."""
    n = px.shape[0]
    if n > target:
        raise ValueError(f"{n} points exceed bucket {target}")
    padded = np.full((target, px.shape[1]), pad_value, dtype=px.dtype)
    padded[:n] = px
    mask = np.zeros((target,), dtype=bool)
    mask[:n] = True
    return padded, mask


def stack_padded(
    pixel_lists: Sequence[np.ndarray],
    granularity: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length (N_i, C) lists into one (B, N_max, C) array
    plus (B, N_max) masks, N_max bucketed for compile-cache friendliness."""
    target = bucket_size(max(p.shape[0] for p in pixel_lists), granularity)
    padded, masks = zip(*(pad_points(p, target) for p in pixel_lists))
    return np.stack(padded), np.stack(masks)


@dataclasses.dataclass(frozen=True)
class BatchSettings:
    """Per-dataset batch-size + shuffle configuration consumed by the
    training engines.

    Spec: `awesome/dataset/batched_dataset.py:5-38` ``BatchedDataset``
    (training/validation batch size + shuffle flags the agent reads when
    building loaders; here the epoch planners read them).
    """

    training_batch_size: int = 1
    validation_batch_size: int = 1
    shuffle_in_training_dataloader: bool = True
    shuffle_in_validation_dataloader: bool = False

    @classmethod
    def of(cls, dataset) -> "BatchSettings":
        """Settings of a dataset (its ``batch_settings`` attr or fields,
        else defaults)."""
        if hasattr(dataset, "batch_settings"):
            return dataset.batch_settings
        kwargs = {}
        for f in dataclasses.fields(cls):
            if hasattr(dataset, f.name):
                kwargs[f.name] = getattr(dataset, f.name)
        return cls(**kwargs)
