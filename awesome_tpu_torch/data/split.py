"""Seeded train/val splitting with optional persisted indices; counterpart
of ``awesome_tpu/data/split.py``.

Spec: `awesome/dataset/separable_dataset.py:10-105` (sklearn
train_test_split with a seed, indices optionally saved/loaded so reruns
and analytics see the identical split).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple


def split_indices(
    n: int,
    split_ratio: float = 0.8,
    seed: int = 42,
    shuffle: bool = True,
    indices_file: Optional[str] = None,
) -> Tuple[List[int], List[int]]:
    """Returns (train_indices, val_indices). If ``indices_file`` exists it
    wins (persisted-split semantics); otherwise the split is computed and,
    if a path is given, persisted."""
    if indices_file and os.path.exists(indices_file):
        with open(indices_file) as f:
            data = json.load(f)
        return list(data["train"]), list(data["val"])

    import numpy as np

    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(idx)
    n_train = int(round(n * split_ratio))
    train, val = idx[:n_train].tolist(), idx[n_train:].tolist()
    if indices_file:
        os.makedirs(os.path.dirname(indices_file) or ".", exist_ok=True)
        with open(indices_file, "w") as f:
            json.dump({"train": train, "val": val, "seed": seed,
                       "split_ratio": split_ratio}, f)
    return train, val
