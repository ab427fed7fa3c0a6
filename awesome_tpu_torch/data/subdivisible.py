"""Subset views with two-way index remapping; counterpart of
``awesome_tpu/data/subdivisible.py`` (numpy as it is).

Behavior port of `awesome/dataset/subdivisible_dataset.py:13-124`
``SubdivisibleDataset``: a dataset restricted to a subset (int / list /
slice specifier) that can map a subset index to the original data index
(``get_data_index``) and back (``get_subset_index``), and restrict a
train/val split computed on ORIGINAL indices onto the subset
(``subset_split_indices``).

Subsetting is a host-side indexing concern — on the device the subset is
simply the gather of the stacked tensors by ``data_indices`` — so this is
a small pure-python wrapper any dataset can compose (no abstract base
class needed)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Specifier = Union[int, Sequence[int], slice, None]


class SubsetView:
    """Index remapping for a subset of ``n`` items.

    ``specifier``: None (identity / no subset), an int (single item), a
    sequence of original indices, or a slice.
    """

    def __init__(self, n: int, specifier: Specifier = None):
        self.n = int(n)
        self.specifier = specifier
        if specifier is None:
            self._forward: Optional[Dict[int, int]] = None
        else:
            if isinstance(specifier, int):
                data_indices = [specifier]
            elif isinstance(specifier, slice):
                data_indices = list(range(self.n))[specifier]
            else:
                data_indices = list(specifier)
            for d in data_indices:
                if not 0 <= d < self.n:
                    raise IndexError(f"subset index {d} out of range 0..{n}")
            self._forward = {i: int(d) for i, d in enumerate(data_indices)}
        self._reverse = (
            None if self._forward is None
            else {d: i for i, d in self._forward.items()}
        )

    @property
    def has_subset(self) -> bool:
        return self._forward is not None

    def __len__(self) -> int:
        return len(self._forward) if self._forward is not None else self.n

    def get_data_index(self, index: int) -> int:
        """Subset index -> original dataset index
        (`subdivisible_dataset.py:86`)."""
        if self._forward is None:
            return index
        return self._forward[index]

    def get_subset_index(self, data_index: int) -> Optional[int]:
        """Original index -> subset index, None if excluded (`:108`)."""
        if self._reverse is None:
            return data_index
        return self._reverse.get(data_index)

    def data_indices(self) -> List[int]:
        """All original indices in subset order (the device-side gather)."""
        if self._forward is None:
            return list(range(self.n))
        return [self._forward[i] for i in range(len(self._forward))]

    def subset_split_indices(
        self, train: np.ndarray, val: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Restrict a split over ORIGINAL indices onto the subset: every
        subset entry lands in train iff its data index is in ``train``
        (`subdivisible_dataset.py:74-84`)."""
        if self._forward is None:
            return np.asarray(train), np.asarray(val)
        train_set = set(np.asarray(train).tolist())
        trains, vals = [], []
        for sub_i in range(len(self._forward)):
            (trains if self._forward[sub_i] in train_set else vals).append(
                sub_i
            )
        return np.asarray(trains), np.asarray(vals)


class SubdivisibleDataset:
    """Composition wrapper: any dataset with ``__len__`` +
    ``load(i)``/``__getitem__`` gains subset semantics."""

    def __init__(self, dataset, subset: Specifier = None):
        self.dataset = dataset
        self.view = SubsetView(len(dataset), subset)

    def __len__(self) -> int:
        return len(self.view)

    def get_data_index(self, index: int) -> int:
        return self.view.get_data_index(index)

    def get_subset_index(self, data_index: int) -> Optional[int]:
        return self.view.get_subset_index(data_index)

    def load(self, index: int):
        data_index = self.view.get_data_index(index)
        if hasattr(self.dataset, "load"):
            return self.dataset.load(data_index)
        return self.dataset[data_index]

    def __getitem__(self, index: int):
        return self.load(index)
