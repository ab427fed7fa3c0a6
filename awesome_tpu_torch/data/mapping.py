"""Ground-truth <-> weak-label object-id mapping for FBMS sequences;
counterpart of ``awesome_tpu/data/mapping.py`` (numpy and JSON, as it is).

Behavior port of `awesome/dataset/mapping/ground_truth_foreground_id_mapping.py`
and `ground_truth_foreground_id_mapping_collection.py`: FBMS dense GT
annotations label *regions* with arbitrary gray values, while the
trajectory weak labels carry *object ids* from the multicut tracker — the
two id spaces must be matched before any multi-object training or
evaluation. Matching is by spatial overlap of trajectory points with GT
regions on labeled frames (`fbms_sequence_dataset.py:154-357`
get_segmentation_object_mapping / get_ground_truth_id_mapping_*).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class GroundTruthForegroundIdMapping:
    """Per-sequence mapping: GT region value -> trajectory object id(s)."""

    sequence: str
    gt_to_object: Dict[int, int]
    object_to_gt: Dict[int, int]
    background_gt_value: int

    def foreground_object_ids(self) -> List[int]:
        return [
            oid for gt, oid in self.gt_to_object.items()
            if gt != self.background_gt_value
        ]


def match_ids(
    gt_masks: Sequence[np.ndarray],  # per labeled frame: (H, W) int labels
    trajectory_masks: Sequence[Tuple[np.ndarray, np.ndarray]],
    # per same frame: ((N_obj, H, W) point masks, (N_obj,) object ids)
    sequence: str = "",
) -> GroundTruthForegroundIdMapping:
    """Match each trajectory object id to the GT region value its points
    fall into most often, accumulated over all labeled frames. The GT
    value covering the most area is taken as background."""
    votes: Dict[int, Dict[int, int]] = {}
    area: Dict[int, int] = {}
    for gt, (masks, ids) in zip(gt_masks, trajectory_masks):
        for v in np.unique(gt):
            area[int(v)] = area.get(int(v), 0) + int((gt == v).sum())
        for i, oid in enumerate(ids):
            ys, xs = np.nonzero(masks[i] > 0)
            vals, counts = np.unique(gt[ys, xs], return_counts=True)
            d = votes.setdefault(int(oid), {})
            for v, c in zip(vals, counts):
                d[int(v)] = d.get(int(v), 0) + int(c)
    background = max(area, key=area.get) if area else 0
    object_to_gt = {
        oid: max(d, key=d.get) for oid, d in votes.items() if d
    }
    gt_to_object: Dict[int, int] = {}
    for oid, gt_val in object_to_gt.items():
        # prefer the object with the most votes for that GT value
        if gt_val not in gt_to_object or (
            votes[oid][gt_val] > votes[gt_to_object[gt_val]][gt_val]
        ):
            gt_to_object[gt_val] = oid
    return GroundTruthForegroundIdMapping(
        sequence=sequence,
        gt_to_object=gt_to_object,
        object_to_gt=object_to_gt,
        background_gt_value=background,
    )


class MappingCollection:
    """Persisted mappings across sequences.

    Spec: `ground_truth_foreground_id_mapping_collection.py`.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.mappings: Dict[str, GroundTruthForegroundIdMapping] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            for name, d in data.items():
                self.mappings[name] = GroundTruthForegroundIdMapping(
                    sequence=name,
                    gt_to_object={int(k): v for k, v in
                                  d["gt_to_object"].items()},
                    object_to_gt={int(k): v for k, v in
                                  d["object_to_gt"].items()},
                    background_gt_value=d["background_gt_value"],
                )

    def get(self, sequence: str) -> Optional[GroundTruthForegroundIdMapping]:
        return self.mappings.get(sequence)

    def put(self, mapping: GroundTruthForegroundIdMapping) -> None:
        self.mappings[mapping.sequence] = mapping

    def save(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(
                {
                    name: {
                        "gt_to_object": m.gt_to_object,
                        "object_to_gt": m.object_to_gt,
                        "background_gt_value": m.background_gt_value,
                    }
                    for name, m in self.mappings.items()
                },
                f,
            )
