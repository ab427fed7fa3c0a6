"""Convexity benchmark dataset (51 scribble-annotated images); counterpart
of ``awesome_tpu/data/convexity.py`` (numpy; PNGs load through PIL,
imported only when a file is read).

Host-side loader producing device-ready arrays; behavior spec:
`awesome/dataset/convexity_segmentation_dataset.py:24-246`.

Conventions (exact parity):
- important pixels: rows = (y/h - 0.5, x/w - 0.5, r, g, b) for every pixel
  inside the fg|bg scribble masks (`:178-192` get_important_pixels),
- ground truth: PNG value 1 -> class 0 (FOREGROUND IS 0), else 1 (`:210-214`),
- scribble PNG: sorted unique values map to (none, bg, fg) (`:216-222`),
- scribble_percentage < 1 tops up with seeded random pixels (`:148-176`).

Padding images to one point count is ``awesome_tpu_torch.data.batching``'s
job (pad-to-bucket + validity mask), not here.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGE_PATTERN = re.compile(r"img_(?P<index>\d+)\.png")
GROUND_TRUTH_PATTERN = re.compile(r"GT_(?P<index>\d+)\.png")
SCRIBBLES_PATTERN = re.compile(r"scribbleMask_(?P<index>\d+)\.png")


@dataclasses.dataclass
class ConvexitySample:
    """One benchmark image, fully materialized as numpy arrays."""

    image: np.ndarray  # (H, W, 3) float32 in [0,1]
    gt: np.ndarray  # (H, W) float32, 0 = foreground
    fg_mask: np.ndarray  # (H, W) bool — scribble foreground
    bg_mask: np.ndarray  # (H, W) bool — scribble background
    index: int = 0
    # Weak-label view of the GT for TRAINING targets only (None -> gt).
    # The reference reads the dense GT at scribble positions for pixel
    # targets (`:195-207` get_gt_important_pixels), which makes real
    # datasets' scribble labels exactly as noisy as their GT; synthetic
    # noisy-scribble scenes model SSS-derived label noise by flipping
    # values HERE while ``gt`` stays the clean evaluation truth.
    train_gt: Optional[np.ndarray] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return self.gt.shape

    def important_pixels(self) -> Tuple[np.ndarray, np.ndarray]:
        """((N, 5) (y, x, r, g, b) with y/x in [-0.5, 0.5], (N, 1) gt)."""
        interesting = np.logical_or(self.fg_mask, self.bg_mask)
        idx = np.argwhere(interesting)  # (N, 2) row-major (y, x)
        norm = idx / np.asarray(self.shape, dtype=np.float32) - 0.5
        rgb = self.image[interesting]  # (N, 3)
        px = np.concatenate([norm.astype(np.float32), rgb], axis=-1)
        lbl = self.gt if self.train_gt is None else self.train_gt
        gt_px = lbl[interesting][:, None].astype(np.float32)
        return px, gt_px

    def random_pixels(self, count: int, seed: int = 42) -> np.ndarray:
        """Seeded random pixel top-up (`:148-176` get_random_pix): draw
        random (y, x) positions without replacement via a mask."""
        rng = np.random.default_rng(seed)
        h, w = self.shape
        mask = np.zeros((h, w), dtype=bool)
        needed = count
        for _ in range(1000):
            if needed <= 0:
                break
            ys = rng.integers(0, h, size=needed)
            xs = rng.integers(0, w, size=needed)
            mask[ys, xs] = True
            needed = count - int(mask.sum())
        idx = np.argwhere(mask)[:count]
        norm = idx / np.asarray(self.shape, dtype=np.float32) - 0.5
        rgb = self.image[idx[:, 0], idx[:, 1]]
        return np.concatenate([norm.astype(np.float32), rgb], axis=-1)

    def pixels(
        self, scribble_percentage: float = 1.0, seed: int = 42
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Scribble pixels + random top-up so that scribbles make up
        ``scribble_percentage`` of the rows (`:138-141`)."""
        px, gt_px = self.important_pixels()
        if scribble_percentage < 1.0:
            n = px.shape[0]
            extra = int(np.ceil(n / scribble_percentage - n))
            rand_px = self.random_pixels(extra, seed=seed)
            px = np.concatenate([px, rand_px], axis=0)
        return px, gt_px


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path), dtype=np.float64) / 255.0
    return img[:, :, 0:3].astype(np.float32)


def _load_gt(path: str) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path), dtype=np.float64) / 255.0
    return np.where(img == 1, 0.0, 1.0).astype(np.float32)


def _load_scribbles(path: str) -> Tuple[np.ndarray, np.ndarray]:
    from PIL import Image

    img = np.asarray(Image.open(path), dtype=np.float64) / 255.0
    vals = np.unique(img)
    if len(vals) < 3:
        # degenerate scribble file: assume 0 none / max fg
        bg = np.zeros_like(img, dtype=bool)
        fg = img == vals[-1]
        return bg, fg
    _, bg_val, fg_val = vals[:3]
    return img == bg_val, img == fg_val


class ConvexityDataset:
    """Directory-indexed dataset: img/ ground_truth/ user_scribbles/ with
    the reference's regex file patterns (`:24-29`)."""

    def __init__(
        self,
        dataset_path: str,
        scribble_percentage: float = 1.0,
        subset: Optional[List[int]] = None,
        seed: int = 42,
    ):
        self.dataset_path = dataset_path
        self.scribble_percentage = scribble_percentage
        self.seed = seed
        self.entries = self._index(dataset_path)
        if subset is not None:
            self.entries = [self.entries[i] for i in subset]

    @staticmethod
    def _index(root: str) -> List[Dict[str, str]]:
        res: Dict[int, Dict[str, str]] = {}
        for sub, pattern, key in (
            ("img", IMAGE_PATTERN, "image_path"),
            ("ground_truth", GROUND_TRUTH_PATTERN, "gt_path"),
            ("user_scribbles", SCRIBBLES_PATTERN, "scribble_path"),
        ):
            d = os.path.join(root, sub)
            if not os.path.isdir(d):
                continue
            for file in os.listdir(d):
                m = pattern.fullmatch(file)
                if m:
                    i = int(m.group("index"))
                    res.setdefault(i, {})[key] = os.path.join(d, file)
        return [res[i] | {"index": i} for i in sorted(res)]

    def __len__(self) -> int:
        return len(self.entries)

    def load(self, i: int) -> ConvexitySample:
        e = self.entries[i]
        bg, fg = _load_scribbles(e["scribble_path"])
        return ConvexitySample(
            image=_load_image(e["image_path"]),
            gt=_load_gt(e["gt_path"]),
            fg_mask=fg,
            bg_mask=bg,
            index=e["index"],
        )

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.load(i).pixels(self.scribble_percentage, seed=self.seed)
