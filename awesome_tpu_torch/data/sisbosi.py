"""SISBOSI — the legacy single-image-scribble pipeline with augmentation;
counterpart of ``awesome_tpu/data/sisbosi.py`` (numpy and PIL as it is,
so the same seed gives the same image, gt and scribble, bit for bit).

Behavior port of `awesome/dataset/sisbosi_dataset.py:26-602`
(ScribbleImage / ConvexityDataset / SISBOSIDataset): per-image scribble
samples with data augmentation (random hflip, random rotation +-20deg,
color jitter, gaussian noise) and semantic-label re-indexing. Augmentation
is host-side numpy/PIL (cold path); re-uses ``ConvexitySample`` as the
underlying record so both pipelines share loaders.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from awesome_tpu_torch.data.convexity import ConvexitySample


def remove_semantic_information(labels: np.ndarray) -> np.ndarray:
    """Re-index arbitrary label values to 0..K-1.

    Spec: `sisbosi_dataset.py:352-360`.
    """
    vals = np.unique(labels)
    out = np.zeros_like(labels)
    for i, v in enumerate(vals):
        out[labels == v] = i
    return out


def augment(
    image: np.ndarray,
    gt: np.ndarray,
    scribble: np.ndarray,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random hflip + rotation(+-20deg) + color jitter + gaussian noise.

    Spec: `sisbosi_dataset.py:320-350` (the torchvision recipe in
    numpy/PIL terms). Masks rotate with nearest interpolation.
    """
    from PIL import Image

    img = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
    gt_i = Image.fromarray((gt * 255).astype(np.uint8))
    scr_i = Image.fromarray(scribble.astype(np.uint8))

    if rng.random() > 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        gt_i = gt_i.transpose(Image.FLIP_LEFT_RIGHT)
        scr_i = scr_i.transpose(Image.FLIP_LEFT_RIGHT)
    if rng.random() > 0.5:
        angle = int(rng.integers(-20, 21))
        img = img.rotate(angle)
        gt_i = gt_i.rotate(angle, resample=Image.NEAREST)
        scr_i = scr_i.rotate(angle, resample=Image.NEAREST)

    out = np.asarray(img, np.float32) / 255.0
    # color jitter: brightness/contrast/saturation/hue-ish perturbations
    out = out * rng.uniform(0.8, 1.2)  # brightness
    mean = out.mean()
    out = (out - mean) * rng.uniform(0.8, 1.2) + mean  # contrast
    gray = out.mean(axis=-1, keepdims=True)
    out = gray + (out - gray) * rng.uniform(0.8, 1.2)  # saturation
    out = out[..., np.asarray([0, 1, 2])] + rng.uniform(-0.02, 0.02, 3)
    # gaussian noise
    out = out + rng.normal(0, 0.05, out.shape)
    out = np.clip(out, 0.0, 1.0).astype(np.float32)
    return (
        out,
        (np.asarray(gt_i, np.float32) / 255.0),
        np.asarray(scr_i),
    )


def random_patch(
    image: np.ndarray,
    gt: np.ndarray,
    scribble: np.ndarray,
    patch_size: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random square crop (the reference's ``patch_size = 300`` crops,
    `sisbosi_dataset.py:223`); images smaller than the patch pass
    through."""
    h, w = gt.shape
    if h <= patch_size and w <= patch_size:
        return image, gt, scribble
    ph, pw = min(patch_size, h), min(patch_size, w)
    y0 = int(rng.integers(0, h - ph + 1))
    x0 = int(rng.integers(0, w - pw + 1))
    sl = (slice(y0, y0 + ph), slice(x0, x0 + pw))
    return image[sl], gt[sl], scribble[sl]


@dataclasses.dataclass
class ScribbleImage:
    """Per-image view bundling rgb / xy encodings / scribble / GT /
    semantic features with 2d (pixel-matrix) and 3d (image) emission.

    Behavior port of `awesome/dataset/sisbosi_dataset.py:26-181`
    ``ScribbleImage`` — channel-LAST layout, as in the JAX package (the
    reference is channel-first torch).
    """

    image: np.ndarray  # (H, W, 3) float [0,1]
    gt: np.ndarray  # (H, W) float, fg = 0
    scribble: np.ndarray  # (H, W) int: 0 fg, 1 bg, 2 none
    feat: Optional[np.ndarray] = None  # (H, W, F) semantic features
    clean_image: Optional[np.ndarray] = None
    xy_mode: str = "xy"
    noneclass: float = 2.0

    def __post_init__(self):
        if self.clean_image is None:
            self.clean_image = self.image
        from awesome_tpu_torch.data.image_sample import assemble_channels

        # seeded rng: only the 'gauss_bubbles' mode draws randomness, and
        # the repo convention is deterministic feature encodings (the
        # reference redraws bubbles per access, unseeded)
        self.xy = assemble_channels(
            self.image, self.xy_mode, scribble=self.scribble,
            rng=np.random.default_rng(self.image.shape[:2]),
        )
        self.xy_clean = assemble_channels(self.image, "xy")
        if self.feat is None:
            self.feat = self.image  # reference falls back to rgb (`:175`)

    def get_number_of_classes(self) -> int:
        vals = np.unique(self.scribble)
        return int((vals != self.noneclass).sum())

    def get_xy_dimension(self) -> int:
        return self.xy.shape[-1]

    def __getitem__(self, dimensional: str = "3d") -> dict:
        """'2d': pixel matrices (N, C); '3d': (H, W, C) images.
        Spec: `sisbosi_dataset.py:129-181`."""
        if dimensional == "2d":
            return {
                "rgb": self.image.reshape(-1, 3),
                "xy": self.xy.reshape(-1, self.xy.shape[-1]),
                "xy_clean": self.xy_clean.reshape(-1, 2),
                "scribble": self.scribble.reshape(-1, 1),
                "gt": self.gt.reshape(1, -1),
                "mask": self.scribble,
                "feat": self.feat.reshape(-1, self.feat.shape[-1]),
                "image": self.image,
                "clean_image": self.clean_image,
            }
        if dimensional == "3d":
            return {
                "rgb": self.image,
                "xy": self.xy,
                "xy_clean": self.xy_clean,
                "scribble": self.scribble,
                "gt": self.gt,
                "mask": self.scribble,
                "feat": self.feat,
                "image": self.image,
                "clean_image": self.clean_image,
            }
        raise ValueError(f"dimensional must be '2d' or '3d', not {dimensional}")


class SISBOSIDataset:
    """Single-image scribble dataset with optional augmentation; each
    __getitem__ draws a fresh augmentation of the SAME image (the
    reference trains many epochs on one augmented image). Supports patch
    cropping (``patch_size``) and subset views (``subset``,
    `sisbosi_dataset.py:432-441` create_subset_mapping)."""

    def __init__(
        self,
        samples: Sequence[ConvexitySample],
        augmentation: bool = True,
        scribble_percentage: float = 1.0,
        seed: int = 42,
        patch_size: Optional[int] = None,
        subset=None,
        semantic: bool = False,
    ):
        from awesome_tpu_torch.data.subdivisible import SubsetView

        self.samples = list(samples)
        self.augmentation = augmentation
        self.scribble_percentage = scribble_percentage
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.patch_size = patch_size
        self.semantic = semantic
        self.view = SubsetView(len(self.samples), subset)

    def __len__(self) -> int:
        return len(self.view)

    def get_data_index(self, index: int) -> int:
        return self.view.get_data_index(index)

    def _materialize(self, index: int) -> ConvexitySample:
        s = self.samples[self.view.get_data_index(index)]
        scribble = np.full(s.gt.shape, 2, np.uint8)
        scribble[s.bg_mask] = 1
        scribble[s.fg_mask] = 0
        img, gt = s.image, s.gt
        if self.augmentation:
            # augment() uses label values 1=bg / 2=fg; remap around it
            aug_scr = np.zeros_like(scribble)
            aug_scr[scribble == 1] = 1
            aug_scr[scribble == 0] = 2
            img, gt, aug_scr = augment(img, gt, aug_scr, self.rng)
            scribble = np.full(gt.shape, 2, np.uint8)
            scribble[aug_scr == 1] = 1
            scribble[aug_scr == 2] = 0
        if self.patch_size:
            img, gt, scribble = random_patch(
                img, gt, scribble, self.patch_size, self.rng
            )
        if not self.semantic:
            gt = remove_semantic_information(
                gt.astype(np.int64)
            ).astype(np.float32)
        return ConvexitySample(
            image=img, gt=gt,
            fg_mask=scribble == 0, bg_mask=scribble == 1,
            index=s.index,
        )

    def scribble_image(self, index: int, **kwargs) -> ScribbleImage:
        """The full per-image view (rgb/xy/feat/...)."""
        s = self._materialize(index)
        scribble = np.full(s.gt.shape, 2, np.uint8)
        scribble[s.bg_mask] = 1
        scribble[s.fg_mask] = 0
        return ScribbleImage(
            image=s.image, gt=s.gt, scribble=scribble, **kwargs
        )

    def load(self, index: int) -> ConvexitySample:
        return self._materialize(index)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._materialize(index).pixels(
            self.scribble_percentage, seed=self.seed
        )
