"""AwesomeDataset — the generic per-image training-sample assembler;
counterpart of ``awesome_tpu/data/awesome_dataset.py`` (the samples are
numpy as there, equal bit for bit; :class:`PriorCache` holds tensors).

Behavior port of `awesome/dataset/awesome_dataset.py:24-428`: wraps an
inner image collection, emits either pixel-mode ('2d') or image-mode
('3d') samples with weak (scribble) or full (GT) supervision, scribble
subsampling with random-pixel top-up, temporal channel for spatio-temporal
sequences, and target encoding.

Host-side numpy assembly; arrays come out NHWC / (N, C). Per-image prior
plumbing (the ``@prior`` getitem decorator + PriorManager of
`awesome/dataset/prior_dataset.py:13-110`) does not exist here: the
stacked-params engine replaces weight swapping with indexing, so a sample
only needs to carry its integer ``index``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.data.image_sample import assemble_channels, edge_map
from awesome_tpu_torch.nn.module import make_generator


@dataclasses.dataclass
class AwesomeSample:
    """One emitted training sample."""

    image: np.ndarray  # 2d: (N, 3) rgb | 3d: (H, W, 3)
    feature_encoding: np.ndarray  # 2d: (N, F) | 3d: (H, W, F)
    xy_clean: np.ndarray  # 2d: (N, 2) | 3d: (H, W, 2)
    target: np.ndarray  # 2d: (N, 1) | 3d: (H, W, 1)
    index: int
    clean_image: Optional[np.ndarray] = None  # always (H, W, 3)
    labeled_mask: Optional[np.ndarray] = None  # 3d weak supervision


class AwesomeDataset:
    """dimension: '2d' (pixel lists) or '3d' (dense images);
    supervision_mode: 'weakly' (scribbles) or 'full' (GT)."""

    def __init__(
        self,
        samples: Sequence[Any],  # ConvexitySample-like objects
        dimension: str = "2d",
        supervision_mode: str = "weakly",
        scribble_percentage: float = 1.0,
        # 'xy' | 'distance_scribble' | 'gauss_bubbles' | 'edge'
        feature_mode: str = "xy",
        temporal: bool = False,
        split_seed: int = 42,
        dtype=np.float32,
        mode: str = "model_input",  # 'model_input' | 'sample'
    ):
        self.samples = list(samples)
        self.dimension = dimension
        self.supervision_mode = supervision_mode
        self.scribble_percentage = scribble_percentage
        self.feature_mode = feature_mode
        self.temporal = temporal
        self.split_seed = split_seed
        self.dtype = dtype
        if mode not in ("model_input", "sample"):
            raise ValueError(f"Unknown mode {mode}")
        # 'sample' emits the raw per-image record dict instead of the
        # assembled model input (`awesome/dataset/awesome_dataset.py:37,72`;
        # eval handles flip this via TemporaryProperty in the reference)
        self.mode = mode

    def __len__(self) -> int:
        return len(self.samples)

    def _raw_sample(self, index: int) -> dict:
        s = self.samples[index]
        scribble = np.full(s.gt.shape, 2, np.int32)
        scribble[s.bg_mask] = 1
        scribble[s.fg_mask] = 0
        return {
            "image": s.image,
            "label": s.gt,
            "mask": scribble,
            "name": f"img_{getattr(s, 'index', index)}",
            "clean_image": s.image,
        }

    def _features(self, s, index: int) -> np.ndarray:
        img = s.image
        t = float(index) if self.temporal else None
        t_max = float(max(len(self.samples) - 1, 1)) if self.temporal else None
        if self.feature_mode == "edge":
            xy = assemble_channels(img, "xy", t=t, t_max=t_max)
            e = edge_map(img)[..., None]
            return np.concatenate([xy, e], axis=-1)
        scribble = None
        if self.feature_mode == "distance_scribble":
            scribble = np.zeros(s.gt.shape, np.int32)
            scribble[s.bg_mask] = 0
            scribble[s.fg_mask] = 1
            scribble[~(s.bg_mask | s.fg_mask)] = 2
        # rng only used by 'gauss_bubbles' (reference redraws per access,
        # unseeded; we seed per image for the determinism convention)
        return assemble_channels(
            img, self.feature_mode, scribble=scribble, t=t, t_max=t_max,
            rng=np.random.default_rng((self.split_seed, index)),
        )

    def _target_2d(self, s, scribbled) -> np.ndarray:
        if self.supervision_mode == "weakly":
            # weak labels: fg scribble -> 0, bg scribble -> 1 (unaries conv.)
            lbl = np.where(s.fg_mask, 0.0, 1.0)[scribbled]
        elif self.supervision_mode == "full":
            lbl = s.gt[scribbled]
        else:
            raise ValueError(
                f"Supervision mode {self.supervision_mode} not supported!"
            )
        return lbl[:, None].astype(self.dtype)

    def __getitem__(self, index: int) -> Any:
        if self.mode == "sample":
            return self._raw_sample(index)
        s = self.samples[index]
        feats = self._features(s, index)
        h, w = s.gt.shape
        xy_clean = assemble_channels(s.image, "xy")
        if self.dimension == "3d":
            if self.supervision_mode == "weakly":
                target = np.where(s.fg_mask, 0.0, 1.0)[..., None]
                labeled = (s.fg_mask | s.bg_mask)
            else:
                target = s.gt[..., None]
                labeled = np.ones((h, w), bool)
            return AwesomeSample(
                image=s.image.astype(self.dtype),
                feature_encoding=feats.astype(self.dtype),
                xy_clean=xy_clean.astype(self.dtype),
                target=target.astype(self.dtype),
                index=index,
                clean_image=s.image,
                labeled_mask=labeled,
            )
        if self.dimension != "2d":
            raise ValueError(f"Unknown dimension {self.dimension}")

        scribbled = s.fg_mask | s.bg_mask
        img_px = s.image[scribbled].astype(self.dtype)
        feat_px = feats[scribbled].astype(self.dtype)
        xy_px = xy_clean[scribbled].astype(self.dtype)
        target = self._target_2d(s, scribbled)

        if self.scribble_percentage < 1.0:
            n = img_px.shape[0]
            extra = int(np.ceil(n / self.scribble_percentage - n))
            rng = np.random.default_rng(self.split_seed)
            idx = np.stack(
                [rng.integers(0, h, extra), rng.integers(0, w, extra)], -1
            )
            img_px = np.concatenate([img_px, s.image[idx[:, 0], idx[:, 1]]])
            feat_px = np.concatenate([feat_px, feats[idx[:, 0], idx[:, 1]]])
            xy_px = np.concatenate([xy_px, xy_clean[idx[:, 0], idx[:, 1]]])
        return AwesomeSample(
            image=img_px,
            feature_encoding=feat_px,
            xy_clean=xy_px,
            target=target,
            index=index,
            clean_image=s.image,
        )


class PriorCache:
    """API-parity wrapper over the stacked per-image prior tree.

    Spec: `awesome/util/prior_cache.py:10-91` (index->state mapping, lazy
    materialization, get_state/set_state). Here "state_dicts" are tree
    slices; the backing store IS the stacked tensors on the model's
    device, so apply/extract are index ops there, with no copy to the
    host. The per-image inits come from one ``torch.Generator`` (``key``:
    a generator or an int seed; ``None`` seeds 0), so they equal the JAX
    package's in distribution only.
    """

    def __init__(self, model, num_entries: int, key=None):
        self.model = model
        gen = make_generator(key)
        self.stacked = T.stack_trees(
            [model.init(gen) for _ in range(num_entries)])
        self.num_entries = num_entries

    def extract_prior(self, index: int):
        return T.tree_select(self.stacked, index)

    def apply_prior(self, index: int, params) -> None:
        self.stacked = T.tree_update(self.stacked, index, params)

    def get_state(self):
        return self.stacked

    def set_state(self, state) -> None:
        self.stacked = state

    def save(self, path: str) -> None:
        from awesome_tpu_torch.fit.checkpoint import save_prior_cache

        save_prior_cache(self.stacked, path)

    def load(self, path: str) -> None:
        from awesome_tpu_torch.fit.checkpoint import load_prior_cache

        self.stacked = load_prior_cache(path, template=self.stacked)
