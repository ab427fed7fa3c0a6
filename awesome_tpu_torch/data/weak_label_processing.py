"""Weak-label preprocessing: outlier removal and confidence-based
uncertainty re-labeling; counterpart of
``awesome_tpu/data/weak_label_processing.py`` (numpy only, so the same
``np.random.Generator`` draws give the same flips).

Behavior port of `awesome/dataset/fbms_sequence_sample.py:505-706`
(``_process_weak_label`` + ``_closest_node``): before training on sparse
trajectory labels,

1. **outlier removal** — a foreground point whose nearest other
   foreground point is further than OUTLIER_THRESHOLD (squared pixel
   distance) becomes unlabeled (`:540-546`),
2. **uncertainty re-labeling** — points with tracker confidence < 0.4 get
   re-voted from a 128x128 patch around them: class votes in the patch,
   normalized by global class frequency, decide whether the label flips
   (`:560-660`).

The reference runs these as per-point Python loops; here both are
vectorized numpy (KD-tree for neighbors, summed-area tables for patch
votes) — host-side preprocessing, cached per frame.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def remove_foreground_outliers(
    unaries: np.ndarray,
    labeled: np.ndarray,
    outlier_threshold_sq: float = 1000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Unlabel isolated fg points (unaries==0 & labeled)."""
    from scipy.spatial import cKDTree

    fg = (unaries == 0.0) & labeled
    pts = np.argwhere(fg)
    if len(pts) < 2:
        return unaries, labeled
    tree = cKDTree(pts)
    # nearest neighbor excluding self: k=2
    dists, _ = tree.query(pts, k=2)
    nearest_sq = dists[:, 1] ** 2
    bad = nearest_sq > outlier_threshold_sq
    labeled = labeled.copy()
    unaries = unaries.copy()
    labeled[pts[bad, 0], pts[bad, 1]] = False
    unaries[pts[bad, 0], pts[bad, 1]] = 1.0
    return unaries, labeled


def _box_sum(img: np.ndarray, radius: int) -> np.ndarray:
    """Sum over a (2r x 2r) box via a summed-area table."""
    h, w = img.shape
    sat = np.zeros((h + 1, w + 1), np.float64)
    sat[1:, 1:] = np.cumsum(np.cumsum(img, 0), 1)
    ys = np.arange(h)
    xs = np.arange(w)
    y0 = np.clip(ys - radius, 0, h)[:, None]
    y1 = np.clip(ys + radius, 0, h)[:, None]
    x0 = np.clip(xs - radius, 0, w)[None, :]
    x1 = np.clip(xs + radius, 0, w)[None, :]
    return (
        sat[y1, x1] - sat[y0, x1] - sat[y1, x0] + sat[y0, x0]
    )


def flip_probabilities(
    unaries: np.ndarray,
    labeled: np.ndarray,
    patch_radius: int = 64,
    bg_support_threshold: int = 900,
    bg_vote_cap: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point flip probabilities from patch votes weighted by GLOBAL
    class frequency — the reference's scheme
    (`awesome/dataset/fbms_sequence_sample.py:560-668`):

    - a labeled point may flip to the OTHER class with probability equal
      to that class's normalized vote share in the surrounding patch,
    - a class whose global support exceeds ``bg_support_threshold`` points
      ("most probably a bg label", `:624`) has its vote share capped at
      ``bg_vote_cap``,
    - a point whose OWN label has global support above the threshold never
      flips (`:658-662` — background points are trusted),
    - the patch must contain both classes (`:605` requires > 2 labels
      including the none label).

    Returns (p_to_fg, p_to_bg) maps; zeros where no flip is possible.
    """
    fg = ((unaries == 0.0) & labeled).astype(np.float64)
    bg = ((unaries == 1.0) & labeled).astype(np.float64)
    fg_votes = _box_sum(fg, patch_radius)
    bg_votes = _box_sum(bg, patch_radius)
    total = fg_votes + bg_votes
    both = (fg_votes > 0) & (bg_votes > 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        fg_share = np.where(total > 0, fg_votes / total, 0.0)
        bg_share = np.where(total > 0, bg_votes / total, 0.0)
    global_fg = int(fg.sum())
    global_bg = int(bg.sum())
    if global_fg > bg_support_threshold:
        fg_share = np.minimum(fg_share, bg_vote_cap)
    if global_bg > bg_support_threshold:
        bg_share = np.minimum(bg_share, bg_vote_cap)
    # bg-labeled points flip to fg; fg-labeled points flip to bg
    p_to_fg = np.where((unaries == 1.0) & labeled & both, fg_share, 0.0)
    p_to_bg = np.where((unaries == 0.0) & labeled & both, bg_share, 0.0)
    # own-label trust: points of a globally-dominant class never flip
    if global_bg > bg_support_threshold:
        p_to_fg = np.zeros_like(p_to_fg)
    if global_fg > bg_support_threshold:
        p_to_bg = np.zeros_like(p_to_bg)
    return p_to_fg, p_to_bg


def flip_on_probability(
    unaries: np.ndarray,
    p_to_fg: np.ndarray,
    p_to_bg: np.ndarray,
    rng: np.random.Generator,
) -> np.ndarray:
    """Sample the flips (`fbms_sequence_sample.py:706` _flip_on_probability):
    independent uniforms per point; fg flips take precedence over bg."""
    r = rng.random(unaries.shape + (2,))
    to_fg = r[..., 0] < p_to_fg
    to_bg = (r[..., 1] < p_to_bg) & ~to_fg
    out = unaries.copy()
    out[to_fg] = 0.0
    out[to_bg] = 1.0
    return out


def relabel_uncertain(
    unaries: np.ndarray,
    labeled: np.ndarray,
    confidence: np.ndarray,
    uncertainty_threshold: float = 0.4,
    patch_radius: int = 64,
    rng: Optional[np.random.Generator] = None,
    bg_support_threshold: int = 900,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stochastic re-labeling of low-confidence points: flip probabilities
    from patch votes with global-frequency weighting, then sampled flips —
    matching `fbms_sequence_sample.py:560-706` (vectorized; the reference
    loops points in Python)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    conf = np.where(confidence == -1, 100.0, confidence)
    uncertain = (conf < uncertainty_threshold) & labeled
    p_to_fg, p_to_bg = flip_probabilities(
        unaries, labeled, patch_radius,
        bg_support_threshold=bg_support_threshold,
    )
    p_to_fg = np.where(uncertain, p_to_fg, 0.0)
    p_to_bg = np.where(uncertain, p_to_bg, 0.0)
    out = flip_on_probability(unaries, p_to_fg, p_to_bg, rng)
    return out, labeled


def process_weak_label(
    unaries: np.ndarray,
    labeled: np.ndarray,
    confidence: Optional[np.ndarray] = None,
    outlier_threshold_sq: float = 1000.0,
    uncertainty_threshold: float = 0.4,
    patch_radius: int = 64,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    unaries, labeled = remove_foreground_outliers(
        unaries, labeled, outlier_threshold_sq
    )
    if confidence is not None:
        unaries, labeled = relabel_uncertain(
            unaries, labeled, confidence, uncertainty_threshold, patch_radius,
            rng=np.random.default_rng(seed),
        )
    return unaries, labeled
