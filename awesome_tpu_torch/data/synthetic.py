"""Synthetic dataset generator producing ``ConvexitySample``-shaped data;
counterpart of ``awesome_tpu/data/synthetic.py`` (numpy, the same seed
gives the same scene bit for bit).

The reference benchmark images must be downloaded (`scripts/setup.py`);
where they are absent, tests and runs use procedurally generated scenes
that exercise the exact same code paths: colored convex shapes
(disks/ellipses) with occlusions, scribble masks, and ground truth with
the fg=0 convention. Video sequences are written in the FBMS-59 on-disk
layout (:func:`write_synthetic_fbms_sequence`), file for file as the JAX
package writes them.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from awesome_tpu_torch.data.convexity import ConvexitySample


def _shape_mask(rng, h: int, w: int) -> np.ndarray:
    cy = rng.uniform(0.35 * h, 0.65 * h)
    cx = rng.uniform(0.35 * w, 0.65 * w)
    ry = rng.uniform(0.18 * h, 0.3 * h)
    rx = rng.uniform(0.18 * w, 0.3 * w)
    theta = rng.uniform(0, np.pi)
    yy, xx = np.mgrid[0:h, 0:w]
    yr = (yy - cy) * np.cos(theta) + (xx - cx) * np.sin(theta)
    xr = -(yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta)
    return (yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0


def _distractor_mask(rng, h: int, w: int, obj: np.ndarray) -> np.ndarray:
    """A smaller convex blob disjoint from (and not touching) the object —
    a color-ambiguous distractor for the hard benchmark."""
    yy, xx = np.mgrid[0:h, 0:w]
    from scipy import ndimage

    keepout = ndimage.binary_dilation(obj, iterations=3)
    for _ in range(30):
        cy = rng.uniform(0.1 * h, 0.9 * h)
        cx = rng.uniform(0.1 * w, 0.9 * w)
        ry = rng.uniform(0.05 * h, 0.11 * h)
        rx = rng.uniform(0.05 * w, 0.11 * w)
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        if not (m & keepout).any() and m.any():
            return m
    return np.zeros((h, w), bool)


def make_sample(
    seed: int,
    h: int = 64,
    w: int = 64,
    occlude: bool = True,
    hard: float = 0.0,
    flip_scale: float = 1.0,
) -> ConvexitySample:
    """One synthetic scene: a colored convex object on textured background,
    optionally with an occluding stripe (the 'tomato behind leaves' case —
    the prior should recover the full object).

    ``hard`` in [0, 1] controls the DISCRIMINATIVE benchmark axes
    (VERDICT r4: the hard=0 scenes saturate — every model family scores
    identically because color alone separates fg/bg). Hardness adds:

    - **textured background**: an oriented sinusoidal texture plus a
      smooth color gradient instead of uniform noise;
    - **color-ambiguous distractors**: up to 3 convex blobs OFF the
      object whose color approaches the object's — a pointwise color
      rule misclassifies them, only capacity in (y, x) or local context
      separates;
    - **fg/bg color overlap**: the object color is pulled toward the
      background palette;
    - **noisy scribbles**: a fraction of the weak labels is flipped
      (like real SSS-derived weak labels). ``flip_scale`` multiplies the
      base ~8%·hard flip rate (capped at 40% of each class) — the
      overfit-probe axis: at high rates late epochs memorize the flipped
      points and dense-GT eval declines, so best-epoch != last-epoch;
    - **wider occluder**: more of the object only recoverable by the
      prior.
    """
    rng = np.random.default_rng(seed)
    hard = float(np.clip(hard, 0.0, 1.0))
    obj = _shape_mask(rng, h, w)
    yy, xx = np.mgrid[0:h, 0:w]

    if hard > 0:
        # smooth two-color gradient + oriented sinusoidal texture
        g_theta = rng.uniform(0, np.pi)
        t = ((yy * np.cos(g_theta) + xx * np.sin(g_theta))
             / max(h, w)).astype(np.float32)
        c0 = rng.uniform(0.1, 0.5, size=(3,)).astype(np.float32)
        c1 = rng.uniform(0.1, 0.5, size=(3,)).astype(np.float32)
        image = c0 * (1 - t[..., None]) + c1 * t[..., None]
        freq = rng.uniform(4.0, 9.0)
        t_theta = rng.uniform(0, np.pi)
        wave = np.sin(
            2 * np.pi * freq
            * (yy * np.cos(t_theta) + xx * np.sin(t_theta)) / min(h, w)
            + rng.uniform(0, 2 * np.pi)
        ).astype(np.float32)
        tex_col = rng.uniform(-1, 1, size=(3,)).astype(np.float32)
        image = image + 0.20 * hard * wave[..., None] * tex_col
        image += rng.normal(0, 0.02, size=(h, w, 3)).astype(np.float32)
    else:
        image = rng.uniform(0.0, 0.35, size=(h, w, 3)).astype(np.float32)

    color = rng.uniform(0.6, 1.0, size=(3,)).astype(np.float32)
    if hard > 0:
        # pull the object color toward the background palette
        bg_mean = image[~obj].mean(axis=0)
        color = (1 - 0.45 * hard) * color + 0.45 * hard * bg_mean
    image[obj] = color + rng.normal(
        0, 0.03, size=(int(obj.sum()), 3)
    ).astype(np.float32)

    distractors = np.zeros((h, w), bool)
    for _ in range(int(round(3 * hard))):
        m = _distractor_mask(rng, h, w, obj)
        # distractor color converges to the object's as hard -> 1
        d_col = color + rng.normal(0, 0.25 * (1.05 - hard), size=(3,))
        image[m] = d_col.astype(np.float32) + rng.normal(
            0, 0.03, size=(int(m.sum()), 3)
        ).astype(np.float32)
        distractors |= m
    image = np.clip(image, 0.0, 1.0)

    visible = obj.copy()
    if occlude:
        # occluder: a rotated stripe of bounded width so a guaranteed
        # majority of the object stays visible (a full random shape could
        # swallow it entirely and leave no fg scribbles)
        theta = rng.uniform(0, np.pi)
        d = (yy - h / 2) * np.cos(theta) + (xx - w / 2) * np.sin(theta)
        offset = rng.uniform(-0.15, 0.15) * min(h, w)
        # thin occluder (~leaf over tomato): hides 10-20% of the object
        # so the full-GT IoU cap stays realistic; hardness widens it
        stripe = (np.abs(d - offset)
                  < (0.04 + 0.03 * hard) * min(h, w)) & obj
        image[stripe] = rng.uniform(0.0, 0.25, size=(3,)).astype(np.float32)
        visible = obj & ~stripe

    gt = 1.0 - obj.astype(np.float32)  # fg = 0 convention

    # scribbles: random subsets of visible fg and of bg, with a floor so
    # every sample carries both classes; hardness sparsifies fg labels
    fg_scr = visible & (rng.random((h, w)) < 0.25 * (1 - 0.5 * hard))
    bg_scr = (~obj) & (rng.random((h, w)) < 0.1)
    if fg_scr.sum() < 8:
        idx = np.argwhere(visible)
        take = idx[rng.permutation(len(idx))[: max(8, len(idx) // 4)]]
        fg_scr[take[:, 0], take[:, 1]] = True
    if hard > 0:
        # weak-label noise (real SSS-derived scribbles are noisy): flip
        # a slice of each class's scribbles to the other class. The
        # bg->fg flip COUNT is tied to the fg class size (bg is several
        # times larger) so the wrong fraction of each resulting class
        # stays ~8% regardless of how much of the object is visible
        flip_p = min(0.08 * hard * max(flip_scale, 0.0), 0.40)
        flip_fg = fg_scr & (rng.random((h, w)) < flip_p)
        bg_idx = np.argwhere(bg_scr)
        n_flip = int(round(flip_p * int(fg_scr.sum())))
        flip_bg = np.zeros((h, w), bool)
        if n_flip and len(bg_idx):
            take = bg_idx[rng.permutation(len(bg_idx))[:n_flip]]
            flip_bg[take[:, 0], take[:, 1]] = True
        fg_scr = (fg_scr & ~flip_fg) | flip_bg
        bg_scr = (bg_scr & ~flip_bg) | flip_fg
        # the flipped scribble CLAIMS the other class — training targets
        # must follow the claim (train_gt), while `gt` stays the clean
        # evaluation truth. Moving mask membership alone is invisible to
        # the pixel path: both here and in the reference the pixel target
        # is the dense GT read at scribble positions
        # (`awesome/dataset/convexity_segmentation_dataset.py:195-207`),
        # and fg|bg union + gt values are invariant under membership swaps
        train_gt = gt.copy()
        train_gt[flip_fg] = 1.0  # was fg (0), now claims bg
        train_gt[flip_bg] = 0.0  # was bg (1), now claims fg
    else:
        train_gt = None
    return ConvexitySample(
        image=image, gt=gt, fg_mask=fg_scr, bg_mask=bg_scr, index=seed,
        train_gt=train_gt,
    )


def synthetic_convexity_dataset(
    n: int = 8,
    h: int = 64,
    w: int = 64,
    occlude: bool = True,
    seed0: int = 0,
    hard: float = 0.0,
    hard_spread: bool = False,
    flip_scale: float = 1.0,
) -> List[ConvexitySample]:
    """``hard_spread=True`` ramps per-image difficulty 0..``hard`` across
    the dataset (the per-image difficulty spread the reference benchmark
    has naturally — `notebooks/evaluation.ipynb` cell 13's 0.79-0.91
    range)."""
    if hard_spread and n > 1:
        levels = [hard * i / (n - 1) for i in range(n)]
    else:
        levels = [hard] * n
    return [
        make_sample(seed0 + i, h, w, occlude, hard=levels[i],
                    flip_scale=flip_scale)
        for i in range(n)
    ]


def write_fbms_layout(
    root: str,
    name: str,
    n_frames: int,
    trajs: List[Tuple[int, List[Tuple[float, float, int]]]],
    frames: List[np.ndarray],
    gt_masks: dict,
) -> str:
    """Serialize a synthetic sequence in the FBMS-59 on-disk layout: the
    one format writer every synthetic-sequence generator delegates to, in
    sync with the ``data/fbms.py`` parser. ``trajs`` is ``[(object_id,
    [(x, y, frame), ...])]`` in the Ochs et al. multicut ``.dat`` format;
    ``frames`` is a list of ``(H, W, 3)`` uint8 images; ``gt_masks`` maps
    frame index -> ``(H, W)`` uint8 mask (255 = object). Layout spec:
    `awesome/dataset/fbms_sequence_dataset.py`."""
    import os

    from PIL import Image

    seq = os.path.join(str(root), name)
    os.makedirs(os.path.join(seq, "GroundTruth"), exist_ok=True)
    os.makedirs(os.path.join(seq, "tracks", "multicut"), exist_ok=True)
    with open(os.path.join(seq, "tracks", "multicut", f"{name}.dat"),
              "w") as f:
        f.write(f"{n_frames}\n{len(trajs)}\n")
        for oid, pts in trajs:
            f.write(f"{oid} {len(pts)}\n")
            for x, y, fr in pts:
                f.write(f"{x:.2f} {y:.2f} {fr}\n")
    for i, img in enumerate(frames):
        Image.fromarray(np.asarray(img, np.uint8)).save(
            os.path.join(seq, f"{name}_{i:02d}.png"))
    labeled = sorted(gt_masks)
    for i in labeled:
        Image.fromarray(np.asarray(gt_masks[i], np.uint8)).save(
            os.path.join(seq, "GroundTruth", f"gt_{i:02d}.png"))
    with open(os.path.join(seq, "GroundTruth", f"{name}Def.dat"),
              "w") as f:
        f.write(
            f"Sequence {name}\n\nTotal number of regions:\n2\n"
            "Scale of region 0:\n100\nScale of region 1:\n50\n\n"
            "Confusion penality matrix:\n0 1\n1 0\n\n"
            f"Total number of frames in this shot:\n{n_frames}\n"
            "Total number of labeled frames for this shot:\n"
            f"{len(labeled)}\n"
            + "".join(f"gt_{i:02d}.png\n{i}\n" for i in labeled)
        )
    return seq


def write_synthetic_fbms_sequence(
    root: str,
    name: str = "syn99",
    n_frames: int = 5,
    h: int = 24,
    w: int = 32,
    seed: int = 0,
) -> str:
    """Write a synthetic moving-disk sequence in the FBMS-59 on-disk
    layout (frames, ``tracks/multicut/<seq>.dat`` trajectories: 12 on the
    disk as object 1 and 20 off it as background, and ``GroundTruth/``
    masks of the first and last frame with a ``<Seq>Def.dat``
    description), so the FBMS pipeline runs end to end without the
    FBMS-59 files. Geometry only; serialization is
    :func:`write_fbms_layout`."""
    rng = np.random.default_rng(seed)

    def _center(f: int) -> Tuple[float, float]:
        return 0.5 * h, 0.22 * w + (0.5 * w / max(n_frames - 1, 1)) * f

    r = 0.22 * min(h, w)
    trajs = []
    for oid, n_traj in ((1, 12), (0, 20)):
        for _ in range(n_traj):
            pts = []
            if oid == 1:
                ang = rng.uniform(0, 2 * np.pi)
                rad = rng.uniform(0, 0.8 * r)
                for f in range(n_frames):
                    cy, cx = _center(f)
                    pts.append((cx + rad * np.cos(ang),
                                cy + rad * np.sin(ang), f))
            else:
                # background points kept off the disk in every frame
                while True:
                    x0 = rng.uniform(0, w - 1)
                    y0 = rng.uniform(0, h - 1)
                    if all(
                        (y0 - _center(f)[0]) ** 2
                        + (x0 - _center(f)[1]) ** 2 > (r + 2) ** 2
                        for f in range(n_frames)
                    ):
                        break
                for f in range(n_frames):
                    pts.append((x0, y0, f))
            trajs.append((oid, pts))

    yy, xx = np.mgrid[0:h, 0:w]

    def _disk(i: int) -> np.ndarray:
        cy, cx = _center(i)
        return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r

    frames = []
    for i in range(n_frames):
        img = np.zeros((h, w, 3), np.uint8) + 30
        img[_disk(i)] = 200
        frames.append(img)
    gt_masks = {
        i: np.where(_disk(i), 255, 0).astype(np.uint8)
        for i in (0, n_frames - 1)
    }
    return write_fbms_layout(root, name, n_frames, trajs, frames, gt_masks)
