"""A synthetic reference tree for the teaser harness
(``awesome_tpu_torch/runner/teaser.py`` and its JAX counterpart).

The harness opens files under ``AWESOME_REFERENCE_ROOT``: the reference's
notebook images, scribbles, naive masks and shipped result masks. This
tool writes a file at every name the nine protocols open, each image
holding a shape its prior can represent and each result mask that shape:

- a red convex blob with a green band across it (the tomato; the naive
  colour threshold misses the band), in the convex teaser and the how-to;
- a five-armed star with a blue band across one arm;
- a mirror-symmetric two-winged shape on green (the butterfly; its
  shipped mask is the background);
- a dot lattice, and its naive mask with some dots missing and speckle;
- a two-level depth map (a near disk on a far plane) with green scribbles
  on the disk and red ones around it;
- an elongated region with red scribble strokes (the cat), in the
  connectedness teaser and the how-to;
- eight frames of a moving disk, their naive masks (a bar cut out, some
  speckle) and their result masks.

Run ``python -m tools.teaser_tree --root DIR [--h 480 --w 640]`` and point
``AWESOME_REFERENCE_ROOT`` at ``DIR``. Sizes are arguments: the images are
``h x w``, the temporal masks ``--frame-h x --frame-w`` (default the
same). Everything comes from ``--seed``.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np

TEASER = os.path.join("notebooks", "icml_teaser_code")
HOWTO = os.path.join("notebooks", "how_to", "data")
FRAMES = 8


def _grid(h: int, w: int):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    return yy, xx


def _disk(h: int, w: int, cy: float, cx: float, r: float) -> np.ndarray:
    yy, xx = _grid(h, w)
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2


def _paint(shape: Tuple[int, int], base, noise: float,
           rng: np.random.Generator) -> np.ndarray:
    img = np.empty(shape + (3,), np.float64)
    img[:] = base
    return img + rng.normal(0.0, noise, img.shape)


def _save_rgb(path: str, img: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    im = Image.fromarray((np.clip(img, 0.0, 1.0) * 255).round()
                         .astype(np.uint8))
    if path.endswith(".jpg"):
        im.save(path, quality=95, subsampling=0)  # no chroma subsampling
    else:
        im.save(path)


def _save_mask(path: str, mask: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(mask.astype(np.uint8) * 255).save(path)


def tomato(h: int, w: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    """The red convex blob with a green band across it (as
    ``examples/howto_convexity.py``'s synthetic scene) on a grey-blue
    ground; the mask is the whole blob."""
    m = min(h, w)
    cy, cx = 0.5 * h, 0.5 * w
    blob = _disk(h, w, cy, cx, 0.3 * m)
    yy, xx = _grid(h, w)
    band = (np.abs((yy - cy) * 0.5 + (xx - cx) - 0.15 * m)
            < max(0.07 * m, 1.5)) & blob
    img = _paint((h, w), (0.15, 0.35, 0.35), 0.03, rng)
    img[blob] = (0.85, 0.15, 0.1)
    img[band] = (0.1, 0.5, 0.12)
    return img + rng.normal(0.0, 0.02, img.shape), blob


def star(h: int, w: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    """A five-armed star around the centre, orange on blue, with a blue
    band across one arm."""
    m = min(h, w)
    yy, xx = _grid(h, w)
    dy, dx = yy - 0.5 * h, xx - 0.5 * w
    r = np.hypot(dy, dx)
    theta = np.arctan2(dy, dx)
    shape = r <= 0.38 * m * (0.6 + 0.4 * np.cos(5 * theta))
    img = _paint((h, w), (0.2, 0.4, 0.6), 0.03, rng)
    img[shape] = (0.9, 0.3, 0.2)
    band = (np.abs(dx - 0.22 * m) < max(0.03 * m, 1.0)) & shape
    img[band] = (0.2, 0.4, 0.6)
    return img, shape


def butterfly(h: int, w: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    """Two wings mirrored about the vertical axis through the centre,
    purple on green; the mask is the background (as the shipped one)."""
    m = min(h, w)
    yy, xx = _grid(h, w)
    dy, dx = yy - 0.5 * h, np.abs(xx - 0.5 * w)
    wings = np.zeros((h, w), bool)
    for (oy, ox, a, b, ang) in ((-0.1, 0.17, 0.2, 0.12, 0.5),
                                (0.13, 0.12, 0.13, 0.08, -0.6)):
        c, s = np.cos(ang), np.sin(ang)
        u = (dx - ox * m) * c + (dy - oy * m) * s
        v = -(dx - ox * m) * s + (dy - oy * m) * c
        wings |= (u / (a * m)) ** 2 + (v / (b * m)) ** 2 <= 1.0
    wings |= (dx < max(0.03 * m, 1.0)) & (np.abs(dy) < 0.25 * m)
    img = _paint((h, w), (0.2, 0.8, 0.2), 0.03, rng)
    img[wings] = (0.6, 0.1, 0.6)
    return img, ~wings


def lattice(h: int, w: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    """A dot lattice (holes white) and its naive mask: a fifth of the dots
    missing and some speckle. The period is a quarter of the short side,
    within reach of ``PeriodicNet``'s sin features (``sin(10 pi W1 x)``,
    W1 drawn within +-1/sqrt(2), so periods of ~0.28 in centred
    coordinates at init): a lattice of a twelfth of the short side is
    not, and its fits stay at the constant predictor."""
    p = max(int(round(min(h, w) / 4)), 4)
    yy, xx = _grid(h, w)
    cell_y, cell_x = np.floor(yy / p), np.floor(xx / p)
    ry, rx = yy - (cell_y + 0.5) * p, xx - (cell_x + 0.5) * p
    dots = ry ** 2 + rx ** 2 <= (0.3 * p) ** 2
    ny, nx = int(cell_y.max()) + 1, int(cell_x.max()) + 1
    keep = rng.random((ny, nx)) >= 0.2
    naive = dots & keep[cell_y.astype(int), cell_x.astype(int)]
    naive |= rng.random((h, w)) < 0.01
    return dots, naive


def depth_scene(h: int, w: int) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]:
    """(depth, scribbles, result mask, naive mask): a near disk (0.8) on a
    far plane (0.2); green scribbles on the disk, red ones around it; the
    naive mask is the disk with a notch."""
    m = min(h, w)
    cy, cx, r = 0.5 * h, 0.5 * w, 0.3 * m
    disk = _disk(h, w, cy, cx, r)
    depth = np.where(disk, 0.8, 0.2)
    yy, xx = _grid(h, w)
    t = max(0.04 * m, 2.0)
    scr = np.full((h, w, 3), 0.5)
    green = ((np.abs(yy - cy) < t) & (np.abs(xx - cx) < 0.6 * r)) | (
        (np.abs(xx - cx) < t) & (np.abs(yy - cy) < 0.6 * r))
    red = ((np.abs(yy - 0.08 * h) < t) | (np.abs(yy - 0.92 * h) < t)
           | (np.abs(xx - 0.08 * w) < t) | (np.abs(xx - 0.92 * w) < t))
    scr[green] = (0.1, 0.8, 0.1)
    scr[red] = (0.9, 0.1, 0.1)
    notch = (yy > cy) & (np.abs(xx - cx) < 0.25 * r)
    return depth, scr, disk, disk & ~notch


def cat(h: int, w: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    """An elongated region (a tilted ellipse, brown on grey) with red
    scribble strokes along its long axis and across it."""
    m = min(h, w)
    yy, xx = _grid(h, w)
    ang = 0.35
    c, s = np.cos(ang), np.sin(ang)
    dy, dx = yy - 0.5 * h, xx - 0.5 * w
    u, v = dx * c + dy * s, -dx * s + dy * c
    a, b = 0.42 * w, 0.16 * m
    region = (u / a) ** 2 + (v / b) ** 2 <= 1.0
    t = max(0.025 * m, 1.5)
    strokes = ((np.abs(v) < t) & (np.abs(u) < 0.75 * a)) | (
        (np.abs(u - 0.3 * a) < t) & (np.abs(v) < 0.6 * b)) | (
        (np.abs(u + 0.4 * a) < t) & (np.abs(v) < 0.6 * b))
    img = _paint((h, w), (0.3, 0.35, 0.4), 0.03, rng)
    img[region] = (0.55, 0.45, 0.35)
    img[strokes & region] = (1.0, 0.0, 0.0)
    return img, region


def ball(h: int, w: int, i: int, rng) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Frame ``i`` of a disk moving left to right: (frame, result mask,
    naive mask with a bar cut out and some speckle)."""
    m = min(h, w)
    cx = (0.3 + 0.4 * i / (FRAMES - 1)) * w
    cy, r = 0.5 * h, 0.2 * m
    disk = _disk(h, w, cy, cx, r)
    yy, xx = _grid(h, w)
    bar = np.abs(yy - cy - 0.3 * r * np.sin(i)) < max(0.15 * r, 1.0)
    naive = (disk & ~bar) | (rng.random((h, w)) < 0.005)
    frame = _paint((h, w), (0.3, 0.5, 0.3), 0.03, rng)
    frame[disk] = (0.9, 0.6, 0.1)
    return frame, disk, naive


def write_tree(root: str, h: int = 480, w: int = 640,
               frame_shape: Optional[Tuple[int, int]] = None,
               seed: int = 0) -> str:
    """Write the tree under ``root``; returns ``root``."""
    rng = np.random.default_rng(seed)
    t = os.path.join(root, TEASER)
    howto = os.path.join(root, HOWTO)

    img, blob = tomato(h, w, rng)
    for path in (os.path.join(t, "convex", "cocktail-tomatoes.jpg"),
                 os.path.join(howto, "cocktail-tomatoes.jpg")):
        _save_rgb(path, img)
    _save_mask(os.path.join(t, "convex", "mask.png"), blob)

    img, shape = star(h, w, rng)
    _save_rgb(os.path.join(t, "star_shaped", "starfish.jpg"), img)
    _save_mask(os.path.join(t, "star_shaped", "original", "mask.png"), shape)

    img, background = butterfly(h, w, rng)
    _save_rgb(os.path.join(t, "rotation_symmetric", "butter2.jpg"), img)
    _save_mask(os.path.join(t, "rotation_symmetric", "original", "mask.png"),
               background)

    dots, naive = lattice(h, w, rng)
    _save_mask(os.path.join(t, "repeating", "original", "mask.png"), dots)
    _save_mask(os.path.join(t, "repeating", "original", "mask_naive.png"),
               naive)

    depth, scr, disk, notched = depth_scene(h, w)
    base = os.path.join(t, "convex-depth")
    os.makedirs(base, exist_ok=True)
    from PIL import Image

    Image.fromarray((depth * 255).round().astype(np.uint8)).save(
        os.path.join(base, "depth.png"))
    _save_rgb(os.path.join(base, "depth_scribbles.png"), scr)
    _save_mask(os.path.join(base, "original", "mask_ours.png"), disk)
    _save_mask(os.path.join(base, "original", "mask_no_convexity.png"),
               notched)

    img, region = cat(h, w, rng)
    for path in (os.path.join(t, "connectedness", "cat_scribbled.jpg"),
                 os.path.join(howto, "cat_scribbled.jpg")):
        _save_rgb(path, img)
    for name in ("mask.png", "pc_prior_mask_rescale.png"):
        _save_mask(os.path.join(t, "connectedness", "original", name),
                   region)

    fh, fw = frame_shape or (h, w)
    base = os.path.join(t, "temporal_connectedness")
    for i in range(FRAMES):
        frame, disk, naive = ball(fh, fw, i, rng)
        _save_rgb(os.path.join(base, "test", f"img_{i}.jpg"), frame)
        _save_mask(os.path.join(base, "original", f"mask_{i}.png"), disk)
        _save_mask(os.path.join(base, "original", f"mask_{i}_naive.png"),
                   naive)
    return root


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--h", type=int, default=480)
    p.add_argument("--w", type=int, default=640)
    p.add_argument("--frame-h", type=int, default=None)
    p.add_argument("--frame-w", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    frames = None
    if args.frame_h or args.frame_w:
        frames = (args.frame_h or args.h, args.frame_w or args.w)
    write_tree(args.root, args.h, args.w, frames, args.seed)
    print(f"wrote the synthetic reference tree under {args.root}")


if __name__ == "__main__":
    main()
