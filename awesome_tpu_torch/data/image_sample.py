"""Per-image feature assembly, the ImageSample equivalent; counterpart of
``awesome_tpu/data/image_sample.py``.

Behavior spec: `awesome/dataset/image_sample.py:15-334`. A sample exposes
the channels the models consume:

- rgb, xy (positional encoding; optionally distance-scribble features),
- xy_clean (the plain [0,1] grid the prior is queried on),
- scribble (weak labels), gt, edge map (Sobel), semantic features (PCA of
  precomputed embedding maps -> 2 channels).

Implemented host-side in numpy (cold path); arrays are NHWC-ready. The
cv2-based edge map (`:260-275`) is reproduced with numpy separable
filters; the TF1 Soft-Semantic-Segmentation extractor
(`awesome/run/semantic_soft_segmentation_extractor.py:1`) is external in
the reference too — here ``semantic_features`` consumes precomputed
embedding maps (.npy) when present.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from awesome_tpu_torch.core import grids as G


def _gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    if sigma <= 0:
        # OpenCV's default sigma for given ksize
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _sep_filter(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 2D filter with reflect-101 borders (cv2 default)."""
    pad = len(k) // 2
    out = np.pad(img, ((pad, pad), (0, 0)), mode="reflect")
    out = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="valid"), 0, out
    )
    out = np.pad(out, ((0, 0), (pad, pad)), mode="reflect")
    out = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="valid"), 1, out
    )
    return out


def _conv2(img: np.ndarray, kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    pad = 1
    out = np.pad(img, pad, mode="reflect")
    h, w = img.shape
    res = np.zeros_like(img, dtype=np.float64)
    for dy in range(3):
        for dx in range(3):
            res += ky[dy] * kx[dx] * out[dy : dy + h, dx : dx + w]
    return res


def edge_map(image: np.ndarray) -> np.ndarray:
    """Sobel edge magnitude, cv2-recipe parity (`image_sample.py:260-275`):
    gaussian(3) -> gray -> |sobel_x|/2 + |sobel_y|/2 -> /255 -> gaussian(5).

    ``image``: (H, W, 3) float [0,1]. Returns (H, W) float32 in [0,1].
    """
    img = (np.clip(image, 0, 1) * 255).astype(np.uint8).astype(np.float64)
    blur = np.stack(
        [_sep_filter(img[..., c], _gaussian_kernel1d(3)) for c in range(3)],
        axis=-1,
    )
    # cv2 RGB2GRAY weights
    gray = blur @ np.asarray([0.299, 0.587, 0.114])
    # sobel via separable [1,2,1] x [-1,0,1]
    gx = _conv2(gray, np.asarray([-1.0, 0.0, 1.0]), np.asarray([1.0, 2.0, 1.0]))
    gy = _conv2(gray, np.asarray([1.0, 2.0, 1.0]), np.asarray([-1.0, 0.0, 1.0]))
    grad = 0.5 * np.clip(np.abs(gx), 0, 255) + 0.5 * np.clip(np.abs(gy), 0, 255)
    grad = grad / 255.0
    grad = _sep_filter(grad, _gaussian_kernel1d(5))
    return grad.astype(np.float32)


def semantic_features(
    embedmap: np.ndarray, n_components: int = 2
) -> np.ndarray:
    """PCA of a (H, W, C) embedding map -> (H, W, n_components) in [0,1].

    Parity with `image_sample.py:223-247`: PCA is fit on the (C, H*W)
    matrix and the *components* (not the projection) are reshaped back —
    an idiosyncrasy we reproduce exactly.
    """
    from sklearn.decomposition import PCA

    h, w, c = embedmap.shape
    X = np.moveaxis(embedmap, -1, 0).reshape(c, -1)
    pca = PCA(n_components=n_components)
    pca.fit(X)
    feat = pca.components_.reshape(n_components, h, w)
    feat = (feat - feat.min()) / max(feat.max() - feat.min(), 1e-12)
    return np.moveaxis(feat, 0, -1).astype(np.float32)


def load_semantic_features(
    feature_dir: str, name: str, n_components: int = 2
) -> Optional[np.ndarray]:
    """Load a precomputed embedmap (<name>.npy with key-free array or .npz
    with 'embedmap') and PCA it; None if absent."""
    for ext in (".npy", ".npz"):
        path = os.path.join(feature_dir, name + ext)
        if os.path.exists(path):
            data = np.load(path)
            emb = data["embedmap"] if hasattr(data, "files") else data
            return semantic_features(np.asarray(emb), n_components)
    return None


def assemble_channels(
    image: np.ndarray,
    xy_mode: str = "xy",
    scribble: Optional[np.ndarray] = None,
    t: Optional[float] = None,
    t_max: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Build the positional feature encoding (H, W, C).

    xy_mode: 'xy' (plain grid), 'distance_scribble' (per-class EDT of the
    scribble, `awesome/dataset/transformator.py:63-83`), or
    'gauss_bubbles' (random Gaussian bump channels,
    `awesome/dataset/transformator.py:85-110`).
    """
    h, w = image.shape[:2]
    if xy_mode == "xy":
        grid = G.positional_grid(w, h, t=t, t_max=t_max,
                                 device="cpu").numpy()
        return np.moveaxis(grid, 0, -1)
    if xy_mode == "distance_scribble":
        if scribble is None:
            raise ValueError("distance_scribble needs a scribble map")
        from scipy import ndimage

        c = int(scribble.max())
        feats = []
        for i in range(c):
            onehot = (scribble == i).astype(np.float64)
            dist = ndimage.distance_transform_edt(
                1 - onehot, sampling=[1 / h, 1 / w]
            )
            feats.append(dist.astype(np.float32))
        return np.stack(feats, axis=-1)
    if xy_mode == "gauss_bubbles":
        # reference draws fresh bubbles per access (unseeded); pass a
        # seeded rng for reproducibility (t/t_max don't apply — the
        # reference's bubble encoding is 2d-only, transformator.py:17-18)
        return gauss_bubbles((h, w), rng=rng)
    raise ValueError(f"Unknown xy_mode {xy_mode}")


def gauss_bubbles(
    shape,
    n_bubbles: int = 20,
    kernel_size: int = 101,
    std: float = 3.0,
    scale: float = 500.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random Gaussian-bump positional channels (H, W, n_bubbles).

    Behavior port of `awesome/dataset/transformator.py:85-118`
    (``gauss_bubbles`` + ``gkern``): each channel is zero except for one
    ``kernel_size``-wide normalized Gaussian bump (CDF-difference outer
    product, scaled by 500) dropped at a uniformly random interior
    location. The reference hardcodes no=20/101/std 3; we expose them.
    """
    from scipy import stats

    h, w = shape
    half = kernel_size // 2
    if h < kernel_size + 1 or w < kernel_size + 1:
        raise ValueError(
            f"image {shape} smaller than gauss_bubbles kernel {kernel_size}"
        )
    rng = rng or np.random.default_rng()
    xs = np.linspace(-std, std, kernel_size + 1)
    k1 = np.diff(stats.norm.cdf(xs))
    kern = np.outer(k1, k1)
    kern = (kern / kern.sum() * scale).astype(np.float32)
    out = np.zeros((h, w, n_bubbles), np.float32)
    for i in range(n_bubbles):
        cy = int(rng.integers(half, h - half - 1))
        cx = int(rng.integers(half, w - half - 1))
        out[cy - half:cy + half + 1, cx - half:cx + half + 1, i] = kern
    return out
