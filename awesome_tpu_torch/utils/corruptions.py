"""ImageNet-C style image corruptions for robustness experiments;
counterpart of ``awesome_tpu/utils/corruptions.py``, numpy/scipy/PIL as
it is, so the same seed gives equal arrays.

Behavior port of `awesome/util/corruptions.py:123-368` (which wraps
cv2/wand). Severity 1-5 parameter tables follow the ImageNet-C
convention. Input: (H, W, 3) float [0, 1]; output same, clipped.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def _rng(seed):
    return np.random.default_rng(seed)


def gaussian_noise(x, severity=1, seed=0):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    return np.clip(x + _rng(seed).normal(size=x.shape) * c, 0, 1).astype(
        np.float32
    )


def shot_noise(x, severity=1, seed=0):
    c = [60, 25, 12, 5, 3][severity - 1]
    return np.clip(
        _rng(seed).poisson(x * c) / float(c), 0, 1
    ).astype(np.float32)


def impulse_noise(x, severity=1, seed=0):
    amount = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    rng = _rng(seed)
    out = x.copy()
    mask = rng.random(x.shape[:2]) < amount
    salt = rng.random(x.shape[:2]) < 0.5
    out[mask & salt] = 1.0
    out[mask & ~salt] = 0.0
    return out.astype(np.float32)


def _gauss_blur(x, sigma):
    from scipy import ndimage

    return np.stack(
        [ndimage.gaussian_filter(x[..., c], sigma) for c in range(x.shape[-1])],
        axis=-1,
    )


def gaussian_blur(x, severity=1, seed=0):
    c = [1, 2, 3, 4, 6][severity - 1]
    return np.clip(_gauss_blur(x, c), 0, 1).astype(np.float32)


def defocus_blur(x, severity=1, seed=0):
    from scipy import ndimage

    radius = [3, 4, 6, 8, 10][severity - 1]
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    kernel = ((yy**2 + xx**2) <= radius**2).astype(np.float64)
    kernel /= kernel.sum()
    out = np.stack(
        [ndimage.convolve(x[..., c], kernel, mode="reflect")
         for c in range(x.shape[-1])],
        axis=-1,
    )
    return np.clip(out, 0, 1).astype(np.float32)


def motion_blur(x, severity=1, seed=0):
    from scipy import ndimage

    length = [8, 12, 16, 20, 26][severity - 1]
    angle = _rng(seed).uniform(-np.pi / 4, np.pi / 4)
    kernel = np.zeros((length, length))
    c = length // 2
    for i in range(length):
        t = i - c
        y = int(round(c + t * np.sin(angle)))
        xk = int(round(c + t * np.cos(angle)))
        if 0 <= y < length and 0 <= xk < length:
            kernel[y, xk] = 1
    kernel /= kernel.sum()
    out = np.stack(
        [ndimage.convolve(x[..., ch], kernel, mode="reflect")
         for ch in range(x.shape[-1])],
        axis=-1,
    )
    return np.clip(out, 0, 1).astype(np.float32)


def brightness(x, severity=1, seed=0):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    return np.clip(x + c, 0, 1).astype(np.float32)


def contrast(x, severity=1, seed=0):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    means = x.mean(axis=(0, 1), keepdims=True)
    return np.clip((x - means) * c + means, 0, 1).astype(np.float32)


def saturate(x, severity=1, seed=0):
    c = [2.0, 3.0, 5.0, 10.0, 20.0][severity - 1]
    gray = x.mean(axis=-1, keepdims=True)
    return np.clip(gray + (x - gray) * c, 0, 1).astype(np.float32)


def pixelate(x, severity=1, seed=0):
    from PIL import Image

    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = x.shape[:2]
    img = Image.fromarray((x * 255).astype(np.uint8))
    img = img.resize((max(int(w * c), 1), max(int(h * c), 1)), Image.BOX)
    img = img.resize((w, h), Image.NEAREST)
    return (np.asarray(img, np.float32) / 255.0).astype(np.float32)


def fog(x, severity=1, seed=0):
    c, decay = [(1.5, 2.0), (2.0, 2.0), (2.5, 1.7), (2.5, 1.5), (3.0, 1.4)][
        severity - 1
    ]
    h = x.shape[0]
    # diamond-square-ish plasma via filtered noise
    rng = _rng(seed)
    noise = rng.normal(size=x.shape[:2])
    from scipy import ndimage

    plasma = ndimage.gaussian_filter(noise, h / 8)
    plasma = (plasma - plasma.min()) / max(
        float(plasma.max() - plasma.min()), 1e-9
    )
    fog_layer = (c * plasma**decay)[..., None]
    mx = x.max()
    return np.clip((x + fog_layer) * mx / (mx + c), 0, 1).astype(np.float32)


def elastic_transform(x, severity=1, seed=0):
    from scipy import ndimage

    alpha, sigma = [(2, 0.7), (3, 0.7), (4, 0.6), (6, 0.6), (9, 0.6)][
        severity - 1
    ]
    h, w = x.shape[:2]
    rng = _rng(seed)
    dx = ndimage.gaussian_filter(rng.uniform(-1, 1, (h, w)), sigma * 8) * alpha
    dy = ndimage.gaussian_filter(rng.uniform(-1, 1, (h, w)), sigma * 8) * alpha
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    coords = np.stack([yy + dy, xx + dx])
    out = np.stack(
        [
            ndimage.map_coordinates(x[..., c], coords, order=1,
                                    mode="reflect")
            for c in range(x.shape[-1])
        ],
        axis=-1,
    )
    return np.clip(out, 0, 1).astype(np.float32)


def speckle_noise(x, severity=1, seed=0):
    c = [0.15, 0.2, 0.35, 0.45, 0.6][severity - 1]
    return np.clip(
        x + x * _rng(seed).normal(size=x.shape) * c, 0, 1
    ).astype(np.float32)


def glass_blur(x, severity=1, seed=0):
    """Blur -> iterated local pixel shuffling -> blur. The reference swaps
    pixel pairs in a Python double loop (`corruptions.py:158-173`); here
    each iteration is one vectorized gather of random neighbors."""
    sigma, max_delta, iters = [
        (0.7, 1, 2), (0.9, 2, 1), (1.0, 2, 3), (1.1, 3, 2), (1.5, 4, 2)
    ][severity - 1]
    rng = _rng(seed)
    h, w = x.shape[:2]
    out = _gauss_blur(x, sigma)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(iters):
        dy = rng.integers(-max_delta, max_delta + 1, size=(h, w))
        dx = rng.integers(-max_delta, max_delta + 1, size=(h, w))
        ys = np.clip(yy + dy, 0, h - 1)
        xs = np.clip(xx + dx, 0, w - 1)
        out = out[ys, xs]
    return np.clip(_gauss_blur(out, sigma), 0, 1).astype(np.float32)


def _clipped_zoom(img, zoom_factor):
    """Center-cropped zoom keeping the original shape
    (`corruptions.py:110-120` semantics)."""
    from scipy import ndimage

    h, w = img.shape[:2]
    ch, cw = int(np.ceil(h / zoom_factor)), int(np.ceil(w / zoom_factor))
    top, left = (h - ch) // 2, (w - cw) // 2
    crop = img[top:top + ch, left:left + cw]
    zoom = (h / crop.shape[0], w / crop.shape[1]) + (1,) * (img.ndim - 2)
    out = ndimage.zoom(crop, zoom, order=1)
    return out[:h, :w]


def zoom_blur(x, severity=1, seed=0):
    factors = [
        np.arange(1, 1.11, 0.01), np.arange(1, 1.16, 0.01),
        np.arange(1, 1.21, 0.02), np.arange(1, 1.26, 0.02),
        np.arange(1, 1.31, 0.03),
    ][severity - 1]
    acc = np.zeros_like(x)
    for z in factors:
        acc += _clipped_zoom(x, z)
    return np.clip((x + acc) / (len(factors) + 1), 0, 1).astype(np.float32)


def _frost_texture(h, w, rng):
    """Synthesized frost streak texture. The reference overlays bundled
    frost photographs (`corruptions.py:233-242`, asset files not shipped
    here) — filtered anisotropic noise thresholded into streaks is the
    asset-free stand-in."""
    from scipy import ndimage

    noise = rng.normal(size=(h, w))
    streaks = ndimage.gaussian_filter(noise, (0.8, 6.0))
    streaks += 0.6 * ndimage.gaussian_filter(noise, (6.0, 0.8))
    streaks = (streaks - streaks.min()) / max(
        float(streaks.max() - streaks.min()), 1e-9
    )
    frost = np.where(streaks > 0.55, streaks, 0.0)
    return np.repeat(frost[..., None], 3, axis=-1)


def frost(x, severity=1, seed=0):
    keep, amount = [
        (1.0, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7), (0.6, 0.75)
    ][severity - 1]
    tex = _frost_texture(x.shape[0], x.shape[1], _rng(seed))
    return np.clip(keep * x + amount * tex, 0, 1).astype(np.float32)


def snow(x, severity=1, seed=0):
    loc, scale, zoom, thresh, mb_len, _, blend = [
        (0.1, 0.3, 3.0, 0.5, 10, 4, 0.8),
        (0.2, 0.3, 2.0, 0.5, 12, 4, 0.7),
        (0.55, 0.3, 4.0, 0.9, 12, 8, 0.7),
        (0.55, 0.3, 4.5, 0.85, 12, 8, 0.65),
        (0.55, 0.3, 2.5, 0.85, 12, 12, 0.55),
    ][severity - 1]
    rng = _rng(seed)
    layer = rng.normal(size=x.shape[:2], loc=loc, scale=scale)
    layer = _clipped_zoom(layer[..., None], zoom)[..., 0]
    layer = np.where(layer < thresh, 0.0, layer)
    layer = motion_blur(
        np.repeat(np.clip(layer, 0, 1)[..., None], 3, -1),
        severity=min(max(mb_len // 6, 1), 5), seed=seed + 1,
    )[..., 0]
    gray = x.mean(axis=-1, keepdims=True)
    base = blend * x + (1 - blend) * np.maximum(x, gray * 1.5 + 0.5)
    return np.clip(
        base + layer[..., None] + np.rot90(layer, 2)[..., None], 0, 1
    ).astype(np.float32)


def spatter(x, severity=1, seed=0):
    """Water droplets (severities 1-3) / mud splatter (4-5)."""
    from scipy import ndimage

    loc, scale, sigma, thresh, mult, mud = [
        (0.65, 0.3, 4.0, 0.69, 0.9, 0), (0.65, 0.3, 3.5, 0.68, 0.9, 0),
        (0.65, 0.3, 3.0, 0.68, 0.8, 0), (0.65, 0.3, 1.2, 0.65, 1.8, 1),
        (0.67, 0.4, 1.2, 0.65, 1.8, 1),
    ][severity - 1]
    rng = _rng(seed)
    liquid = ndimage.gaussian_filter(
        rng.normal(size=x.shape[:2], loc=loc, scale=scale), sigma
    )
    if mud:
        m = (liquid > thresh).astype(np.float32)
        m = ndimage.gaussian_filter(m, mult)
        m = np.where(m < 0.8, 0.0, m)[..., None]
        color = np.asarray([63, 42, 20], np.float32) / 255.0
        return np.clip(
            x * (1 - m) + color[None, None] * m, 0, 1
        ).astype(np.float32)
    liquid = np.where(liquid < thresh, 0.0, liquid)
    # droplet highlights: edge magnitude of the liquid layer (the reference
    # uses canny+distance transform; sobel magnitude is the scipy stand-in)
    gy = ndimage.sobel(liquid, 0)
    gx = ndimage.sobel(liquid, 1)
    edges = np.sqrt(gy**2 + gx**2)
    m = liquid * edges
    m = m / max(float(m.max()), 1e-9) * mult
    color = np.asarray([175, 238, 238], np.float32) / 255.0  # pale turquoise
    return np.clip(x + m[..., None] * color[None, None], 0, 1).astype(
        np.float32
    )


def jpeg_compression(x, severity=1, seed=0):
    from io import BytesIO

    from PIL import Image

    quality = [25, 18, 15, 10, 7][severity - 1]
    buf = BytesIO()
    Image.fromarray((x * 255).astype(np.uint8)).save(
        buf, "JPEG", quality=quality
    )
    out = np.asarray(Image.open(buf), np.float32) / 255.0
    return out.astype(np.float32)


CORRUPTIONS: Dict[str, Callable] = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "gaussian_blur": gaussian_blur,
    "defocus_blur": defocus_blur,
    "motion_blur": motion_blur,
    "brightness": brightness,
    "contrast": contrast,
    "saturate": saturate,
    "pixelate": pixelate,
    "fog": fog,
    "elastic_transform": elastic_transform,
    "speckle_noise": speckle_noise,
    "glass_blur": glass_blur,
    "zoom_blur": zoom_blur,
    "frost": frost,
    "snow": snow,
    "spatter": spatter,
    "jpeg_compression": jpeg_compression,
}


def corrupt(x: np.ndarray, name: str, severity: int = 1,
            seed: int = 0) -> np.ndarray:
    if name not in CORRUPTIONS:
        raise ValueError(
            f"Unknown corruption {name}; available: {sorted(CORRUPTIONS)}"
        )
    if not 1 <= severity <= 5:
        raise ValueError("severity must be in 1..5")
    return CORRUPTIONS[name](x, severity=severity, seed=seed)
