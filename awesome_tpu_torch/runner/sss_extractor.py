"""Semantic Soft Segmentation feature extraction front-end; counterpart of
``awesome_tpu/runner/sss_extractor.py`` (numpy and scipy, kept as this
package's own copy).

The reference shells out to third-party TF1 Soft-Semantic-Segmentation
code to precompute 128-d embedding maps per image
(`awesome/run/semantic_soft_segmentation_extractor.py:1-261`), then PCA's
them to 2 channels inside ImageSample. Here the extractor

- consumes precomputed embedmaps (.npy/.npz) when present
  (``awesome_tpu_torch.data.image_sample.load_semantic_features``),
- can invoke a user-supplied command per image (the reference's shell-out
  pattern) when one is configured,
- otherwise falls back to a self-contained proxy. The default proxy is
  **spectral matting**: eigenvectors of Levin's closed-form matting
  Laplacian (the non-semantic half of the SSS pipeline), on the host with
  scipy. ``proxy="spectral_device"`` builds the Laplacian and solves on
  the card (``awesome_tpu_torch.ops.spectral``); it falls back to the host
  path only for an image too small for the device solve (logged, and
  counted in the extractor's ``fallbacks``), and any other failure of the
  device solve propagates. ``proxy="sss_fused"`` fuses a self-contained semantic
  affinity with the matting Laplacian BEFORE the eigendecomposition (L =
  L_matting + w L_sem, Aksoy et al. 2018 §3). ``proxy="pyramid"`` is the
  Gaussian-pyramid PCA. The host proxies degrade as the JAX package's do
  (host spectral -> pyramid PCA).
"""
from __future__ import annotations

import logging
import os
import subprocess
from typing import List, Optional

import numpy as np

from awesome_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)


def matting_laplacian(image: np.ndarray, eps: float = 1e-7):
    """Levin's closed-form matting Laplacian as a sparse CSR matrix.

    ``image``: (H, W, 3) float in [0, 1]. For every 3x3 window w_k with
    color mean mu_k and covariance Sigma_k,

        L[i, j] += delta_ij - (1 + (I_i-mu_k)^T (Sigma_k + eps/9 I)^-1
                                   (I_j-mu_k)) / 9

    (A Closed-Form Solution to Natural Image Matting, Levin et al. 2008,
    eq. 12). This is the affinity the reference's SSS dependency builds
    its soft segments on (Aksoy et al. 2018 section 3 — there fused with
    a semantic affinity from the TF1 feature net before
    eigendecomposition).
    """
    from numpy.lib.stride_tricks import sliding_window_view
    from scipy import sparse

    h, w, c = image.shape
    if h < 3 or w < 3:
        raise ValueError("matting_laplacian needs at least a 3x3 image")
    n = h * w
    m = 9
    inds = np.arange(n).reshape(h, w)
    win_inds = sliding_window_view(inds, (3, 3)).reshape(-1, m)
    win_img = sliding_window_view(image, (3, 3), axis=(0, 1))
    # sliding_window_view with axis=(0,1) yields (h-2, w-2, 3, 3, 3) with
    # the channel axis in the middle; flatten windows to (nw, 9, 3)
    win_img = win_img.transpose(0, 1, 3, 4, 2).reshape(-1, m, c)
    mu = win_img.mean(axis=1, keepdims=True)                  # (nw, 1, 3)
    x = win_img - mu                                          # (nw, 9, 3)
    cov = np.einsum("nmc,nmd->ncd", x, x) / m                 # (nw, 3, 3)
    inv = np.linalg.inv(cov + (eps / m) * np.eye(c))
    vals = (1.0 + np.einsum("nic,ncd,njd->nij", x, inv, x)) / m
    vals = np.eye(m)[None] - vals                             # (nw, 9, 9)
    rows = np.repeat(win_inds, m, axis=1).ravel()
    cols = np.tile(win_inds, (1, m)).ravel()
    L = sparse.coo_matrix((vals.ravel(), (rows, cols)), shape=(n, n))
    return L.tocsr()


def semantic_descriptor(
    image: np.ndarray,
    color_sigma: float = 4.0,
    tex_scales=(1.0, 2.0),
    pool: float = 2.5,
    tex_gain: float = 10.0,
) -> np.ndarray:
    """Self-contained color-texture descriptor (H, W, 3 + len(tex_scales)).

    Channels stay in RAW comparable units — no per-channel
    standardization (which would blow a near-constant channel up into
    full-range noise) and no per-pixel L2 norm:

    - coarse color: Gaussian-smoothed RGB at ``color_sigma`` (already
      in [0, 1]);
    - texture energy per scale: gradient magnitude pooled over a
      ``pool`` window, with the image-median subtracted as the noise
      floor and saturated at a FIXED physical gradient scale
      (``1/tex_gain`` intensity units/px) — so untextured regions sit
      at 0 regardless of sensor noise and real texture saturates at 1.

    This is the default stand-in for the TF1 deep semantic features in
    the SSS fusion (`semantic_affinity_laplacian`); any richer feature
    source (e.g. a UNet encoder) can replace it via the extractor's
    ``semantic_feature_fn``."""
    from scipy import ndimage

    chans: List[np.ndarray] = [
        ndimage.gaussian_filter(image[..., c], color_sigma)
        for c in range(image.shape[-1])
    ]
    gray = image.mean(axis=-1)
    for s in tex_scales:
        gy = ndimage.gaussian_filter(gray, s, order=(1, 0))
        gx = ndimage.gaussian_filter(gray, s, order=(0, 1))
        e = np.sqrt(ndimage.gaussian_filter(gy * gy + gx * gx, pool))
        e = np.maximum(e - np.median(e), 0.0)
        chans.append(np.clip(e * tex_gain, 0.0, 1.0))
    return np.stack(chans, axis=-1).astype(np.float64)


def semantic_affinity_laplacian(
    feats: np.ndarray,
    offsets=((0, 1), (1, 0), (1, 1), (1, -1), (0, 4), (4, 0)),
    sigma: Optional[float] = None,
    sigma_scale: float = 1.0,
    normalized: bool = False,
):
    """Graph Laplacian of a semantic affinity W over a local + dilated
    pixel graph: ``w_ij = exp(-||f_i - f_j||^2 / (2 sigma^2))`` for each
    neighbor offset (the dilated taps give the longer-range grouping the
    SSS paper gets from superpixel-level semantic connections — Aksoy et
    al. 2018 §3.2; the reference consumes that fusion via its TF1
    shell-out, `awesome/run/semantic_soft_segmentation_extractor.py`).

    ``sigma`` defaults to ``sigma_scale`` times the RMS pairwise feature
    distance over all edges (scale-adaptive, deterministic;
    ``sigma_scale`` < 1 sharpens within/between-region contrast — the
    fusion uses 0.5). With ``normalized=True`` returns the symmetric
    normalized (ncut) Laplacian ``D^-1/2 (D - W) D^-1/2`` (eigenvalues
    O(1), balanced cuts); otherwise CSR ``L = D - W`` scaled by the mean
    degree so its magnitude is comparable regardless of neighbor
    count."""
    from scipy import sparse

    h, w = feats.shape[:2]
    n = h * w
    inds = np.arange(n).reshape(h, w)
    rows, cols, d2s = [], [], []
    for dy, dx in offsets:
        ys = slice(max(dy, 0), h + min(dy, 0)) if dy else slice(None)
        xs = slice(max(dx, 0), w + min(dx, 0)) if dx else slice(None)
        ys2 = slice(max(-dy, 0), h + min(-dy, 0)) if dy else slice(None)
        xs2 = slice(max(-dx, 0), w + min(-dx, 0)) if dx else slice(None)
        i = inds[ys2, xs2].ravel()
        j = inds[ys, xs].ravel()
        d = feats[ys2, xs2].reshape(len(i), -1) - feats[ys, xs].reshape(
            len(j), -1)
        rows.append(i)
        cols.append(j)
        d2s.append((d * d).sum(axis=1))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    d2 = np.concatenate(d2s)
    if sigma is None:
        sigma = sigma_scale * float(np.sqrt(max(d2.mean(), 1e-12)))
    wgt = np.exp(-d2 / (2.0 * sigma * sigma))
    W = sparse.coo_matrix((wgt, (rows, cols)), shape=(n, n))
    W = (W + W.T) * 0.5
    deg = np.asarray(W.sum(axis=1)).ravel()
    L = sparse.diags(deg) - W
    if normalized:
        dinv = sparse.diags(1.0 / np.sqrt(np.maximum(deg, 1e-12)))
        return (dinv @ L @ dinv).tocsr()
    return (L / max(deg.mean(), 1e-12)).tocsr()


def _otsu_stats(v: np.ndarray, bins: int = 256) -> tuple:
    """One histogram pass -> (Otsu threshold, between-class separability).

    Threshold: argmax of between-class variance on values in [0, 1].
    Separability: that variance over total variance — how bimodal
    (cut-like) a normalized eigenvector is; used to pick the fused
    operator's output channels from an over-computed eigenbasis."""
    hist, edges = np.histogram(v, bins=bins, range=(0.0, 1.0))
    p = hist.astype(np.float64) / max(hist.sum(), 1)
    omega = np.cumsum(p)
    mids = 0.5 * (edges[:-1] + edges[1:])
    mu = np.cumsum(p * mids)
    denom = omega * (1.0 - omega)
    with np.errstate(divide="ignore", invalid="ignore"):
        sb = (mu[-1] * omega - mu) ** 2 / np.where(
            denom > 0, denom, np.inf)
    thr = float(mids[int(np.nanargmax(sb))])
    var = float((p * (mids - mu[-1]) ** 2).sum())
    return thr, float(np.nanmax(sb)) / max(var, 1e-12)


def _otsu_threshold(v: np.ndarray, bins: int = 256) -> float:
    return _otsu_stats(v, bins)[0]


def _otsu_separability(v: np.ndarray, bins: int = 256) -> float:
    return _otsu_stats(v, bins)[1]


def _otsu_calibrate(f: np.ndarray, t: Optional[float] = None) -> np.ndarray:
    """Piecewise-linearly remap a [0, 1] channel so its Otsu threshold
    lands at 0.5. Eigenvectors of a FUSED operator are mixtures of the
    matting and semantic terms' near-degenerate cut directions, so the
    bimodal gap wanders away from mid-range; after this calibration a
    plain 0.5 threshold recovers the spectral bipartition (the
    lightweight analogue of the SSS paper's grouping stage). Pass ``t``
    to reuse a threshold already computed during candidate ranking."""
    if t is None:
        t = _otsu_threshold(f.ravel())
    lo = np.clip(f / max(2.0 * t, 1e-9), 0.0, 0.5) * (f <= t)
    hi = (0.5 + 0.5 * (f - t) / max(1.0 - t, 1e-9)) * (f > t)
    return lo + hi


def spectral_soft_segments(
    image: np.ndarray,
    n_components: int = 2,
    max_side: int = 160,
    eps: float = 1e-7,
    semantic_feature_fn=None,
    semantic_weight: float = 0.0,
) -> np.ndarray:
    """Soft segments = smallest nontrivial matting-Laplacian eigenvectors.

    Computes L on a <=``max_side`` downscale of the image, takes the
    ``n_components`` eigenvectors after the (near-)constant nullspace
    vector, min-max normalizes each to [0, 1], and bilinearly upsamples
    back to (H, W, n_components). Deterministic (fixed Lanczos start
    vector). Replacement for the reference's SSS embedmap+PCA front-end
    (`awesome/run/semantic_soft_segmentation_extractor.py:1-261`) when
    neither precomputed embedmaps nor the TF1 checkout are available.

    SSS FUSION: with ``semantic_weight`` > 0, fuses a semantic affinity
    into the operator BEFORE the eigendecomposition — the pipeline shape
    of the SSS paper (Aksoy et al. 2018 §3: L = L_matting + w L_sem):
    ``semantic_feature_fn(small_image) -> (h, w, C)`` features (default
    `semantic_descriptor`) build an ncut-normalized
    `semantic_affinity_laplacian`; the matting term is rescaled by its
    mean diagonal so ``semantic_weight`` is a scale-free mixing ratio
    (default 10 — the semantic term must out-weigh texture modes that
    are near-null in the matting operator). Fused mode POOLS candidate
    eigenvectors from BOTH operators — the pure matting Laplacian and
    the fused one (n_components + 4 extra each) — and keeps the
    ``n_components`` most bimodal candidates (highest Otsu between-class
    separability), Otsu-calibrated (`_otsu_calibrate`) so 0.5 separates
    each spectral bipartition. Pooling is the lightweight analogue of
    the SSS paper computing ~100 eigenvectors then grouping; a greedy
    redundancy filter (|corr| > 0.95) keeps near-duplicate cuts from
    the two pools from crowding out a distinct region's eigenvector.
    Together they make fusion NON-DESTRUCTIVE: where matting alone
    already exposes the object its (very bimodal) eigenvectors win
    selection, and where it is blind (texture-only boundaries: matting
    IoU 0.26) the fused operator's do (measured on the designed scenes
    in tests/test_sss.py and an 8-scene synthetic A/B on the r5 hard
    axis: easy 0.810 = pure's 0.810 exactly, hard 0.504 vs pure 0.350).
    ``semantic_weight=0`` is bit-identical to the pure matting path."""
    from scipy import ndimage
    from scipy.sparse.linalg import eigsh

    h, w = image.shape[:2]
    scale = min(1.0, max_side / max(h, w))
    if scale < 1.0:
        small = ndimage.zoom(image, (scale, scale, 1), order=1)
        small = np.clip(small, 0.0, 1.0)
    else:
        small = image
    sh, sw = small.shape[:2]
    L = matting_laplacian(small.astype(np.float64), eps=eps)
    fused = semantic_weight > 0.0
    v0 = np.full(L.shape[0], 1.0 / np.sqrt(L.shape[0]))

    def _eigvecs(op, k):
        # shift-invert around 0: smallest eigenpairs of the PSD operator
        vecs = eigsh(op, k=k, sigma=0, which="LM", v0=v0)[1]
        out = []
        for i in range(1, k):  # skip the (near-)constant nullspace vec
            f = vecs[:, i]
            lo, hi = float(f.min()), float(f.max())
            out.append((f - lo) / max(hi - lo, 1e-12))
        return out

    if fused:
        fn = semantic_feature_fn or semantic_descriptor
        feats = np.asarray(fn(small), dtype=np.float64)
        if feats.shape[:2] != (sh, sw):
            raise ValueError(
                f"semantic_feature_fn returned {feats.shape[:2]}, "
                f"expected {(sh, sw)}"
            )
        L_sem = semantic_affinity_laplacian(
            feats, sigma_scale=0.5, normalized=True)
        L_fused = (L / max(L.diagonal().mean(), 1e-12)
                   + semantic_weight * L_sem).tocsr()
        # pool candidates from BOTH operators, keep the most bimodal
        # (cut-like) ones — see docstring
        k = n_components + 5
        cands = _eigvecs(L, k) + _eigvecs(L_fused, k)
        stats = [_otsu_stats(f) for f in cands]
        order = sorted(range(len(cands)), key=lambda i: -stats[i][1])
        # greedy redundancy filter: when color already exposes the
        # strongest cut, both operators' leading eigenvectors are the
        # SAME bipartition — without this, near-duplicate cuts from the
        # two pools can fill every output slot and drop a distinct
        # region's eigenvector
        picked = []
        for i in order:
            if len(picked) == n_components:
                break
            if any(abs(float(np.corrcoef(cands[i], cands[j])[0, 1]))
                   > 0.95 for j in picked):
                continue
            picked.append(i)
        for i in order:  # backfill if the filter left too few
            if len(picked) == n_components:
                break
            if i not in picked:
                picked.append(i)
        chosen = [_otsu_calibrate(cands[i], stats[i][0])
                  for i in sorted(picked)]
    else:
        chosen = _eigvecs(L, n_components + 1)
    feats = []
    for f in chosen:
        f = f.reshape(sh, sw)
        if scale < 1.0:
            f = ndimage.zoom(f, (h / sh, w / sw), order=1)[:h, :w]
            # zoom can come up a pixel short on strongly rational ratios
            if f.shape != (h, w):
                pad = ((0, h - f.shape[0]), (0, w - f.shape[1]))
                f = np.pad(f, pad, mode="edge")
        feats.append(np.clip(f, 0.0, 1.0))
    return np.stack(feats, axis=-1).astype(np.float32)


class SemanticSoftSegmentationExtractor:
    def __init__(
        self,
        feature_dir: str,
        command_template: Optional[str] = None,
        n_components: int = 2,
        proxy: str = "spectral",
        semantic_feature_fn=None,
        semantic_weight: float = 10.0,
        device: DeviceLike = None,
    ):
        self.feature_dir = feature_dir
        self.command_template = command_template
        self.n_components = n_components
        self.proxy = proxy
        # the fused proxy's swappable semantic feature source:
        # None -> `semantic_descriptor` (multiscale color-texture); a
        # callable (h, w, 3) -> (h, w, C) — e.g. a UNet encoder apply —
        # plays the role of the reference's TF1 feature net
        self.semantic_feature_fn = semantic_feature_fn
        self.semantic_weight = semantic_weight
        # where the 'spectral_device' proxy solves (None: the card), and
        # how many images were too small for it and went to the host
        self.device = device
        self.fallbacks = 0

    @classmethod
    def from_config(cls, config, feature_dir: str, n_components: int = 2
                    ) -> "SemanticSoftSegmentationExtractor":
        """Build from AwesomeConfig's SSS fields
        (`awesome/run/awesome_config.py` semantic_soft_segmentation_code_dir
        / _model_checkpoint_dir / tf_use_gpu): when a code dir is
        configured, reproduce the reference's shell-out
        (`awesome/run/semantic_soft_segmentation_extractor.py:139-176` runs
        ``main.py`` inside the SSS checkout against the checkpoint dir);
        otherwise precomputed-embedmap / proxy fallback. The proxy flavor
        comes from ``config.dataset_args['sss_proxy']`` (default
        "spectral"; "spectral_device" = the eigensolve on the config's
        device, "pyramid" = the legacy Gaussian-pyramid PCA)."""
        tmpl = None
        code_dir = getattr(
            config, "semantic_soft_segmentation_code_dir", None)
        if code_dir:
            ckpt = getattr(
                config, "semantic_soft_segmentation_model_checkpoint_dir",
                "") or ""
            device = "" if getattr(config, "tf_use_gpu", False) else (
                "CUDA_VISIBLE_DEVICES= ")
            tmpl = (
                f"cd {code_dir} && {device}python main.py"
                f" --model-checkpoint-dir {ckpt}"
                f" --image {{name}} --output-dir {feature_dir}"
            )
        da = getattr(config, "dataset_args", None) or {}
        da = da if isinstance(da, dict) else {}
        return cls(feature_dir, command_template=tmpl,
                   n_components=n_components,
                   proxy=da.get("sss_proxy", "spectral"),
                   semantic_weight=float(
                       da.get("sss_semantic_weight", 10.0)),
                   device=getattr(config, "device", None))

    def extract(self, image: np.ndarray, name: str) -> np.ndarray:
        """(H, W, 3) float [0,1] -> (H, W, n_components) features."""
        from awesome_tpu_torch.data.image_sample import (
            load_semantic_features,
            semantic_features,
        )

        feat = load_semantic_features(
            self.feature_dir, name, self.n_components
        )
        if feat is not None:
            return feat
        if self.command_template:
            cmd = self.command_template.format(name=name)
            subprocess.run(cmd, shell=True, check=True)
            feat = load_semantic_features(
                self.feature_dir, name, self.n_components
            )
            if feat is not None:
                return feat
        return self._proxy_features(image)

    def proxy_features(self, image: np.ndarray) -> np.ndarray:
        """Features from the configured proxy alone (no embedmap lookup /
        shell-out)."""
        return self._proxy_features(image)

    def _proxy_features(self, image: np.ndarray) -> np.ndarray:
        if self.proxy == "spectral_device":
            from awesome_tpu_torch.ops.spectral import (
                ImageTooSmall,
                spectral_soft_segments_device,
            )

            try:
                return spectral_soft_segments_device(
                    image, self.n_components, device=self.device)
            except ImageTooSmall as e:
                # the solve's shape precondition, the one documented
                # fallback; every other failure of the device solve raises
                self.fallbacks += 1
                logger.warning("device spectral soft segments: %s; "
                               "using the host spectral path", e)
        if self.proxy in ("spectral", "spectral_device", "sss_fused") and (
                min(image.shape[:2]) >= 3):
            fused = self.proxy == "sss_fused"
            try:
                return spectral_soft_segments(
                    image, self.n_components,
                    semantic_feature_fn=self.semantic_feature_fn,
                    semantic_weight=self.semantic_weight if fused else 0.0,
                )
            except Exception as e:  # singular Laplacian corner cases
                logger.warning(
                    "spectral soft segments failed (%r); falling back to "
                    "the pyramid-PCA proxy: 'feat' quality degrades", e)
        return self._pyramid_features(image)

    def _pyramid_features(self, image: np.ndarray) -> np.ndarray:
        from scipy import ndimage

        h, w = image.shape[:2]
        chans: List[np.ndarray] = []
        for sigma in (1, 4, 16):
            for c in range(3):
                chans.append(ndimage.gaussian_filter(image[..., c], sigma))
        yy, xx = np.mgrid[0:h, 0:w]
        chans.append(yy / max(h - 1, 1))
        chans.append(xx / max(w - 1, 1))
        emb = np.stack(chans, axis=-1).astype(np.float32)
        from awesome_tpu_torch.data.image_sample import semantic_features

        return semantic_features(emb, self.n_components)
