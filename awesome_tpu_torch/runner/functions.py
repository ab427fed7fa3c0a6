"""Evaluation / plotting / saving toolbox; counterpart of
``awesome_tpu/runner/functions.py``.

- :func:`get_result`: full-image inference with one image's slice of the
  stacked params (spec `run/functions.py:2111`),
- :func:`split_model_result`: seg/prior split and an optional dense-CRF
  refinement of the seg (`:2432`),
- :func:`get_prior_result`: dense prior eval on an arbitrary-resolution
  grid, chunked (`:2154`),
- :func:`save_result`: masks + overlay PNGs into a run dir (`:2490`),
- mask <-> channel converters (`:1314,1469`),
- :func:`plot_mask` / :func:`plot_as_image` figures, the
  :func:`saveable` decorator and :func:`plot_space_time_tube`, and a GIF
  writer (`awesome/util/gif_writer_images.py:10`),
- the SAM-mask utilities (`:1050-1120`).

PIL and matplotlib are imported only where an image is written.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from awesome_tpu_torch.core import grids as G
from awesome_tpu_torch.core import tree as T

# --- inference helpers ---------------------------------------------------


def get_result(wrapper, stacked_params, pixels, index: int,
               evaluate_prior: bool = True):
    """Forward one image's pixels through its OWN model slice."""
    params = T.tree_select(stacked_params, index)
    with torch.no_grad():
        return wrapper.apply(params, pixels, evaluate_prior=evaluate_prior)


def split_model_result(wrapper, output, image: Optional[np.ndarray] = None,
                       use_crf: bool = False, crf_options=None,
                       grid_shape: Optional[Tuple[int, int]] = None):
    """Split into (seg, prior[, crf]) maps; ``use_crf`` refines the seg
    with the dense CRF against ``image`` (on the output's device). Spec:
    `run/functions.py:2432` + `run/crf.py:45`."""
    seg, prior = wrapper.split_output(output)
    result = {"seg": _host(seg), "prior": None if prior is None
              else _host(prior), "crf": None}
    if use_crf:
        if image is None or grid_shape is None:
            raise ValueError("CRF needs the image and grid_shape")
        from awesome_tpu_torch.ops.crf import dense_crf

        device = seg.device if isinstance(seg, torch.Tensor) else None
        seg_img = result["seg"].reshape(grid_shape)[..., None]
        refined = dense_crf(image, seg_img, options=crf_options,
                            device=device)
        result["crf"] = refined[..., 0].reshape(result["seg"].shape)
    return result


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def get_prior_result(prior_module, prior_params,
                     grid_shape: Tuple[int, int],
                     super_resolution: float = 1.0,
                     chunk: int = 1 << 16) -> np.ndarray:
    """Dense prior evaluation on a (super-resolution) grid, chunked to
    bound memory. Returns (H', W') sigmoid probabilities."""
    h = int(grid_shape[0] * super_resolution)
    w = int(grid_shape[1] * super_resolution)
    dev = T.tree_leaves(prior_params)[0].device
    pts = G.flatten_grid(G.pixel_grid((h, w), device=dev))
    outs = []
    with torch.no_grad():
        for i in range(0, pts.shape[0], chunk):
            out = prior_module.apply(prior_params, pts[i:i + chunk])
            outs.append(torch.sigmoid(out))
    return _host(torch.cat(outs, dim=0)).reshape(h, w)


# --- mask <-> channel converters ----------------------------------------


def masks_to_channels(masks: Sequence[np.ndarray]) -> np.ndarray:
    """Stack binary masks (each (H, W)) into (H, W, N)."""
    return np.stack([np.asarray(m, np.float32) for m in masks], axis=-1)


def channels_to_masks(channels: np.ndarray,
                      threshold: float = 0.5) -> List[np.ndarray]:
    return [channels[..., i] > threshold for i in range(channels.shape[-1])]


def labels_to_onehot(labels: np.ndarray,
                     num_classes: Optional[int] = None) -> np.ndarray:
    n = num_classes or int(labels.max()) + 1
    return (labels[..., None] == np.arange(n)).astype(np.float32)


def onehot_to_labels(onehot: np.ndarray) -> np.ndarray:
    return onehot.argmax(axis=-1)


# --- plotting ------------------------------------------------------------


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_as_image(img: np.ndarray, variable_name: str = "", path=None):
    """Figure showing an image. Spec: how-to notebooks' plot_as_image."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    ax.imshow(np.clip(img, 0, 1))
    ax.set_title(variable_name)
    ax.axis("off")
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_mask(img: np.ndarray, mask: np.ndarray, color=(1.0, 0.5, 0.0),
              alpha: float = 0.4, lined_contours: bool = True,
              variable_name: str = "", path=None):
    """Overlay a binary mask on an image (filled + contour)."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    ax.imshow(np.clip(img, 0, 1))
    m = np.asarray(mask, bool)
    overlay = np.zeros(m.shape + (4,))
    overlay[m] = (*color, alpha)
    ax.imshow(overlay)
    if lined_contours:
        ax.contour(m.astype(float), levels=[0.5], colors=[color])
    ax.set_title(variable_name)
    ax.axis("off")
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig


def save_overlay(img: np.ndarray, mask: np.ndarray, path: str,
                 color=(1.0, 0.5, 0.0), alpha: float = 0.4) -> str:
    """:func:`plot_mask`'s filled overlay written as a PNG through PIL,
    for machines without matplotlib; returns ``path``."""
    from PIL import Image

    out = np.clip(np.asarray(img, np.float64), 0, 1)
    m = np.asarray(mask, bool)
    out[m] = (1.0 - alpha) * out[m] + alpha * np.asarray(color)
    Image.fromarray((out * 255).round().astype(np.uint8)).save(path)
    return path


def save_result(out_dir: str, index: int, image: np.ndarray,
                seg_mask: np.ndarray, prior_mask: Optional[np.ndarray] = None,
                unaries: Optional[np.ndarray] = None) -> Dict[str, str]:
    """Persist masks (PNG) + overlay plots for one image.

    Spec: `run/functions.py:2490` save_result (tiffs+overlays -> PNGs).
    """
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paths = {}

    def save_mask(name, m):
        p = os.path.join(out_dir, f"{name}_{index}.png")
        Image.fromarray(
            (np.asarray(m, np.float32) * 255).astype(np.uint8)).save(p)
        paths[name] = p

    save_mask("mask", seg_mask)
    if prior_mask is not None:
        save_mask("prior_mask", prior_mask)
    if unaries is not None:
        save_mask("unaries", unaries)
    p = os.path.join(out_dir, f"overlay_{index}.png")
    plot_mask(image, seg_mask, path=p)
    paths["overlay"] = p
    return paths


def write_gif(frames: Sequence[np.ndarray], path: str,
              duration_ms: int = 100) -> str:
    """Animated GIF from (H, W, 3) float frames.

    Spec: `awesome/util/gif_writer_images.py:10`.
    """
    from PIL import Image

    imgs = [Image.fromarray((np.clip(f, 0, 1) * 255).astype(np.uint8))
            for f in frames]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=duration_ms, loop=0)
    return path


# --- figure-save decorator -------------------------------------------------


def saveable(fn):
    """Decorate a figure-producing function with ``path=`` / ``show=``
    kwargs that save/close the figure.

    Spec: `awesome/util/matplotlib.py` ``saveable()`` (the reference wraps
    every plot helper with it so handles can route figures to run dirs).
    """
    import functools

    @functools.wraps(fn)
    def wrapper(*args, path: Optional[str] = None, show: bool = False,
                **kwargs):
        fig = fn(*args, **kwargs)
        if fig is None:
            return None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fig.savefig(path, bbox_inches="tight")
        if not show:
            _pyplot().close(fig)
        return fig

    return wrapper


# --- SAM-mask utilities ----------------------------------------------------
# Spec: `awesome/run/functions.py:1050-1120` — utilities over
# segment-anything outputs (lists of boolean masks + scores). The model
# itself is an external dependency; these are the pure array transforms.


def sam_masks_to_label_mask(masks: Sequence[np.ndarray],
                            scores: Optional[Sequence[float]] = None,
                            base_value: int = 0) -> np.ndarray:
    """Paint a stack of (possibly overlapping) boolean masks into one
    integer label map: bigger masks first so smaller (higher-detail) masks
    overwrite them; ids follow the (score-sorted) paint order."""
    if not len(masks):
        raise ValueError("need at least one mask")
    order = list(range(len(masks)))
    if scores is not None:
        order.sort(key=lambda i: -float(scores[i]))
    order.sort(key=lambda i: -int(np.asarray(masks[i]).sum()))
    label = np.full(np.asarray(masks[0]).shape, base_value, np.int32)
    for new_id, i in enumerate(order, start=1):
        label[np.asarray(masks[i], bool)] = new_id
    return label


def filter_sam_masks(masks: Sequence[np.ndarray], scores: Sequence[float],
                     min_score: float = 0.8, min_area: int = 0,
                     max_area: Optional[int] = None
                     ) -> Tuple[List[np.ndarray], List[float]]:
    """Quality/area filtering of SAM mask proposals."""
    out_m, out_s = [], []
    for m, s in zip(masks, scores):
        area = int(np.asarray(m).sum())
        if s < min_score or area < min_area:
            continue
        if max_area is not None and area > max_area:
            continue
        out_m.append(np.asarray(m, bool))
        out_s.append(float(s))
    return out_m, out_s


# --- 3D space-time plots ----------------------------------------------------


@saveable
def plot_space_time_tube(volume_fg: np.ndarray, max_points: int = 20000,
                         elev: float = 20.0, azim: float = -60.0):
    """Scatter the foreground voxels of a (T, H, W) space-time mask — the
    'temporal connectedness tube' figure. Needs matplotlib, which the
    runners' paths do not: where it is not installed this helper raises
    ``ImportError`` and nothing else in this module is affected.

    Spec: `awesome/run/functions.py:2197...` 3D space-time tube plots (the
    reference draws the spatio-temporal prior's level set over frames).
    """
    plt = _pyplot()
    vol = np.asarray(volume_fg, bool)
    t, y, x = np.nonzero(vol)
    if len(t) > max_points:
        sel = np.linspace(0, len(t) - 1, max_points).astype(int)
        t, y, x = t[sel], y[sel], x[sel]
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(x, t, y, s=1, c=t, cmap="viridis", alpha=0.5)
    ax.set_xlabel("x")
    ax.set_ylabel("t (frame)")
    ax.set_zlabel("y")
    ax.view_init(elev=elev, azim=azim)
    return fig
