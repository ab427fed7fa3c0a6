"""Evaluation / plotting / saving toolbox; counterpart of the parts of
``awesome_tpu/runner/functions.py`` that the runner calls.

- :func:`get_result`: full-image inference with one image's slice of the
  stacked params (spec `run/functions.py:2111`),
- :func:`split_model_result`: seg/prior split and an optional dense-CRF
  refinement of the seg (`:2432`),
- :func:`get_prior_result`: dense prior eval on an arbitrary-resolution
  grid, chunked (`:2154`),
- :func:`save_result`: masks + overlay PNGs into a run dir (`:2490`),
- mask <-> channel converters (`:1314,1469`),
- :func:`plot_mask` / :func:`plot_as_image` figures.

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
