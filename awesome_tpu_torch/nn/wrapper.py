"""Combined segmentation + prior model; counterpart of
``awesome_tpu/nn/wrapper.py``.

A pure function over param dicts: the per-image prior is one entry of a
stacked prior param tree (a leading image axis), not weights swapped into a
live module.

Two input modes:

- 'pixel': point matrices (N, C) laid out (y, x, r, g, b, ...); the prior
  sees channels [0:2] (``prior_arg_mode='xy_c_preattached'``); outputs
  concatenate on the last dim -> (N, 2) [seg, prior].
- 'image': NHWC image and feature map, and coordinate points for the prior
  (``prior_arg_mode='param_grid'`` or ``'param_clean_grid'``); outputs
  concatenate on the channel dim -> (B, H, W, 2C).
"""
from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from awesome_tpu_torch.nn.module import Module, make_generator


class PriorMode(enum.Enum):
    """What the per-image prior state covers: the whole wrapper (FULL),
    the prior module only (PARTIAL), or nothing (NONE)."""

    FULL = "full"
    PARTIAL = "partial"
    NONE = "none"


class InputMode(enum.Enum):
    PIXEL = "pixel"
    IMAGE = "image"


class EvaluationMode(enum.Enum):
    BOTH = "both"
    SEGMENTATION = "segmentation"
    PRIOR = "prior"


class GradientMode(enum.Enum):
    """Which sub-module's gradients flow through the forward; the other
    part's output is detached."""

    NONE = "none"
    SEGMENTATION = "segmentation"
    PRIOR = "prior"
    BOTH = "both"


class WrapperModule(Module):
    def __init__(self, segmentation_module: Module,
                 prior_module: Optional[Module] = None,
                 input_mode: str = "pixel",
                 prior_arg_mode: str = "xy_c_preattached",
                 segmentation_arg_mode: str = "forward",
                 segmentation_module_gets_targets: bool = False,
                 use_segmentation_sigmoid: bool = True,
                 use_segmentation_output_inversion: bool = False,
                 use_prior_sigmoid: bool = True,
                 gradient_mode: str = "both", prior_mode: str = "partial",
                 seg_stateful: bool = False):
        super().__init__(segmentation_module.device)
        self.segmentation_module = segmentation_module
        self.prior_module = prior_module
        self.input_mode = input_mode
        self.prior_arg_mode = prior_arg_mode
        # 'forward' is the only segmentation_arg_mode there is
        self.segmentation_arg_mode = segmentation_arg_mode
        self.segmentation_module_gets_targets = \
            segmentation_module_gets_targets
        self.use_segmentation_sigmoid = use_segmentation_sigmoid
        self.use_segmentation_output_inversion = \
            use_segmentation_output_inversion
        self.use_prior_sigmoid = use_prior_sigmoid
        self.gradient_mode = GradientMode(gradient_mode).value
        self.prior_mode = PriorMode(prior_mode).value
        self.seg_stateful = seg_stateful

    # ---- init ------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        seg = self.segmentation_module.init(gen)
        seg_params, seg_state = seg if self.seg_stateful else (seg, None)
        params = {"seg": seg_params}
        if self.prior_module is not None:
            params["prior"] = self.prior_module.init(gen)
        return (params, seg_state) if self.seg_stateful else params

    # ---- pieces ----------------------------------------------------------
    def process_segmentation_output(self, segm):
        if self.use_segmentation_sigmoid:
            segm = torch.sigmoid(segm)
        if self.use_segmentation_output_inversion:
            segm = 1.0 - segm
        return segm

    def process_prior_output(self, prior, use_sigmoid: Optional[bool] = None):
        if use_sigmoid is None:
            use_sigmoid = self.use_prior_sigmoid
        return torch.sigmoid(prior) if use_sigmoid else prior

    def get_prior_input(self, _input, grid=None, clean_grid=None):
        """The prior's coordinate input: the xy channels of the pixel
        matrix ('xy_c_preattached'), the per-image grid ('param_grid'), or
        the clean grid ('param_clean_grid', the per-image grid if none)."""
        mode = self.prior_arg_mode
        if mode == "none":
            return None
        if mode == "xy_c_preattached":
            return _input[..., 0:2]
        if mode == "param_grid":
            if grid is None:
                raise ValueError("prior_arg_mode param_grid requires grid")
            return grid
        if mode == "param_clean_grid":
            chosen = clean_grid if clean_grid is not None else grid
            if chosen is None:
                raise ValueError(
                    "prior_arg_mode param_clean_grid requires clean_grid")
            return chosen
        raise ValueError(f"Unknown prior_arg_mode {mode}")

    # ---- PriorMode extract/apply -----------------------------------------
    def extract_prior(self, params):
        """The per-image prior state: the prior subtree (PARTIAL), the whole
        tree (FULL) or None (NONE)."""
        mode = PriorMode(self.prior_mode)
        if mode == PriorMode.PARTIAL:
            return params.get("prior") if self.prior_module else None
        if mode == PriorMode.FULL:
            return params
        return None

    def apply_prior(self, params, prior_state):
        """Write a prior state back into the wrapper params."""
        if prior_state is None:
            return params
        mode = PriorMode(self.prior_mode)
        if mode == PriorMode.PARTIAL:
            return dict(params, prior=prior_state)
        if mode == PriorMode.FULL:
            return prior_state
        return params

    def _grad_gate(self, segm, prior):
        mode = GradientMode(self.gradient_mode)
        if mode in (GradientMode.NONE, GradientMode.PRIOR):
            segm = segm.detach()
        if prior is not None and mode in (GradientMode.NONE,
                                          GradientMode.SEGMENTATION):
            prior = prior.detach()
        return segm, prior

    def enforce_convexity(self, params):
        if self.prior_module is None or "prior" not in params:
            return params
        return dict(params,
                    prior=self.prior_module.enforce_convexity(params["prior"]))

    # ---- forward ---------------------------------------------------------
    def _seg_apply(self, params, *args, targets=None, **kwargs):
        if self.segmentation_arg_mode != "forward":
            raise NotImplementedError(
                f"segmentation_arg_mode {self.segmentation_arg_mode} is "
                "unknown.")
        if self.segmentation_module_gets_targets:
            kwargs["targets"] = targets
        return self.segmentation_module.apply(params, *args, **kwargs)

    def apply(self, params, _input, features=None, grid=None,
              clean_grid=None, seg_state=None, targets=None,
              evaluate_prior: bool = True, train: bool = False):
        """Pixel mode: ``_input`` (N, C) -> (N, 2). Image mode: ``_input``
        NHWC image, ``features`` NHWC, ``grid`` / ``clean_grid`` (N_pts,
        C) points -> (B, H, W, 2 * out_chn). A stateful seg module also
        returns its new state."""
        if self.input_mode == "pixel":
            segm = self._seg_apply(params["seg"], _input, targets=targets)
            segm = self.process_segmentation_output(segm)
            if self.prior_module is None or not evaluate_prior:
                return segm
            prior_in = self.get_prior_input(_input, grid, clean_grid)
            prior = self.process_prior_output(
                self.prior_module.apply(params["prior"], prior_in))
            segm, prior = self._grad_gate(segm, prior)
            return torch.cat([segm, prior], dim=-1)
        if self.input_mode == "image":
            if self.seg_stateful:
                segm, new_state = self.segmentation_module.apply(
                    params["seg"], seg_state, _input, features, train=train)
            else:
                segm = self._seg_apply(params["seg"], _input, features,
                                       targets=targets)
                new_state = None
            segm = self.process_segmentation_output(segm)
            if self.prior_module is None or not evaluate_prior:
                return (segm, new_state) if self.seg_stateful else segm
            prior_in = self.get_prior_input(None, grid, clean_grid)
            prior_pts = self.process_prior_output(
                self.prior_module.apply(params["prior"], prior_in))
            segm, prior_pts = self._grad_gate(segm, prior_pts)
            prior_img = prior_pts.reshape(segm.shape)
            out = torch.cat([segm, prior_img], dim=-1)
            return (out, new_state) if self.seg_stateful else out
        raise ValueError(f"Unknown input_mode {self.input_mode}")

    def split_output(self, output) -> Tuple[torch.Tensor,
                                            Optional[torch.Tensor]]:
        """The combined output split back into (seg, prior)."""
        if self.prior_module is None:
            return output, None
        half = output.shape[-1] // 2
        return output[..., :half], output[..., half:]
