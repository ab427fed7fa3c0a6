"""Instance-segmentation prior losses (the Mask-RCNN experiments);
counterpart of ``awesome_tpu/measures/instance_losses.py``.

Pure functions over (detector_loss, instance_masks, prior_masks): they
align per-instance prior fields with an instance segmenter's per-instance
mask logits, on top of the detector's own losses.
"""
from __future__ import annotations

from typing import Optional

import torch


def _instance_mean(per_inst: torch.Tensor,
                   valid_instances: Optional[torch.Tensor]) -> torch.Tensor:
    if valid_instances is None:
        return per_inst.mean()
    w = valid_instances.to(per_inst.dtype)
    return (per_inst * w).sum() / torch.clamp_min(w.sum(), 1.0)


def instance_prior_loss(detector_loss, instance_masks: torch.Tensor,
                        prior_masks: torch.Tensor,
                        valid_instances: Optional[torch.Tensor] = None,
                        alpha: float = 1.0, extra_penalty=False):
    """detector_loss: scalar (the detector's own summed losses);
    instance_masks: (K, H, W) mask logits (1 = object); prior_masks: (K,
    H, W) prior probabilities; valid_instances: (K,) bool, padded slots
    weigh 0. Without ``extra_penalty`` the prior fits the thresholded
    detections, with it the soft inverted masks; the target carries no
    gradient."""
    seg_sig = torch.sigmoid(instance_masks)
    hard = (seg_sig >= 0.5).to(seg_sig.dtype)
    target = torch.where(torch.as_tensor(extra_penalty), 1.0 - seg_sig,
                         hard).detach()
    per_inst = ((prior_masks - target) ** 2).mean(dim=(-2, -1))
    return detector_loss + alpha * _instance_mean(per_inst, valid_instances)


def instance_finetune_loss(detector_loss, instance_masks: torch.Tensor,
                           prior_masks: torch.Tensor,
                           valid_instances: Optional[torch.Tensor] = None,
                           alpha: float = 1.0):
    """The finetune variant: the gradients flow into the detector's masks,
    pulling them towards the frozen prior."""
    prior = prior_masks.detach()
    seg_sig = torch.sigmoid(instance_masks)
    per_inst = ((seg_sig - (1.0 - prior)) ** 2).mean(dim=(-2, -1))
    return detector_loss + alpha * _instance_mean(per_inst, valid_instances)
