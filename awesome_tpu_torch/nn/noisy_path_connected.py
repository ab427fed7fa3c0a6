"""NoisyPathConnectedNet, the spatio-temporal prior under label noise;
counterpart of ``awesome_tpu/nn/noisy_path_connected.py``.

Behavior port of `awesome/model/noisy_path_connected_net.py:35` (a
PathConnectedNet whose ``_non_prior_based_pretrain`` override tolerates
probabilistically flipped weak labels). Noise injection lives in the data
layer (``FBMSSequenceDataset.flip_probability``) and the fit in
``fit.spatiotemporal``; this module bundles the pieces into the
reference's single-object API: a 3-channel (x, y, t) path-connected prior
plus ``pretrain_noisy``, the fit with its warm-start prefits.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.nn.path_connected import (
    PathConnectedNet,
    real_nvp_path_connected_net,
)


def noisy_path_connected_net(
    spatial_shape: Tuple[int, int],
    hidden_units: int = 32,
    flow_n_flows: int = 12,
    convex_net_hidden_units: int = 130,
    convex_net_hidden_layers: int = 2,
    device: DeviceLike = None,
) -> PathConnectedNet:
    """The (x, y, t) flagship variant used by the noisy experiments."""
    return real_nvp_path_connected_net(
        channels=3,
        hidden_units=hidden_units,
        flow_n_flows=flow_n_flows,
        flow_output_fn="tanh",
        spatial_shape=spatial_shape,
        convex_net_hidden_units=convex_net_hidden_units,
        convex_net_hidden_layers=convex_net_hidden_layers,
        device=device,
    )


def pretrain_noisy(
    model: PathConnectedNet,
    params: Any,
    frame_points: torch.Tensor,
    frame_targets: torch.Tensor,
    labeled_masks: torch.Tensor,
    num_epochs: int = 2000,
    lr: float = 1e-3,
    weight_mode: str = "none",
    prefit_flow_net_identity: bool = False,
    prefit_flow_net_identity_lr: float = 1e-2,
    prefit_flow_net_identity_num_epochs: int = 100,
    prefit_convex_net: bool = False,
    prefit_convex_net_lr: float = 1e-3,
    prefit_convex_net_num_epochs: int = 200,
    **fit_kwargs,
):
    """Shared spatio-temporal fit against (possibly noise-flipped) weak
    labels, with the reference override's warm-start prefits
    (`noisy_path_connected_net.py:38-160`): flow ~ identity on the
    sequence grid, ICNN prefit on the FIRST + LAST frames' unaries. The
    temporal smoothness of the (x, y, t) representation is itself the
    noise regularizer (isolated flipped points cannot bend the connected
    space-time tube)."""
    from awesome_tpu_torch.fit.prior_fit import FitConfig
    from awesome_tpu_torch.fit.spatiotemporal import fit_spatiotemporal_prior

    params = apply_prefits(
        model, params, frame_points, frame_targets,
        {
            "prefit_flow_net_identity": prefit_flow_net_identity,
            "prefit_flow_net_identity_lr": prefit_flow_net_identity_lr,
            "prefit_flow_net_identity_num_epochs":
                prefit_flow_net_identity_num_epochs,
            "prefit_convex_net": prefit_convex_net,
            "prefit_convex_net_lr": prefit_convex_net_lr,
            "prefit_convex_net_num_epochs": prefit_convex_net_num_epochs,
        },
    )
    cfg = FitConfig(num_steps=num_epochs, lr=lr, weight_mode=weight_mode,
                    **fit_kwargs)
    return fit_spatiotemporal_prior(
        model, params, frame_points, frame_targets, labeled_masks, cfg,
        num_epochs=num_epochs,
    )


def apply_prefits(model, params, frame_points: torch.Tensor,
                  frame_targets: torch.Tensor, pa: dict):
    """The reference override's warm-start prefits, driven by the YAML's
    ``pretrain_args`` keys (`noisy_path_connected_net.py:38-160`): flow ~
    identity on the sequence grid; ICNN on the FIRST + LAST frames'
    unaries (the reference stacks frames 0 and -1)."""
    from awesome_tpu_torch.fit.prior_fit import (
        learn_convex_net,
        learn_flow_identity,
    )

    pts_flat = (
        frame_points.reshape(-1, frame_points.shape[-1])
        if frame_points.ndim == 3
        else frame_points
    )
    if pa.get("prefit_flow_net_identity"):
        params, _ = learn_flow_identity(
            model, params, pts_flat,
            lr=float(pa.get("prefit_flow_net_identity_lr", 1e-2)),
            weight_decay=float(
                pa.get("prefit_flow_net_identity_weight_decay", 1e-5)),
            max_iter=int(
                pa.get("prefit_flow_net_identity_num_epochs", 100)),
        )
    if pa.get("prefit_convex_net"):
        first_last_pts = torch.cat([frame_points[0], frame_points[-1]],
                                   dim=0)
        first_last_tgt = torch.cat([frame_targets[0], frame_targets[-1]],
                                   dim=0)
        params, _ = learn_convex_net(
            model, params, first_last_pts, first_last_tgt, mode="unaries",
            lr=float(pa.get("prefit_convex_net_lr", 1e-3)),
            weight_decay=float(
                pa.get("prefit_convex_net_weight_decay", 0.0)),
            max_iter=int(pa.get("prefit_convex_net_num_epochs", 200)),
        )
    return params
