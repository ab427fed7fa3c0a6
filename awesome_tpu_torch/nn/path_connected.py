"""Path-connectedness prior: translation -> normalization -> flow -> ICNN;
counterpart of ``awesome_tpu/nn/path_connected.py``.

Pipeline on a point matrix (N, C)::

    x -> PerChannelAffine (global translation, init identity)
      -> MinMax norm fitted on the normalized grid
      -> RealNVP flow
      -> inverse norm
      -> ICNN (ConvexNextNet)
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from awesome_tpu_torch.core import grids as G
from awesome_tpu_torch.core.transforms import MeanStd, MinMax
from awesome_tpu_torch.core.tree import tree_map
from awesome_tpu_torch.device import DeviceLike, resolve_device
from awesome_tpu_torch.nn.flows import RealNVPFlow
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.nn.linear import PerChannelAffine
from awesome_tpu_torch.nn.module import Module, make_generator


class PathConnectedNet(Module):
    """Composite path-connected prior. ``norm`` is an optional frozen
    input normalization wrapped around the flow."""

    def __init__(self, convex_net: Module, flow_net: Module,
                 in_channels: int = 2,
                 norm: Optional[Union[MinMax, MeanStd]] = None,
                 device: DeviceLike = None):
        super().__init__(device)
        self.convex_net = convex_net
        self.flow_net = flow_net
        self.in_channels = in_channels
        self.norm = norm
        self.affine = PerChannelAffine(in_channels, device=self.device)

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        return {
            "linear": self.affine.init(gen),
            "flow": self.flow_net.init(gen),
            "convex": self.convex_net.init(gen),
        }

    def deformation(self, params, x):
        """Translation + normalized flow: the learned diffeomorphism."""
        x = self.affine.apply(params["linear"], x)
        if self.norm is not None:
            x = self.norm.transform(x)
        x = self.flow_net.apply(params["flow"], x)
        if self.norm is not None:
            x = self.norm.inverse_transform(x)
        return x

    def apply(self, params, x):
        return self.convex_net.apply(params["convex"],
                                     self.deformation(params, x))

    def inverse(self, params, y):
        """Analytic inverse of :meth:`deformation`."""
        if self.norm is not None:
            y = self.norm.transform(y)
        x = self.flow_net.inverse(params["flow"], y)
        if self.norm is not None:
            x = self.norm.inverse_transform(x)
        return self.affine.inverse(params["linear"], x)

    def enforce_convexity(self, params):
        """Project only the ICNN part; the flow stays unconstrained."""
        return dict(params,
                    convex=self.convex_net.enforce_convexity(params["convex"]))

    def param_groups(self, params):
        """Label tree for the optimizer's weight-decay groups."""
        return {name: tree_map(lambda _, n=name: n, params[name])
                for name in ("linear", "flow", "convex")}


def real_nvp_path_connected_net(
    channels: int = 2,
    hidden_units: int = 130,
    flow_n_flows: int = 6,
    flow_output_fn: Optional[str] = None,
    flow_output_scale: Optional[float] = None,
    norm: str = "minmax",
    spatial_shape: Tuple[int, int] = (1000, 1000),
    convex_net_hidden_units: int = 130,
    convex_net_hidden_layers: int = 2,
    device: DeviceLike = None,
) -> PathConnectedNet:
    """The flagship prior factory. The norm is fitted on the normalized
    coordinate grid of ``spatial_shape``."""
    dev = resolve_device(device)
    flow = RealNVPFlow(channels=channels, hidden_units=hidden_units,
                       n_flows=flow_n_flows, output_fn=flow_output_fn,
                       output_scale=flow_output_scale, device=dev)
    shape = spatial_shape if channels == 2 else (100, *spatial_shape)
    pts = G.flatten_grid(G.normalized_grid(shape, device=dev))
    if norm == "minmax":
        fitted = MinMax.fit(pts, dim=0)
        norm_t = MinMax(fitted.min[0], fitted.max[0])  # per-channel stats
    elif norm == "meanstd":
        fitted = MeanStd.fit(pts, dim=0)
        norm_t = MeanStd(fitted.mean[0], fitted.std[0])
    else:
        raise ValueError("Invalid norm")
    icnn = ConvexNextNet(n_hidden=convex_net_hidden_units,
                         n_hidden_layers=convex_net_hidden_layers,
                         in_features=channels, device=dev)
    return PathConnectedNet(convex_net=icnn, flow_net=flow,
                            in_channels=channels, norm=norm_t, device=dev)
