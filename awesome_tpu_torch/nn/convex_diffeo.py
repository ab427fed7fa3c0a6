"""ConvexDiffeomorphismNet, the older composite prior: a full linear layer,
then a ``NormalizingFlow1D``, then an ICNN, with affine re-targeting;
counterpart of ``awesome_tpu/nn/convex_diffeo.py``.

Behavior port of `awesome/model/convex_diffeomorphism_net.py:41-190`:

- the composite forward (a full linear layer in front of the alternating
  coupling flow and the ICNN);
- :meth:`ConvexDiffeomorphismNet.translate`: a least-squares refit of the
  linear layer so that target points map where source points used to,
  moving the learned prior without refitting it (`:43-128`);
- the weight-norm decay groups of its own pretrain loop (`:130-190`),
  served by the shared fit engine through ``param_groups``.

Any ICNN serves as the convex part; a ``FullyFusedConvexNextNet`` runs its
forward and backward in the fused ICNN kernels (K4/K5), whose input
gradient then trains the flow and the linear layer.
"""
from __future__ import annotations

from typing import Optional

import torch

from awesome_tpu_torch.core.tree import tree_map
from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.nn.flows import NormalizingFlow1D
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.nn.linear import Linear, matmul_t
from awesome_tpu_torch.nn.module import Module, make_generator


class ConvexDiffeomorphismNet(Module):
    """``convex(flow(x @ w.T + b))``; the defaults are the reference's
    flow of 4 couplings of width 130 and a ConvexNextNet 130 x 1."""

    def __init__(self, in_features: int = 2, flow: Optional[Module] = None,
                 convex: Optional[Module] = None, device: DeviceLike = None):
        super().__init__(device)
        self.in_features = in_features
        self.flow = flow if flow is not None else NormalizingFlow1D(
            num_coupling=4, width=130, device=self.device)
        self.convex = convex if convex is not None else ConvexNextNet(
            n_hidden=130, n_hidden_layers=1, device=self.device)

    @classmethod
    def create(cls, in_features: int = 2, n_hidden: int = 130,
               n_hidden_layers: int = 1, nf_layers: int = 4,
               nf_hidden: int = 70, device: DeviceLike = None
               ) -> "ConvexDiffeomorphismNet":
        """The reference constructor (`convex_diffeomorphism_net.py:41-60`):
        flow and ICNN with matching feature counts (flow width 70 there).
        The coupling count is rounded up to a multiple of ``in_features``
        so that every channel is transformed equally often."""
        rem = nf_layers % in_features
        if rem:
            nf_layers += in_features - rem
        return cls(
            in_features=in_features,
            flow=NormalizingFlow1D(num_coupling=nf_layers, width=nf_hidden,
                                   in_features=in_features, device=device),
            convex=ConvexNextNet(n_hidden=n_hidden,
                                 n_hidden_layers=n_hidden_layers,
                                 in_features=in_features, device=device),
            device=device)

    def init(self, generator: Optional[torch.Generator] = None):
        if getattr(self.flow, "in_features", self.in_features) != \
                self.in_features:
            raise ValueError(
                "flow.in_features must match in_features; use "
                "ConvexDiffeomorphismNet.create(in_features=...)")
        gen = make_generator(generator)
        return {
            "linear": Linear(self.in_features, self.in_features,
                             device=self.device).init(gen),
            "flow": self.flow.init(gen),
            "convex": self.convex.init(gen),
        }

    def deformation(self, params, x):
        h = matmul_t(x, params["linear"]["w"]) + params["linear"]["b"]
        return self.flow.apply(params["flow"], h)

    def apply(self, params, x):
        return self.convex.apply(params["convex"],
                                 self.deformation(params, x))

    def inverse(self, params, y):
        """Analytic inverse of :meth:`deformation`: the flow's, then the
        linear layer's (``(h - b) @ inv(w).T``)."""
        h = self.flow.inverse(params["flow"], y)
        w, b = params["linear"]["w"], params["linear"]["b"]
        return (h - b) @ torch.linalg.inv(w).T

    def enforce_convexity(self, params):
        return dict(params,
                    convex=self.convex.enforce_convexity(params["convex"]))

    def param_groups(self, params):
        return {name: tree_map(lambda _, n=name: n, params[name])
                for name in ("linear", "flow", "convex")}

    # --- affine re-targeting --------------------------------------------
    def translate(self, params, from_points, to_points):
        """Refit the linear layer by least squares so that ``to_points``
        give the outputs ``from_points`` gave. Needs at least
        ``in_features + 1`` affinely independent points. Spec:
        `convex_diffeomorphism_net.py:82-128`."""
        if from_points.shape != to_points.shape:
            raise ValueError("From and to points must have the same shape.")
        w, b = params["linear"]["w"], params["linear"]["b"]
        from_transf = matmul_t(from_points, w) + b
        ones = torch.ones((to_points.shape[0], 1), dtype=to_points.dtype,
                          device=to_points.device)
        design = torch.cat([to_points, ones], dim=1)
        # (in + 1, in): the weight in the JAX layout over the bias row
        theta = torch.linalg.lstsq(design, from_transf).solution
        return dict(params, linear={"w": theta[:-1].T.contiguous(),
                                    "b": theta[-1]})

    def translate_only_point(self, params, from_point, to_point):
        """A pure shift (`:43-80`): ``in_features + 1`` affinely independent
        point pairs offset by the same constant, through :meth:`translate`
        (a square system)."""
        d = self.in_features
        dev = from_point.device
        offsets = torch.cat([torch.zeros((1, d), device=dev),
                             3.0 * torch.eye(d, device=dev)], dim=0)
        return self.translate(params, from_point[None] + offsets,
                              to_point[None] + offsets)
