"""Input-convex neural networks — the convexity prior; counterpart of
``awesome_tpu/nn/icnn.py``.

Convexity needs non-negative hidden-to-hidden weights. As in the JAX
package it is kept by a projection (``enforce_convexity``) that the fit
applies AFTER every optimizer step, not by a reparameterization.
"""
from __future__ import annotations

from typing import Optional

import torch

from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.nn.linear import Linear, matmul_t
from awesome_tpu_torch.nn.module import Module, make_generator


class ConvexNet(Module):
    """2-layer Amos-style ICNN with input skips."""

    def __init__(self, n_hidden: int = 130, in_channels: int = 2,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_hidden = n_hidden
        self.in_channels = in_channels

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        c, n, d = self.in_channels, self.n_hidden, self.device
        return {
            "W0y": Linear(c, n, device=d).init(gen),
            "W1z": Linear(n, n, device=d).init(gen),
            "W2z": Linear(n, 1, device=d).init(gen),
            "W1y": Linear(c, n, bias=False, device=d).init(gen),
            "W2y": Linear(c, 1, bias=False, device=d).init(gen),
        }

    def apply(self, params, x):
        x0 = x
        h = torch.relu(matmul_t(x, params["W0y"]["w"]) + params["W0y"]["b"])
        h = torch.relu(matmul_t(h, params["W1z"]["w"]) + params["W1z"]["b"]
                       + matmul_t(x0, params["W1y"]["w"]))
        return (matmul_t(h, params["W2z"]["w"]) + params["W2z"]["b"]
                + matmul_t(x0, params["W2y"]["w"]))

    def enforce_convexity(self, params):
        """Clip the hidden-to-hidden weights (W1z, W2z) to >= 0."""
        params = dict(params)
        for name in ("W1z", "W2z"):
            params[name] = dict(params[name], w=torch.relu(params[name]["w"]))
        return params


class ConvexNextNet(Module):
    """Deeper ICNN: input layer + N skip blocks + out block.
    Block: ``h = relu(ln(h) + skp(x))``; out: ``ln(h) + skp(x)``. Only the
    ``ln`` weights are clipped; the input skips may be signed."""

    def __init__(self, n_hidden: int = 130, in_features: int = 2,
                 out_features: int = 1, n_hidden_layers: int = 1,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_hidden = n_hidden
        self.in_features = in_features
        self.out_features = out_features
        self.n_hidden_layers = n_hidden_layers

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        n, c, d = self.n_hidden, self.in_features, self.device
        params = {"input": Linear(c, n, device=d).init(gen)}
        params["skip"] = [
            {"ln": Linear(n, n, device=d).init(gen),
             "skp": Linear(c, n, bias=False, device=d).init(gen)}
            for _ in range(self.n_hidden_layers)
        ]
        params["out"] = {
            "ln": Linear(n, self.out_features, device=d).init(gen),
            "skp": Linear(c, self.out_features, bias=False,
                          device=d).init(gen),
        }
        return params

    def apply(self, params, x):
        # each block's ln and skp matmuls merged into one: [h, x] @ [ln|skp]^T
        x0 = x
        h = torch.relu(matmul_t(x, params["input"]["w"])
                       + params["input"]["b"])
        for blk in params["skip"]:
            w = torch.cat([blk["ln"]["w"], blk["skp"]["w"]], dim=1)
            h = torch.relu(matmul_t(torch.cat([h, x0], dim=-1), w)
                           + blk["ln"]["b"])
        out = params["out"]
        w = torch.cat([out["ln"]["w"], out["skp"]["w"]], dim=1)
        return matmul_t(torch.cat([h, x0], dim=-1), w) + out["ln"]["b"]

    def enforce_convexity(self, params):
        params = dict(params)
        params["skip"] = [
            {"ln": dict(blk["ln"], w=torch.relu(blk["ln"]["w"])),
             "skp": blk["skp"]}
            for blk in params["skip"]
        ]
        out = params["out"]
        params["out"] = dict(out, ln=dict(out["ln"],
                                          w=torch.relu(out["ln"]["w"])))
        return params
