"""ICNN building blocks that keep convexity by a weight transform in the
forward pass, and a principled convex initialisation; counterpart of
``awesome_tpu/nn/convex_modules.py``.

Behavior port of `awesome/model/convex_modules.py:12-231` (the positivity
family, ConvexLinear/ConvexConv2d/ConvexLayerNorm, skip wrappers) and
`awesome/model/convex_init.py` (Hoedt & Klambauer, "Principled Weight
Initialisation for Input-Convex Neural Networks": log-normal weights
targeting variance/correlation fixed points).

Unlike the ICNNs of ``nn/icnn.py`` (a clip after the optimizer step),
these make the effective weight positive in the forward pass (exp, relu or
negexp of a free parameter): gradients flow through the transform and no
projection is needed. Weights use torch's ``(out, in)`` layout, conv
weights ``(out, in, kh, kw)`` over NHWC images (``nn/conv.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from awesome_tpu_torch.device import DeviceLike, resolve_device
from awesome_tpu_torch.nn.linear import Linear, matmul_t
from awesome_tpu_torch.nn.module import Module, make_generator

# --- positivity transforms ----------------------------------------------


def no_positivity(w):
    """The identity, to compare ICNNs with unconstrained nets. Spec:
    `:25-33`."""
    return w


def clipped_positivity(w):
    """relu(w) in the forward pass. Spec: `:79-86`."""
    return torch.relu(w)


def negexp_positivity(w):
    """exp(w) for the negative entries only (Sivaprasad et al.). Spec:
    `:53-64`."""
    return torch.where(w < 0, torch.exp(w), w)


def exponential_positivity(w):
    """exp(w), always positive. Spec: `:66-76`."""
    return torch.exp(w)


def exponential_inverse(w_pos):
    return torch.log(w_pos)


POSITIVITIES: dict = {
    "none": no_positivity,
    "clipped": clipped_positivity,
    "negexp": negexp_positivity,
    "exp": exponential_positivity,
}

# The reference's LazyClippedPositivity (clip the stored weight after each
# update, `:36-50`) is the projection ``enforce_convexity`` of nn/icnn.py:
# a training-loop transform, not a forward one.


class ConvexLinear(Module):
    """Linear layer whose effective weight is ``positivity(w)``. Spec:
    `convex_modules.py:89-100`."""

    def __init__(self, in_features: int, out_features: int,
                 positivity: str = "exp", bias: bool = True,
                 device: DeviceLike = None):
        super().__init__(device)
        self.in_features = in_features
        self.out_features = out_features
        self.positivity = positivity
        self.bias = bias

    def init(self, generator: Optional[torch.Generator] = None,
             initialiser: Optional["ConvexInitialiser"] = None):
        gen = make_generator(generator)
        if initialiser is None and self.positivity == "exp":
            initialiser = ConvexInitialiser()
        if initialiser is not None:
            return initialiser.init(gen, self.in_features, self.out_features,
                                    positivity=self.positivity,
                                    bias=self.bias, device=self.device)
        return Linear(self.in_features, self.out_features, bias=self.bias,
                      device=self.device).init(gen)

    def apply(self, params, x):
        return _convex_linear(params, x, self.positivity, self.bias)


def _convex_linear(params, x, positivity: str, bias: bool = True):
    y = matmul_t(x, POSITIVITIES[positivity](params["w"]))
    if bias and "b" in params:
        y = y + params["b"]
    return y


class ConvexConv2d(Module):
    """NHWC conv with positive effective weights. Spec: `:103-117`."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, positivity: str = "exp",
                 device: DeviceLike = None):
        super().__init__(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.positivity = positivity

    def init(self, generator: Optional[torch.Generator] = None):
        from awesome_tpu_torch.nn.conv import Conv2d

        params = Conv2d(self.in_channels, self.out_channels, self.kernel_size,
                        device=self.device).init(generator)
        if self.positivity == "exp":
            # start near the magnitude of the raw init
            params = dict(params, w=torch.log(torch.abs(params["w"]) + 1e-4))
        return params

    def apply(self, params, x):
        from awesome_tpu_torch.nn.conv import conv2d

        w = POSITIVITIES[self.positivity](params["w"])
        return conv2d(x, w, params.get("b"))


class ConvexLayerNorm(Module):
    """LayerNorm with a positive scale, so the affine part keeps
    convexity. The mean subtraction does not in general; like the
    reference it is meant for the unconstrained input path. Spec:
    `convex_modules.py:120-160`."""

    def __init__(self, features: int, positivity: str = "exp",
                 eps: float = 1e-5, device: DeviceLike = None):
        super().__init__(device)
        self.features = features
        self.positivity = positivity
        self.eps = eps

    def init(self, generator: Optional[torch.Generator] = None):
        del generator
        d = self.device
        scale0 = (torch.zeros((self.features,), device=d)  # exp(0) = 1
                  if self.positivity == "exp"
                  else torch.ones((self.features,), device=d))
        return {"scale": scale0,
                "bias": torch.zeros((self.features,), device=d)}

    def apply(self, params, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
        xn = (x - mean) * torch.rsqrt(var + self.eps)
        scale = POSITIVITIES[self.positivity](params["scale"])
        return xn * scale + params["bias"]


class LinearSkip(Module):
    """Residual wrapper ``main(x) + skip(x_input)`` with a plain linear
    skip from the original input (affine plus convex stays convex). Spec:
    `:163-190`."""

    def __init__(self, in_features: int, out_features: int,
                 main: Module = None, device: DeviceLike = None):
        super().__init__(device)
        self.in_features = in_features
        self.out_features = out_features
        self.main = main

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        return {"main": self.main.init(gen),
                "skip": Linear(self.in_features, self.out_features,
                               bias=False, device=self.device).init(gen)}

    def apply(self, params, x, x_input=None):
        x_input = x if x_input is None else x_input
        return (self.main.apply(params["main"], x)
                + matmul_t(x_input, params["skip"]["w"]))


# --- principled convex initialisation ------------------------------------


@dataclasses.dataclass(frozen=True)
class TraditionalInitialiser:
    """Variance-scaling normal init. Spec: `convex_init.py:12-33`."""

    gain: float = 1.0

    def init(self, generator, in_features, out_features, bias=True,
             device: DeviceLike = None, **_):
        gen, device = make_generator(generator), resolve_device(device)
        std = math.sqrt(self.gain / in_features)
        w = std * torch.randn((out_features, in_features), generator=gen)
        params = {"w": w.to(device)}
        if bias:
            params["b"] = torch.zeros((out_features,), device=device)
        return params


@dataclasses.dataclass(frozen=True)
class ConvexInitialiser:
    """Log-normal weight init for ICNN layers targeting the variance and
    correlation fixed points (var = 1, corr = 0.5 by default).

    Spec: `convex_init.py:77-195`: weights ~ LogNormal with squared mean
    ``corr / f_c(fan_in)`` and variance ``relu_scale (1 - corr) / fan_in``;
    bias mean ``-fan_in sqrt(mean_sq var / 2 pi)``. For positivity 'exp'
    the raw parameter stores log(weight).
    """

    var: float = 1.0
    corr: float = 0.5
    bias_noise: float = 0.0
    alpha: float = 0.0

    def corr_func(self, fan_in: int) -> float:
        rho = self.corr
        mix_mom = math.sqrt(1 - rho**2) + rho * math.acos(-rho)
        return fan_in / (2 * math.pi) * mix_mom + fan_in * (fan_in - 1) / 4.0

    def compute_parameters(self, fan_in: int):
        relu_scale = 2.0 / (1.0 + self.alpha**2)
        mean_sq = self.corr / self.corr_func(fan_in)
        w_var = relu_scale * (1.0 - self.corr) / fan_in
        shift = fan_in * math.sqrt(mean_sq * self.var / (2 * math.pi))
        b_var = 0.0
        if self.bias_noise > 0:
            w_var *= 1 - self.bias_noise
            b_var = self.bias_noise * (1.0 - self.corr) * self.var
        return (mean_sq, w_var), (-shift, b_var)

    def init(self, generator, in_features, out_features, positivity="exp",
             bias=True, device: DeviceLike = None):
        gen, device = make_generator(generator), resolve_device(device)
        (mean_sq, w_var), (b_mean, b_var) = self.compute_parameters(
            in_features)
        # log-normal sampling (convex_init.py:119-140)
        log_mom2 = math.log(mean_sq + w_var)
        log_mean = math.log(mean_sq) - log_mom2 / 2.0
        log_var = log_mom2 - math.log(mean_sq)
        log_w = log_mean + math.sqrt(log_var) * torch.randn(
            (out_features, in_features), generator=gen)
        raw_w = log_w if positivity == "exp" else torch.exp(log_w)
        params = {"w": raw_w.to(device)}
        if bias:
            params["b"] = (b_mean + math.sqrt(b_var) * torch.randn(
                (out_features,), generator=gen)).to(device)
        return params


class ConvexMLP(Module):
    """ICNN of :class:`ConvexLinear` layers (exp positivity) with input
    skips and the principled init: the forward-transform alternative to
    ``ConvexNextNet``."""

    def __init__(self, in_features: int = 2, hidden: int = 64,
                 depth: int = 2, positivity: str = "exp",
                 device: DeviceLike = None):
        super().__init__(device)
        self.in_features = in_features
        self.hidden = hidden
        self.depth = depth
        self.positivity = positivity

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        c, n, d, pos = self.in_features, self.hidden, self.device, \
            self.positivity
        init = ConvexInitialiser()
        first = Linear(c, n, device=d).init(gen)
        layers = [{"main": ConvexLinear(n, n, pos, device=d).init(gen, init),
                   "skip": Linear(c, n, bias=False, device=d).init(gen)}
                  for _ in range(self.depth - 1)]
        out = {"main": ConvexLinear(n, 1, pos, device=d).init(gen, init),
               "skip": Linear(c, 1, bias=False, device=d).init(gen)}
        return {"first": first, "layers": layers, "out": out}

    def apply(self, params, x):
        pos = self.positivity
        h = torch.relu(matmul_t(x, params["first"]["w"])
                       + params["first"]["b"])
        for blk in params["layers"]:
            h = torch.relu(_convex_linear(blk["main"], h, pos)
                           + matmul_t(x, blk["skip"]["w"]))
        out = params["out"]
        return (_convex_linear(out["main"], h, pos)
                + matmul_t(x, out["skip"]["w"]))

    def enforce_convexity(self, params):
        # positivity is a forward reparameterization: nothing to project
        return params
