"""More flow families: Glow steps and rational-quadratic spline couplings;
counterpart of ``awesome_tpu/nn/flows_extra.py``.

Equivalents of the reference's normflows-based factories
`awesome/model/net_factory.py:43-68` (``init_glow``: ActNorm, an
invertible LU-parameterized linear map and an affine coupling with a
sigmoid scale map) and `:17-41` (``init_splines``: rational-quadratic
splines, Durkan et al., "Neural Spline Flows"), on (N, C) points with
analytic inverses; the splines are coupling layers.

The coupling masks are registered buffers, never parameters (the JAX
package keeps them as stop-gradient leaves; ``bridge.params_from_jax``
drops them). ``GlowFlow``'s permutation ``P`` is a parameter leaf, as in
the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.nn.flows import binary_counting_masks
from awesome_tpu_torch.nn.linear import Linear, matmul_t
from awesome_tpu_torch.nn.module import Module, make_generator


def _mlp_init(module: Module, gen, out_dim: int, width: int):
    """Linear(C, width) then a zero-initialized Linear(width, out_dim)."""
    d = module.device
    return {"l1": Linear(module.channels, width, device=d).init(gen),
            "l2": {"w": torch.zeros((out_dim, width), device=d),
                   "b": torch.zeros((out_dim,), device=d)}}


def _mlp(p, x):
    h = F.leaky_relu(matmul_t(x, p["l1"]["w"]) + p["l1"]["b"],
                     negative_slope=0.01)
    return matmul_t(h, p["l2"]["w"]) + p["l2"]["b"]


class _Coupled(Module):
    masks: torch.Tensor

    def __init__(self, channels: int, n_flows: int, device: DeviceLike):
        super().__init__(device)
        self.channels = channels
        self.n_flows = n_flows
        self.register_buffer("masks", torch.as_tensor(
            binary_counting_masks(channels, n_flows), device=self.device))


# --- Glow ---------------------------------------------------------------


class GlowFlow(_Coupled):
    """Glow steps on (N, C): ActNorm, then the LU-parameterized linear map
    ``W = P (I + tril(L, -1)) (triu(U, 1) + diag(exp(log_s)))``, then a
    masked affine coupling with the scale ``sigmoid(s + 2)`` (bounded,
    never 0)."""

    def __init__(self, channels: int = 2, hidden_channels: int = 64,
                 n_flows: int = 4, device: DeviceLike = None):
        super().__init__(channels, n_flows, device)
        self.hidden_channels = hidden_channels

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        c, d = self.channels, self.device
        steps = []
        for _ in range(self.n_flows):
            perm = torch.randperm(c, generator=gen)
            steps.append({
                "an_s": torch.zeros((c,), device=d),
                "an_t": torch.zeros((c,), device=d),
                "P": torch.eye(c)[perm].to(d),
                "L": torch.zeros((c, c), device=d),  # strictly lower
                "U": torch.zeros((c, c), device=d),  # strictly upper
                "log_s": torch.zeros((c,), device=d),  # U's diagonal
                "st": _mlp_init(self, gen, 2 * c, self.hidden_channels),
            })
        return {"steps": steps}

    @staticmethod
    def _lu_weight(step):
        c = step["P"].shape[0]
        eye = torch.eye(c, device=step["P"].device)
        tril = torch.tril(step["L"], -1) + eye
        triu = torch.triu(step["U"], 1) + torch.diag(torch.exp(step["log_s"]))
        return step["P"] @ tril @ triu

    def _st(self, step, zm):
        st = _mlp(step["st"], zm)
        c = self.channels
        return torch.sigmoid(st[:, :c] + 2.0), st[:, c:]

    def apply(self, params, x):
        z = x
        for step, b in zip(params["steps"], self.masks):
            z = z * torch.exp(step["an_s"]) + step["an_t"]
            z = z @ self._lu_weight(step).T
            zm = b * z
            scale, t = self._st(step, zm)
            z = zm + (1.0 - b) * (z * scale + t)
        return z

    def inverse(self, params, y):
        z = y
        for step, b in zip(reversed(params["steps"]), self.masks.flip(0)):
            zm = b * z
            scale, t = self._st(step, zm)
            z = zm + (1.0 - b) * (z - t) / scale
            z = z @ torch.linalg.inv(self._lu_weight(step)).T
            z = (z - step["an_t"]) * torch.exp(-step["an_s"])
        return z


# --- rational-quadratic splines -----------------------------------------


def _rqs(x, widths, heights, derivs, bound: float, inverse: bool):
    """Monotone rational-quadratic spline on [-bound, bound], the identity
    outside. ``widths``/``heights`` (..., K) positive and normalized;
    ``derivs`` (..., K + 1) positive knot derivatives. A point's bin is the
    count of knots at or below it (``>=``), less one."""
    k = widths.shape[-1]
    zero = torch.zeros(widths.shape[:-1] + (1,), dtype=widths.dtype,
                       device=widths.device)
    xk = -bound + 2 * bound * torch.cat([zero, torch.cumsum(widths, -1)], -1)
    yk = -bound + 2 * bound * torch.cat([zero, torch.cumsum(heights, -1)],
                                        -1)

    inside = (x > -bound) & (x < bound)
    xs = torch.clamp(x, -bound + 1e-6, bound - 1e-6)

    ref = yk if inverse else xk
    idx = torch.clamp(
        torch.sum((xs[..., None] >= ref[..., :-1]).to(torch.int64), -1) - 1,
        0, k - 1)[..., None]

    def take(a):
        return torch.gather(a, -1, idx)[..., 0]

    x_lo, x_hi = take(xk[..., :-1]), take(xk[..., 1:])
    y_lo, y_hi = take(yk[..., :-1]), take(yk[..., 1:])
    d_lo, d_hi = take(derivs[..., :-1]), take(derivs[..., 1:])
    w = torch.clamp_min(x_hi - x_lo, 1e-6)
    h = torch.clamp_min(y_hi - y_lo, 1e-6)
    slope = h / w

    if not inverse:
        theta = (xs - x_lo) / w
        num = h * (slope * theta ** 2 + d_lo * theta * (1 - theta))
        den = slope + (d_hi + d_lo - 2 * slope) * theta * (1 - theta)
        out = y_lo + num / den
    else:
        yq = xs - y_lo
        a = h * (slope - d_lo) + yq * (d_hi + d_lo - 2 * slope)
        bq = h * d_lo - yq * (d_hi + d_lo - 2 * slope)
        cq = -slope * yq
        disc = torch.clamp_min(bq ** 2 - 4 * a * cq, 0.0)
        theta = 2 * cq / (-bq - torch.sqrt(disc))
        out = x_lo + theta * w
    return torch.where(inside, out, x)


class SplineFlow(_Coupled):
    """Rational-quadratic spline couplings on (N, C) points: the transformed
    channels' spline parameters come from an MLP over the masked channels
    (zero-initialized output layer, so the flow starts near the identity);
    ``num_bins`` bins on [-bound, bound]."""

    def __init__(self, channels: int = 2, hidden_units: int = 32,
                 n_flows: int = 4, num_bins: int = 8, bound: float = 3.0,
                 device: DeviceLike = None):
        super().__init__(channels, n_flows, device)
        self.hidden_units = hidden_units
        self.num_bins = num_bins
        self.bound = bound

    def _param_dim(self) -> int:
        return 3 * self.num_bins + 1

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        out_dim = self.channels * self._param_dim()
        return {"steps": [{"st": _mlp_init(self, gen, out_dim,
                                           self.hidden_units)}
                          for _ in range(self.n_flows)]}

    def _couple(self, step, b, z, inverse: bool):
        raw = _mlp(step["st"], b * z)
        n, k = z.shape[0], self.num_bins
        raw = raw.reshape(n, self.channels, self._param_dim())
        widths = torch.softmax(raw[..., :k], -1)
        heights = torch.softmax(raw[..., k:2 * k], -1)
        # softplus as log(1 + e^x) everywhere (~1 at init)
        inner = raw[..., 2 * k:] + 0.5413
        d_inner = torch.logaddexp(inner, torch.zeros_like(inner))
        ones = torch.ones(d_inner.shape[:-1] + (1,), dtype=z.dtype,
                          device=z.device)
        derivs = torch.cat([ones, d_inner[..., 1:-1], ones], -1)
        out = _rqs(z, widths, heights, derivs, self.bound, inverse)
        return b * z + (1.0 - b) * out

    def apply(self, params, x):
        z = x
        for step, b in zip(params["steps"], self.masks):
            z = self._couple(step, b, z, inverse=False)
        return z

    def inverse(self, params, y):
        z = y
        for step, b in zip(reversed(params["steps"]), self.masks.flip(0)):
            z = self._couple(step, b, z, inverse=True)
        return z
