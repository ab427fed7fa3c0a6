"""Shape priors of the paper's teaser experiments beyond convexity:
star shape, rotational symmetry, periodicity; counterpart of
``awesome_tpu/nn/priors_extra.py``.

Specs: the ``myNet`` variants of the reference's notebook-only code,
`notebooks/icml_teaser_code/star_shaped/star.ipynb` (a network monotone
in the radius), `rotation_symmetric/rotation_symmetric.ipynb` (learned
offset and orientation, an |y| fold) and `repeating/repeating.ipynb`
(sin features). They take (N, 2) points like the other priors and plug
into the same fit engine.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from awesome_tpu_torch.device import DeviceLike
from awesome_tpu_torch.nn.linear import Linear, matmul_t
from awesome_tpu_torch.nn.module import Module, make_generator


def _dense(p, x):
    return matmul_t(x, p["w"]) + p["b"]


class StarShapedNet(Module):
    """Star-shape prior: ``f(x) = r * (W2(h(u)) + W2_r(relu(W1(h(u)) +
    W1_r(r)))) - 1`` with ``u = x / (0.01 + r)`` the direction; ``f < 0``
    is star-shaped around ``offset`` once ``W2_r >= 0``
    (:meth:`enforce_convexity`). The offset is not trained unless
    ``train_offset`` (the notebook's ``offset.requires_grad = False``)."""

    def __init__(self, n_hidden: int = 130, train_offset: bool = False,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_hidden = n_hidden
        self.train_offset = train_offset

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        n, d = self.n_hidden, self.device
        return {
            "offset": torch.zeros((1, 2), device=d),
            "W0": Linear(2, n, device=d).init(gen),
            "W1": Linear(n, n, device=d).init(gen),
            "W2": Linear(n, 1, device=d).init(gen),
            "W1_r": Linear(1, n, device=d).init(gen),
            "W2_r": Linear(n, 1, device=d).init(gen),
        }

    def apply(self, params, x):
        offset = params["offset"]
        if not self.train_offset:
            offset = offset.detach()
        x = x + offset
        r = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
        h = torch.relu(_dense(params["W0"], x / (0.01 + r)))
        r_aug = torch.relu(_dense(params["W1"], h)
                           + _dense(params["W1_r"], r))
        return r * (_dense(params["W2"], h)
                    + _dense(params["W2_r"], r_aug)) - 1.0

    def enforce_convexity(self, params):
        """Radial monotonicity: ``W2_r >= 0`` after the step, as the
        notebook's ``net.W2_r.weight.data = F.relu(...)``
        (`notebooks/icml_teaser_code/star_shaped/star.ipynb` cell 3)."""
        return dict(params, W2_r=dict(params["W2_r"],
                                      w=torch.relu(params["W2_r"]["w"])))


class RotationSymmetricNet(Module):
    """Symmetry prior: a learned offset and orientation; with
    ``symmetry_prior`` the |y| fold of the rotated direction makes the mask
    mirror-symmetric about the learned axis."""

    def __init__(self, n_hidden: int = 130, symmetry_prior: bool = True,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_hidden = n_hidden
        self.symmetry_prior = symmetry_prior

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        n, d = self.n_hidden, self.device
        return {
            "offset": torch.zeros((1, 2), device=d),
            "orientation": torch.full((1,), -0.05, device=d),
            "W0": Linear(3, n, device=d).init(gen),
            "W1": Linear(n, n, device=d).init(gen),
            "W2": Linear(n, 1, device=d).init(gen),
        }

    def apply(self, params, x):
        x = x + params["offset"]
        r = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
        u = x / (0.001 + r)
        c = torch.cos(params["orientation"])
        s = torch.sin(params["orientation"])
        u0 = (u[:, 0] * c - u[:, 1] * s)[:, None]
        u1 = (u[:, 0] * s + u[:, 1] * c)[:, None]
        if self.symmetry_prior:
            u1 = torch.abs(u1)
        h = torch.relu(_dense(params["W0"], torch.cat([u0, u1, r], dim=1)))
        h = torch.relu(_dense(params["W1"], h))
        return _dense(params["W2"], h)


class PeriodicNet(Module):
    """Periodicity prior: ``f(x) = W2(sin(10 pi W1(W0(x + offset))))``, the
    offset never trained, ``W0`` a learned 2x2 affine pre-map (identity at
    init) that lets the period lattice rotate and stretch.
    ``use_premap=False`` drops ``W0``: the notebook's forward
    (`repeating.ipynb` cell 3) defines a W0 but never applies it."""

    def __init__(self, n_hidden: int = 130, use_premap: bool = True,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_hidden = n_hidden
        self.use_premap = use_premap

    def init(self, generator: Optional[torch.Generator] = None):
        gen = make_generator(generator)
        n, d = self.n_hidden, self.device
        params = {
            "offset": torch.zeros((1, 2), device=d),
            "W1": Linear(2, n, device=d).init(gen),
            "W2": Linear(n, 1, device=d).init(gen),
        }
        if self.use_premap:
            params["W0"] = {"w": torch.eye(2, device=d),
                            "b": torch.zeros((2,), device=d)}
        return params

    def apply(self, params, x):
        x = x + params["offset"].detach()
        if self.use_premap:
            x = _dense(params["W0"], x)
        h = 10.0 * math.pi * _dense(params["W1"], x)
        return _dense(params["W2"], torch.sin(h))
