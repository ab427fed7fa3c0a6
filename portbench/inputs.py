"""The one generator of every traffic mix: shapes, unaries, frames and
weights, made on the run's device from the run's seed.

A traffic file gives the frame size and the mix's parameters; every seed
gives the same sizes and amounts of work, with other shapes, motions and
noise. Foreground is encoded 0 in unaries and targets, as in the port.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number;
    taken modulo 2**63)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def pixel_points(h: int, w: int, device) -> torch.Tensor:
    """(h*w, 2) points (x = column / w, y = row / h), row-major."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device) / h,
        torch.arange(w, dtype=torch.float32, device=device) / w,
        indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1)


def _u(gen, n, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def _ellipses(gen, n, yy, xx, h, w, device) -> torch.Tensor:
    cy, cx = _u(gen, n, 0.35, 0.65, device) * h, \
        _u(gen, n, 0.35, 0.65, device) * w
    a, b = _u(gen, n, 0.12, 0.25, device) * h, \
        _u(gen, n, 0.12, 0.25, device) * w
    th = _u(gen, n, 0.0, math.pi, device)
    c, s = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    dy, dx = yy[None] - cy[:, None, None], xx[None] - cx[:, None, None]
    u, v = c * dx + s * dy, -s * dx + c * dy
    return (u / b[:, None, None]) ** 2 + (v / a[:, None, None]) ** 2 <= 1.0


def _polygons(gen, n, yy, xx, h, w, device, corners: int = 6):
    """Convex polygons: ``corners`` points on a random ellipse, one at a
    random angle in each of ``corners`` equal sectors, inside every edge's
    half-plane."""
    cy, cx = _u(gen, n, 0.35, 0.65, device) * h, \
        _u(gen, n, 0.35, 0.65, device) * w
    a, b = _u(gen, n, 0.15, 0.28, device) * h, \
        _u(gen, n, 0.15, 0.28, device) * w
    sector = torch.arange(corners, dtype=torch.float32, device=device)
    ang = (sector[None] + _u(gen, (n, corners), 0.0, 1.0, device)) \
        * (2 * math.pi / corners)
    py = cy[:, None] + a[:, None] * torch.sin(ang)
    px = cx[:, None] + b[:, None] * torch.cos(ang)
    inside = torch.ones((n,) + yy.shape, dtype=torch.bool, device=device)
    for k in range(corners):
        j = (k + 1) % corners
        ex, ey = (px[:, j] - px[:, k])[:, None, None], \
            (py[:, j] - py[:, k])[:, None, None]
        rx, ry = xx[None] - px[:, k, None, None], \
            yy[None] - py[:, k, None, None]
        inside &= ex * ry - ey * rx >= 0.0
    return inside


def shapes(gen, n: int, h: int, w: int, kinds: Sequence[str], device
           ) -> torch.Tensor:
    """(n, h, w) bool foreground masks: shape ``i`` of kind ``kinds[i %
    len(kinds)]``."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device) + 0.5,
                            torch.arange(w, dtype=torch.float32,
                                         device=device) + 0.5,
                            indexing="ij")
    out = torch.empty((n, h, w), dtype=torch.bool, device=device)
    for kind in set(kinds):
        idx = [i for i in range(n) if kinds[i % len(kinds)] == kind]
        make = _ellipses if kind == "ellipse" else _polygons
        out[idx] = make(gen, len(idx), yy, xx, h, w, device)
    return out


def moving_ellipse(gen, frames: int, h: int, w: int, motion: float,
                   device) -> torch.Tensor:
    """(frames, h, w) masks of one ellipse whose centre moves ``motion`` of
    the frame's height and width per frame, in a random direction."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device) + 0.5,
                            torch.arange(w, dtype=torch.float32,
                                         device=device) + 0.5,
                            indexing="ij")
    cy0, cx0 = _u(gen, 1, 0.4, 0.6, device) * h, \
        _u(gen, 1, 0.4, 0.6, device) * w
    a, b = _u(gen, 1, 0.12, 0.22, device) * h, \
        _u(gen, 1, 0.12, 0.22, device) * w
    th = _u(gen, 1, 0.0, math.pi, device)
    phi = _u(gen, 1, 0.0, 2 * math.pi, device)
    f = torch.arange(frames, dtype=torch.float32, device=device)
    cy = cy0 + f * motion * h * torch.sin(phi)
    cx = cx0 + f * motion * w * torch.cos(phi)
    c, s = torch.cos(th), torch.sin(th)
    dy, dx = yy[None] - cy[:, None, None], xx[None] - cx[:, None, None]
    u, v = c * dx + s * dy, -s * dx + c * dy
    return (u / b) ** 2 + (v / a) ** 2 <= 1.0


def unaries(gen, fg: torch.Tensor, flip: float) -> torch.Tensor:
    """(..., h*w, 1) unaries of (..., h, w) masks: 0 on foreground, 1 on
    background, each pixel flipped with probability ``flip``."""
    t = (~fg).to(torch.float32)
    flips = torch.rand(fg.shape, generator=gen, device=fg.device) < flip
    t = torch.where(flips, 1.0 - t, t)
    return t.reshape(fg.shape[:-2] + (-1, 1))


def joint_frames(gen, fg: torch.Tensor) -> dict:
    """Frames for joint training from (T, h, w) masks: an image of uniform
    noise, brighter on the object; a feature map of noise; the target."""
    t, h, w = fg.shape
    dev = fg.device
    tgt = (~fg).to(torch.float32)[..., None]
    image = 0.5 * torch.rand((t, h, w, 3), generator=gen, device=dev) \
        + 0.5 * (1.0 - tgt)
    feats = torch.rand((t, h, w, 1), generator=gen, device=dev)
    return {"image": image, "features": feats, "target": tgt,
            "grid": pixel_points(h, w, dev)}


def keys(gen, n: int) -> List[int]:
    """``n`` integer seeds for the program's own draws (the gate's retry
    inits)."""
    return [int(k) for k in torch.randint(
        0, 2 ** 31 - 1, (n,), generator=gen, device=gen.device).tolist()]
