"""Parameter trees of the configurations, in the port's layout (nested
dicts and lists of float32 tensors; a linear weight is (out, in), a conv
weight (out, in, kh, kw)), and how the benchmark draws them.

A layout leaf is ``(shape, centre, half_width)``: the benchmark draws the
leaf uniformly in ``centre +- half_width`` (a half-width of 0 is the
constant ``centre``). All leaves of a tree come from one draw on the card
(:func:`draw`)."""
from __future__ import annotations

import math
from typing import Any, List

import torch


def _linear(fan_in: int, fan_out: int, bias: bool = True,
            scale: float = 1.0) -> dict:
    """torch.nn.Linear's default init, U(+-1/sqrt(fan_in)), times
    ``scale``."""
    b = scale / math.sqrt(fan_in)
    out = {"w": ((fan_out, fan_in), 0.0, b)}
    if bias:
        out["b"] = ((fan_out,), 0.0, b)
    return out


def icnn(cfg: dict) -> dict:
    """ConvexNextNet(width, layers): input layer, skip blocks (ln, skp),
    output block."""
    c, w = cfg.get("channels", 2), cfg["convex_hidden_units"]
    return {
        "input": _linear(c, w),
        "skip": [{"ln": _linear(w, w), "skp": _linear(c, w, bias=False)}
                 for _ in range(cfg["convex_hidden_layers"])],
        "out": {"ln": _linear(w, 1), "skp": _linear(c, 1, bias=False)},
    }


def path_connected(cfg: dict) -> dict:
    """Translate (per-channel affine near the identity), RealNVP couplings
    (s and t MLPs; their last layers a tenth of the default scale, so the
    flow starts near the identity but every leaf carries a gradient) with
    ActNorm near the identity, then the ICNN."""
    c, h = cfg.get("channels", 2), cfg["flow_hidden_units"]

    def mlp():
        return {"l1": _linear(c, h), "l2": _linear(h, c, scale=0.1)}

    steps = [{"s": mlp(), "t": mlp(), "an_s": ((c,), 0.0, 0.01),
              "an_t": ((c,), 0.0, 0.01)}
             for _ in range(cfg["flow_n_flows"])]
    return {"linear": {"w": ((c,), 1.0, 0.01), "b": ((c,), 0.0, 0.01)},
            "flow": {"steps": steps}, "convex": icnn(cfg)}


def prior(cfg: dict) -> dict:
    if cfg["prior"] == "path_connected":
        return path_connected(cfg)
    return icnn(cfg)


def _conv(cin: int, cout: int, k: int) -> dict:
    b = 1.0 / math.sqrt(cin * k * k)
    return {"w": ((cout, cin, k, k), 0.0, b), "b": ((cout,), 0.0, b)}


def _bn(ch: int) -> dict:
    return {"scale": ((ch,), 1.0, 0.0), "bias": ((ch,), 0.0, 0.0)}


def unet(cfg: dict) -> dict:
    """UNet params: double convs (conv, batch norm, twice) and the 1x1
    out conv; torch's Conv2d init, batch norm scale 1 and bias 0."""

    def double(ci, co):
        return {"conv1": _conv(ci, co, 3), "bn1": _bn(co),
                "conv2": _conv(co, co, 3), "bn2": _bn(co)}

    out = {"inc": double(cfg["seg_in_chn"], 64)}
    for i, (ci, co) in enumerate(cfg["unet_down"], start=1):
        out[f"down{i}"] = double(ci, co)
    for i, (ci, co) in enumerate(cfg["unet_up"], start=1):
        out[f"up{i}"] = double(ci, co)
    out["outc"] = _conv(64, cfg["seg_out_chn"], 1)
    return out


def unet_state(cfg: dict, device) -> dict:
    """Batch-norm running statistics: mean 0, variance 1, count 0."""

    def bn(ch):
        return {"mean": torch.zeros(ch, device=device),
                "var": torch.ones(ch, device=device),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def double(co):
        return {"bn1": bn(co), "bn2": bn(co)}

    out = {"inc": double(64)}
    for i, (_, co) in enumerate(cfg["unet_down"], start=1):
        out[f"down{i}"] = double(co)
    for i, (_, co) in enumerate(cfg["unet_up"], start=1):
        out[f"up{i}"] = double(co)
    return out


# --- trees -------------------------------------------------------------------


def leaves(tree: Any) -> List[Any]:
    """Leaves with dict keys sorted and lists in order: the order in which
    :func:`rebuild` takes them back."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree: Any, it) -> Any:
    """``tree``'s structure with its leaves taken from the iterator."""
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [rebuild(v, it) for v in tree]
    return next(it)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def draw(layout: Any, gen: torch.Generator, count: int, device) -> Any:
    """``count`` trees of ``layout`` stacked on a leading axis, from ONE
    uniform draw of ``gen`` (a generator on ``device``): each leaf
    ``centre + half_width * U(-1, 1)``, contiguous."""
    specs = leaves(layout)
    sizes = [math.prod(s) for s, _, _ in specs]
    total = sum(sizes)
    u = torch.rand((count, total), generator=gen, device=device)
    n = torch.tensor(sizes, device=device)
    centre = torch.repeat_interleave(
        torch.tensor([c for _, c, _ in specs], device=device), n)
    half = torch.repeat_interleave(
        torch.tensor([h for _, _, h in specs], device=device), n)
    vals = centre + half * (2.0 * u - 1.0)
    parts = torch.split(vals, sizes, dim=1)
    flat = [p.reshape((count,) + s).contiguous()
            for p, (s, _, _) in zip(parts, specs)]
    return rebuild(layout, iter(flat))


def select(stacked: Any, i: int) -> Any:
    return tree_map(lambda x: x[i], stacked)
