"""Operations and bytes of the port's steps and kernels, frozen from a
configuration's shapes, and the card's published peaks.

Model FLOPs count 2 FLOP per multiply-add over every weight matrix:
one pass for a forward, three for a training step (the forward and two
backward passes: data and weight grads). Elementwise work (activations,
exp, sigmoid, batch norm, pooling) is not counted. A kernel's bound is the
larger of its operations at the FP32 peak and its bytes (every input read
once, every output written once) at the HBM rate.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
PEAK_FP32_FLOPS = 67e12  # CUDA cores, FP32 FMA
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense bf16
PEAK_BYTES_PER_S = 3.35e12  # HBM3

# kernel names in the port's CUDA sources (ops/csrc/flagship.cu, icnn.cu);
# each reduce_tiles launch belongs to the loss+grad kernel before it on its
# stream
KERNELS = {
    "flagship": "flagship_fwd_bwd",
    "icnn_fwd": "icnn_fwd",
    "icnn_bwd": "icnn_bwd",
}
REDUCE = "reduce_tiles"
OWNS_REDUCE = ("flagship", "icnn_bwd")
NCCL = "nccl"


# --- the ICNN (ConvexNextNet) ----------------------------------------------


def icnn_macs(width: int, layers: int, in_features: int = 2) -> int:
    """Multiply-adds per point of ``ConvexNextNet(width, layers)``: the
    input layer, each block's hidden-to-hidden and input-skip matrices,
    the output layer and its skip."""
    c, w = in_features, width
    return c * w + layers * (w * w + c * w) + w + c


def icnn_params(width: int, layers: int, in_features: int = 2) -> int:
    c, w = in_features, width
    return (c * w + w) + layers * (w * w + w + c * w) + (w + 1 + c)


# --- the path-connected prior (translate, norm, RealNVP, ICNN) --------------


def flow_macs(n_flows: int, hidden: int, channels: int = 2) -> int:
    """Per point: each coupling's s and t MLPs, C -> hidden -> C each."""
    return n_flows * 4 * hidden * channels


def flow_params(n_flows: int, hidden: int, channels: int = 2) -> int:
    mlp = hidden * channels + hidden + channels * hidden + channels
    return n_flows * (2 * mlp + 2 * channels)


def prior_macs(cfg: dict) -> int:
    """Multiply-adds per point of a configuration's prior."""
    c = cfg.get("channels", 2)
    icnn = icnn_macs(cfg["convex_hidden_units"], cfg["convex_hidden_layers"],
                     c)
    if cfg["prior"] == "path_connected":
        return flow_macs(cfg["flow_n_flows"], cfg["flow_hidden_units"],
                         c) + icnn
    return icnn


def prior_params(cfg: dict) -> int:
    c = cfg.get("channels", 2)
    icnn = icnn_params(cfg["convex_hidden_units"],
                       cfg["convex_hidden_layers"], c)
    if cfg["prior"] == "path_connected":
        return 2 * c + flow_params(cfg["flow_n_flows"],
                                   cfg["flow_hidden_units"], c) + icnn
    return icnn


def fit_flops_per_point_step(cfg: dict) -> float:
    """Model FLOPs of one optimizer step at one point: three passes."""
    return 6.0 * prior_macs(cfg)


# --- the UNet ----------------------------------------------------------------


def _double_conv(cin: int, cout: int, h: int, w: int) -> int:
    return h * w * 9 * (cin * cout + cout * cout)


def unet_macs(cfg: dict, h: int, w: int) -> int:
    """Multiply-adds of one image's UNet forward: every 3x3 conv of the
    double convs at its resolution (4 halvings, odd edges dropped) and the
    1x1 conv out."""
    sizes = [(h, w)]
    for _ in range(4):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    total = _double_conv(cfg["seg_in_chn"], 64, h, w)
    for (ci, co), (hh, ww) in zip(cfg["unet_down"], sizes[1:]):
        total += _double_conv(ci, co, hh, ww)
    for (ci, co), (hh, ww) in zip(cfg["unet_up"], sizes[-2::-1]):
        total += _double_conv(ci, co, hh, ww)
    return total + h * w * 64 * cfg["seg_out_chn"]


def joint_flops_per_step(cfg: dict, h: int, w: int, batch: int) -> float:
    """Model FLOPs of one joint step: the UNet and each image's prior,
    three passes each."""
    return 6.0 * batch * (unet_macs(cfg, h, w) + prior_macs(cfg) * h * w)


# --- kernel bounds -----------------------------------------------------------


def _bound(flops: float, nbytes: float, peak: float) -> Tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flagship_bound_s(cfg: dict, n: int, g: int, bf16: bool = False,
                     per_image: bool = False) -> Tuple[float, str]:
    """Least seconds of one fused loss+grad launch (K1, or K2 at G > 1)
    over ``g`` images of ``n`` points: three passes over every matrix;
    points, targets, weights and params read once, grads and loss written
    once."""
    p = prior_params(cfg)
    c = cfg.get("channels", 2)
    n_pts = n * g if per_image else n
    flops = fit_flops_per_point_step(cfg) * n * g
    nbytes = 4.0 * (c * n_pts + 2 * g * n + g * p + g * (p + 1))
    return _bound(flops, nbytes, PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)


def icnn_bound_s(cfg: dict, n: int, g: int, backward: bool,
                 per_image: bool = False) -> Tuple[float, str]:
    """Least seconds of one K4 (forward: one pass) or K5 (backward: its
    forward recompute, weight and data grads, three passes) launch."""
    c = cfg.get("channels", 2)
    macs = icnn_macs(cfg["convex_hidden_units"], cfg["convex_hidden_layers"],
                     c)
    p = icnn_params(cfg["convex_hidden_units"], cfg["convex_hidden_layers"],
                    c)
    x_floats = n * c * (g if per_image else 1)
    flops = 2.0 * (3.0 if backward else 1.0) * macs * n * g
    if backward:
        nbytes = 4.0 * (x_floats + g * n + 2 * g * p + g * n * c)
    else:
        nbytes = 4.0 * (x_floats + g * p + g * n)
    return _bound(flops, nbytes, PEAK_FP32_FLOPS)


def kernel_of(name: str) -> str:
    """The kind (a key of KERNELS, 'reduce', 'nccl') of a device op's
    name, or ''."""
    for kind, pattern in KERNELS.items():
        if pattern in name:
            return kind
    if REDUCE in name:
        return "reduce"
    if NCCL in name.lower():
        return "nccl"
    return ""


def per_kernel(device_ops: Sequence[Tuple[str, float, float, int]]
               ) -> Dict[str, Dict[str, float]]:
    """Launch counts and device seconds per kernel kind from the traced
    device ops ``(name, start_s, end_s, stream)``, each ``reduce_tiles``
    added to the loss+grad kernel before it on its stream."""
    out: Dict[str, Dict[str, float]] = {}
    owner: Dict[int, str] = {}
    for name, start, end, stream in sorted(device_ops, key=lambda e: e[1]):
        kind = kernel_of(name)
        if kind == "reduce":
            kind = owner.get(stream, "")
            if not kind:
                continue
            out[kind]["seconds"] += end - start
            continue
        if not kind:
            continue
        if kind in OWNS_REDUCE:
            owner[stream] = kind
        slot = out.setdefault(kind, {"launches": 0.0, "seconds": 0.0})
        slot["launches"] += 1
        slot["seconds"] += end - start
    return out
