"""The fused loss and gradient of the flagship prior fit; counterpart of
``awesome_tpu/ops/pallas_flagship.py``.

One call computes ``sum(w * (sigmoid(f(x)) - t)^2)`` and its gradient with
respect to every parameter of the flagship model (translate -> MinMax norm
-> RealNVP flow with tanh s/t and ActNorm -> inverse norm -> ConvexNextNet
ICNN), in the JAX package's packed layout (``PACKED_FIELDS``).

Two implementations of the same function:

- the CUDA kernel ``csrc/flagship.cu`` (Hopper, ``sm_90a``), built with
  ``nvcc`` on first use (``ops/build.py``) and bound with ``ctypes``; it
  runs for tensors on a CUDA device;
- :func:`flagship_loss_grad_plain`, the plain PyTorch version (autograd),
  which runs for tensors on the CPU and is the kernel's reference on the
  card.

A call picks by the device of its inputs; there is no fallback from one to
the other. Both come in an FP32 build and a bf16 build (``use_bf16``: the
operands of every matrix product rounded to bf16, FP32 sums, FP32 params
and loss, as the JAX kernel's ``use_bf16``). The points are shared by the
images of a call, (N, 2), or one set per image, (G, N, 2).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from awesome_tpu_torch.nn.flows import RealNVPFlow, binary_counting_masks
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.nn.path_connected import PathConnectedNet
from awesome_tpu_torch.ops.build import Library, check

Params = Any

# packed buffer names, in the kernel's flat-row order
PACKED_FIELDS = (
    "wt", "bt",
    "w1", "b1", "w2", "b2", "an_s", "an_t",
    "win", "bin", "wln", "bln", "wsk", "wout", "bout", "wosk",
)
_FLOW_FIELDS = {"w1", "b1", "w2", "b2", "an_s", "an_t"}


def _norm_constants(model) -> Tuple[np.ndarray, ...]:
    """Fold the frozen MinMax/MeanStd into pre/post per-channel affines::

        pre:  x2 = x1 * pre_a + pre_b     (norm.transform)
        post: xd = z * post_a + post_b    (norm.inverse_transform)

    Identity when ``model.norm`` is None. Each is (2, 1) float32."""
    if model.norm is None:
        a = np.ones((2, 1), np.float32)
        mn = np.zeros((2, 1), np.float32)
        new_min = 0.0
    else:
        norm = model.norm
        if hasattr(norm, "min"):  # MinMax
            mn = norm.min.detach().cpu().numpy().astype(np.float32)
            mn = mn.reshape(2, 1)
            mx = norm.max.detach().cpu().numpy().astype(np.float32)
            mx = mx.reshape(2, 1)
            span = np.where(mx - mn == 0, 1.0, mx - mn)
            a = (norm.new_max - norm.new_min) / span
            new_min = norm.new_min
        else:  # MeanStd: (x - mean) / std
            mn = norm.mean.detach().cpu().numpy().astype(np.float32)
            mn = mn.reshape(2, 1)
            std = norm.std.detach().cpu().numpy().astype(np.float32)
            a = 1.0 / np.where(std.reshape(2, 1) == 0, 1.0, std.reshape(2, 1))
            new_min = 0.0
    pre_a = a.astype(np.float32)
    pre_b = (new_min - mn * a).astype(np.float32)
    post_a = (1.0 / a).astype(np.float32)
    post_b = (mn - new_min / a).astype(np.float32)
    return pre_a, pre_b, post_a, post_b


def flagship_supported(model) -> bool:
    """The fused loss+grad covers the flagship family: a 2-channel
    PathConnectedNet with a RealNVPFlow (tanh or no output fn, no scale)
    and a ConvexNextNet."""
    return (
        isinstance(model, PathConnectedNet)
        and isinstance(model.flow_net, RealNVPFlow)
        and isinstance(model.convex_net, ConvexNextNet)
        and model.in_channels == 2
        and model.flow_net.channels == 2
        and model.flow_net.output_fn in (None, "tanh")
        and model.flow_net.output_scale is None
        and model.convex_net.out_features == 1
    )


def pack_flagship(model, params: Params) -> Dict[str, torch.Tensor]:
    """Param tree -> packed buffers, (out, in) weight orientation. Leaves
    may carry leading batch axes (a stacked tree packs to stacked
    buffers)."""
    del model
    flow = params["flow"]["steps"]
    conv = params["convex"]

    def stack(get):
        return torch.stack([get(s) for s in flow], dim=-3)

    def col(v):
        return v[..., None]

    def w2_block(s):
        ws, wt_ = s["s"]["l2"]["w"], s["t"]["l2"]["w"]  # (2, hidden) each
        top = torch.cat([ws, torch.zeros_like(ws)], dim=-1)
        bottom = torch.cat([torch.zeros_like(wt_), wt_], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    return {
        "wt": col(params["linear"]["w"]),
        "bt": col(params["linear"]["b"]),
        # merged first layers: rows [s | t], (2*hidden, 2)
        "w1": stack(lambda s: torch.cat(
            [s["s"]["l1"]["w"], s["t"]["l1"]["w"]], dim=-2)),
        "b1": stack(lambda s: col(torch.cat(
            [s["s"]["l1"]["b"], s["t"]["l1"]["b"]], dim=-1))),
        # merged second layers: block-diagonal (4, 2*hidden)
        "w2": stack(w2_block),
        "b2": stack(lambda s: col(torch.cat(
            [s["s"]["l2"]["b"], s["t"]["l2"]["b"]], dim=-1))),
        "an_s": stack(lambda s: col(s["an_s"])),
        "an_t": stack(lambda s: col(s["an_t"])),
        "win": conv["input"]["w"],
        "bin": col(conv["input"]["b"]),
        "wln": torch.stack([b["ln"]["w"] for b in conv["skip"]], dim=-3),
        "bln": torch.stack([col(b["ln"]["b"]) for b in conv["skip"]], dim=-3),
        "wsk": torch.stack([b["skp"]["w"] for b in conv["skip"]], dim=-3),
        "wout": conv["out"]["ln"]["w"],
        "bout": col(conv["out"]["ln"]["b"]),
        "wosk": conv["out"]["skp"]["w"],
    }


def unpack_flagship(model, packed: Dict[str, torch.Tensor]) -> Params:
    """Packed buffers -> param tree, the exact inverse of
    :func:`pack_flagship`."""
    del model
    n_flows = packed["w1"].shape[-3]
    hidden = packed["w1"].shape[-2] // 2
    w1, b1, w2, b2 = (packed[k] for k in ("w1", "b1", "w2", "b2"))
    s_, t_ = slice(None, hidden), slice(hidden, None)
    steps = []
    for i in range(n_flows):
        steps.append({
            "s": {
                "l1": {"w": w1[..., i, s_, :], "b": b1[..., i, s_, 0]},
                "l2": {"w": w2[..., i, 0:2, s_], "b": b2[..., i, 0:2, 0]},
            },
            "t": {
                "l1": {"w": w1[..., i, t_, :], "b": b1[..., i, t_, 0]},
                "l2": {"w": w2[..., i, 2:4, t_], "b": b2[..., i, 2:4, 0]},
            },
            "an_s": packed["an_s"][..., i, :, 0],
            "an_t": packed["an_t"][..., i, :, 0],
        })
    n_layers = packed["wln"].shape[-3]
    conv = {
        "input": {"w": packed["win"], "b": packed["bin"][..., 0]},
        "skip": [
            {"ln": {"w": packed["wln"][..., i, :, :],
                    "b": packed["bln"][..., i, :, 0]},
             "skp": {"w": packed["wsk"][..., i, :, :]}}
            for i in range(n_layers)
        ],
        "out": {
            "ln": {"w": packed["wout"], "b": packed["bout"][..., 0]},
            "skp": {"w": packed["wosk"]},
        },
    }
    return {
        "linear": {"w": packed["wt"][..., 0], "b": packed["bt"][..., 0]},
        "flow": {"steps": steps},
        "convex": conv,
    }


def packed_weight_decay(packed: dict, flow_weight_decay: float) -> dict:
    """Per-buffer weight decay: the flow buffers get
    ``flow_weight_decay``, everything else 0."""
    return {name: (flow_weight_decay if name in _FLOW_FIELDS else 0.0)
            for name in packed}


def packed_enforce_convexity(packed: dict) -> dict:
    """Clip the ICNN hidden-to-hidden weights (wln, wout) to >= 0 — the
    convexity projection on the packed layout, applied after the step."""
    return dict(packed, wln=torch.clamp_min(packed["wln"], 0.0),
                wout=torch.clamp_min(packed["wout"], 0.0))


@dataclasses.dataclass(frozen=True)
class FlagshipSpec:
    """Static description of one flagship model, as the kernel sees it."""

    n_flows: int
    hidden: int
    icnn_w: int
    n_layers: int
    use_tanh: bool
    pre_a: np.ndarray
    pre_b: np.ndarray
    post_a: np.ndarray
    post_b: np.ndarray

    @staticmethod
    def of(model) -> "FlagshipSpec":
        if not flagship_supported(model):
            raise ValueError("model not in the fused flagship family")
        flow, icnn = model.flow_net, model.convex_net
        return FlagshipSpec(flow.n_flows, flow.hidden_units, icnn.n_hidden,
                            icnn.n_hidden_layers, flow.output_fn == "tanh",
                            *_norm_constants(model))

    def field_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Per-image shape of every packed buffer."""
        f, h2, w = self.n_flows, 2 * self.hidden, self.icnn_w
        nl = self.n_layers
        return {
            "wt": (2, 1), "bt": (2, 1),
            "w1": (f, h2, 2), "b1": (f, h2, 1), "w2": (f, 4, h2),
            "b2": (f, 4, 1), "an_s": (f, 2, 1), "an_t": (f, 2, 1),
            "win": (w, 2), "bin": (w, 1), "wln": (nl, w, w), "bln": (nl, w, 1),
            "wsk": (nl, w, 2), "wout": (1, w), "bout": (1, 1), "wosk": (1, 2),
        }

    def offsets(self) -> Tuple[Dict[str, int], int]:
        """Offset of every buffer in a flat per-image row, and the row
        length P."""
        off, pos = {}, 0
        for name, shape in self.field_shapes().items():
            off[name] = pos
            pos += math.prod(shape)
        return off, pos

    def coupling_masks(self) -> np.ndarray:
        """(n_flows, 2) masks; the kernel keeps channel ``i % 2`` in flow
        ``i``, which is what :func:`binary_counting_masks` gives for 2
        channels (checked here, so the two cannot drift apart)."""
        masks = binary_counting_masks(2, self.n_flows)
        expect = np.eye(2, dtype=np.float32)[np.arange(self.n_flows) % 2]
        if not np.array_equal(masks, expect):
            raise AssertionError("coupling masks disagree with the kernel")
        return masks

    def w2_mask(self, device) -> torch.Tensor:
        """Block mask of the merged second layer: rows [s|t] x cols
        [hs|ht]; the off-block grads are masked to 0."""
        h = self.hidden
        r = torch.arange(4, device=device)[:, None]
        c = torch.arange(2 * h, device=device)[None, :]
        return (((r < 2) & (c < h)) | ((r >= 2) & (c >= h))).to(torch.float32)


def pack_flat(packed: Dict[str, torch.Tensor], group: int) -> torch.Tensor:
    """Packed buffers (leading image axis of length ``group``) -> one
    contiguous (group, P) tensor in the kernel's row order."""
    return torch.cat([packed[k].reshape(group, -1) for k in PACKED_FIELDS],
                     dim=1)


def unpack_flat(spec: FlagshipSpec, flat: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """(group, P) -> packed buffers with a leading image axis."""
    off, _ = spec.offsets()
    g = flat.shape[0]
    return {name: flat[:, off[name]:off[name] + math.prod(shape)]
            .reshape((g,) + shape)
            for name, shape in spec.field_shapes().items()}


# --- the plain PyTorch version ---------------------------------------------


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bf16 (ties to even), kept as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


class RoundedMatmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to bf16 and FP32 sums: one
    ``mm`` of the JAX kernel's bf16 build. Its backward rounds the same
    way, ``r(g) @ r(b)^T`` and ``r(a)^T @ r(g)``, as the kernel's backward
    products do."""

    @staticmethod
    def forward(a, b):
        return _bf16(a) @ _bf16(b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _bf16(g)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ _bf16(b).mT).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gb = (_bf16(a).mT @ g).sum_to_size(b.shape)
        return ga, gb


def _points_t(x: torch.Tensor) -> torch.Tensor:
    """(N, 2) shared or (G, N, 2) per-image points -> (1 or G, 2, N)."""
    return x.T[None] if x.ndim == 2 else x.transpose(1, 2)


def _plain_loss(spec: FlagshipSpec, p: Dict[str, torch.Tensor],
                x: torch.Tensor, tgt: torch.Tensor, wpt: torch.Tensor,
                use_sigmoid: bool, use_bf16: bool = False) -> torch.Tensor:
    """Per-image loss (G,) on packed buffers with a leading image axis,
    in the kernel's transposed (G, C, N) layout. ``use_bf16``: every
    matrix product rounds its operands (:class:`RoundedMatmul`)."""
    dev = x.device
    mm = RoundedMatmul.apply if use_bf16 else torch.matmul

    def const(a):
        return torch.as_tensor(a, device=dev)

    pre_a, pre_b = const(spec.pre_a), const(spec.pre_b)
    post_a, post_b = const(spec.post_a), const(spec.post_b)
    masks = const(spec.coupling_masks())
    z = (_points_t(x) * p["wt"] + p["bt"]) * pre_a + pre_b
    for i in range(spec.n_flows):
        b = masks[i].reshape(2, 1)
        zm = z * b
        h = torch.relu(mm(p["w1"][:, i], zm) + p["b1"][:, i])
        st = mm(p["w2"][:, i], h) + p["b2"][:, i]
        if spec.use_tanh:
            st = torch.tanh(st)
        s, t = st[:, :2], st[:, 2:]
        z = zm + (1.0 - b) * (z * torch.exp(s) + t)
        z = z * torch.exp(p["an_s"][:, i]) + p["an_t"][:, i]
    xd = z * post_a + post_b
    h = torch.relu(mm(p["win"], xd) + p["bin"])
    for i in range(spec.n_layers):
        h = torch.relu(mm(p["wln"][:, i], h) + mm(p["wsk"][:, i], xd)
                       + p["bln"][:, i])
    y = mm(p["wout"], h) + mm(p["wosk"], xd) + p["bout"]  # (G, 1, N)
    out = torch.sigmoid(y) if use_sigmoid else y
    e = out - tgt[:, None, :]
    return (wpt[:, None, :] * e * e).sum(dim=(1, 2))


def flagship_loss_grad_plain(spec: FlagshipSpec,
                             packed: Dict[str, torch.Tensor],
                             x: torch.Tensor, tgt: torch.Tensor,
                             wpt: torch.Tensor, use_sigmoid: bool = True,
                             use_bf16: bool = False):
    """Plain PyTorch value-and-grad. ``packed`` leaves carry a leading
    image axis G; ``x`` is (N, 2), or (G, N, 2) per image, and
    ``tgt``/``wpt`` are (G, N). Returns the per-image loss (G,) and the
    packed grads (the ``w2`` off-blocks masked to 0, as the kernel does).
    ``use_bf16``: the bf16 build's function."""
    leaves = {k: packed[k].detach().requires_grad_(True)
              for k in PACKED_FIELDS}
    with torch.enable_grad():
        loss = _plain_loss(spec, leaves, x, tgt, wpt, use_sigmoid, use_bf16)
        grads = torch.autograd.grad(loss.sum(),
                                    [leaves[k] for k in PACKED_FIELDS])
    grads = dict(zip(PACKED_FIELDS, grads))
    grads["w2"] = grads["w2"] * spec.w2_mask(x.device)
    return loss.detach(), grads


# --- the CUDA kernel --------------------------------------------------------


def _declare(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flagship_loss_grad.argtypes = [vp] * 8 + [i] * 15 + [vp]
    lib.flagship_loss_grad.restype = i
    lib.flagship_smem_bytes.argtypes = [i] * 6
    lib.flagship_smem_bytes.restype = i
    lib.flagship_device_limits.argtypes = [i, vp, vp]
    lib.flagship_device_limits.restype = i
    lib.flagship_blocks_per_sm.argtypes = [i] * 4
    lib.flagship_blocks_per_sm.restype = i


LIBRARY = Library("flagship.cu", _declare)


@dataclasses.dataclass(frozen=True)
class LaunchShape:
    """How a call is cut: ``tp`` points per chunk (the shared-memory
    tile), ``chunks`` chunks per block, ``n_tiles`` blocks per image."""

    tp: int
    smem: int
    chunks: int
    n_tiles: int


def launch_shape(spec: FlagshipSpec, n: int, group: int,
                 tile_n: Optional[int], device: torch.device,
                 use_bf16: bool = False) -> LaunchShape:
    """Pick the launch shape of the FP32 or the bf16 build. ``tile_n`` is a
    hint for the points per block; by default the blocks of all images fill
    one wave of the card.
    The result depends only on the shapes and the card, so two calls on the
    same inputs reduce in the same order (bitwise equal results)."""
    lib = LIBRARY.get()
    dev = device.index if device.index is not None else \
        torch.cuda.current_device()
    max_smem, sms = ctypes.c_int(), ctypes.c_int()
    check(lib.flagship_device_limits(dev, ctypes.byref(max_smem),
                                     ctypes.byref(sms)), "device query")
    dims = (spec.n_flows, spec.hidden, spec.icnn_w, spec.n_layers)
    for tp in (64, 32):
        smem = lib.flagship_smem_bytes(tp, int(use_bf16), *dims)
        if smem <= max_smem.value:
            break
    else:
        raise ValueError(f"model too wide for the kernel: needs {smem} B of "
                         f"shared memory, the card allows {max_smem.value}")
    n_chunks = -(-n // tp)
    if tile_n is not None:
        chunks = max(1, -(-tile_n // tp))
    else:
        per_sm = lib.flagship_blocks_per_sm(dev, tp, int(use_bf16), smem)
        if per_sm < 1:
            raise RuntimeError(f"occupancy query failed ({per_sm})")
        chunks = max(1, -(-n_chunks * group // (sms.value * per_sm)))
    return LaunchShape(tp, smem, chunks, -(-n_chunks // chunks))


def flagship_loss_grad_cuda(spec: FlagshipSpec, flat: torch.Tensor,
                            x: torch.Tensor, tgt: torch.Tensor,
                            wpt: torch.Tensor, use_sigmoid: bool,
                            shape: LaunchShape,
                            use_bf16: bool = False) -> torch.Tensor:
    """Launch the kernel (its bf16 build with ``use_bf16``): ``flat`` (G, P)
    params, ``x`` (N, 2) shared or (G, N, 2) per image, ``tgt`` and ``wpt``
    (G, N), all float32, contiguous, on one CUDA device. Returns (G, P + 1):
    the packed grads of each image then its loss. Adds one to
    ``flagship_loss_grad_cuda.launches`` (FP32 build) or to
    ``flagship_loss_grad_cuda.launches_bf16`` (bf16 build)."""
    off, p_len = spec.offsets()
    g, n = tgt.shape
    dev = x.device
    per_image = x.ndim == 3
    x_shape = (g, n, 2) if per_image else (n, 2)
    for name, t, want in (("flat", flat, (g, p_len)), ("x", x, x_shape),
                          ("target", tgt, (g, n)), ("weights", wpt, (g, n))):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {want}, got "
                             f"{tuple(t.shape)}")
    if dev.type != "cuda":
        raise ValueError("the flagship kernel takes CUDA tensors only")
    lib = LIBRARY.get()
    partials = torch.empty((g, shape.n_tiles, p_len + 1), device=dev)
    out = torch.empty((g, p_len + 1), device=dev)
    offsets = np.array([off[k] for k in PACKED_FIELDS] + [p_len], np.int32)
    consts = np.concatenate([spec.pre_a.ravel(), spec.pre_b.ravel(),
                             spec.post_a.ravel(), spec.post_b.ravel()]
                            ).astype(np.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.flagship_loss_grad(
        x.data_ptr(), tgt.data_ptr(), wpt.data_ptr(), flat.data_ptr(),
        partials.data_ptr(), out.data_ptr(),
        offsets.ctypes.data, consts.ctypes.data,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        n, g, int(per_image), spec.n_flows, spec.hidden, spec.icnn_w,
        spec.n_layers, int(spec.use_tanh), int(use_sigmoid), int(use_bf16),
        shape.tp, shape.smem, shape.chunks, shape.n_tiles, stream)
    check(code, "flagship kernel launch")
    if use_bf16:
        flagship_loss_grad_cuda.launches_bf16 += 1
    else:
        flagship_loss_grad_cuda.launches += 1
    return out


flagship_loss_grad_cuda.launches = 0
flagship_loss_grad_cuda.launches_bf16 = 0


class FlagshipLossGrad:
    """``f(packed, x, target, point_weights) -> (loss, packed_grads)``,
    the fused value-and-grad of the flagship objective (see
    :func:`make_flagship_loss_grad`). :meth:`flat` is the same function on
    flat (G, P) parameter rows, the form the fit engine keeps."""

    def __init__(self, spec: FlagshipSpec, use_sigmoid: bool, group: int,
                 tile_n: Optional[int], use_bf16: bool = False):
        self.spec = spec
        self.use_sigmoid = use_sigmoid
        self.group = group
        self.tile_n = tile_n
        self.use_bf16 = use_bf16
        self._shapes: Dict[Tuple, LaunchShape] = {}

    def flat(self, flat: torch.Tensor, x: torch.Tensor, tgt: torch.Tensor,
             wpt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(G, P) params, (N, 2) shared or (G, N, 2) per-image points, (G,
        N) targets and weights -> per-image loss (G,) and grads (G, P)."""
        n = x.shape[-2]
        if n == 0:
            raise ValueError("flagship kernel needs at least one point")
        if x.device.type == "cpu":
            loss, grads = flagship_loss_grad_plain(
                self.spec, unpack_flat(self.spec, flat), x, tgt, wpt,
                self.use_sigmoid, self.use_bf16)
            return loss, pack_flat(grads, flat.shape[0])
        key = (n, flat.shape[0], x.device)
        if key not in self._shapes:
            self._shapes[key] = launch_shape(self.spec, n, flat.shape[0],
                                             self.tile_n, x.device,
                                             self.use_bf16)
        out = flagship_loss_grad_cuda(self.spec, flat, x, tgt, wpt,
                                      self.use_sigmoid, self._shapes[key],
                                      self.use_bf16)
        _, p_len = self.spec.offsets()
        return out[:, p_len], out[:, :p_len]

    def __call__(self, packed: Dict[str, torch.Tensor], x: torch.Tensor,
                 target: torch.Tensor, point_weights: torch.Tensor):
        grouped = self.group > 1
        if not grouped:
            packed = {k: v[None] for k, v in packed.items()}
            target, point_weights = target[None], point_weights[None]
        g = target.shape[0]
        flat = pack_flat(packed, g).contiguous()
        loss, grads = self.flat(
            flat, x.contiguous(), target.reshape(g, -1).contiguous(),
            point_weights.reshape(g, -1).contiguous())
        grads = unpack_flat(self.spec, grads)
        if not grouped:
            return loss[0], {k: v[0] for k, v in grads.items()}
        return loss, grads


def make_flagship_loss_grad(model, use_sigmoid: bool = True,
                            tile_n: Optional[int] = None, group: int = 1,
                            interleave: bool = False,
                            use_bf16: bool = False) -> FlagshipLossGrad:
    """Build ``f(packed, x, target, point_weights) -> (loss, grads)``.

    ``x``: (N, 2) points; ``target`` and ``point_weights``: (N, 1), or
    (G, N, 1) with ``group`` = G > 1, where the packed buffers carry a
    leading image axis and the points are shared (N, 2) or per image (G,
    N, 2); the loss is then (G,). ``tile_n`` is only a hint for the points
    each CUDA block takes.

    ``interleave`` (group > 1 only) selects the JAX package's
    ``_kernel_interleaved``, which computes the same function as the
    grouped ``_kernel`` on a schedule made for the TPU: it alternates the
    images' matrix-unit chains inside one sequential program and recomputes
    activations to fit VMEM. On the card the images are already separate
    blocks that run concurrently, and the kernel already recomputes the
    flow's hidden layer, so it is served by the same grouped kernel.

    ``use_bf16`` selects the bf16 build: the operands of every matrix
    product are rounded to bf16 and the products summed in FP32; the
    params, activations, plain sums and the loss stay FP32."""
    spec = FlagshipSpec.of(model)
    if interleave and group < 2:
        raise ValueError("interleave requires group >= 2")
    spec.coupling_masks()
    return FlagshipLossGrad(spec, use_sigmoid, group, tile_n, use_bf16)
