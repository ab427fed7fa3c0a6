"""The ICNN (ConvexNextNet) forward and backward over coordinate points;
counterpart of ``awesome_tpu/ops/pallas_mlp.py``.

Two implementations of each function:

- the CUDA kernels of ``csrc/icnn.cu`` (Hopper, ``sm_90a``): K4, the
  forward, and K5, the backward (it recomputes the forward per chunk),
  built with ``nvcc`` on first use (``ops/build.py``) and bound with
  ``ctypes``; they run for tensors on a CUDA device;
- :func:`icnn_forward_plain` and :func:`icnn_backward_plain`, plain
  PyTorch versions in the port's ``(out, in)`` weight layout, which run for
  tensors on the CPU and are the kernels' reference on the card.

A call picks by the device of its points; there is no fallback from one to
the other (the JAX package's "plain apply off-TPU" becomes that device
rule). Both kernels carry a leading image axis G: the parameters are one
flat row per image, in the order of :func:`flat_weights`, and the points
are shared by the group or one set per image.

:class:`FusedConvexNextNet` runs K4 with the plain VJP as its backward;
:class:`FullyFusedConvexNextNet` runs K4 and K5. Their autograd Functions
take ``torch.func.grad`` and ``torch.func.vmap``: a vmapped call maps the
batch onto the kernels' image axis, so a batched fit of B images makes one
K4 and one K5 launch per step, not B of each.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, List, Sequence, Tuple

import torch

from awesome_tpu_torch.nn.module import Module
from awesome_tpu_torch.ops.build import Library, check

Params = Any


# --- param layout -----------------------------------------------------------


def flat_weights(params: Params) -> Tuple[torch.Tensor, ...]:
    """The ConvexNextNet leaves in the kernels' order (``_flat_weights`` of
    the JAX package): win, bin, per layer (wln, bln, wsk), wout, bout,
    wosk."""
    ws = [params["input"]["w"], params["input"]["b"]]
    for blk in params["skip"]:
        ws += [blk["ln"]["w"], blk["ln"]["b"], blk["skp"]["w"]]
    ws += [params["out"]["ln"]["w"], params["out"]["ln"]["b"],
           params["out"]["skp"]["w"]]
    return tuple(ws)


def unflat_weights(leaves: Sequence[torch.Tensor]) -> Params:
    """The inverse of :func:`flat_weights`."""
    n_layers = (len(leaves) - 5) // 3
    it = iter(leaves)
    tree = {"input": {"w": next(it), "b": next(it)}, "skip": []}
    for _ in range(n_layers):
        w, b, sk = next(it), next(it), next(it)
        tree["skip"].append({"ln": {"w": w, "b": b}, "skp": {"w": sk}})
    w, b, sk = next(it), next(it), next(it)
    tree["out"] = {"ln": {"w": w, "b": b}, "skp": {"w": sk}}
    return tree


@dataclasses.dataclass(frozen=True)
class IcnnSpec:
    """Static description of one ICNN as the kernels see it."""

    in_features: int
    width: int
    n_layers: int

    @staticmethod
    def of(base) -> "IcnnSpec":
        if base.out_features != 1:
            raise ValueError("the fused ICNN kernels take out_features = 1 "
                             f"only, got {base.out_features}")
        return IcnnSpec(base.in_features, base.n_hidden, base.n_hidden_layers)

    def field_shapes(self) -> List[Tuple[int, ...]]:
        """Per-image shape of every leaf, in :func:`flat_weights` order."""
        w, c = self.width, self.in_features
        shapes = [(w, c), (w,)]
        for _ in range(self.n_layers):
            shapes += [(w, w), (w,), (w, c)]
        return shapes + [(1, w), (1,), (1, c)]

    @property
    def row_len(self) -> int:
        """P, the floats of one image's parameter row."""
        return sum(math.prod(s) for s in self.field_shapes())


# --- the plain PyTorch versions ---------------------------------------------


def _forward_acts(leaves, x, n_layers: int):
    """Post-relu activations of every hidden layer and the output. Leaves
    and points may carry leading batch axes; they broadcast."""
    win, bin_ = leaves[0], leaves[1]
    h = torch.relu(x @ win.mT + bin_.unsqueeze(-2))
    acts = [h]
    for i in range(n_layers):
        wln, bln, wsk = leaves[2 + 3 * i:5 + 3 * i]
        h = torch.relu(h @ wln.mT + x @ wsk.mT + bln.unsqueeze(-2))
        acts.append(h)
    wout, bout, wosk = leaves[-3:]
    return acts, h @ wout.mT + x @ wosk.mT + bout.unsqueeze(-2)


def _backward_leaves(leaves, x, g, n_layers: int):
    """The VJP written out: leaf grads summed over the points, and dx with
    the batch axes of ``g``."""
    acts, _ = _forward_acts(leaves, x, n_layers)
    win = leaves[0]
    wout, wosk = leaves[-3], leaves[-1]
    gt = g.mT
    d_out = [gt @ acts[-1], g.sum(-2), gt @ x]
    dh = g @ wout
    dx = g @ wosk
    d_layers = []
    for i in reversed(range(n_layers)):
        wln, wsk = leaves[2 + 3 * i], leaves[4 + 3 * i]
        dz = dh * (acts[i + 1] > 0)
        d_layers = [dz.mT @ acts[i], dz.sum(-2), dz.mT @ x] + d_layers
        dh = dz @ wln
        dx = dx + dz @ wsk
    dz0 = dh * (acts[0] > 0)
    dx = dx + dz0 @ win
    return [dz0.mT @ x, dz0.sum(-2)] + d_layers + d_out, dx


def icnn_forward_plain(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Plain ICNN forward: ``(..., N, C)`` points -> ``(..., N, 1)``."""
    leaves = flat_weights(params)
    return _forward_acts(leaves, x, (len(leaves) - 5) // 3)[1]


def icnn_backward_plain(params: Params, x: torch.Tensor, g: torch.Tensor
                        ) -> Tuple[Params, torch.Tensor]:
    """Plain ICNN VJP for the upstream ``g`` (..., N, 1): the param grads
    (summed over the points) and dx (..., N, C)."""
    leaves = flat_weights(params)
    grads, dx = _backward_leaves(leaves, x, g, (len(leaves) - 5) // 3)
    return unflat_weights(grads), dx


# --- the CUDA kernels -------------------------------------------------------


def _declare(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.icnn_forward.argtypes = [vp] * 3 + [i] * 12 + [vp]
    lib.icnn_forward.restype = i
    lib.icnn_backward.argtypes = [vp] * 6 + [i] * 12 + [vp]
    lib.icnn_backward.restype = i
    lib.icnn_smem_bytes.argtypes = [i] * 5
    lib.icnn_smem_bytes.restype = i
    lib.icnn_device_limits.argtypes = [i, vp, vp]
    lib.icnn_device_limits.restype = i
    lib.icnn_blocks_per_sm.argtypes = [i] * 5
    lib.icnn_blocks_per_sm.restype = i


LIBRARY = Library("icnn.cu", _declare)
FORWARD, BACKWARD = 0, 1  # the kernel kinds of csrc/icnn.cu


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


@dataclasses.dataclass(frozen=True)
class IcnnLaunch:
    """How K4 or K5 is launched: ``tp`` points per chunk, ``resident``
    weights (one hidden layer, its weight held in shared memory by each
    block) or staged ones, ``smem`` bytes per block, ``chunks`` per block,
    ``n_tiles`` blocks per image."""

    tp: int
    resident: bool
    smem: int
    chunks: int
    n_tiles: int


@functools.lru_cache(maxsize=64)
def launch_shape(kind: int, width: int, n_layers: int, n: int, group: int,
                 device_index: int) -> IcnnLaunch:
    """Pick the launch shape of K4 (``kind`` 0) or K5 (1): 64-point chunks
    where they fit in shared memory, else 32; at 64, resident weights (one
    hidden layer) unless staged ones put more blocks on an SM; the blocks
    of all images fill one wave of the card. It depends only on the shapes
    and the card, so two calls on the same inputs reduce in the same
    order."""
    lib = LIBRARY.get()
    max_smem, sms = ctypes.c_int(), ctypes.c_int()
    check(lib.icnn_device_limits(device_index, ctypes.byref(max_smem),
                                 ctypes.byref(sms)), "device query")
    for tp in (64, 32):
        fits = []
        for res in ((1, 0) if n_layers == 1 and tp == 64 else (0,)):
            smem = lib.icnn_smem_bytes(kind, tp, width, n_layers, res)
            if smem <= max_smem.value:
                per_sm = lib.icnn_blocks_per_sm(kind, device_index, tp, res,
                                                smem)
                if per_sm < 1:
                    raise RuntimeError(f"occupancy query failed ({per_sm})")
                fits.append((per_sm, res, smem))
        if fits:
            break
    else:
        raise ValueError(f"ICNN too wide for the kernel: needs {smem} B of "
                         f"shared memory, the card allows {max_smem.value}")
    per_sm, res, smem = max(fits, key=lambda f: f[0])  # ties: resident
    n_chunks = -(-n // tp)
    chunks = max(1, -(-n_chunks * group // (sms.value * per_sm)))
    return IcnnLaunch(tp, bool(res), smem, chunks, -(-n_chunks // chunks))


def _check_operands(spec: IcnnSpec, flat, x, extra=()):
    """Validate the kernels' operands; returns (G, N, x_gstride)."""
    g, c = flat.shape[0], spec.in_features
    n = x.shape[-2]
    want_x = (n, c) if x.ndim == 2 else (g, n, c)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("the ICNN kernels take CUDA tensors only")
    for name, t, want in (("params", flat, (g, spec.row_len)),
                          ("x", x, want_x)) + tuple(extra):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(want) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {want}, got "
                             f"{tuple(t.shape)}")
    if n < 1:
        raise ValueError("the ICNN kernels need at least one point")
    return g, n, (0 if x.ndim == 2 else n * c)


def icnn_forward_cuda(spec: IcnnSpec, flat: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Launch K4: ``flat`` (G, P) params, ``x`` (N, C) shared or (G, N, C),
    float32, contiguous, on one CUDA device -> y (G, N). Adds one to
    ``icnn_forward_cuda.launches``."""
    g, n, x_gs = _check_operands(spec, flat, x)
    dev = x.device
    shape = launch_shape(FORWARD, spec.width, spec.n_layers, n, g,
                         _device_index(dev))
    y = torch.empty((g, n), device=dev)
    code = LIBRARY.get().icnn_forward(
        x.data_ptr(), flat.data_ptr(), y.data_ptr(), _device_index(dev), n,
        g, spec.in_features, spec.width, spec.n_layers, x_gs, shape.tp,
        int(shape.resident), shape.smem, shape.chunks, shape.n_tiles,
        torch.cuda.current_stream(dev).cuda_stream)
    check(code, "ICNN forward kernel launch")
    icnn_forward_cuda.launches += 1
    return y


icnn_forward_cuda.launches = 0


def icnn_backward_cuda(spec: IcnnSpec, flat: torch.Tensor, x: torch.Tensor,
                       g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5: ``flat`` and ``x`` as for K4, ``g`` (G, N) the upstream
    grad -> (dparams (G, P), dx (G, N, C)). Adds one to
    ``icnn_backward_cuda.launches``."""
    grp, n, x_gs = _check_operands(spec, flat, x,
                                   (("g", g, (flat.shape[0], x.shape[-2])),))
    dev = x.device
    shape = launch_shape(BACKWARD, spec.width, spec.n_layers, n, grp,
                         _device_index(dev))
    p_len = spec.row_len
    partials = torch.empty((grp, shape.n_tiles, p_len), device=dev)
    dparams = torch.empty((grp, p_len), device=dev)
    dx = torch.empty((grp, n, spec.in_features), device=dev)
    code = LIBRARY.get().icnn_backward(
        x.data_ptr(), g.data_ptr(), flat.data_ptr(), partials.data_ptr(),
        dparams.data_ptr(), dx.data_ptr(), _device_index(dev), n, grp,
        spec.in_features, spec.width, spec.n_layers, x_gs, shape.tp,
        int(shape.resident), shape.smem, shape.chunks, shape.n_tiles,
        torch.cuda.current_stream(dev).cuda_stream)
    check(code, "ICNN backward kernel launch")
    icnn_backward_cuda.launches += 1
    return dparams, dx


icnn_backward_cuda.launches = 0


# --- dispatch on the group ----------------------------------------------------


def _batch_shape(spec: IcnnSpec, leaves) -> Tuple[int, ...]:
    """The leading image axes shared by every leaf."""
    bs = tuple(leaves[0].shape[:-2])
    for leaf, base in zip(leaves, spec.field_shapes()):
        if tuple(leaf.shape) != bs + base:
            raise ValueError(f"ICNN leaf of shape {tuple(leaf.shape)}, "
                             f"expected {bs + base}")
    return bs


def _group_points(x: torch.Tensor, bs: Tuple[int, ...]) -> torch.Tensor:
    """Points shared by the group, or broadcast to one set per image."""
    if x.ndim == 2 or tuple(x.shape[:-2]) == bs:
        return x
    return x.expand(bs + tuple(x.shape[-2:]))


def pack_rows(leaves, g: int) -> torch.Tensor:
    """Leaves with ``g`` images on their leading axes -> one contiguous
    (G, P) tensor, the kernels' parameter rows."""
    return torch.cat([leaf.reshape(g, -1) for leaf in leaves], dim=1
                     ).contiguous()


def _kernel_points(x: torch.Tensor, g: int) -> torch.Tensor:
    return x.contiguous() if x.ndim == 2 else \
        x.reshape((g,) + tuple(x.shape[-2:])).contiguous()


def grouped_forward(spec: IcnnSpec, x: torch.Tensor, leaves
                    ) -> torch.Tensor:
    """y (bs..., N, 1) for leaves with leading image axes ``bs``: K4 for
    CUDA points, the plain version for CPU points."""
    bs = _batch_shape(spec, leaves)
    x = _group_points(x, bs)
    if x.device.type == "cpu":
        return _forward_acts(leaves, x, spec.n_layers)[1]
    g, n = math.prod(bs), x.shape[-2]
    y = icnn_forward_cuda(spec, pack_rows(leaves, g), _kernel_points(x, g))
    return y.reshape(bs + (n, 1))


def grouped_backward(spec: IcnnSpec, x: torch.Tensor, gy: torch.Tensor,
                     leaves) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(dx (bs..., N, C), leaf grads) for the upstream ``gy`` (bs..., N,
    1): K5 for CUDA points, the plain VJP for CPU points."""
    bs = _batch_shape(spec, leaves)
    x = _group_points(x, bs)
    gy = gy.expand(bs + tuple(gy.shape[-2:]))
    if x.device.type == "cpu":
        grads, dx = _backward_leaves(leaves, x, gy, spec.n_layers)
        return dx, grads
    g, n = math.prod(bs), x.shape[-2]
    dflat, dx = icnn_backward_cuda(spec, pack_rows(leaves, g),
                                   _kernel_points(x, g),
                                   gy.reshape(g, n).contiguous())
    sizes = [math.prod(s) for s in spec.field_shapes()]
    grads = [d.reshape(leaf.shape)
             for d, leaf in zip(torch.split(dflat, sizes, dim=1), leaves)]
    return dx.reshape(bs + (n, spec.in_features)), grads


# --- autograd -----------------------------------------------------------------


def _to_front(t: torch.Tensor, dim, batch: int) -> torch.Tensor:
    """A vmapped operand with its batch axis first (unbatched ones
    expanded)."""
    if dim is None:
        return t.expand((batch,) + tuple(t.shape))
    return t.movedim(dim, 0)


def _vmap_forward(fn, info, in_dims, spec, x, *leaves):
    """The vmap rule of the fused forward: the vmapped axis becomes the
    kernels' leading image axis, so the batch makes one launch."""
    b = info.batch_size
    leaves = [_to_front(t, d, b) for t, d in zip(leaves, in_dims[2:])]
    if in_dims[1] is not None:
        x = x.movedim(in_dims[1], 0)
    return fn.apply(spec, x, *leaves), 0


class _IcnnForward(torch.autograd.Function):
    """K4 as the forward; the subclasses give the backward."""

    @staticmethod
    def forward(spec, x, *leaves):
        return grouped_forward(spec, x, leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, x, *leaves = inputs
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)


class IcnnForwardFused(_IcnnForward):
    """K4 forward, plain VJP backward (``pallas_mlp.py:158-169``)."""

    @staticmethod
    def backward(ctx, gy):
        x, *leaves = ctx.saved_tensors
        xg = _group_points(x, _batch_shape(ctx.spec, leaves))
        grads, dx = _backward_leaves(leaves, xg, gy, ctx.spec.n_layers)
        return (None, dx.sum_to_size(x.shape), *grads)

    @staticmethod
    def vmap(info, in_dims, spec, x, *leaves):
        return _vmap_forward(IcnnForwardFused, info, in_dims, spec, x,
                             *leaves)


class IcnnFusedFB(_IcnnForward):
    """K4 forward, K5 backward (``pallas_mlp.py:327-347``)."""

    @staticmethod
    def backward(ctx, gy):
        x, *leaves = ctx.saved_tensors
        dx, *grads = IcnnBackward.apply(ctx.spec, x, gy, *leaves)
        return (None, dx.sum_to_size(x.shape), *grads)

    @staticmethod
    def vmap(info, in_dims, spec, x, *leaves):
        return _vmap_forward(IcnnFusedFB, info, in_dims, spec, x, *leaves)


class IcnnBackward(torch.autograd.Function):
    """K5 as a Function of its own, so that a vmapped backward also maps
    the batch onto the image axis (one launch)."""

    @staticmethod
    def forward(spec, x, gy, *leaves):
        dx, grads = grouped_backward(spec, x, gy, leaves)
        return (dx, *grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the fused ICNN backward has no "
                                  "derivative of its own")

    @staticmethod
    def vmap(info, in_dims, spec, x, gy, *leaves):
        b = info.batch_size
        leaves = [_to_front(t, d, b) for t, d in zip(leaves, in_dims[3:])]
        gy = _to_front(gy, in_dims[2], b)
        if in_dims[1] is not None:
            x = x.movedim(in_dims[1], 0)
        out = IcnnBackward.apply(spec, x, gy, *leaves)
        return out, (0,) * len(out)


def icnn_forward_fused(model, params: Params, x: torch.Tensor):
    """Fused forward (K4) with the plain VJP as its backward; ``model``
    is the ConvexNextNet the params belong to. Params may carry leading
    image axes; the points are shared (N, C) or carry the same axes."""
    return IcnnForwardFused.apply(IcnnSpec.of(model), x,
                                  *flat_weights(params))


def icnn_fused_fb(model, params: Params, x: torch.Tensor):
    """Fused forward (K4) with the fused backward (K5)."""
    return IcnnFusedFB.apply(IcnnSpec.of(model), x, *flat_weights(params))


class _Wrapped(Module):
    def __init__(self, base):
        super().__init__(base.device)
        IcnnSpec.of(base)  # out_features = 1 only
        self.base = base

    def init(self, generator=None):
        return self.base.init(generator)

    def enforce_convexity(self, params):
        return self.base.enforce_convexity(params)

    @property
    def n_hidden_layers(self) -> int:
        return self.base.n_hidden_layers


class FusedConvexNextNet(_Wrapped):
    """ConvexNextNet whose apply runs the fused forward (K4) and the plain
    VJP; same params, init and convexity clip as the base model."""

    def apply(self, params, x):
        return icnn_forward_fused(self.base, params, x)


def fused_icnn(model) -> bool:
    """Whether ``model`` is a fused ICNN (its apply runs K4, and K5)."""
    return isinstance(model, _Wrapped)


class FullyFusedConvexNextNet(_Wrapped):
    """ConvexNextNet whose apply runs the fused forward (K4) and the fused
    backward (K5)."""

    def apply(self, params, x):
        return icnn_fused_fb(self.base, params, x)
