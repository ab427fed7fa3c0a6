"""The device mesh on ``torch.distributed``; counterpart of
``awesome_tpu/parallel/mesh.py``.

A mesh is a 2D grid of processes ("ranks"), ``(data, grid)``:

- **data**: independent per-image work (prior fits, per-image training
  states, the images of a joint batch) is split into contiguous blocks,
  one per data coordinate;
- **grid**: the coordinate points of every image are split into
  contiguous blocks; the points are independent through the MLP/flow, so
  the loss and gradient sums over points are the only coupling: one
  ``all_reduce`` over the grid group.

JAX expresses this with ``NamedSharding`` annotations and XLA inserts the
collectives. Here every function that takes ``mesh=`` takes the FULL
inputs on every rank, works on this rank's block, reduces what the
single-device code reduces over points or images, and returns the FULL
result on every rank: sharding changes placement, not math. A size that
does not divide its mesh axis is replicated on that axis (every rank of
the axis does all of the work), as ``maybe_shard`` does in JAX.

Backends (:func:`backend_for`): NCCL when each rank has a card of its
own; gloo when ranks share a card (the one-card machine) or run on the
CPU (the tests). Gloo offers only ``all_reduce`` and ``broadcast`` on
CUDA tensors, so gathers on gloo go through CPU tensors. Nothing falls
back from one backend to another.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.device import resolve_device

Params = Any
AXES = ("data", "grid")
_ANNOUNCED = set()
# this process's rank device, as ``parallel.launch.init_rank`` chose it
_RANK_DEVICE: Optional[torch.device] = None


def set_rank_device(device) -> None:
    """Record this rank's device: the default of :func:`make_mesh`."""
    global _RANK_DEVICE
    _RANK_DEVICE = torch.device(device)


def backend_for(device: torch.device, ranks: int) -> str:
    """The backend rule: ``"nccl"`` when every rank has a card of its own
    (``ranks``, the ranks on this host, on at least as many cards),
    ``"gloo"`` when ranks share a card or run on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no mesh backend for device {device}")
    return "nccl" if ranks <= torch.cuda.device_count() else "gloo"


def rank_device(kind: str, local_rank: int) -> torch.device:
    """The device of the rank with index ``local_rank`` among the ranks of
    its host (torchrun's ``LOCAL_RANK``; the rank itself where one host
    runs them all): the CPU, or the cards round robin."""
    if kind == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a CUDA mesh needs a card; pass device='cpu' to "
                           "run the ranks on the CPU")
    return torch.device("cuda", local_rank % n)


def sum_trees(total: Callable, *trees) -> tuple:
    """``total`` (a sum over a mesh axis) of every leaf of ``trees``, in
    ONE call on a flat buffer of their leaves (float32 all)."""
    leaves = [x for tr in trees for x in T.tree_leaves(tr)]
    flat = total(torch.cat([x.reshape(-1) for x in leaves]))
    out, pos = [], 0
    for x in leaves:
        out.append(flat[pos:pos + x.numel()].reshape(x.shape))
        pos += x.numel()
    it = iter(out)
    return tuple(T.tree_map(lambda _: next(it), tr) for tr in trees)


class Mesh:
    """This rank's view of a ``(data, grid)`` mesh: the shape, this rank's
    coordinates, one process group per data row (the grid group) and per
    grid column (the data group), the mesh's group, and the rank's
    device. An axis of size 1 has no group: its reductions are the
    identity."""

    def __init__(self, shape: Tuple[int, int], rank: int,
                 groups: Dict[str, Any], group: Any,
                 device: torch.device, backend: Optional[str],
                 members: Sequence[int] = (0,)):
        self.shape = {"data": int(shape[0]), "grid": int(shape[1])}
        self.rank = rank  # position in the mesh (0 .. size - 1)
        self.coords = {"data": rank // self.shape["grid"],
                       "grid": rank % self.shape["grid"]}
        self.groups = groups
        self.group = group
        self.device = torch.device(device)
        self.backend = backend
        self.members = list(members)  # the mesh's ranks in the world

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["grid"]

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, grid={self.shape['grid']}"
                f", rank={self.rank}, backend={self.backend})")

    # --- placement ---------------------------------------------------------
    def splits(self, axis: str, n: int) -> bool:
        """Whether a length-``n`` axis is split over ``axis`` (else it is
        replicated there)."""
        size = self.shape[axis]
        return size > 1 and n % size == 0

    def local(self, axis: str, n: int) -> slice:
        """This rank's contiguous block of a length-``n`` axis split over
        ``axis``; the whole axis where it is replicated."""
        if not self.splits(axis, n):
            return slice(0, n)
        b = n // self.shape[axis]
        c = self.coords[axis]
        return slice(c * b, (c + 1) * b)

    def reducer(self, axis: str, n: int) -> Optional[Callable]:
        """``sum_over(axis, .)`` where a length-``n`` axis is split over
        ``axis``, else ``None`` (a replicated axis holds whole sums)."""
        if not self.splits(axis, n):
            return None
        return lambda t: self.sum_over(axis, t)

    # --- collectives -------------------------------------------------------
    def _group(self, axis: str):
        return self.group if axis == "world" else self.groups.get(axis)

    def _axis_size(self, axis: str) -> int:
        return self.size if axis == "world" else self.shape[axis]

    def sum_over(self, axis: str, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axis`` ('data', 'grid' or
        'world'), on every one of them (a new tensor on ``t``'s device,
        reduced on the mesh's; ``t`` is kept)."""
        if self._axis_size(axis) == 1:
            return t
        out = t.detach().to(self.device, copy=True)
        dist.all_reduce(out, group=self._group(axis))
        return out.to(t.device)

    def sum_over_tree(self, axis: str, tree: Params) -> Params:
        """:meth:`sum_over` of every (float) leaf, in one reduction."""
        if self._axis_size(axis) == 1:
            return tree
        return sum_trees(lambda t: self.sum_over(axis, t), tree)[0]

    def gather(self, axis: str, t: torch.Tensor, dim: int = 0
               ) -> torch.Tensor:
        """Concatenate the ranks' blocks of ``t`` along ``dim`` in the
        order of their ``axis`` coordinates (exact copies; every rank gets
        the whole, on ``t``'s device). The blocks cross on the CPU under
        gloo and on the mesh's card under NCCL."""
        size = self._axis_size(axis)
        if size == 1:
            return t
        comm = torch.device("cpu") if self.backend == "gloo" else self.device
        src = t.detach().to(comm).contiguous()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=self._group(axis))
        return torch.cat(parts, dim=dim).to(t.device)

    def gather_tree(self, axis: str, tree: Params, dim: int = 0) -> Params:
        """:meth:`gather` of every leaf."""
        return T.tree_map(lambda x: self.gather(axis, x, dim), tree)

    def gather_to_root(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's picklable ``obj``, as a list in rank order on mesh
        rank 0 (``None`` on the others)."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size if self.is_root else None
        dist.gather_object(obj, out, dst=self.members[0], group=self.group)
        return out

    def barrier(self) -> None:
        if self.size > 1:
            if self.backend == "nccl":
                dist.barrier(group=self.group,
                             device_ids=[self.device.index])
            else:
                dist.barrier(group=self.group)

    # --- autograd-aware collectives ----------------------------------------
    def sum_over_grad(self, axis: str, t: torch.Tensor) -> torch.Tensor:
        """:meth:`sum_over` whose backward sums the gradient over the same
        ranks: the gradient of every rank's loss with respect to the
        shared sum reaches each rank's summand."""
        if self._axis_size(axis) == 1:
            return t
        return _SumGrad.apply(t, self, axis)

    def gather_grad(self, axis: str, t: torch.Tensor, dim: int = 0
                    ) -> torch.Tensor:
        """:meth:`gather` for a value that every rank of ``axis`` then uses
        in the SAME way (a loss computed identically on each): the
        backward keeps this rank's own block of the gradient, so each
        rank's grads hold its block's share."""
        if self._axis_size(axis) == 1:
            return t
        return _GatherGrad.apply(t, self, axis, dim)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.sum_over(axis, t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum_over(ctx.axis, g.contiguous()), None, None


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.block, ctx.dim = t.shape[dim], dim
        ctx.coord = mesh.coords[axis] if axis != "world" else mesh.rank
        return mesh.gather(axis, t, dim)

    @staticmethod
    def backward(ctx, g):
        own = g.narrow(ctx.dim, ctx.coord * ctx.block, ctx.block)
        return own.contiguous(), None, None, None


# --- construction -------------------------------------------------------------


def _resolve_shape(shape, world: int) -> Tuple[int, int]:
    """``[data, grid]``, ``[n]`` (all on data) or an int; ``-1`` in one
    slot absorbs the rest of ``world``."""
    if isinstance(shape, int):
        shape = [shape]
    shape = [int(s) for s in shape] + [1] * (2 - len(shape))
    if len(shape) != 2:
        raise ValueError(f"mesh shape {shape}: at most two axes")
    if -1 in shape:
        other = shape[1] if shape[0] == -1 else shape[0]
        shape[shape.index(-1)] = max(world // max(other, 1), 1)
    return shape[0], shape[1]


def make_mesh(shape=None, device=None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """Build the mesh over the process group's ranks (or the subset
    ``ranks``), in rank order, data-major: ranks ``i * grid .. i * grid +
    grid - 1`` form data row ``i``. Default shape: every rank on the data
    axis. Every rank of the world calls this (group creation is
    collective); a rank outside ``ranks`` gets ``None``. Raises
    ``ValueError`` when the shape does not match the ranks, as JAX's
    ``make_mesh`` does for devices.

    ``device``: the rank's device; by default the one
    ``parallel.launch.init_rank`` chose, else the current card. Without a
    card it raises unless the caller passes ``device='cpu'``. Without a
    process group the world is this one process: only a (1, 1) mesh can
    be built."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    members = list(range(world)) if ranks is None else [int(r) for r in
                                                        ranks]
    if shape is None:
        shape = (len(members), 1)
    d, g = _resolve_shape(shape, len(members))
    if d * g != len(members):
        raise ValueError(f"mesh shape {(d, g)} != {len(members)} processes")
    if any(not 0 <= r < world for r in members):
        raise ValueError(f"mesh ranks {members} outside a world of {world}")
    backend = dist.get_backend() if dist.is_initialized() else None
    dev = resolve_device(_RANK_DEVICE if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def new_group(rs):
        if len(rs) == 1:
            return None
        if len(rs) == world:
            return dist.group.WORLD
        return dist.new_group(rs)

    # every rank creates every group, in one order
    rows = [new_group(members[i * g:(i + 1) * g]) for i in range(d)]
    cols = [new_group(members[j::g]) for j in range(g)]
    whole = new_group(members)
    if me not in members:
        return None
    pos = members.index(me)
    mesh = Mesh((d, g), pos, {"grid": rows[pos // g], "data": cols[pos % g]},
                whole, dev, backend, members)
    key = (d, g, backend)
    if pos == 0 and key not in _ANNOUNCED:
        _ANNOUNCED.add(key)
        share = ("ranks share a card" if backend == "gloo"
                 and dev.type == "cuda" else
                 "a card per rank" if backend == "nccl" else "CPU ranks")
        print(f"mesh: (data={d}, grid={g}) on {backend} ({share})",
              flush=True)
    return mesh


def mesh_from_config(config, device=None) -> Optional[Mesh]:
    """The runner's mesh from ``mesh_shape``: ``[data, grid]`` (e.g. ``[4,
    2]``), ``[n]`` (all on data), ``-1`` in one slot absorbing the rest of
    the world (the process group's size; the ranks that
    ``python -m awesome_tpu_torch.run`` starts). ``None`` -> no mesh: the
    runner stays on one device. A mesh of more than one rank needs the
    process group (:func:`awesome_tpu_torch.parallel.launch.spawn`, or
    ``torchrun``); without one it raises ``ValueError``. ``device``: the
    runner's (see :func:`make_mesh`)."""
    shape = getattr(config, "mesh_shape", None)
    if not shape:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    d, g = _resolve_shape(shape, world)
    if d * g != world:
        raise ValueError(
            f"mesh_shape {list(shape)} needs {d * g} processes and this "
            f"world has {world}; run it through python -m "
            "awesome_tpu_torch.run, which starts the ranks")
    return make_mesh((d, g), device=device)


# --- the JAX module's placement helpers ---------------------------------------


def _leading_block(mesh: Mesh, x, axis: str):
    """This rank's block of ``x``'s leading axis over ``axis`` (whole
    where the axis does not divide it, or for a 0-d leaf)."""
    if isinstance(x, torch.Tensor) and x.ndim >= 1:
        return x[mesh.local(axis, x.shape[0])]
    return x


def shard_batched(mesh: Optional[Mesh], tree: Params, axis: str = "data"
                  ) -> Params:
    """This rank's block of every leaf's leading axis over ``axis``."""
    if mesh is None:
        return tree
    return T.tree_map(lambda x: _leading_block(mesh, x, axis), tree)


def replicate(mesh: Optional[Mesh], tree: Params) -> Params:
    """Every rank holds the whole tree already; the identity."""
    del mesh
    return tree


def maybe_shard(mesh: Optional[Mesh], x: torch.Tensor,
                axes: Sequence[Optional[str]]) -> torch.Tensor:
    """This rank's block of ``x``: dim ``d`` split over ``axes[d]`` where
    its size divides that mesh axis, else kept whole (replicated); a name
    that is not a mesh axis keeps its dim whole too."""
    if mesh is None:
        return x
    idx = []
    for d in range(x.ndim):
        name = axes[d] if d < len(axes) else None
        idx.append(mesh.local(name, x.shape[d]) if name in AXES
                   else slice(None))
    return x[tuple(idx)]


def shard_leading_stacked(mesh: Optional[Mesh], tree: Params,
                          batch: Optional[int], axis: str = "data"
                          ) -> Params:
    """This rank's block of every leaf whose LEADING dim equals ``batch``;
    other leaves (all of them when ``batch`` is None) whole."""
    if mesh is None:
        return tree

    def put(x):
        if isinstance(x, torch.Tensor) and x.ndim >= 1 and (
                x.shape[0] == batch):
            return _leading_block(mesh, x, axis)
        return x

    return T.tree_map(put, tree)


def fit_priors_sharded(model, stacked_params: Params, points: torch.Tensor,
                       stacked_targets: torch.Tensor, cfg,
                       mesh: Optional[Mesh] = None, **kwargs):
    """``fit_priors_batched`` on the mesh: the images over 'data', the
    coordinate points over 'grid' (one ``all_reduce`` of the loss and
    grads per step over the grid group). Full inputs and outputs on every
    rank. ``mesh`` defaults to every rank on the data axis."""
    from awesome_tpu_torch.fit.prior_fit import fit_priors_batched

    if mesh is None:
        mesh = make_mesh(device=points.device)
    return fit_priors_batched(model, stacked_params, points,
                              stacked_targets, cfg, mesh=mesh, **kwargs)


def fit_spatiotemporal_sharded(model, params: Params,
                               frame_points: torch.Tensor,
                               frame_targets: torch.Tensor, labeled_masks,
                               cfg, mesh: Optional[Mesh] = None, **kwargs):
    """The spatio-temporal fit on the mesh: every frame's points over
    'grid', the shared prior replicated, each frame step's loss and grads
    summed over the grid group. Semantically
    :func:`awesome_tpu_torch.fit.spatiotemporal.fit_spatiotemporal_prior`."""
    from awesome_tpu_torch.fit.spatiotemporal import fit_spatiotemporal_prior

    if mesh is None:
        mesh = make_mesh((1, -1), device=frame_targets.device)
    return fit_spatiotemporal_prior(model, params, frame_points,
                                    frame_targets, labeled_masks, cfg,
                                    mesh=mesh, **kwargs)
