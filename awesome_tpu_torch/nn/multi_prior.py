"""Multi-object priors: K child priors per image, grown on demand;
counterpart of ``awesome_tpu/nn/multi_prior.py``.

The children are one stacked param tree with a fixed capacity
``max_priors`` (a leading child axis on every leaf); the active count is a
runtime value. Growing is masking: inactive slots are computed and masked
out, so a step's graph does not change with the count, and under
``torch.func.vmap`` the K children (or the B x K children of a batch of
images, :meth:`MultiPriorModule.apply_images`) cost one batched product,
not K launches.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.nn.module import Module, make_generator

Params = Any


class MultiPriorModule(Module):
    """K copies of a child prior evaluated on the same points. ``apply``
    returns (N, K) outputs, one channel per object."""

    def __init__(self, child: Module, max_priors: int = 4):
        super().__init__(child.device)
        self.child = child
        self.max_priors = max_priors

    def init(self, generator: Optional[torch.Generator] = None):
        """The params hold only the stacked children; the active count is
        kept by the caller, never a param leaf."""
        gen = make_generator(generator)
        return {"children": T.stack_trees(
            [self.child.init(gen) for _ in range(self.max_priors)])}

    def active_mask(self, count) -> torch.Tensor:
        """(max_priors,) bool mask of the active child slots."""
        dev = count.device if isinstance(count, torch.Tensor) else \
            self.device
        return torch.arange(self.max_priors, device=dev) < count

    def assure_prior_count(self, params: Params, prev_count: int, count: int,
                           key: Union[int, torch.Generator, None] = None
                           ) -> Params:
        """Grow to ``count`` children: slots in [prev_count, count) get
        fresh params (from ``key``, an int seed or a ``torch.Generator``;
        seed ``count`` by default). Shrinking is the caller lowering its
        count."""
        if count > self.max_priors:
            raise ValueError(
                f"count {count} exceeds static capacity {self.max_priors}")
        prev = int(prev_count)
        children = params["children"]
        if count > prev:
            fresh = self.init(make_generator(count if key is None else key))
            sel = torch.arange(self.max_priors, device=self.device)
            keep = (sel < prev) | (sel >= count)
            children = T.tree_where(keep, children, fresh["children"])
        return {"children": children}

    def apply(self, params, x, num_priors: Optional[int] = None):
        """Children on points x (N, C) -> (N, max_priors); with
        ``num_priors`` only the first that many channels. Inactive slots
        are not masked here: pass the count to :meth:`combine`."""
        outs = torch.func.vmap(self.child.apply, in_dims=(0, None))(
            params["children"], x)  # (max, N, 1)
        outs = torch.movedim(outs[..., 0], 0, -1)
        if num_priors is not None and num_priors < self.max_priors:
            outs = outs[..., :num_priors]
        return outs

    def apply_images(self, children: Params, x: torch.Tensor
                     ) -> torch.Tensor:
        """Each image's children on its points: ``children`` with leading
        (B, K) axes, ``x`` shared (N, C) or per image (B, N, C) -> (B, N,
        K). The B x K children run as one ``vmap`` over a flat B*K
        axis."""
        lead = T.tree_leaves(children)[0].shape[:2]
        b, k = int(lead[0]), int(lead[1])
        flat = T.tree_map(lambda t: t.reshape((b * k,) + t.shape[2:]),
                          children)
        if x.ndim == 3:
            x, dims = x.repeat_interleave(k, dim=0), (0, 0)
        else:
            dims = (0, None)
        outs = torch.func.vmap(self.child.apply, in_dims=dims)(flat, x)
        return outs[..., 0].reshape(b, k, -1).transpose(1, 2)

    def combine(self, outs: torch.Tensor, count=None) -> torch.Tensor:
        """One field from the per-object fields: the min over objects (the
        union of their sub-level sets; fg is low). ``count`` restricts the
        min to the active slots."""
        if count is not None:
            active = self.active_mask(count).to(outs.device)[None, :]
            big = torch.finfo(outs.dtype).max
            outs = torch.where(active, outs, torch.full_like(outs, big))
        return outs.amin(dim=-1, keepdim=True)

    def enforce_convexity(self, params):
        if not hasattr(self.child, "enforce_convexity"):
            return params
        children = torch.func.vmap(self.child.enforce_convexity)(
            params["children"])
        return dict(params, children=children)

    def param_groups(self, params):
        if hasattr(self.child, "param_groups"):
            return {"children": self.child.param_groups(
                T.tree_select(params["children"], 0))}
        return T.tree_map(lambda _: "other", params)


class MultipleObjectsPathConnectedNet(MultiPriorModule):
    """Multi-object path-connected prior: the child is a
    ``PathConnectedNet``; each object's child is fitted against its own
    unary channel (``fit.prior_fit.fit_multi_object_priors``)."""

    def deformation(self, params, x, index: int = 0):
        return self.child.deformation(
            T.tree_select(params["children"], index), x)

    def inverse(self, params, y, index: int = 0):
        return self.child.inverse(
            T.tree_select(params["children"], index), y)
