"""Zoo: a content-addressed cache of fitted parameter trees; counterpart
of ``awesome_tpu/nn/zoo.py``.

A prefit result (the flow-identity fit of ``fit.prior_fit.apply_prefits``,
for one) is stored under a SHA key of (name, model description, config),
so the same prefit is loaded instead of computed again. An entry is a
:func:`fit.checkpoint.save_pytree` save (``<key>.npz`` and
``<key>.tree.json``, the tree's structure) plus ``<key>.json`` with the
name, the model's description, the config and a context.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from awesome_tpu_torch.fit.checkpoint import load_pytree, save_pytree


def _hash_key(name: str, model_repr: str, config: Optional[Dict]) -> str:
    h = hashlib.sha256()
    h.update(name.encode())
    h.update(model_repr.encode())
    if config:
        h.update(json.dumps(config, sort_keys=True, default=str).encode())
    return h.hexdigest()[:32]


def describe(model) -> str:
    """A deterministic description of a module: its class, its plain
    hyperparameters, its buffers' shapes and its submodules, recursively
    (torch's ``repr`` of these modules leaves the hyperparameters out, so
    two flows of different widths would share a key)."""
    if not isinstance(model, torch.nn.Module):
        return repr(model)
    parts = []
    for k, v in sorted(vars(model).items()):
        if k.startswith("_") or k == "training":
            continue
        if isinstance(v, (bool, int, float, str, type(None), tuple)):
            parts.append(f"{k}={v!r}")
        elif isinstance(v, torch.device):
            continue  # the same prefit on another device shares the key
        elif isinstance(v, torch.Tensor):
            parts.append(f"{k}=tensor{tuple(v.shape)}")
        else:
            parts.append(f"{k}={describe(v)}")
    for k, b in model.named_buffers(recurse=False):
        parts.append(f"{k}=buffer{tuple(b.shape)}")
    for k, m in model.named_children():
        parts.append(f"{k}={describe(m)}")
    return f"{type(model).__name__}({', '.join(parts)})"


class Zoo:
    def __init__(self, path: str = "./zoo"):
        self.path = path

    def _entry(self, key: str) -> Tuple[str, str]:
        """(the tree's save path, the meta file)."""
        base = os.path.join(self.path, key)
        return base, base + ".json"

    def save_model_state(self, name: str, model, params: Any,
                         config: Optional[Dict] = None,
                         context: Optional[Dict] = None) -> str:
        """Store a param tree under its content key; returns the key."""
        key = _hash_key(name, describe(model), config)
        base, meta_path = self._entry(key)
        os.makedirs(self.path, exist_ok=True)
        save_pytree(params, base)
        with open(meta_path, "w") as f:
            json.dump({"name": name, "model": describe(model),
                       "config": config, "context": context or {}}, f,
                      default=str)
        return key

    def load_model_state(self, name: str, model, params_template: Any,
                         config: Optional[Dict] = None
                         ) -> Tuple[Optional[Any], Dict]:
        """``(params or None, context)``. The stored tree lands on
        ``params_template``'s structure and devices; one that lacks a leaf
        of the template is a miss."""
        key = _hash_key(name, describe(model), config)
        base, meta_path = self._entry(key)
        if not (os.path.exists(base + ".npz") and os.path.exists(meta_path)):
            return None, {}
        try:
            params = load_pytree(base, template=params_template)
        except ValueError:  # restructure_like: a leaf is missing
            return None, {}
        with open(meta_path) as f:
            return params, json.load(f).get("context", {})
