"""Import ORIGINAL reference YAML configs; counterpart of
``awesome_tpu/runner/reference_import.py``.

The reference persists configs as YAML with a top-level class-name wrapper
and ``__class__`` tags throughout, including full torch-module dumps
(`awesome/serialization/json_convertible.py:107-245`). This importer loads
those files unchanged:

1. unwrap the top-level ``AwesomeConfig:`` key,
2. strip torch-module internals (keys starting with '_'),
3. translate dotted reference type paths via
   ``runner.config.TYPE_TRANSLATION`` (unknown types survive as strings so
   nothing is silently dropped),
4. map reference-only field values (device 'cuda' stays 'cuda', dtype
   'torch.float32' -> 'float32') onto ``AwesomeConfig``.

Everything the schema doesn't know lands in ``extra`` for inspection:
imports are lossy-by-listing, not lossy-by-silence.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from awesome_tpu_torch.runner.config import (
    AwesomeConfig,
    translate_reference_value,
)

_DTYPE_MAP = {
    "torch.float32": "float32",
    "torch.float64": "float32",  # float32 is the policy of both packages
    "torch.bfloat16": "bfloat16",
    "torch.float16": "bfloat16",
}
_DEVICE_MAP = {"cuda": "cuda", "cpu": "cpu"}


def _sanitize(node: Any) -> Any:
    """Strip torch-module internals; translate __class__ strings."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k.startswith("_") and k != "__class__":
                continue
            if k == "__class__":
                out[k] = translate_reference_value(v)
                continue
            out[k] = _sanitize(v)
        return out
    if isinstance(node, list):
        return [_sanitize(v) for v in node]
    if isinstance(node, str):
        return translate_reference_value(node)
    return node


def load_reference_config(path: str) -> Tuple[AwesomeConfig, Dict[str, Any]]:
    """Returns (config, extra) where ``extra`` holds every reference field
    that has no direct slot in the new schema."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    # unwrap 'AwesomeConfig:' (or any single top-level class-name key)
    if isinstance(raw, dict) and len(raw) == 1:
        raw = next(iter(raw.values()))
    data = _sanitize(raw)
    data.pop("__class__", None)

    if "device" in data:
        data["device"] = _DEVICE_MAP.get(data["device"], "cuda")
    if "dtype" in data:
        data["dtype"] = _DTYPE_MAP.get(data["dtype"], "float32")

    names = {f.name for f in dataclasses.fields(AwesomeConfig)}
    # the reference nests pretrain orchestration inside agent_args
    # (`config/path-connectedness/joint/*.yaml` agent_args:
    # do_pretraining/force_pretrain/pretrain_args/pretrain_state_path/
    # pretrain_only): lift the known keys into the schema
    agent_args = data.get("agent_args")
    if isinstance(agent_args, dict):
        for key in list(agent_args):
            if key in names and key not in data:
                data[key] = agent_args.pop(key)
    known = {k: v for k, v in data.items() if k in names}
    extra = {k: v for k, v in data.items() if k not in names}
    cfg = AwesomeConfig(**known)
    cfg.prepare()
    return cfg, extra
