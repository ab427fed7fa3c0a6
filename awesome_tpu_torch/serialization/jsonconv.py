"""Polymorphic JSON/YAML (de)serialization with ``__class__`` tags;
counterpart of ``awesome_tpu/serialization/jsonconv.py``.

Objects serialize to dicts carrying a ``__class__`` dotted path and are
rebuilt by dynamic import; a rule registry handles the types that are not
dataclasses (tuple, set, slice, enum, datetime, numpy arrays and torch
tensors, module-level functions, classes).

Configs and YAMLs written by the JAX package name its classes
(``awesome_tpu.nn.icnn.ConvexNextNet``). Importing such a path would import
the JAX package, and with it JAX, so :func:`port_path` maps it onto this
package's module through one table (:data:`PORT_MODULES`) before anything
is imported. A path under ``awesome_tpu`` with no counterpart here raises
:class:`NoPortError`, naming it; nothing falls through to the JAX package.

The port's modules (``nn.module.Module``) are ``torch.nn.Module``s that hold
hyperparameters and the device their params are made on. They serialize
as their constructor arguments, without the device; decoding builds them
on the ``device`` the caller passes (the card unless it says otherwise).
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import enum
import importlib
import inspect
import json
import os
import types
from typing import Any, Callable, Dict, List, Optional

import numpy as np

CLASS_KEY = "__class__"
_RULES: List["Rule"] = []

# module of the JAX package -> its counterpart in this one
PORT_MODULES = {
    "awesome_tpu.analytics.result_model":
        "awesome_tpu_torch.analytics.result_model",
    "awesome_tpu.core.affine": "awesome_tpu_torch.core.affine",
    "awesome_tpu.core.grids": "awesome_tpu_torch.core.grids",
    "awesome_tpu.core.transforms": "awesome_tpu_torch.core.transforms",
    "awesome_tpu.core.tree": "awesome_tpu_torch.core.tree",
    "awesome_tpu.data.awesome_dataset":
        "awesome_tpu_torch.data.awesome_dataset",
    "awesome_tpu.data.batching": "awesome_tpu_torch.data.batching",
    "awesome_tpu.data.convexity": "awesome_tpu_torch.data.convexity",
    "awesome_tpu.data.fbms": "awesome_tpu_torch.data.fbms",
    "awesome_tpu.data.image_sample": "awesome_tpu_torch.data.image_sample",
    "awesome_tpu.data.mapping": "awesome_tpu_torch.data.mapping",
    "awesome_tpu.data.sisbosi": "awesome_tpu_torch.data.sisbosi",
    "awesome_tpu.data.split": "awesome_tpu_torch.data.split",
    "awesome_tpu.data.subdivisible": "awesome_tpu_torch.data.subdivisible",
    "awesome_tpu.data.synthetic": "awesome_tpu_torch.data.synthetic",
    "awesome_tpu.data.weak_label_processing":
        "awesome_tpu_torch.data.weak_label_processing",
    "awesome_tpu.errors": "awesome_tpu_torch.errors",
    "awesome_tpu.events.event": "awesome_tpu_torch.events.event",
    "awesome_tpu.events.watchdog": "awesome_tpu_torch.events.watchdog",
    "awesome_tpu.fit.checkpoint": "awesome_tpu_torch.fit.checkpoint",
    "awesome_tpu.fit.fused_fit": "awesome_tpu_torch.fit.fused_fit",
    "awesome_tpu.fit.optim": "awesome_tpu_torch.fit.optim",
    "awesome_tpu.fit.pixel_trainer": "awesome_tpu_torch.fit.pixel_trainer",
    "awesome_tpu.fit.prior_fit": "awesome_tpu_torch.fit.prior_fit",
    "awesome_tpu.fit.spatiotemporal": "awesome_tpu_torch.fit.spatiotemporal",
    "awesome_tpu.fit.tracker": "awesome_tpu_torch.fit.tracker",
    "awesome_tpu.fit.trainer": "awesome_tpu_torch.fit.trainer",
    "awesome_tpu.measures.instance_losses":
        "awesome_tpu_torch.measures.instance_losses",
    "awesome_tpu.measures.losses": "awesome_tpu_torch.measures.losses",
    "awesome_tpu.measures.losses_extra":
        "awesome_tpu_torch.measures.losses_extra",
    "awesome_tpu.measures.metrics": "awesome_tpu_torch.measures.metrics",
    "awesome_tpu.nn.adapters": "awesome_tpu_torch.nn.adapters",
    "awesome_tpu.nn.conv": "awesome_tpu_torch.nn.conv",
    "awesome_tpu.nn.convex_diffeo": "awesome_tpu_torch.nn.convex_diffeo",
    "awesome_tpu.nn.convex_modules": "awesome_tpu_torch.nn.convex_modules",
    "awesome_tpu.nn.flows": "awesome_tpu_torch.nn.flows",
    "awesome_tpu.nn.flows_extra": "awesome_tpu_torch.nn.flows_extra",
    "awesome_tpu.nn.icnn": "awesome_tpu_torch.nn.icnn",
    "awesome_tpu.nn.init": "awesome_tpu_torch.nn.init",
    "awesome_tpu.nn.linear": "awesome_tpu_torch.nn.linear",
    "awesome_tpu.nn.module": "awesome_tpu_torch.nn.module",
    "awesome_tpu.nn.multi_prior": "awesome_tpu_torch.nn.multi_prior",
    "awesome_tpu.nn.noisy_path_connected":
        "awesome_tpu_torch.nn.noisy_path_connected",
    "awesome_tpu.nn.path_connected": "awesome_tpu_torch.nn.path_connected",
    "awesome_tpu.nn.priors_extra": "awesome_tpu_torch.nn.priors_extra",
    "awesome_tpu.nn.seg": "awesome_tpu_torch.nn.seg",
    "awesome_tpu.nn.wrapper": "awesome_tpu_torch.nn.wrapper",
    "awesome_tpu.nn.zoo": "awesome_tpu_torch.nn.zoo",
    "awesome_tpu.ops.crf": "awesome_tpu_torch.ops.crf",
    "awesome_tpu.ops.pallas_flagship": "awesome_tpu_torch.ops.flagship",
    "awesome_tpu.ops.pallas_mlp": "awesome_tpu_torch.ops.mlp",
    "awesome_tpu.ops.permutohedral": "awesome_tpu_torch.ops.permutohedral",
    "awesome_tpu.ops.spectral": "awesome_tpu_torch.ops.spectral",
    "awesome_tpu.runner.config": "awesome_tpu_torch.runner.config",
    "awesome_tpu.runner.fbms_runner": "awesome_tpu_torch.runner.fbms_runner",
    "awesome_tpu.runner.functions": "awesome_tpu_torch.runner.functions",
    "awesome_tpu.runner.handles": "awesome_tpu_torch.runner.handles",
    "awesome_tpu.runner.multi": "awesome_tpu_torch.runner.multi",
    "awesome_tpu.runner.reference_import":
        "awesome_tpu_torch.runner.reference_import",
    "awesome_tpu.runner.runner": "awesome_tpu_torch.runner.runner",
    "awesome_tpu.runner.sss_extractor":
        "awesome_tpu_torch.runner.sss_extractor",
    "awesome_tpu.serialization.jsonconv":
        "awesome_tpu_torch.serialization.jsonconv",
    "awesome_tpu.utils.corruptions": "awesome_tpu_torch.utils.corruptions",
    "awesome_tpu.utils.format": "awesome_tpu_torch.utils.format",
    "awesome_tpu.utils.logging": "awesome_tpu_torch.utils.logging",
    "awesome_tpu.utils.profiling": "awesome_tpu_torch.utils.profiling",
    "awesome_tpu.utils.shims": "awesome_tpu_torch.utils.shims",
    "awesome_tpu.utils.tensorboard": "awesome_tpu_torch.utils.tensorboard",
    "awesome_tpu.utils.timer": "awesome_tpu_torch.utils.timer",
}


class NoPortError(LookupError):
    """A dotted path of the JAX package that this package has no
    counterpart for."""


@dataclasses.dataclass
class Rule:
    name: str
    matches: Callable[[Any], bool]
    encode: Callable[[Any], Dict[str, Any]]
    decode: Callable[..., Any]


def register_rule(name, matches, encode, decode):
    _RULES.append(Rule(name, matches, encode, decode))


def port_path(path: str) -> str:
    """``path`` with a JAX-package module replaced by this package's
    counterpart; other paths unchanged. Raises :class:`NoPortError` for a
    path under ``awesome_tpu`` that has none."""
    if path != "awesome_tpu" and not path.startswith("awesome_tpu."):
        return path
    module, _, attr = path.rpartition(".")
    if path in PORT_MODULES:
        return PORT_MODULES[path]
    if module in PORT_MODULES:
        return f"{PORT_MODULES[module]}.{attr}"
    raise NoPortError(
        f"{path!r} names the JAX package and awesome_tpu_torch has no "
        "counterpart of it yet (ROADMAP.md, Queue 1)")


def dynamic_import(path: str):
    """Import a dotted name, a JAX-package path mapped by
    :func:`port_path` first. Spec: `awesome/util/reflection.py`."""
    mapped = port_path(path)
    module, _, attr = mapped.rpartition(".")
    if not module:
        return importlib.import_module(attr)
    try:
        return getattr(importlib.import_module(module), attr)
    except AttributeError:
        if mapped != path:
            raise NoPortError(
                f"{path!r}: {module} has no {attr} (not ported yet, "
                "ROADMAP.md Queue 1)") from None
        raise


def class_name(obj_or_type) -> str:
    t = obj_or_type if isinstance(obj_or_type, type) else type(obj_or_type)
    return f"{t.__module__}.{t.__qualname__}"


# --- built-in rules ------------------------------------------------------

register_rule(
    "tuple",
    lambda v: isinstance(v, tuple),
    lambda v: {CLASS_KEY: "builtins.tuple",
               "items": [to_jsonable(x) for x in v]},
    lambda d, dev: tuple(from_jsonable(x, dev) for x in d["items"]),
)
register_rule(
    "set",
    lambda v: isinstance(v, (set, frozenset)),
    lambda v: {CLASS_KEY: "builtins.set",
               "items": [to_jsonable(x) for x in v]},
    lambda d, dev: set(from_jsonable(x, dev) for x in d["items"]),
)
register_rule(
    "slice",
    lambda v: isinstance(v, slice),
    lambda v: {CLASS_KEY: "builtins.slice", "start": v.start, "stop": v.stop,
               "step": v.step},
    lambda d, dev: slice(d["start"], d["stop"], d["step"]),
)
register_rule(
    "datetime",
    lambda v: isinstance(v, _dt.datetime),
    lambda v: {CLASS_KEY: "datetime.datetime", "iso": v.isoformat()},
    lambda d, dev: _dt.datetime.fromisoformat(d["iso"]),
)
register_rule(
    "enum",
    lambda v: isinstance(v, enum.Enum),
    lambda v: {CLASS_KEY: class_name(v), "value": to_jsonable(v.value),
               "__enum__": True},
    lambda d, dev: dynamic_import(d[CLASS_KEY])(from_jsonable(d["value"])),
)
register_rule(
    "type",
    lambda v: isinstance(v, type),
    lambda v: {CLASS_KEY: "builtins.type", "name": class_name(v)},
    lambda d, dev: dynamic_import(d["name"]),
)


def _is_array(v) -> bool:
    if isinstance(v, np.ndarray):
        return True
    import torch

    return isinstance(v, torch.Tensor)


def _host(v) -> np.ndarray:
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


register_rule(
    "ndarray",
    _is_array,
    lambda v: {CLASS_KEY: "numpy.ndarray", "dtype": str(_host(v).dtype),
               "data": _host(v).tolist()},
    lambda d, dev: np.asarray(d["data"], dtype=d["dtype"]),
)


def _is_module_function(v) -> bool:
    # only module-level functions round-trip by reference (the reference's
    # function rule has the same restriction,
    # `awesome/serialization/rules/json_function_serialization_rule.py`)
    return isinstance(v, types.FunctionType) and (
        "<locals>" not in v.__qualname__)


register_rule(
    "function",
    _is_module_function,
    lambda v: {CLASS_KEY: "builtins.function",
               "name": f"{v.__module__}.{v.__qualname__}"},
    lambda d, dev: dynamic_import(d["name"]),
)


def _is_port_module(v) -> bool:
    from awesome_tpu_torch.nn.module import Module

    return isinstance(v, Module)


def _parameters(factory):
    """The parameters of a class's constructor or of a factory function."""
    fn = factory.__init__ if isinstance(factory, type) else factory
    return inspect.signature(fn).parameters


def init_names(factory) -> List[str]:
    """The keyword parameters of a class's constructor (or a factory
    function) other than ``self`` and ``device``."""
    return [n for n, p in _parameters(factory).items()
            if n not in ("self", "device")
            and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]


def takes_device(factory) -> bool:
    return "device" in _parameters(factory)


def module_args(module) -> Dict[str, Any]:
    """A port module's constructor arguments, read back from the
    attributes of the same names."""
    return {n: getattr(module, n) for n in init_names(type(module))
            if hasattr(module, n)}


register_rule(
    "module",
    _is_port_module,
    lambda v: {CLASS_KEY: class_name(v),
               **{k: to_jsonable(x) for k, x in module_args(v).items()}},
    None,  # decoded by from_jsonable's class branch
)


def _pickle_encode(v):
    import base64
    import pickle

    return {
        CLASS_KEY: "pickle",
        "data": base64.b64encode(pickle.dumps(v)).decode("ascii"),
        "repr": repr(v)[:200],
    }


def _pickle_decode(d):
    import base64
    import pickle

    return pickle.loads(base64.b64decode(d["data"]))


# --- core ----------------------------------------------------------------

def to_jsonable(value: Any, arrays: Optional[Dict[str, np.ndarray]] = None
                ) -> Any:
    """Recursively convert to JSON-safe structures with class tags.

    ``arrays``: every array goes into this dict instead of the JSON (for a
    binary ``.npz`` beside it), the JSON keeping its key (``"npz"``) and
    dtype; :func:`inline_arrays` puts them back."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if arrays is not None and _is_array(value):
        key = f"a{len(arrays)}"
        arrays[key] = _host(value)
        return {CLASS_KEY: "numpy.ndarray", "dtype": str(arrays[key].dtype),
                "npz": key}
    for rule in _RULES:
        if rule.matches(value):
            return rule.encode(value)
    if isinstance(value, dict):
        return {str(k): to_jsonable(v, arrays) for k, v in value.items()}
    if isinstance(value, list):
        return [to_jsonable(v, arrays) for v in value]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        out = {CLASS_KEY: class_name(value)}
        for f in dataclasses.fields(value):
            out[f.name] = to_jsonable(getattr(value, f.name), arrays)
        return out
    if hasattr(value, "__dict__"):
        out = {CLASS_KEY: class_name(value)}
        for k, v in vars(value).items():
            if not k.startswith("_"):
                out[k] = to_jsonable(v, arrays)
        return out
    # last resort: base64 pickle (the reference's pickle rule,
    # `awesome/serialization/rules/json_pickle_serialization_rule.py`)
    return _pickle_encode(value)


def inline_arrays(data: Any, arrays) -> Any:
    """The JSON of ``to_jsonable(value, arrays)`` with every array back in
    place (as the ndarray itself, which :func:`from_jsonable` takes as it
    is); ``arrays`` maps the keys to the arrays (a dict or an opened
    ``.npz``)."""
    if isinstance(data, list):
        return [inline_arrays(v, arrays) for v in data]
    if not isinstance(data, dict):
        return data
    if data.get(CLASS_KEY) == "numpy.ndarray" and "npz" in data:
        return {CLASS_KEY: "numpy.ndarray", "dtype": data["dtype"],
                "data": np.asarray(arrays[data["npz"]])}
    return {k: inline_arrays(v, arrays) for k, v in data.items()}


_DECODERS = {
    "builtins.tuple": "tuple",
    "builtins.set": "set",
    "builtins.slice": "slice",
    "datetime.datetime": "datetime",
    "builtins.type": "type",
    "numpy.ndarray": "ndarray",
    "builtins.function": "function",
}


def from_jsonable(data: Any, device=None) -> Any:
    """Inverse of :func:`to_jsonable` (class tags drive reconstruction).
    Port modules are built on ``device`` (``None``: the card)."""
    if isinstance(data, list):
        return [from_jsonable(v, device) for v in data]
    if not isinstance(data, dict):
        return data
    tag = data.get(CLASS_KEY)
    if tag is None:
        return {k: from_jsonable(v, device) for k, v in data.items()}
    if tag in _DECODERS:
        name = _DECODERS[tag]
        rule = next(r for r in _RULES if r.name == name)
        return rule.decode(data, device)
    if tag == "pickle":
        try:
            return _pickle_decode(data)
        except Exception:
            # foreign pickle payload (e.g. references awesome.*): keep
            # the raw envelope instead of failing the whole load
            return dict(data)
    if data.get("__enum__"):
        try:
            return dynamic_import(tag)(from_jsonable(data["value"]))
        except (ImportError, AttributeError, ValueError, KeyError):
            return from_jsonable(data["value"])
    try:
        cls = dynamic_import(tag)
    except (ImportError, AttributeError):
        # lenient resurrection: a foreign class tag (e.g. the reference's
        # own `awesome.*` tags carried inside imported configs) degrades
        # to a plain dict with the tag preserved instead of failing the
        # whole load; a JAX-package tag with no port raises (NoPortError)
        return {k: from_jsonable(v, device) for k, v in data.items()}
    kwargs = {k: from_jsonable(v, device) for k, v in data.items()
              if k != CLASS_KEY}
    if _is_port_module_class(cls):
        names = set(init_names(cls))
        return cls(**{k: v for k, v in kwargs.items() if k in names},
                   **({"device": device} if takes_device(cls) else {}))
    if dataclasses.is_dataclass(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kwargs.items() if k in names})
    obj = cls.__new__(cls)
    obj.__dict__.update(kwargs)
    return obj


def _is_port_module_class(cls) -> bool:
    from awesome_tpu_torch.nn.module import Module

    return isinstance(cls, type) and issubclass(cls, Module)


# --- file I/O ------------------------------------------------------------

def save_json(value: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_jsonable(value), f, indent=2)


def load_json(path: str, device=None) -> Any:
    with open(path) as f:
        return from_jsonable(json.load(f), device)


def save_yaml(value: Any, path: str) -> None:
    import yaml

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(to_jsonable(value), f, sort_keys=True)


def read_yaml(path: str) -> Any:
    """The YAML's plain data, class tags not yet decoded."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def load_yaml(path: str, device=None) -> Any:
    return from_jsonable(read_yaml(path), device)
