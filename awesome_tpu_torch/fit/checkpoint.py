"""Checkpoints: agent-checkpoint bundles, resumable train states and
stacked prior caches; counterpart of ``awesome_tpu/fit/checkpoint.py``.

A saved tree is two files beside each other: ``<path>.npz`` with one
array per leaf, stored under the leaf's key path, and ``<path>.tree.json``
with the tree's structure (dicts, lists, tuples, NamedTuples, ``None``)
and each leaf's kind and dtype. Leaves are matched back by key path,
never by position: the port's trees keep dict insertion order where JAX
sorts keys, so a template with another key order, or a NamedTuple where
the save had a dict, loads the same leaves. The round trip is bitwise and
keeps dtypes (a bfloat16 leaf is stored as its 16-bit patterns). Nothing
is pickled. There is no Orbax here: an Orbax directory (a save of the
JAX package) counts as absent, with the JAX package's warning.

Resume is bit-identical: a train state restored with
:func:`restore_resumable` and trained on equals, leaf for leaf, the state
of a run that was never interrupted (given a deterministic step, which
``awesome_tpu_torch/__init__.py`` sets up on the card).
"""
from __future__ import annotations

import collections
import contextlib
import copy
import importlib
import json
import logging
import os
import shutil
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from awesome_tpu_torch.core.tree import is_namedtuple, tree_flatten_with_path
from awesome_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# what a torn or foreign save raises when it is read
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)

# a checkpoint's in-memory samples (``dataset_args['samples']``), binary
SAMPLES_FILE = "samples.npz"


def _key(path) -> str:
    """A leaf's name in the ``.npz``: its key path, '/'-joined after a
    leading '/' (so no name can clash with ``np.savez``'s own
    arguments)."""
    return "/" + "/".join(path)


def _encode(tree, arrays: Dict[str, np.ndarray], path=()):
    """The JSON structure of ``tree``; fills ``arrays`` with its leaves."""
    if isinstance(tree, dict):
        return {"dict": [[k, _encode(v, arrays, path + (str(k),))]
                         for k, v in tree.items()]}
    if is_namedtuple(tree):
        cls = type(tree)
        return {"namedtuple": [cls.__module__, cls.__qualname__],
                "fields": [[f, _encode(v, arrays, path + (f,))]
                           for f, v in zip(tree._fields, tree)]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_encode(v, arrays, path + (str(i),))
                       for i, v in enumerate(tree)]}
    if tree is None:
        return {"none": True}
    key = _key(path)
    if key in arrays:
        raise ValueError(f"two leaves share the key path {key!r}")
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arrays[key] = t.numpy()
        return {"leaf": key, "kind": "tensor", "dtype": dtype}
    if isinstance(tree, (bool, int, float)):
        arrays[key] = np.asarray(tree)
        return {"leaf": key, "kind": type(tree).__name__}
    arr = np.asarray(tree)
    if arr.dtype == object:
        raise TypeError(f"cannot save a leaf of type {type(tree).__name__} "
                        f"at {key!r}: no pickling")
    arrays[key] = arr
    return {"leaf": key, "kind": "ndarray"}


def _leaf(spec: dict, arrays, device: torch.device):
    a = arrays[spec["leaf"]]
    kind = spec["kind"]
    if kind == "tensor":
        t = torch.from_numpy(np.array(a))
        if spec["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device)
    if kind in ("bool", "int", "float"):
        return {"bool": bool, "int": int, "float": float}[kind](a.item())
    return np.array(a)


def _namedtuple_class(module: str, qualname: str, fields):
    """The NamedTuple class a save names, or one of the same name and
    fields when it cannot be imported."""
    try:
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        if isinstance(obj, type) and tuple(getattr(obj, "_fields", ())) \
                == tuple(fields):
            return obj
    except (ImportError, AttributeError):
        pass
    return collections.namedtuple(qualname.split(".")[-1], fields)


def _decode(node: dict, arrays, device: torch.device):
    if "dict" in node:
        return {k: _decode(v, arrays, device) for k, v in node["dict"]}
    if "namedtuple" in node:
        fields = [f for f, _ in node["fields"]]
        cls = _namedtuple_class(*node["namedtuple"], fields)
        return cls(*(_decode(v, arrays, device) for _, v in node["fields"]))
    if "list" in node:
        return [_decode(v, arrays, device) for v in node["list"]]
    if "tuple" in node:
        return tuple(_decode(v, arrays, device) for v in node["tuple"])
    if "none" in node:
        return None
    return _leaf(node, arrays, device)


def save_pytree(tree: Any, path: str) -> None:
    """Persist a tree of tensors, arrays, Python scalars and ``None`` as
    ``<path>.npz`` plus the structure sidecar ``<path>.tree.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    structure = _encode(tree, arrays)
    np.savez(path + ".npz", **arrays)
    with open(path + ".tree.json", "w") as f:
        json.dump(structure, f)


_warned_unreadable: set = set()


def pytree_exists(path: str) -> bool:
    """True iff :func:`save_pytree` files for ``path`` exist. An Orbax
    directory (the JAX package's format) cannot be read here and counts
    as absent, with a warning once per path, so a resume from it starts
    fresh instead of failing in :func:`load_pytree`."""
    if os.path.exists(path + ".npz") and os.path.exists(path + ".tree.json"):
        return True
    if os.path.isdir(path) and path not in _warned_unreadable:
        _warned_unreadable.add(path)
        logger.warning(
            "checkpoint %s is an Orbax directory but Orbax is unavailable "
            "in this process (this package saves .npz files); treating it "
            "as absent", path)
    return False


def restructure_like(template: Any, restored: Any) -> Any:
    """Rebuild ``restored`` with ``template``'s exact structure, matching
    leaves by key path (a NamedTuple field and the same key of a dict
    compare equal). Tensor leaves land on the template leaf's device;
    ``None`` in the template stays ``None``."""
    by_path = {p: leaf for p, leaf in tree_flatten_with_path(restored)}
    leaves = []
    for p, t in tree_flatten_with_path(template):
        if t is None:
            leaves.append(None)
            continue
        if p not in by_path:
            raise ValueError(
                f"checkpoint is missing leaf {_key(p)!r} expected by the "
                f"template (has: {sorted(map(_key, by_path))[:8]}...)")
        v = by_path[p]
        if isinstance(t, torch.Tensor):
            v = torch.as_tensor(v).to(t.device)
        leaves.append(v)
    it = iter(leaves)
    return _rebuild_like(template, it)


def _rebuild_like(template, it):
    if isinstance(template, dict):
        return {k: _rebuild_like(v, it) for k, v in template.items()}
    if is_namedtuple(template):
        return type(template)(*(_rebuild_like(v, it) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild_like(v, it) for v in template)
    return next(it)


def load_pytree(path: str, template: Optional[Any] = None,
                device: DeviceLike = None) -> Any:
    """Load a :func:`save_pytree` save. With a ``template`` the result has
    the template's structure and its leaves' devices; without one, the
    saved structure on ``device`` (the card unless the caller says
    otherwise)."""
    if os.path.isdir(path) and not os.path.exists(path + ".npz"):
        raise RuntimeError(
            f"checkpoint {path} is an Orbax directory but Orbax is "
            f"unavailable in this process; re-save it with save_pytree")
    with open(path + ".tree.json") as f:
        structure = json.load(f)
    with np.load(path + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    if template is None:
        return _decode(structure, arrays, resolve_device(device))
    return restructure_like(template,
                            _decode(structure, arrays, torch.device("cpu")))


def config_snapshot(config) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """A config's JSON for a checkpoint's ``meta.json`` and the arrays of
    its in-memory samples (``dataset_args['samples']``). The samples'
    JSON holds each array's key in :data:`SAMPLES_FILE` instead of its
    values, under ``{"__npz__": SAMPLES_FILE, "value": ...}``. A config
    without samples gives ``to_jsonable(config)`` and no arrays."""
    from awesome_tpu_torch.serialization.jsonconv import to_jsonable

    args = getattr(config, "dataset_args", None)
    if not isinstance(args, dict) or args.get("samples") is None:
        return to_jsonable(config), {}
    arrays: Dict[str, np.ndarray] = {}
    samples = to_jsonable(args["samples"], arrays)
    rest = copy.copy(config)
    rest.dataset_args = {k: v for k, v in args.items() if k != "samples"}
    snap = to_jsonable(rest)
    snap["dataset_args"]["samples"] = {"__npz__": SAMPLES_FILE,
                                       "value": samples}
    return snap, arrays


def _restore_samples(config: Optional[Dict], directory: str
                     ) -> Optional[Dict]:
    """The snapshot's samples with their arrays read back from
    :data:`SAMPLES_FILE` (bit for bit; ``from_jsonable`` rebuilds the
    samples)."""
    from awesome_tpu_torch.serialization.jsonconv import inline_arrays

    args = (config or {}).get("dataset_args")
    ref = args.get("samples") if isinstance(args, dict) else None
    if not (isinstance(ref, dict) and "__npz__" in ref):
        return config
    with np.load(os.path.join(directory, ref["__npz__"])) as arrays:
        samples = inline_arrays(ref["value"], arrays)
    return dict(config, dataset_args=dict(args, samples=samples))


class AgentCheckpoint:
    """Bundle of everything needed to resume or analyze a run; its
    ``meta.json`` has the JAX package's keys. ``arrays`` (from
    :func:`config_snapshot`) go to :data:`SAMPLES_FILE` beside it."""

    def __init__(self, name: str, params: Any, opt_state: Any = None,
                 tracker: Optional[Dict] = None,
                 config: Optional[Dict] = None,
                 extra: Optional[Dict] = None,
                 arrays: Optional[Dict[str, np.ndarray]] = None):
        self.name = name
        self.params = params
        self.opt_state = opt_state
        self.tracker = tracker
        self.config = config
        self.extra = extra or {}
        self.arrays = arrays or {}

    def save(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        save_pytree(self.params, os.path.join(directory, "params"))
        if self.arrays:
            np.savez(os.path.join(directory, SAMPLES_FILE), **self.arrays)
        if self.opt_state is not None:
            save_pytree(self.opt_state, os.path.join(directory, "opt_state"))
        meta = {
            "name": self.name,
            "tracker": self.tracker,
            "config": self.config,
            "extra": self.extra,
            "has_opt_state": self.opt_state is not None,
        }
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f, default=str)
        return directory

    @classmethod
    def load(cls, directory: str, params_template: Optional[Any] = None,
             opt_template: Optional[Any] = None,
             device: DeviceLike = None) -> "AgentCheckpoint":
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        params = load_pytree(os.path.join(directory, "params"),
                             params_template, device)
        opt_state = None
        if meta.get("has_opt_state"):
            opt_state = load_pytree(os.path.join(directory, "opt_state"),
                                    opt_template, device)
        return cls(name=meta["name"], params=params, opt_state=opt_state,
                   tracker=meta.get("tracker"),
                   config=_restore_samples(meta.get("config"), directory),
                   extra=meta.get("extra", {}))


@contextlib.contextmanager
def atomic_dir(directory: str):
    """Write a checkpoint tag directory atomically.

    Yields a scratch path; on clean exit the scratch directory replaces
    ``directory`` by two renames (old -> ``<dir>.old``, tmp -> dir). A
    preemption mid-save can never tear a checkpoint: the previous
    complete save survives (at the tag or its ``.old`` twin, which
    :func:`find_resumable` scans too), or the new one lands."""
    tmp = directory + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.dirname(directory) or ".", exist_ok=True)
    yield tmp
    old = directory + ".old"
    if os.path.isdir(old):
        shutil.rmtree(old)
    if os.path.isdir(directory):
        os.rename(directory, old)
    os.rename(tmp, directory)
    if os.path.isdir(old):
        shutil.rmtree(old)


def find_resumable(base: str, kind: str,
                   tags=("latest", "end")) -> Optional[tuple]:
    """The newest resumable checkpoint under ``base``: each tag directory
    and its ``.old`` crash-window twin, with a readable meta.json whose
    ``extra.state_kind`` is ``kind`` and a saved ``train_state``. Torn
    metadata is skipped with a warning. Returns ``(epoch, directory,
    meta)`` or ``None``."""
    best = None
    for tag in tags:
        d0 = os.path.join(base, tag)
        for d in (d0, d0 + ".old"):
            mp = os.path.join(d, "meta.json")
            if not (os.path.exists(mp)
                    and pytree_exists(os.path.join(d, "train_state"))):
                continue
            try:
                with open(mp) as f:
                    meta = json.load(f)
            except (OSError, ValueError) as e:
                logger.warning("skipping unreadable checkpoint meta %s: %s",
                               mp, e)
                continue
            ex = meta.get("extra") or {}
            try:
                ep = int(ex.get("epoch", -1))
            except (TypeError, ValueError):
                continue
            if ep <= 0 or ex.get("state_kind") != kind:
                continue
            # equal epochs: prefer the save that recorded an early stop
            key = (ep, 1 if ex.get("stopped_early") else 0)
            if best is None or key > best[0]:
                best = (key, d, meta)
    if best is None:
        return None
    return best[0][0], best[1], best[2]


def load_tag_with_twin(base: str, tag: str, subpath: str,
                       template: Any) -> Optional[Any]:
    """Load ``<base>/<tag>/<subpath>``, falling back to the tag's ``.old``
    twin (a preemption during a tag save can leave only the twin).
    Returns the tree, or ``None`` when neither holds a readable save."""
    d0 = os.path.join(base, tag)
    for d in (d0, d0 + ".old"):
        p = os.path.join(d, subpath)
        if not (os.path.exists(os.path.join(d, "meta.json"))
                and pytree_exists(p)):
            continue
        try:
            return load_pytree(p, template=template)
        except _UNREADABLE as e:  # a torn save: fall through to the twin
            if d.endswith(".old"):
                logger.warning("checkpoint twin %s unreadable (%s); "
                               "giving up", d, e)
            else:
                logger.warning("checkpoint %s unreadable (%s); trying twin",
                               d, e)
    return None


def restore_resumable(checkpoint_dir: str, kind: str, template_state: Any,
                      num_epochs: int, best_subpath: str = "train_state",
                      best_template: Optional[Any] = None,
                      validate=None) -> Optional[Dict]:
    """The resume sequence of every training loop: find the newest
    resumable checkpoint of ``kind`` (``.old`` twins included), rebuild
    the full NamedTuple train state on ``template_state``'s structure and
    devices, restore the tracker, and load the 'best' tag (or its twin).
    ``validate(epoch, extra)`` runs after discovery and before loading.

    Returns ``None`` when nothing resumable exists, else a dict with
    ``state``, ``epoch``, ``meta``, ``extra``, ``tracker`` (a Tracker or
    None), ``best`` (the loaded ``best_subpath`` tree or None) and
    ``dir``."""
    from awesome_tpu_torch.fit.tracker import Tracker

    found = find_resumable(checkpoint_dir, kind)
    if found is None:
        logger.info("resume requested but nothing resumable under %s — "
                    "starting fresh", checkpoint_dir)
        return None
    ep, d, meta = found
    extra = meta.get("extra") or {}
    if ep >= num_epochs:
        # keep the true epoch: the loop just has nothing left to run
        logger.info("resume checkpoint epoch %d >= num_epochs %d — "
                    "nothing left to train", ep, num_epochs)
    elif validate is not None:
        validate(ep, extra)
    restored = load_pytree(os.path.join(d, "train_state"),
                           template=tuple(template_state))
    state = type(template_state)(*restored)
    tracker = (Tracker.from_dict(meta["tracker"])
               if meta.get("tracker") else None)
    bst = load_tag_with_twin(
        checkpoint_dir, "best", best_subpath,
        best_template if best_template is not None else tuple(template_state))
    if bst is None:
        logger.info("no readable best checkpoint; best-model restarts")
    logger.info("Resuming training from %s at epoch %d", d, ep)
    return {"state": state, "epoch": ep, "meta": meta, "extra": extra,
            "tracker": tracker, "best": bst, "dir": d}


def run_with_emergency(fn, emergency_dir: Optional[str], state_getter,
                       extra_getter=None):
    """Run ``fn()``; on an error dump the newest train state and the
    traceback under ``emergency_dir`` before re-raising. The getters are
    called inside the handler, so they see the state at failure time."""
    try:
        return fn()
    except BaseException as err:
        if emergency_dir:
            try:
                extra = extra_getter() if extra_getter is not None else None
                d = emergency_save(emergency_dir, params=state_getter(),
                                   error=err, extra=extra)
                logger.error("training failed (%r) — emergency state "
                             "dumped to %s", err, d)
            except Exception:
                logger.exception("emergency save itself failed")
        raise


def save_prior_cache(stacked_params: Any, path: str) -> None:
    """Prior-cache checkpoint: the stacked per-image tree in one save."""
    save_pytree(stacked_params, path)


def load_prior_cache(path: str, template: Optional[Any] = None,
                     device: DeviceLike = None) -> Any:
    return load_pytree(path, template, device)


def emergency_save(directory: str, params: Any = None, batch: Any = None,
                   error: Optional[BaseException] = None,
                   extra: Optional[Dict] = None) -> str:
    """Dump what is available about a failing step (params, batch, the
    error and its traceback) for a post-mortem. A part that cannot be
    saved is logged and skipped, so the rest still lands."""
    import traceback

    os.makedirs(directory, exist_ok=True)
    for name, tree in (("params", params), ("batch", batch)):
        if tree is None:
            continue
        try:
            save_pytree(tree, os.path.join(directory, name))
        except (OSError, TypeError, ValueError) as e:
            logger.warning("emergency save of %s failed: %s", name, e)
    meta = {"extra": extra or {}}
    if error is not None:
        meta["error"] = repr(error)
        meta["traceback"] = "".join(traceback.format_exception(
            type(error), error, error.__traceback__))
    with open(os.path.join(directory, "emergency.json"), "w") as f:
        json.dump(meta, f, default=str)
    return directory
