"""Reading ``BENCHMARK.json`` and the data files it names.

A cell is an entry of ``workloads``. Its configuration is
``configs/<config>.json``, its traffic mix ``traffic/<traffic>.json`` (the
driver kind and the mix's parameters), and its correctness limits
``limits/<cell>.json``. A metric's reader is ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict[str, float]:
    return {k: float(v) for k, v in
            _json(HERE / "limits" / f"{cell_name}.json")["limits"].items()}


def metrics_of(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of this cell reports: its end-to-end metrics
    (``trace`` false) or its per-layer ones (``trace`` true). A metric with
    a ``workloads`` key belongs to those cells only; a per-layer metric
    without one belongs to every cell that reports the end-to-end metric it
    moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in reported]


def reader(metric_name: str) -> Callable[[dict], object]:
    """``metrics/<name>.py``'s ``read(record)``: the metric's value, or
    None where the record holds nothing to read it from."""
    path = HERE / "metrics" / f"{metric_name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """``drivers/<kind>.py`` as a module: ``setup``, ``unit``, ``release``
    and ``check``."""
    return importlib.import_module(f"portbench.drivers.{kind}")
