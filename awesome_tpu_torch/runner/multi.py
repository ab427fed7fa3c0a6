"""Experiment fan-out: grid search and multi-config runners; counterpart
of ``awesome_tpu/runner/multi.py``.

Behavior port of `awesome/run/multi_runner.py:16-236`,
`awesome/run/grid_search_runner.py:12` and
`awesome/run/multi_config_runner.py:18-84`: derive child configs (param
grid or config-directory scan), persist them with their diff vs the
parent, then either emit a job file for external execution (the
reference's SLURM path) or run serially in-process.

``shard_jobs`` splits the job list deterministically across processes or
machines. A job's default script is this package's entry point
(``python -m awesome_tpu_torch.run``), given as :data:`PORT_SCRIPT`.
"""
from __future__ import annotations

import copy
import itertools
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from awesome_tpu_torch.runner.config import AwesomeConfig, Config
from awesome_tpu_torch.serialization.jsonconv import save_yaml

Job = Tuple[str, List[str]]  # (script, argv)

#: the job script: this package's entry point, run as ``python -m``
PORT_SCRIPT = "-m awesome_tpu_torch.run"


def expand_grid(param_grid: Dict[str, Sequence[Any]]) -> List[Dict[str, Any]]:
    """Cartesian product of named parameter lists."""
    keys = list(param_grid)
    out = []
    for combo in itertools.product(*(param_grid[k] for k in keys)):
        out.append(dict(zip(keys, combo)))
    return out


def _set_dotted(cfg: Config, dotted: str, value: Any) -> None:
    """Set 'a.b.c' on nested config fields / dict values."""
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
    if isinstance(obj, dict):
        obj[parts[-1]] = value
    else:
        setattr(obj, parts[-1], value)


class GridSearchRunner:
    """Expand a param grid into child configs (diff recorded)."""

    def __init__(self, base_config: AwesomeConfig,
                 param_grid: Dict[str, Sequence[Any]],
                 output_dir: str = "./grid"):
        self.base_config = base_config
        self.param_grid = param_grid
        self.output_dir = output_dir
        self.children: List[AwesomeConfig] = []

    def build(self) -> List[AwesomeConfig]:
        for i, combo in enumerate(expand_grid(self.param_grid)):
            child = copy.deepcopy(self.base_config)
            for dotted, value in combo.items():
                _set_dotted(child, dotted, value)
            child.name_experiment = (
                f"{self.base_config.name_experiment or 'grid'}_{i}"
            )
            child.diff_config = {
                k: v for k, v in combo.items()
            }
            self.children.append(child)
        return self.children

    def save_children(self) -> List[str]:
        paths = []
        for i, child in enumerate(self.children):
            p = os.path.join(self.output_dir, f"config_{i}.yaml")
            save_yaml(child, p)
            paths.append(p)
        return paths

    def create_jobs(self, script: str = PORT_SCRIPT) -> List[Job]:
        """Job list for external execution.

        Spec: `awesome/run/multi_runner.py:106-141` create_job_file.
        """
        return [
            (script, ["--config-path", p]) for p in self.save_children()
        ]

    def create_job_file(self, path: Optional[str] = None,
                        script: str = PORT_SCRIPT) -> str:
        path = path or os.path.join(self.output_dir, "JobFile.py")
        jobs = self.create_jobs(script)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("JOBS = [\n")
            for s, argv in jobs:
                f.write(f"    ({s!r}, {argv!r}),\n")
            f.write("]\n")
        return path

    def run_serial(self) -> List[Dict[str, float]]:
        """In-process serial execution (`multi_runner.py:225-236`)."""
        from awesome_tpu_torch.runner.runner import AwesomeRunner

        results = []
        for child in self.children:
            r = AwesomeRunner(child)
            r.build()
            r.train()
            results.append(r.evaluate())
            r.save_results()
        return results


class MultiConfigRunner:
    """Run every config YAML in a directory.

    Spec: `awesome/run/multi_config_runner.py:18-84`.
    """

    def __init__(self, config_dir: str):
        self.config_dir = config_dir

    def scan(self) -> List[str]:
        return sorted(
            os.path.join(self.config_dir, f)
            for f in os.listdir(self.config_dir)
            if f.endswith((".yaml", ".yml"))
        )

    def create_jobs(self, script: str = PORT_SCRIPT) -> List[Job]:
        return [(script, ["--config-path", p]) for p in self.scan()]


def shard_jobs(jobs: List[Job], num_shards: int, shard_id: int) -> List[Job]:
    """Deterministic round-robin shard of the job list (the reference's
    `multi_runner.py` writes SLURM job files instead)."""
    return [j for i, j in enumerate(jobs) if i % num_shards == shard_id]
