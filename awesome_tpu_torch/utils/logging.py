"""Logging + path utilities; counterpart of ``awesome_tpu/utils/logging.py``.

Spec: `awesome/util/logging.py` (basic_config) and
`awesome/util/path_tools.py` (project-root discovery, numerated file
names — the latter lives in utils.format).
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def basic_config(
    level: int = logging.INFO,
    fmt: str = "%(asctime)s %(levelname)s %(name)s: %(message)s",
    log_file: Optional[str] = None,
) -> None:
    handlers = [logging.StreamHandler(sys.stderr)]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(level=level, format=fmt, handlers=handlers,
                        force=True)


def get_project_root_path(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default: cwd) to the first directory holding
    a repo marker (.git / pyproject.toml / awesome_tpu_torch package)."""
    path = os.path.abspath(start or os.getcwd())
    while True:
        for marker in (".git", "pyproject.toml", "awesome_tpu_torch"):
            if os.path.exists(os.path.join(path, marker)):
                return path
        parent = os.path.dirname(path)
        if parent == path:
            return os.path.abspath(start or os.getcwd())
        path = parent
