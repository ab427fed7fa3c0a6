"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) on first use and bound with
``ctypes``. A build goes to ``build/awesome_tpu_torch/lib<stem>-<hash>.so``
at the root of the checkout; the hash covers the source text and the nvcc
flags, so a build is reused only for the same source and flags. The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside it in ``<name>.build.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "awesome_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build_library(source: str, extra_flags: Tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<source>`` into a shared library and return its path
    (an existing build of the same source and flags is reused)."""
    src = CSRC / source
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest = hashlib.sha1(src.read_bytes())
    digest.update("\0".join(flags).encode())
    out = BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    out.with_suffix(".build.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def check(code: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what} failed with CUDA error {code}")


class Library:
    """One kernel source: built on first use and loaded once per process.
    ``declare(cdll)`` sets the ``argtypes``/``restype`` of its entry
    points."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = source
        self.declare = declare
        self._cdll: Optional[ctypes.CDLL] = None

    def build(self, extra_flags: Tuple[str, ...] = ()) -> Path:
        return build_library(self.source, extra_flags)

    def load(self, path: Path) -> ctypes.CDLL:
        cdll = ctypes.CDLL(str(path))
        self.declare(cdll)
        return cdll

    def get(self) -> ctypes.CDLL:
        """The loaded library, built with the default flags if need be."""
        if self._cdll is None:
            self._cdll = self.load(self.build())
        return self._cdll

    def use(self, cdll: ctypes.CDLL) -> None:
        """Hand the wrappers another build (e.g. a profiling one)."""
        self._cdll = cdll
