"""ctypes binding of the native permutohedral lattice; counterpart of
``awesome_tpu/ops/permutohedral.py``.

Exact high-dimensional Gaussian filtering and the exact dense-CRF mean
field on the host: the counterpart of the reference's pydensecrf C++
dependency (`awesome/run/crf.py:4`), used to check the bilateral-grid CRF
of ``ops/crf.py``.

``native/permutohedral.cpp`` is compiled with g++ (portable flags, no
``-march=native``) at first use into
``build/awesome_tpu_torch/libpermutohedral-<hash>.so``, the hash taken over
the source and the flags; nothing is written under ``native/``. A failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "permutohedral.cpp"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_LIB: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile :data:`SOURCE` (an existing build of the same source and
    flags is reused) and return the library's path."""
    from awesome_tpu_torch.ops.build import BUILD_DIR

    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update("\0".join(GXX_FLAGS).encode())
    out = BUILD_DIR / f"libpermutohedral-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([cxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name} "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.ph_filter.argtypes = [fp, ctypes.c_int, ctypes.c_int, fp,
                              ctypes.c_int, fp]
    lib.ph_filter.restype = None
    lib.ph_dense_crf.argtypes = [
        fp, ctypes.c_int, ctypes.c_int, fp, ctypes.c_float, fp,
        ctypes.c_float, ctypes.c_int, fp,
    ]
    lib.ph_dense_crf.restype = None
    _LIB = lib
    return lib


def _as_f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def ph_filter(features: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Gaussian-filter ``values`` (N, Vd) over ``features`` (N, Fd),
    pre-scaled by 1/sigma: the kernel ``exp(-|fi - fj|^2 / 2)``."""
    lib = _load()
    features = _as_f32(features)
    values = _as_f32(values)
    n, fd = features.shape
    out = np.zeros_like(values)
    lib.ph_filter(_ptr(features), n, fd, _ptr(values), values.shape[1],
                  _ptr(out))
    return out


def dense_crf_exact(
    img: np.ndarray,
    probs: np.ndarray,
    gaussian_sdims: Tuple[float, float] = (3.0, 3.0),
    gaussian_compat: float = 3.0,
    bilateral_sdims: Tuple[float, float] = (50.0, 50.0),
    bilateral_schan: Tuple[float, float, float] = (10.0, 10.0, 10.0),
    bilateral_compat: float = 5.0,
    iterations: int = 15,
) -> np.ndarray:
    """Exact mean-field dense CRF. img (H, W, 3) float in [0, 1] or uint8;
    probs (H, W, C). Returns (H, W, C)."""
    lib = _load()
    h, w, c = probs.shape
    n = h * w
    if img.dtype != np.uint8:
        img255 = (np.clip(img, 0, 1) * 255.0).astype(np.float32)
    else:
        img255 = img.astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gauss = _as_f32(np.stack([yy / gaussian_sdims[0],
                              xx / gaussian_sdims[1]], axis=-1).reshape(n, 2))
    bilat = _as_f32(np.concatenate([
        (yy / bilateral_sdims[0])[..., None],
        (xx / bilateral_sdims[1])[..., None],
        img255 / np.asarray(bilateral_schan, np.float32),
    ], axis=-1).reshape(n, 5))
    probs_f = _as_f32(probs).reshape(n, c)
    out = np.zeros_like(probs_f)
    lib.ph_dense_crf(_ptr(probs_f), n, c, _ptr(gauss), gaussian_compat,
                     _ptr(bilat), bilateral_compat, iterations, _ptr(out))
    return out.reshape(h, w, c)
