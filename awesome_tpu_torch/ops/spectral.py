"""Spectral matting on the card: the matting Laplacian as a 5x5 stencil and
its smallest eigenvectors by LOBPCG; counterpart of
``awesome_tpu/ops/spectral.py``.

The SSS feature proxy (``runner/sss_extractor.py``) needs the smallest
nontrivial eigenvectors of Levin's closed-form matting Laplacian. The host
path builds a scipy CSR matrix and shift-inverts; this module keeps the
operator DENSELY as a per-pixel 5x5 stencil ``(H, W, 5, 5)`` (two pixels
share a 3x3 window iff their offset is within +/-2), applies it as 25
shifted multiply-adds, and runs LOBPCG on the reversed spectrum ``c*I -
L`` (its top-k is the PSD Laplacian's smallest-k), all as torch ops on
the image's device.

The LOBPCG is this package's own copy of the JAX package's solver
(``jax.experimental.sparse.linalg.lobpcg_standard``): the same SVQB
orthonormalization, basis extension, residual projection, Rayleigh-Ritz
step and convergence test, so its float32 behaviour (it resolves
eigenvalues only down to about ``eps_f32 * ||L||``) is the JAX package's.
``torch.lobpcg`` has another basis update, restart and convergence test.

Every step is deterministic: slice-adds build the stencil (no
``index_add_``, whose CUDA path adds with atomics), the start block is
fixed, and the small dense eigen- and QR decompositions are LAPACK or
cuSOLVER calls on fixed inputs.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from awesome_tpu_torch.device import DeviceLike, resolve_device


class ImageTooSmall(ValueError):
    """The image is below the device eigensolve's shape precondition (a
    3x3 window, and LOBPCG's ``(k + oversample) * 5 < H * W``)."""


def matting_stencil(image: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Levin matting Laplacian of an (H, W, 3) image as a 5x5 stencil.

    Returns ``stencil`` of shape (H, W, 5, 5) with ``L[i, i+d] ==
    stencil[i, d + 2]`` for offsets d in [-2, 2]^2 (zero outside the
    image): for each 3x3 window w_k with mean mu_k, covariance Sigma_k,

        L[i, j] += delta_ij - (1 + (I_i-mu_k)^T (Sigma_k + eps/9 I)^-1
                                   (I_j-mu_k)) / 9
    """
    h, w, _ = image.shape
    if h < 3 or w < 3:
        raise ImageTooSmall("image too small: matting_stencil needs at "
                            "least a 3x3 image")
    m = 9
    # (H-2, W-2, 9, C): the 9 members of every 3x3 window, as slices
    win = torch.stack([image[dy:h - 2 + dy, dx:w - 2 + dx]
                       for dy in range(3) for dx in range(3)], dim=2)
    x = win - win.mean(dim=2, keepdim=True)
    cov = torch.einsum("hwmc,hwmd->hwcd", x, x) / m
    # (cov + eps/9 I)^-1 through a clamped eigendecomposition: float32
    # rounding makes an LU inverse of the regularized matrix NaN out on
    # flat windows
    ew, ev = torch.linalg.eigh(cov)
    ew = torch.clamp_min(ew, 0.0) + eps / m
    inv = torch.einsum("hwce,hwe,hwde->hwcd", ev, 1.0 / ew, ev)
    quad = torch.einsum("hwic,hwcd,hwjd->hwij", x, inv, x)
    vals = torch.eye(m, dtype=image.dtype, device=image.device) \
        - (1.0 + quad) / m  # (nh, nw, 9, 9)

    stencil = torch.zeros((h, w, 5, 5), dtype=image.dtype,
                          device=image.device)
    # window member a at (y+ay, x+ax) receives vals[..., a, b] at offset
    # (by-ay, bx-ax) from member b: 81 slice-adds, no scatter
    for a in range(m):
        ay, ax = divmod(a, 3)
        for b in range(m):
            by, bx = divmod(b, 3)
            stencil[ay:h - 2 + ay, ax:w - 2 + ax,
                    by - ay + 2, bx - ax + 2] += vals[..., a, b]
    return stencil


def stencil_matvec(stencil: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply the stencil operator: (H, W, 5, 5), (H, W, k) -> (H, W, k)."""
    h, w = stencil.shape[:2]
    xp = torch.nn.functional.pad(x, (0, 0, 2, 2, 2, 2))
    out = torch.zeros_like(x)
    for dy in range(5):
        for dx in range(5):
            out = out + stencil[:, :, dy, dx, None] * xp[dy:dy + h,
                                                         dx:dx + w]
    return out


def _det_init(h: int, w: int, k: int, dtype, device,
              image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic (n, k) start block: the constant, the image's own
    mean-removed colour channels (piecewise constant per region, so they
    overlap every segment mode whatever the image's symmetry), and
    low-frequency separable cosines, interleaved so near-collinear colour
    channels do not cost the block its rank."""
    yy, xx = torch.meshgrid(
        torch.linspace(0.0, 1.0, h, dtype=dtype, device=device),
        torch.linspace(0.0, 1.0, w, dtype=dtype, device=device),
        indexing="ij")
    chans = []
    if image is not None:
        for ch in range(image.shape[-1]):
            g = image[..., ch].to(dtype)
            chans.append(g - g.mean())
    cosines = []
    f = 1
    while len(cosines) < k:
        cy, cx = torch.cos(math.pi * f * yy), torch.cos(math.pi * f * xx)
        cosines += [cy, cx, cy * cx]
        f += 1
    cols = [torch.ones((h, w), dtype=dtype, device=device)]
    while len(cols) < k:
        if chans:
            cols.append(chans.pop(0))
        if len(cols) < k:
            cols.append(cosines.pop(0))
    return torch.stack(cols, dim=-1).reshape(h * w, k)


# --- LOBPCG (the JAX package's lobpcg_standard, in torch) -----------------
def _eigh_descending(a: torch.Tensor):
    w, v = torch.linalg.eigh(a)
    return w.flip(0), v.flip(1)


def _col_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=0, keepdim=True)


def _svqb(x: torch.Tensor) -> torch.Tensor:
    """A truncated orthonormal basis of ``x``'s columns (SVQB): columns
    of a numerically rank-deficient ``x`` come back zero."""
    norms = _col_norms(x)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.T @ x
    w, v = _eigh_descending(inner)
    tau = torch.finfo(x.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    ortho = x @ (v * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = _col_norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):  # twice is enough
        basis = _svqb(basis)
    return basis


def _project_out(basis: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``u``'s component in the complement of the orthonormal ``basis``,
    orthonormalized; suspicious columns (norm < 0.99 after the last
    subtraction) are zeroed so [basis, u] stays zero-or-orthonormal."""
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
        u = _orthonormalize(u)
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u * (_col_norms(u) >= 0.99).to(u.dtype)


def _extend_basis(x: torch.Tensor, m: int) -> torch.Tensor:
    """An (n, m) orthonormal extension of the orthonormal (n, k) ``x`` by a
    block Householder reflector (deterministic, unlike a random basis)."""
    n, k = x.shape
    upper, lower = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower], dim=0)
    other = torch.cat([torch.eye(m, dtype=x.dtype, device=x.device),
                       torch.zeros((n - k - m, m), dtype=x.dtype,
                                   device=x.device)], dim=0)
    wv = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (wv @ (wv[k:, :].T @ other))
    h[k:] += other
    return h


def lobpcg_standard(a_op, x: torch.Tensor, m: int = 100,
                    tol: Optional[float] = None):
    """Top-k eigenpairs of the symmetric operator ``a_op`` ((n, b) -> (n,
    b)) from the (n, k) start block ``x``: ``(theta (k,), U (n, k),
    iterations)``. The JAX package's ``lobpcg_standard``: an eigenpair is
    converged when its residual norm is below ``tol * 10 * n * (|A v| +
    lambda)`` (``tol`` defaults to the dtype's epsilon); the loop stops
    after ``m`` iterations or when all k are converged."""
    n, k = x.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    if tol is None:
        tol = float(torch.finfo(x.dtype).eps)
    x = _orthonormalize(x)
    p = _extend_basis(x, k)
    ax = a_op(x)
    theta = (x * ax).sum(dim=0)
    r = ax - theta[None, :] * x
    i = 0
    while i < m:
        r = _project_out(torch.cat((x, p), dim=1), r)
        xpr = torch.cat((x, p, r), dim=1)
        theta, q = _eigh_descending(xpr.T @ a_op(xpr))
        bq = q[:, :k]
        bq = bq / _col_norms(bq)
        x = xpr @ bq
        x = x / _col_norms(x)
        # the difference directions: Q[k:, :k] orthogonalized against
        # Q[:, :k] in the standard basis, then mapped through XPR
        qq, _ = torch.linalg.qr(q[:k, k:].T)
        p = xpr @ (q[:, k:] @ qq)
        norm_p = _col_norms(p)
        p = p / torch.where(norm_p == 0, 1.0, norm_p)
        ax = a_op(x)
        r = ax - theta[None, :k] * x
        resid = torch.linalg.vector_norm(r, dim=0)
        reltol = (torch.linalg.vector_norm(ax, dim=0) + theta[:k]) * n * 10
        i += 1
        if int((resid < tol * reltol).sum()) >= k:
            break
    return theta[:k], x, i


def smallest_eigenvectors(stencil: torch.Tensor, k: int, iters: int = 300,
                          oversample: int = 2, tol: Optional[float] = None,
                          image: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Smallest-(k) eigenvectors of the stencil Laplacian, (H, W, k).

    Includes the (near-)constant nullspace vector as component 0; the
    caller drops it as the host path drops eigsh's first column. LOBPCG on
    ``c*I - L`` with c the Gershgorin bound on lambda_max, from a fixed
    start block. Raises :class:`ImageTooSmall` (a ``ValueError``) when
    ``(k + oversample) * 5 >= H * W``, LOBPCG's own precondition."""
    h, w = stencil.shape[:2]
    n = h * w
    if (k + oversample) * 5 >= n:
        raise ImageTooSmall(
            f"image too small for the device eigensolve: need "
            f"h*w > {(k + oversample) * 5} for k={k} (+{oversample} "
            f"oversample), got {h}x{w}={n}; use the host spectral path")
    c = stencil.abs().sum(dim=(2, 3)).max()

    def a_op(xb):  # (n, b) -> (n, b)
        xi = xb.reshape(h, w, xb.shape[1])
        return (c * xi - stencil_matvec(stencil, xi)).reshape(n, -1)

    x0 = _det_init(h, w, k + oversample, stencil.dtype, stencil.device,
                   image=image)
    _, u, _ = lobpcg_standard(a_op, x0, m=iters, tol=tol)
    return u[:, :k].T.reshape(k, h, w).permute(1, 2, 0)


def spectral_soft_segments_device(image: np.ndarray, n_components: int = 2,
                                  max_side: int = 160, eps: float = 1e-4,
                                  iters: int = 300,
                                  device: DeviceLike = None,
                                  dtype: torch.dtype = torch.float64
                                  ) -> np.ndarray:
    """The card's variant of ``runner/sss_extractor.py:
    spectral_soft_segments``: the same downscale -> eigenvectors ->
    min-max -> upsample contract, with the Laplacian build and the
    eigensolve on ``device`` (the card unless the caller asks for the
    CPU), in ``dtype``.

    Not bit-faithful to the host path: the regularizer is ``eps=1e-4``
    (the host's is 1e-7), as in the JAX package. The solve runs in
    float64 by default: in float32 (the JAX package's type) the
    convergence test ``|r| < eps_f32 * 10 * n * (|A v| + theta)`` holds
    after the first iteration on ``c*I - L`` (``|A v|`` is about c), and
    the two-region test scene's nontrivial subspace then lies at cos 0.937
    from float64 ``eigsh``, in both packages; 300 float32 iterations do
    not pass 0.999 either. In float64 the same algorithm and tolerance
    run all ``iters`` and reach cos > 0.9999. ``dtype=torch.float32``
    gives the JAX package's features."""
    from scipy import ndimage

    dev = resolve_device(device)
    h, w = image.shape[:2]
    scale = min(1.0, max_side / max(h, w))
    if scale < 1.0:
        small = np.clip(ndimage.zoom(image, (scale, scale, 1), order=1),
                        0.0, 1.0)
    else:
        small = image
    sh, sw = small.shape[:2]
    small_t = torch.as_tensor(np.asarray(small), dtype=dtype, device=dev)
    stencil = matting_stencil(small_t, eps=eps)
    vecs = smallest_eigenvectors(stencil, n_components + 1, iters=iters,
                                 image=small_t).cpu().numpy()
    feats = []
    for i in range(1, n_components + 1):
        f = vecs[..., i].astype(np.float32)
        lo, hi = float(f.min()), float(f.max())
        f = (f - lo) / max(hi - lo, 1e-12)
        if scale < 1.0:
            f = ndimage.zoom(f, (h / sh, w / sw), order=1)[:h, :w]
            if f.shape != (h, w):
                pad = ((0, h - f.shape[0]), (0, w - f.shape[1]))
                f = np.pad(f, pad, mode="edge")
        feats.append(np.clip(f, 0.0, 1.0))
    return np.stack(feats, axis=-1).astype(np.float32)
