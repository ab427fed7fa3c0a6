"""Port parity: the SSS feature extractor (``runner/sss_extractor.py``, a
numpy/scipy copy) and the device spectral solve (``ops/spectral.py``)
against the JAX package, on the two-region test scene of
``tests/test_sss.py``.

Tolerances: the host Laplacian at rtol 1e-12 (float64 numpy on both
sides), the host soft segments at atol 1e-5; the float32 stencil within
its float64 version's error of the JAX package's (each package's stencil
is 5-8e-6 from float64 on the test scene, from the 3x3 eigendecompositions
of its nearly singular window covariances, so the two differ by up to
9e-6: held at rtol 1e-5 / atol 1e-5, and the port's largest error against
float64 no larger than the JAX package's); the stencil matvec against scipy's CSR ``L @ x`` at atol 5e-4
(``tests/test_sss.py:172``). Eigenvectors carry a sign and a
near-degenerate pair has no unique basis, so the eigensolve is held by
subspace: the cosine of the largest principal angle between two
nontrivial subspaces, at >= 0.999, and each min-max feature up to ``f <->
1 - f`` at atol 1e-2.

The JAX package solves in float32, where the LOBPCG convergence test
passes after its first iteration on ``c*I - L``; there both packages' 2-D
nontrivial subspaces of this scene lie at cos 0.937 from float64
``eigsh``, and they agree with each other past 0.999. The port's device
proxy solves in float64 by default, which reaches ``eigsh``'s subspace."""
import numpy as np
import pytest
import torch

from awesome_tpu.runner import sss_extractor as JX
from awesome_tpu_torch.ops import spectral as S
from awesome_tpu_torch.runner import sss_extractor as TX
from tests.test_sss import _texture_ambiguous_image, _two_region_image

COS_MIN = 0.999


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's other workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cos_largest_angle(a: np.ndarray, b: np.ndarray) -> float:
    """cos of the largest principal angle between span(a) and span(b)."""
    qa, _ = np.linalg.qr(a.astype(np.float64))
    qb, _ = np.linalg.qr(b.astype(np.float64))
    return float(np.linalg.svd(qa.T @ qb, compute_uv=False).min())


def _eigsh_subspace(img, k, eps=1e-4):
    from scipy.sparse.linalg import eigsh

    lap = TX.matting_laplacian(img.astype(np.float64), eps=eps)
    n = lap.shape[0]
    return eigsh(lap, k=k, sigma=0, which="LM",
                 v0=np.full(n, 1 / np.sqrt(n)))[1]


def test_matting_laplacian_matches_jax():
    img, _ = _two_region_image(24, 30)
    a = TX.matting_laplacian(img.astype(np.float64), eps=1e-4)
    b = JX.matting_laplacian(img.astype(np.float64), eps=1e-4)
    np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=1e-12)


@pytest.mark.parametrize("semantic_weight", [0.0, 10.0],
                         ids=["plain", "sss_fused"])
def test_spectral_soft_segments_match_jax(semantic_weight):
    """Host soft segments, plain and with the SSS fusion (its candidate
    pooling, redundancy filter and Otsu calibration)."""
    img, _ = (_texture_ambiguous_image(36, 48) if semantic_weight
              else _two_region_image(48, 64))
    got = TX.spectral_soft_segments(img, 2, semantic_weight=semantic_weight)
    ref = JX.spectral_soft_segments(img, 2, semantic_weight=semantic_weight)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_extract_prefers_embedmaps_then_proxies(tmp_path):
    """``extract``: a ``feature_dir`` embedmap first, else the proxy; the
    pyramid proxy; ``from_config`` with the reference's shell-out
    template."""
    img, _ = _two_region_image(32, 40)
    emb = np.concatenate([img, img[..., ::-1]], axis=-1)
    np.save(tmp_path / "b.npy", emb)
    tx = TX.SemanticSoftSegmentationExtractor(str(tmp_path))
    jx = JX.SemanticSoftSegmentationExtractor(str(tmp_path))
    np.testing.assert_allclose(tx.extract(img, "b"), jx.extract(img, "b"),
                               atol=1e-5)
    np.testing.assert_allclose(tx.extract(img, "a"), jx.extract(img, "a"),
                               atol=1e-5)
    tp = TX.SemanticSoftSegmentationExtractor(str(tmp_path), proxy="pyramid")
    jp = JX.SemanticSoftSegmentationExtractor(str(tmp_path), proxy="pyramid")
    np.testing.assert_allclose(tp.proxy_features(img),
                               jp.proxy_features(img), atol=1e-5)

    class Cfg:
        semantic_soft_segmentation_code_dir = "/sss"
        semantic_soft_segmentation_model_checkpoint_dir = "/ckpt"
        tf_use_gpu = False
        dataset_args = {"sss_proxy": "spectral_device"}
        device = "cpu"

    tc = TX.SemanticSoftSegmentationExtractor.from_config(Cfg, "/feat")
    jc = JX.SemanticSoftSegmentationExtractor.from_config(Cfg, "/feat")
    assert tc.command_template == jc.command_template
    assert (tc.proxy, tc.device) == ("spectral_device", "cpu")


def test_matting_stencil_and_matvec():
    """The stencil against the JAX package's and against its float64
    version, and its matvec against the scipy CSR Laplacian."""
    import jax.numpy as jnp

    from awesome_tpu.ops.spectral import matting_stencil as jstencil

    img, _ = _two_region_image(20, 27)
    st = S.matting_stencil(torch.as_tensor(img), eps=1e-4)
    ref = np.asarray(jstencil(jnp.asarray(img), eps=1e-4))
    np.testing.assert_allclose(st.numpy(), ref, rtol=1e-5, atol=1e-5)
    st64 = S.matting_stencil(torch.as_tensor(img, dtype=torch.float64),
                             eps=1e-4).numpy()
    assert np.abs(st.numpy() - st64).max() <= np.abs(ref - st64).max()
    lap = TX.matting_laplacian(img.astype(np.float64), eps=1e-4)
    x = np.random.default_rng(3).normal(size=(20, 27, 2)).astype(np.float32)
    y = S.stencil_matvec(st, torch.as_tensor(x)).numpy()
    y_ref = (lap @ x.reshape(-1, 2)).reshape(20, 27, 2)
    np.testing.assert_allclose(y, y_ref, atol=5e-4)


def test_float32_eigensolve_matches_jax():
    """The JAX algorithm in float32: the port's nontrivial subspace and
    each normalized feature against the JAX package's."""
    import jax.numpy as jnp

    from awesome_tpu.ops.spectral import (
        smallest_eigenvectors as jeig,
        spectral_soft_segments_device as jsegs,
    )

    img, _ = _two_region_image()
    st = S.matting_stencil(torch.as_tensor(img), eps=1e-4)
    got = S.smallest_eigenvectors(st, 3, image=torch.as_tensor(img))
    ref = np.asarray(jeig(jnp.asarray(st.numpy()), 3,
                          image=jnp.asarray(img)))
    assert got.dtype == torch.float32 and got.shape == (96, 128, 3)
    assert _cos_largest_angle(got.numpy().reshape(-1, 3)[:, 1:],
                              ref.reshape(-1, 3)[:, 1:]) >= COS_MIN
    f = S.spectral_soft_segments_device(img, 2, device="cpu",
                                        dtype=torch.float32)
    fj = jsegs(img, 2)
    for c in range(2):
        err = min(np.abs(f[..., c] - fj[..., c]).max(),
                  np.abs(f[..., c] - (1 - fj[..., c])).max())
        assert err <= 1e-2, (c, err)


def test_device_solve_reaches_eigsh_and_repeats():
    """The device proxy's default (float64) solve on the scene at 48x64:
    its nontrivial subspace at cos >= 0.999 from float64 eigsh, and two
    calls equal in every bit."""
    img, _ = _two_region_image(48, 64)
    t = torch.as_tensor(img, dtype=torch.float64)
    v = S.smallest_eigenvectors(S.matting_stencil(t, eps=1e-4), 3,
                                image=t).numpy()
    assert _cos_largest_angle(v.reshape(-1, 3)[:, 1:],
                              _eigsh_subspace(img, 3)[:, 1:]) >= COS_MIN
    a = S.spectral_soft_segments_device(img, 2, device="cpu")
    assert a.shape == (48, 64, 2) and a.dtype == np.float32
    assert np.array_equal(a, S.spectral_soft_segments_device(
        img, 2, device="cpu"))


def test_too_small_falls_back_and_counts(monkeypatch):
    """Below LOBPCG's precondition the solve raises its "too small"
    ValueError; the extractor then takes the host path, logs and counts
    it. Any other failure of the device solve propagates."""
    tiny = np.random.default_rng(0).random((5, 5, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="too small"):
        S.spectral_soft_segments_device(tiny, device="cpu")
    ex = TX.SemanticSoftSegmentationExtractor(
        "/nonexistent", proxy="spectral_device", device="cpu")
    np.testing.assert_array_equal(ex.proxy_features(tiny),
                                  TX.spectral_soft_segments(tiny, 2))
    assert ex.fallbacks == 1

    def broken(*a, **k):
        raise RuntimeError("device solve failed")

    monkeypatch.setattr(S, "spectral_soft_segments_device", broken)
    img, _ = _two_region_image(32, 40)
    with pytest.raises(RuntimeError, match="device solve failed"):
        ex.proxy_features(img)
    assert ex.fallbacks == 1
