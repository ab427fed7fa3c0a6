"""Port parity: the dense CRF of awesome_tpu_torch (``ops/crf.py``) and its
exact permutohedral counterpart (``ops/permutohedral.py``, built from
``native/permutohedral.cpp`` into ``build/``) against the JAX package on
the same numpy-seeded inputs.

Tolerances: the refined probabilities at atol 1e-4, the thresholded masks
equal wherever the JAX package's probability is more than 1e-4 from 0.5;
the batched route against the port's own static-sigma oracle
``_mean_field`` at the JAX test's atol 2e-3 (``tests/test_crf.py``); the
permutohedral filter and CRF against the JAX package's binding at rtol
1e-5 of the largest value (the tracked library of the JAX package is
built with ``-march=native``, the port's with portable flags, so the two
may round differently)."""
import numpy as np
import pytest
import torch

from awesome_tpu.data.synthetic import make_sample
from awesome_tpu.ops import crf as JC
from awesome_tpu.ops import permutohedral as JPH
from awesome_tpu_torch.ops import crf as TC
from awesome_tpu_torch.ops import permutohedral as TPH
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
PROB_ATOL = 1e-4
ORACLE_ATOL = 2e-3


def _options(pkg, **kw):
    return pkg.CRFOptions(**kw)


def _assert_refined_close(got, ref):
    np.testing.assert_allclose(got, ref, atol=PROB_ATOL)
    sure = np.abs(ref - 0.5) > 1e-4
    np.testing.assert_array_equal((got > 0.5)[sure], (ref > 0.5)[sure])


@pytest.fixture(scope="module")
def batch():
    samples = [make_sample(i, 24, 32) for i in range(3)]
    imgs = np.stack([s.image for s in samples])
    rng = np.random.default_rng(0)
    unaries = np.stack([
        np.clip(s.gt + rng.normal(0, 0.2, s.gt.shape), 0, 1)
        for s in samples]).astype(np.float32)
    return imgs, unaries


def _scene(h=48, w=48):
    img = np.zeros((h, w, 3), np.float32) + 0.1
    obj = np.zeros((h, w), bool)
    obj[12:36, 12:36] = True
    img[obj] = 0.9
    return img, obj


def test_batched_matches_jax(batch):
    imgs, unaries = batch
    ref = JC.dense_crf_batched(imgs, unaries,
                               options=_options(JC, max_iterations=5))
    got = TC.dense_crf_batched(imgs, unaries, device=CPU,
                               options=_options(TC, max_iterations=5))
    assert got.shape == ref.shape == (3, 24, 32, 1)
    _assert_refined_close(got, ref)
    # uint8 images and tensor inputs take the same route
    u8 = (imgs * 255).astype(np.uint8)
    ref8 = JC.dense_crf_batched(u8, unaries,
                                options=_options(JC, max_iterations=5))
    got8 = TC.dense_crf_batched(torch.tensor(u8), torch.tensor(unaries),
                                device=CPU,
                                options=_options(TC, max_iterations=5))
    _assert_refined_close(got8, ref8)


def test_per_image_matches_jax_and_the_oracle(batch):
    """``dense_crf`` per image against the JAX package's, and the batched
    route against the port's own static-sigma oracle ``_mean_field``."""
    imgs, unaries = batch
    topts, jopts = _options(TC, max_iterations=5), _options(JC,
                                                            max_iterations=5)
    batched = TC.dense_crf_batched(imgs, unaries, device=CPU, options=topts)
    for i in range(len(imgs)):
        solo = TC.dense_crf(imgs[i], unaries[i], device=CPU, options=topts)
        _assert_refined_close(solo, JC.dense_crf(imgs[i], unaries[i],
                                                 options=jopts))
        np.testing.assert_allclose(batched[i], solo, atol=1e-6)
        img255 = (np.clip(imgs[i], 0, 1) * 255.0).astype(np.float32)
        u2 = np.stack([unaries[i], 1.0 - unaries[i]], axis=-1)
        flat, dims, blur = TC._bilateral_grid_assignment(img255, topts)
        oracle = TC._mean_field(torch.tensor(u2), flat, dims, blur,
                                topts).numpy()[..., 0:1]
        np.testing.assert_allclose(solo, oracle, atol=ORACLE_ATOL)
        assert ((solo > 0.5) == (oracle > 0.5)).all()


def test_channel_first_and_multiclass_match_jax():
    img, obj = _scene(32, 32)
    probs = np.where(obj, 0.9, 0.1).astype(np.float32)
    opts = dict(max_iterations=2)
    got = TC.dense_crf(img.transpose(2, 0, 1), probs[None], device=CPU,
                       options=_options(TC, **opts))
    _assert_refined_close(got, JC.dense_crf(img.transpose(2, 0, 1),
                                            probs[None],
                                            options=_options(JC, **opts)))
    np.testing.assert_allclose(
        got, TC.dense_crf(img, probs[..., None], device=CPU,
                          options=_options(TC, **opts)), atol=1e-6)
    three = np.stack([np.where(obj, 0.8, 0.1), np.where(obj, 0.1, 0.8),
                      np.full(obj.shape, 0.1)], axis=-1).astype(np.float32)
    got = TC.dense_crf(img, three, device=CPU,
                       options=_options(TC, max_iterations=3))
    assert got.shape == (32, 32, 3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        got, JC.dense_crf(img, three, options=_options(JC, max_iterations=3)),
        atol=PROB_ATOL)
    gray = TC.dense_crf(img[..., 0], probs, device=CPU,
                        options=_options(TC, **opts))
    _assert_refined_close(gray, JC.dense_crf(img[..., 0], probs,
                                             options=_options(JC, **opts)))


def test_empty_batch_and_logits_rejected():
    out = TC.dense_crf_batched(np.zeros((0, 8, 8, 3), np.float32),
                               np.zeros((0, 8, 8), np.float32), device=CPU)
    assert out.shape == (0, 8, 8, 2)
    for fn, args in ((TC.dense_crf_batched, (np.zeros((1, 8, 8, 3)),
                                             np.zeros((1, 8, 8)))),
                     (TC.dense_crf, (np.zeros((8, 8, 3)), np.zeros((8, 8))))):
        with pytest.raises(NotImplementedError, match="is_softmax_unaries"):
            fn(*args, is_softmax_unaries=False, device=CPU)


def test_crf_denoises_and_respects_color_edges():
    """Mirrors of ``tests/test_crf.py``'s behaviour checks."""
    img, obj = _scene()
    rng = np.random.default_rng(0)
    probs = np.where(obj, 0.9, 0.1).astype(np.float32)
    probs = np.where(rng.random(obj.shape) < 0.1, 1.0 - probs, probs)
    out = TC.dense_crf(img, probs[..., None], device=CPU, options=_options(
        TC, max_iterations=5, bilateral_sdims=(10, 10)))[..., 0]
    base_err = ((probs > 0.5) != obj).mean()
    crf_err = ((out > 0.5) != obj).mean()
    assert crf_err < base_err and crf_err < 0.02
    band = np.where(obj, 0.85, 0.15).astype(np.float32)
    band[:, 30:42] = 0.5
    out = TC.dense_crf(img, band[..., None], device=CPU, options=_options(
        TC, max_iterations=10, bilateral_sdims=(20, 20),
        bilateral_compat=10.0))[..., 0] > 0.5
    assert out[16:32, 31:35].mean() > 0.9
    assert out[16:32, 37:41].mean() < 0.1


def test_two_calls_bitwise_equal(batch):
    imgs, unaries = batch
    opts = _options(TC, max_iterations=3)
    a = TC.dense_crf_batched(imgs, unaries, device=CPU, options=opts)
    b = TC.dense_crf_batched(imgs, unaries, device=CPU, options=opts)
    assert np.array_equal(a, b)


# --- the exact permutohedral CRF -------------------------------------------


def test_permutohedral_built_from_source():
    path = TPH.build()
    assert path.parent.name == "awesome_tpu_torch"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("libpermutohedral-")
    assert TPH.build() == path  # reused


def test_ph_filter_matches_jax():
    rng = np.random.default_rng(3)
    features = rng.uniform(0, 4, size=(300, 5)).astype(np.float32)
    values = rng.uniform(size=(300, 2)).astype(np.float32)
    ref = JPH.ph_filter(features, values)
    got = TPH.ph_filter(features, values)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_dense_crf_exact_matches_jax_and_agrees_with_the_grid_crf():
    """The clean 40x40 scene of ``tests/test_permutohedral.py``: the exact
    CRF against the JAX package's binding, and the port's bilateral-grid
    CRF against the exact one (labels agree above 0.97)."""
    rng = np.random.default_rng(11)
    h = w = 40
    img = np.zeros((h, w, 3), np.float32) + 0.1
    obj = np.zeros((h, w), bool)
    obj[10:30, 10:30] = True
    img[obj] = 0.9
    probs2 = np.where(obj, 0.8, 0.2).astype(np.float32)
    probs2 = np.where(rng.random(obj.shape) < 0.08, 1.0 - probs2, probs2)
    probs = np.stack([probs2, 1 - probs2], -1)
    kw = dict(gaussian_sdims=(3, 3), bilateral_sdims=(10, 10), iterations=5)
    exact = TPH.dense_crf_exact(img, probs, **kw)
    ref = JPH.dense_crf_exact(img, probs, **kw)
    np.testing.assert_allclose(exact, ref, rtol=1e-5, atol=1e-5)
    grid = TC.dense_crf(img, probs2[..., None], device=CPU, options=_options(
        TC, max_iterations=5, gaussian_sdims=(3, 3),
        bilateral_sdims=(10, 10)))[..., 0]
    assert ((exact[..., 0] > 0.5) == (grid > 0.5)).mean() > 0.97
