"""On the card: the convex-diffeomorphism prior through the fused ICNN
kernels (K4/K5, the flow trained through K5's input gradient) against the
same prior with a plain ``ConvexNextNet``; the dense CRF repeating bitwise
and agreeing with the CRF on the CPU; the permutohedral library built from
source.

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_priors_gpu.py``.
Without a card its tests skip."""
import numpy as np
import pytest
import torch

import chip_smoke
from awesome_tpu_torch.ops import crf as TC
from awesome_tpu_torch.ops import permutohedral as PH
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_convex_diffeo_grads_through_k4_k5_match_plain(cuda_device):
    """G = 8 images with their own points (4097 each), the prior's fit
    loss: one K4 and one K5 launch for the vmapped grad; every leaf (the
    flow's and the linear layer's through K5's dx among them) at rtol
    5e-4, atol 1e-6 of the leaf's largest grad, or, element by element,
    within twice the plain version's own error against float64."""
    res = chip_smoke.convex_diffeo_grads_vs_plain(cuda_device, g=8, n=4097,
                                                  seed=3)
    assert res["launches"] == {"K4": 1, "K5": 1}
    assert res["beyond_float64_rule"] == 0, res


@pytest.mark.gpu
def test_crf_repeats_bitwise_and_matches_cpu(cuda_device):
    imgs, unaries = chip_smoke.crf_frames(3, 96, 128, 0)
    opts = TC.CRFOptions(max_iterations=5)
    a = TC.dense_crf_batched(imgs, unaries, options=opts)
    b = TC.dense_crf_batched(imgs, unaries, options=opts)
    assert np.array_equal(a, b)
    torch.use_deterministic_algorithms(True)
    try:
        c = TC.dense_crf_batched(imgs, unaries, options=opts)
    finally:
        torch.use_deterministic_algorithms(False)
    assert np.array_equal(a, c)
    cpu = TC.dense_crf_batched(imgs, unaries, options=opts, device="cpu")
    np.testing.assert_allclose(a, cpu, atol=1e-4)


@pytest.mark.gpu
def test_permutohedral_built_from_source(cuda_device):
    """g++ on the card's machine builds ``native/permutohedral.cpp`` into
    ``build/``; the filter is proportional to the brute-force Gaussian
    filter, and the exact CRF denoises."""
    path = PH.build()
    assert path.parent.parent.name == "build"
    rng = np.random.default_rng(0)
    features = rng.uniform(0, 4, size=(200, 3)).astype(np.float32)
    values = rng.uniform(size=(200, 2)).astype(np.float32)
    d2 = ((features[:, None] - features[None]) ** 2).sum(-1)
    exact = np.exp(-d2 / 2.0) @ values
    approx = PH.ph_filter(features, values)
    for c in range(2):
        assert np.corrcoef(exact[:, c], approx[:, c])[0, 1] > 0.99
    res = chip_smoke.crf_agreement()
    assert res["label_agreement"] > 0.97, res
