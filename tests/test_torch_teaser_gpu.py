"""On the card: the teaser harness (``awesome_tpu_torch/runner/teaser.py``).
``minibatch_fit`` on the card against the CPU with the same draws, its
draws from a generator on the card, the skip of a non-finite step there,
and the convex tomato protocol on a synthetic reference tree
(``tools/teaser_tree.py``).

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_teaser_gpu.py``.
Without a card its tests skip."""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from awesome_tpu_torch.nn.priors_extra import RotationSymmetricNet
from awesome_tpu_torch.runner import teaser as TT
from tools.teaser_tree import write_tree
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_minibatch_fit_card_matches_cpu(cuda_device):
    """ConvexNextNet(150) with 2000 points a class a step, 30 steps:
    loss histories within rtol 2e-4 step by step."""
    res = chip_smoke.teaser_fit_card_vs_cpu(cuda_device, steps=30)
    assert res["max_rel_diff"] <= chip_smoke.TEASER_FIT_RTOL, res


@pytest.mark.gpu
def test_minibatch_fit_draws_on_the_card(cuda_device):
    pts = TT.centered_points(24, 32, cuda_device)
    model = RotationSymmetricNet(n_hidden=16, device=cuda_device)
    params = model.init(torch.Generator().manual_seed(0))
    i0, i1 = TT._draw_indices(torch.Generator(device=cuda_device), 5, 7,
                              10, 20)
    assert i0.device.type == i1.device.type == "cuda"
    fitted, hist = TT.minibatch_fit(model, params, pts[:300] + 0.01,
                                    pts[300:] + 0.01, steps=20, n_sample=64,
                                    lr=1e-3, coef0=2.0)
    assert hist.device.type == "cuda" and hist.shape == (20,)
    assert torch.isfinite(hist).all()
    assert not torch.equal(fitted["W2"]["w"], params["W2"]["w"])


@pytest.mark.gpu
def test_minibatch_fit_skips_a_nonfinite_step_on_the_card(cuda_device,
                                                           monkeypatch):
    """A batch holding the symmetry prior's offset gives NaN grads: the
    step leaves the params as they were, bit for bit."""
    model = RotationSymmetricNet(n_hidden=16, device=cuda_device)
    params = model.init(torch.Generator().manual_seed(0))
    monkeypatch.setattr(TT, "_draw_indices", lambda gen, *a: (
        torch.zeros((1, 2), dtype=torch.int64, device=gen.device),
        torch.arange(2, device=gen.device)[None]))
    fitted, _ = TT.minibatch_fit(
        model, params, torch.zeros((1, 2), device=cuda_device),
        torch.full((4, 2), 0.3, device=cuda_device), steps=1, n_sample=2,
        lr=1e-2)
    for k in params:
        a, b = fitted[k], params[k]
        if isinstance(a, dict):
            assert all(torch.equal(a[j], b[j]) for j in a), k
        else:
            assert torch.equal(a, b), k


@pytest.mark.gpu
def test_convex_tomato_on_a_synthetic_tree(cuda_device, tmp_path,
                                           monkeypatch):
    """The protocol at its 700 steps on a 120x160 tree: a finite loss,
    the reference's shape, and the convex mask beats the naive one."""
    root = str(tmp_path)
    write_tree(root, 120, 160, frame_shape=(30, 40))
    monkeypatch.setattr(TT, "TEASER_DIR", os.path.join(
        root, "notebooks", "icml_teaser_code"))
    monkeypatch.setattr(TT, "HOWTO_DIR", os.path.join(
        root, "notebooks", "how_to", "data"))
    r = TT.run_convex_tomato(device=cuda_device)
    assert np.isfinite(r.extra["loss"])
    assert r.mask.shape == r.ref_mask.shape == (120, 160)
    assert r.iou > r.extra["naive_iou"], (r.iou, r.extra)
