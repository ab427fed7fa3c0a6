"""On the card: the runner's image mode with the fused ICNN prior (K4 and
K5 once each per training epoch for all images), and the device spectral
solve of the 'spectral_device' SSS proxy (``ops/spectral.py``): its
nontrivial eigenvectors at cos >= 0.999 (largest principal angle) from
float64 ``eigsh`` on the same stencil operator, two calls equal in every
bit, and no fallback to the host.

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_paper_table_gpu.py``.
Without a card its tests skip."""
import numpy as np
import pytest
import torch

from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.ops import mlp
from awesome_tpu_torch.ops import spectral as S
from awesome_tpu_torch.runner import sss_extractor as X
from awesome_tpu_torch.runner.config import AwesomeConfig
from awesome_tpu_torch.runner.runner import AwesomeRunner
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _two_region_image(h=96, w=128, noise=0.03, seed=0):
    """The two-region scene of ``tests/test_sss.py``."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[...] = [0.2, 0.3, 0.8]
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((yy - h // 2) ** 2 / 900 + (xx - w // 2) ** 2 / 1600) < 1.0
    img[blob] = [0.8, 0.5, 0.1]
    img += rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


@pytest.mark.gpu
def test_image_runner_launches_k4_k5_once_per_epoch(tmp_path, cuda_device):
    epochs = 10
    runner = AwesomeRunner(AwesomeConfig(
        name_experiment="gpu_image", device=cuda_device,
        dataset_args={"shapes": [[40, 48], [48, 56], [44, 52]],
                      "dimension": "3d"},
        segmentation_model_type="awesome_tpu_torch.nn.seg.CNNNet",
        prior_model_type="awesome_tpu_torch.ops.mlp.FullyFusedConvexNextNet",
        prior_model_args={"base": ConvexNextNet(n_hidden=64,
                                                device=cuda_device)},
        optimizer_args={"lr": 1e-3}, num_epochs=epochs,
        compute_metrics_during_training_nth_epoch=None,
        validation_each_nth_epoch=None, do_pretraining=False,
        runs_path=str(tmp_path), output_folder=str(tmp_path), seed=2))
    runner.build()
    k4, k5 = mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches
    res = runner.train()
    # K4 once more for the final evaluation
    assert mlp.icnn_backward_cuda.launches - k5 == epochs
    assert mlp.icnn_forward_cuda.launches - k4 == epochs + 1
    assert np.isfinite(res["loss_hist"]).all()


def _csr(stencil: np.ndarray):
    from scipy import sparse

    h, w = stencil.shape[:2]
    idx = np.arange(h * w).reshape(h, w)
    rows, cols, vals = [], [], []
    for dy in range(5):
        for dx in range(5):
            oy, ox = dy - 2, dx - 2
            y0, y1 = max(0, -oy), min(h, h - oy)
            x0, x1 = max(0, -ox), min(w, w - ox)
            rows.append(idx[y0:y1, x0:x1].ravel())
            cols.append(idx[y0 + oy:y1 + oy, x0 + ox:x1 + ox].ravel())
            vals.append(stencil[y0:y1, x0:x1, dy, dx].ravel())
    return sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                     np.concatenate(cols))),
                             shape=(h * w, h * w))


@pytest.mark.gpu
def test_device_solve_matches_eigsh_and_repeats(cuda_device):
    from scipy.sparse.linalg import eigsh

    img = _two_region_image()
    t = torch.as_tensor(img, dtype=torch.float64, device=cuda_device)
    stencil = S.matting_stencil(t, eps=1e-4)
    vecs = S.smallest_eigenvectors(stencil, 3, image=t)
    assert vecs.device.type == "cuda"
    assert torch.equal(vecs, S.smallest_eigenvectors(stencil, 3, image=t))
    lap = _csr(stencil.cpu().numpy())
    n = lap.shape[0]
    ref = eigsh(lap, k=3, sigma=0, which="LM",
                v0=np.full(n, 1 / np.sqrt(n)))[1][:, 1:]
    qa, _ = np.linalg.qr(vecs.cpu().numpy().reshape(n, 3)[:, 1:])
    qb, _ = np.linalg.qr(ref)
    assert np.linalg.svd(qa.T @ qb, compute_uv=False).min() >= 0.999


@pytest.mark.gpu
def test_device_proxy_never_falls_back(cuda_device):
    ex = X.SemanticSoftSegmentationExtractor(
        "/nonexistent", proxy="spectral_device", device=cuda_device)
    img = _two_region_image(48, 64)
    a, b = ex.proxy_features(img), ex.proxy_features(img)
    assert a.shape == (48, 64, 2) and np.array_equal(a, b)
    assert ex.fallbacks == 0
