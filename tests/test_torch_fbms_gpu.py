"""On the card: the FBMS runner (``runner/fbms_runner.py``) on a 4-frame
64x64 synthetic sequence with the bench prior (flow 32 x 12, ICNN 130 x
2, ``FBMSExperimentConfig``'s defaults). ``pretrain_joint_priors`` takes
the fused flagship kernel (K1) once per step, and its cold fit's loss
history agrees with the same pretrain with ``fused=False`` on the card
(rtol 2e-4, ``tests/test_fused_fit.py:37``); a joint run stopped after
epoch 1 and resumed to epoch 3 equals the uninterrupted run bitwise.

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_fbms_gpu.py``.
Without a card its tests skip."""
import numpy as np
import pytest
import torch

from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.data.synthetic import write_synthetic_fbms_sequence
from awesome_tpu_torch.fit import prior_fit
from awesome_tpu_torch.ops.flagship import flagship_loss_grad_cuda
from awesome_tpu_torch.runner.fbms_runner import (
    FBMSExperimentConfig,
    FBMSRunner,
)
from torch_one_thread import one_torch_thread  # noqa: F401

HIST_RTOL = 2e-4
COLD, WARM, FRAMES = 100, 40, 4


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def seq(tmp_path):
    return write_synthetic_fbms_sequence(str(tmp_path), n_frames=FRAMES,
                                         h=64, w=64)


def _runner(seq, device):
    return FBMSRunner(FBMSExperimentConfig(dataset_path=seq),
                      device=device).build()


def _pretrain(runner, monkeypatch, **kw):
    """``pretrain_joint_priors`` with the cold fit's loss history kept."""
    seen = {}
    real = prior_fit.fit_priors_sequential

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        seen["hist"] = out[1]["first_aux"]["loss_hist"].cpu().numpy()
        return out

    monkeypatch.setattr(prior_fit, "fit_priors_sequential", keep)
    res = runner.pretrain_joint_priors(num_steps=COLD,
                                       reuse_state_steps=WARM, lr=1e-3,
                                       seed=1, **kw)
    return res, seen["hist"]


@pytest.mark.gpu
def test_pretrain_takes_k1_once_per_step(cuda_device, seq, monkeypatch):
    runner = _runner(seq, cuda_device)
    before = flagship_loss_grad_cuda.launches
    steps = prior_fit.run_fit_loop.steps
    res, hist = _pretrain(runner, monkeypatch)  # fused=None: the card's K1
    torch.cuda.synchronize()
    launches = flagship_loss_grad_cuda.launches - before
    assert launches == prior_fit.run_fit_loop.steps - steps
    assert launches == COLD + (FRAMES - 1) * WARM
    fused_prior = runner.joint_prior_init
    plain_res, plain_hist = _pretrain(runner, monkeypatch, fused=False)
    assert flagship_loss_grad_cuda.launches - before == launches
    assert hist.shape == plain_hist.shape == (COLD,)
    assert np.isfinite(hist).all() and hist[-1] < hist[0]
    np.testing.assert_allclose(hist, plain_hist, rtol=HIST_RTOL)
    np.testing.assert_allclose(res["cold_loss"], plain_res["cold_loss"],
                               rtol=HIST_RTOL)
    assert TT.tree_leaves(fused_prior)[0].shape[0] == FRAMES


@pytest.mark.gpu
def test_joint_resume_is_bitwise_on_the_card(cuda_device, seq, tmp_path):
    kw = dict(batch_size=2, lr=1e-3, prior_lr=1e-3, eval_nth_epoch=1,
              scheduler={"type": "step", "gamma": 0.5, "step_size": 2})

    def run(epochs, **extra):
        r = _runner(seq, cuda_device)
        return r, r.train_joint(num_epochs=epochs, **kw, **extra)

    full, res_full = run(3)
    ck = str(tmp_path / "ck")
    run(1, checkpoint_dir=ck)
    resumed, res = run(3, checkpoint_dir=ck, resume=True)
    assert res["loss"] == res_full["loss"][2:]  # 2 batches per epoch
    assert np.isfinite(res_full["loss"]).all()
    for a, b in zip(TT.tree_leaves(tuple(full.joint_state)),
                    TT.tree_leaves(tuple(resumed.joint_state)),
                    strict=True):
        if a is None:
            assert b is None
            continue
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    m = resumed.evaluate_joint()
    assert m["num_gt_frames"] == 2
    for k in ("MeanForegroundBinaryMIOU", "PriorMeanForegroundBinaryMIOU"):
        assert 0.0 <= m[k] <= 1.0
