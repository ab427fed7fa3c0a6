"""On the card: the convexity runner (``runner/runner.py``) at test size,
its K4/K5 launches counted, its loss history against the same run on the
CPU (rtol 2e-4, ``tests/test_fused_fit.py:37``), and a bitwise resume.

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_runner_gpu.py``.
Without a card its tests skip."""
import os

import numpy as np
import pytest
import torch

from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.ops import mlp
from awesome_tpu_torch.runner.config import AwesomeConfig
from awesome_tpu_torch.runner.runner import AwesomeRunner
from torch_one_thread import one_torch_thread  # noqa: F401

HIST_RTOL = 2e-4


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _config(folder, device, **kw):
    base = dict(
        name_experiment="gpu_runner", device=device,
        dataset_args={"shapes": [[24, 32], [28, 36], [32, 40]]},
        segmentation_model_args={"n_hidden": 32},
        prior_model_type="awesome_tpu_torch.ops.mlp.FullyFusedConvexNextNet",
        prior_model_args={"base": ConvexNextNet(n_hidden=130,
                                                device=device)},
        optimizer_type="adam", optimizer_args={"lr": 0.02},
        num_epochs=40, compute_metrics_during_training_nth_epoch=20,
        use_extra_penalty_hook=True, extra_penalty_after_n_epochs=30,
        pretrain_args={"num_epochs": 50, "proper_prior_fit_retrys": 0},
        runs_path=str(folder), output_folder=str(folder), seed=4)
    base.update(kw)
    return AwesomeConfig(**base)


def _run(folder, device):
    runner = AwesomeRunner(_config(folder, device))
    runner.build()
    if device == "cuda":  # the CPU run's initial params, on the card
        cpu = AwesomeRunner(_config(str(folder) + "_init", "cpu"))
        cpu.build()
        runner.stacked_params = TT.to_device(cpu.stacked_params, device)
    pre = runner.pretrain()
    k4, k5 = mlp.icnn_forward_cuda.launches, mlp.icnn_backward_cuda.launches
    res = runner.train()
    return runner, pre, res, (mlp.icnn_forward_cuda.launches - k4,
                              mlp.icnn_backward_cuda.launches - k5)


@pytest.mark.gpu
def test_runner_on_card_matches_cpu(cuda_device, tmp_path):
    """One K5 launch per training epoch for all images, one K4 per epoch
    and per evaluation; the loss history and eval metrics as on the
    CPU."""
    gpu, pre_g, res_g, (k4, k5) = _run(tmp_path / "gpu", cuda_device)
    cpu, pre_c, res_c, _ = _run(tmp_path / "cpu", "cpu")
    evals = len(gpu.tracker.series[("MeanForegroundBinaryMIOU", "epoch",
                                    "eval")].values)
    assert k5 == 40 and k4 == 40 + evals, (k4, k5, evals)
    np.testing.assert_array_equal(pre_g["gate_iou"], pre_c["gate_iou"])
    np.testing.assert_allclose(res_g["loss_hist"], res_c["loss_hist"],
                               rtol=HIST_RTOL)
    for k, v in res_c["final_metrics"].items():
        assert abs(res_g["final_metrics"][k] - v) <= 1e-3, k


@pytest.mark.gpu
def test_runner_resumes_bitwise_on_card(cuda_device, tmp_path):
    kw = dict(do_pretraining=False)
    full = AwesomeRunner(_config(tmp_path / "full", cuda_device, **kw))
    full.build()
    res_full = full.train()
    part = AwesomeRunner(_config(tmp_path / "part", cuda_device,
                                 num_epochs=20, **kw))
    part.build()
    part.train()
    resumed = AwesomeRunner(_config(tmp_path / "part", cuda_device,
                                    resume=True, **kw))
    resumed.build()
    res = resumed.train()
    assert os.path.isdir(os.path.join(tmp_path, "part", "checkpoints",
                                      "end"))
    for a, b in zip(TT.tree_leaves(full.stacked_params),
                    TT.tree_leaves(resumed.stacked_params)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(res_full["loss_hist"][:, -20:],
                                  res["loss_hist"])
