"""Port parity: the runner's image mode (``dataset_args['dimension'] ==
'3d'``: a conv seg net per image on the dense padded grid) and its xytype
encodings against the JAX package's ``AwesomeRunner``, at a small size (2
images of 16x20 and 20x16, ``CNNNet(width=8, depth=1)``, the prior
``ConvexNextNet(8, 1)``, 20 epochs, ``proper_prior_fit_retrys: 0``).

Tolerances: gate IoUs equal, the training loss history at rtol 2e-4
(``tests/test_fused_fit.py:37``), ``evaluate()``'s metrics at atol 1e-3
(``tests/test_torch_runner.py``), the padded-grid pixels and crops exactly,
the encodings at atol 1e-6. The JAX runner cannot run a UNet in image mode
(its ``_forward_one`` does not pass the batch-norm state), so the UNet's
forward is held to the JAX package's ``UNet.apply`` and prior at rtol
1e-4."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.nn import icnn as JI
from awesome_tpu.nn import seg as JS
from awesome_tpu.runner.config import AwesomeConfig as JConfig
from awesome_tpu.runner.runner import AwesomeRunner as JRunner
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.runner.config import AwesomeConfig
from awesome_tpu_torch.runner.runner import AwesomeRunner
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIST_RTOL = 2e-4
METRIC_ATOL = 1e-3
SHAPES = [[16, 20], [20, 16]]


def _kw(folder, xytype="xy", **kw):
    base = dict(
        name_experiment="image",
        dataset_args={"shapes": SHAPES, "dimension": "3d",
                      "xytype": xytype},
        segmentation_model_type="awesome_tpu.nn.seg.CNNNet",
        segmentation_model_args={"width": 8, "depth": 1},
        prior_model_args={"n_hidden": 8, "n_hidden_layers": 1},
        optimizer_type="adam", optimizer_args={"lr": 1e-3},
        num_epochs=20, compute_metrics_during_training_nth_epoch=10,
        use_extra_penalty_hook=True, extra_penalty_after_n_epochs=10,
        pretrain_args={"num_epochs": 20, "proper_prior_fit_retrys": 0},
        runs_path=str(folder), output_folder=str(folder), seed=5)
    base.update(kw)
    return base


def _pair(folder, **kw):
    jr = JRunner(JConfig(**_kw(folder / "jax", **kw)))
    tr = AwesomeRunner(AwesomeConfig(device="cpu",
                                     **_kw(folder / "port", **kw)))
    jr.build()
    tr.build()
    return jr, tr


def _assert_metrics_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_ATOL, (k, got[k], ref[k])


@pytest.fixture
def one_thread():
    """One intra-op thread for the port's runs: the suite's other workers
    share the cores (the port's results move only by float32 rounding)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX run and one port run from the same params: build ->
    pretrain -> train -> refit (no gate) -> evaluate."""
    jr, tr = _pair(tmp_path_factory.mktemp("image"))
    tr.stacked_params = params_from_jax(
        jax.device_get(jr.stacked_params), "cpu", stacked=1)
    out = {"jr": jr, "tr": tr,
           "batch": {k: (np.asarray(v), tr._batch[k])
                     for k, v in jr._batch.items()}}
    out["pretrain"] = (jr.pretrain(), tr.pretrain())
    out["train"] = (jr.train(), tr.train())
    jr.sequential_prior_fit(num_steps=10, gate_threshold=None)
    tr.sequential_prior_fit(num_steps=10, gate_threshold=None)
    out["refit"] = (jr.evaluate(), tr.evaluate())
    return out


def test_image_runner_matches_jax(runs):
    """Dense tensors equal; gate, loss history, metrics and the refit's
    metrics within the rules above."""
    for k, (a, b) in runs["batch"].items():
        assert np.array_equal(a, b), k
    pj, pt = runs["pretrain"]
    np.testing.assert_array_equal(pt["gate_iou"], pj["gate_iou"])
    rj, rt = runs["train"]
    assert rt["loss_hist"].shape == (2, 20)
    np.testing.assert_allclose(rt["loss_hist"], rj["loss_hist"],
                               rtol=HIST_RTOL)
    _assert_metrics_close(rt["final_metrics"], rj["final_metrics"])
    _assert_metrics_close(runs["refit"][1], runs["refit"][0])


def test_padded_layout_matches_jax(runs):
    """The (Hmax, Wmax) bucket: the padded-grid pixel matrices, the valid
    mask and the crops back to each image's own grid, exactly."""
    jr, tr = runs["jr"], runs["tr"]
    assert tr._shape == jr._shape == (20, 20)
    np.testing.assert_array_equal(tr._eval_pixels(), jr._eval_pixels())
    v0 = tr._batch["valid"][0].reshape(20, 20)
    assert v0[:16, :20].all() and not v0[16:].any()
    outs = np.random.default_rng(0).normal(size=(2, 400, 2)).astype(
        np.float32)
    for i in range(2):
        crop = tr._crop_output(outs, i)
        assert crop.shape == (SHAPES[i][0] * SHAPES[i][1], 2)
        np.testing.assert_array_equal(crop, jr._crop_output(outs, i))


def test_unet_forward_matches_jax(tmp_path):
    """One image-mode forward of a UNet (full width) and the prior through
    the runner's ``_forward_one`` against the JAX package's modules."""
    tr = AwesomeRunner(AwesomeConfig(device="cpu", **_kw(
        tmp_path, segmentation_model_type="awesome_tpu.nn.seg.UNet",
        segmentation_model_args={})))
    tr.build()
    assert tr.seg_stateful and tr._shape == (20, 20)
    jseg = JS.UNet(in_chn=5, out_chn=1)
    jprior = JI.ConvexNextNet(n_hidden=8, n_hidden_layers=1)
    # the port's init, in the JAX layout for the JAX modules
    params = T.tree_select(tr.stacked_params, 1)
    jp, js = (params_to_numpy(t) for t in params["seg"])
    jpr = params_to_numpy(params["prior"])
    px = tr._eval_pixels()[1]
    with torch.no_grad():
        got = tr._forward_one(params, torch.as_tensor(px)).numpy()
    pxj = jnp.asarray(px)

    @jax.jit
    def ref_fn(jp, js, jpr, pxj):
        logits, _ = jseg.apply(jp, js, pxj[:, -3:].reshape(1, 20, 20, 3),
                               pxj[:, :-3].reshape(1, 20, 20, 2),
                               train=False)
        return jnp.concatenate(
            [jax.nn.sigmoid(logits).reshape(-1, 1),
             jax.nn.sigmoid(jprior.apply(jpr, pxj[:, 0:2])).reshape(-1, 1)],
            -1)

    ref = np.asarray(ref_fn(jp, js, jpr, pxj))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_unet_runner_trains_with_per_image_state(tmp_path, one_thread):
    """UNet in image mode through train(): a finite falling loss, and a
    batch-norm state per image that moved once per epoch."""
    tr = AwesomeRunner(AwesomeConfig(device="cpu", **_kw(
        tmp_path, segmentation_model_type="awesome_tpu.nn.seg.UNet",
        segmentation_model_args={}, num_epochs=4,
        compute_metrics_during_training_nth_epoch=None,
        use_extra_penalty_hook=False, do_pretraining=False)))
    tr.build()
    res = tr.train()
    hist = res["loss_hist"]
    assert np.isfinite(hist).all() and (hist[:, -1] < hist[:, 0]).all()
    state = tr.stacked_params["seg"][1]
    assert state["inc"]["bn1"]["count"].tolist() == [4, 4]
    mean = state["inc"]["bn1"]["mean"]
    assert mean.shape[0] == 2 and not torch.equal(mean[0], mean[1])
    for k, v in res["final_metrics"].items():
        assert 0.0 <= v <= 1.0, k


@pytest.mark.parametrize("xytype", ["featxy", "edge", "edgexy"])
def test_encoding_map_matches_jax(tmp_path, xytype, one_thread):
    """``_encoding_map`` (the host spectral proxy for 'featxy', the Sobel
    map for the edge types) and the channels the seg nets get."""
    kw = dict(xytype=xytype, num_epochs=1, do_pretraining=False)
    jr = JRunner(JConfig(**_kw(tmp_path / "jax", **kw)))
    tr = AwesomeRunner(AwesomeConfig(device="cpu",
                                     **_kw(tmp_path / "port", **kw)))
    jr.build_dataset()
    tr.build_dataset()
    for sj, st in zip(jr.samples, tr.samples):
        np.testing.assert_allclose(tr._encoding_map(st),
                                   jr._encoding_map(sj), atol=1e-6)
    enc = AwesomeRunner.XYTYPE_CHANNELS[xytype]
    tr.build()
    assert tr._batch["px"].shape[-1] == enc + 3
    assert tr.wrapper.segmentation_module.in_chn == enc + 3


def test_device_proxy_feeds_the_encoding(tmp_path, one_thread):
    """``sss_proxy: spectral_device`` takes the features from
    ``ops/spectral.py`` on the runner's device, cached per image."""
    from awesome_tpu_torch.ops.spectral import spectral_soft_segments_device

    tr = AwesomeRunner(AwesomeConfig(device="cpu", **_kw(
        tmp_path, xytype="feat", num_epochs=1, do_pretraining=False,
        dataset_args={"shapes": SHAPES[:1], "xytype": "feat",
                      "sss_proxy": "spectral_device"})))
    tr.build_dataset()
    s = tr.samples[0]
    enc = tr._encoding_map(s)
    np.testing.assert_array_equal(
        enc, spectral_soft_segments_device(s.image, 2, device="cpu"))
    assert tr._encoding_map(s) is enc


@pytest.mark.parametrize("seg", ["CNNNet", "UNet"])
def test_conv_seg_in_pixel_mode_raises(tmp_path, seg):
    """A conv seg net needs image mode, as in the JAX runner."""
    kw = _kw(tmp_path, segmentation_model_type=f"awesome_tpu.nn.seg.{seg}",
             dataset_args={"shapes": SHAPES})
    with pytest.raises(ValueError, match="convolutional"):
        AwesomeRunner(AwesomeConfig(device="cpu", **kw)).build()


def _cli(tmp_path, name, dataset_args, seg_args):
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'awesome_tpu', 'tensorflow'):\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['run', '--device', 'cpu', '--num-epochs', '4',\n"
        f"    '--name-experiment', {name!r}, '--runs-path', {str(tmp_path)!r},\n"
        f"    '--dataset-args', {dataset_args!r},\n"
        f"    '--segmentation-model-type', 'awesome_tpu.nn.seg.CNNNet',\n"
        f"    '--segmentation-model-args', {seg_args!r},\n"
        "    '--pretrain-args', '{num_epochs: 5}']\n"
        "runpy.run_module('awesome_tpu_torch.run', run_name='__main__')\n")
    # one intra-op thread: the suite's other workers share the cores
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)


def test_cli_runs_image_mode_and_featxy(tmp_path):
    """``python -m awesome_tpu_torch.run --device cpu`` with a '3d'
    config whose xytype is 'featxy', ``jax`` and ``awesome_tpu``
    blocked."""
    res = _cli(tmp_path, "img3d",
               "{shapes: [[16, 20], [20, 16]], dimension: 3d, "
               "xytype: featxy}", "{width: 8, depth: 1}")
    assert res.returncode == 0, res.stderr[-3000:]
    runs = [d for d in os.listdir(tmp_path) if d.endswith("_img3d")]
    assert len(runs) == 1
    for name in ("config.yaml", "tracker.json", "params.npz"):
        assert os.path.exists(os.path.join(tmp_path, runs[0], name))
