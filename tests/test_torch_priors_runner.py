"""Port parity: the convexity runner of awesome_tpu_torch with the
convex-diffeomorphism prior and the CRF flags, against the JAX package's
``AwesomeRunner`` on the same config and bridged params, at the size of
``tests/test_torch_runner.py`` (2 images of 24x24, ``Net(n_hidden=16)``,
30 epochs), the prior a ``NormalizingFlow1D`` of 2 couplings of width 8
in front of ``FullyFusedConvexNextNet(ConvexNextNet(8, 1))`` (on the CPU
the fused ICNN runs its plain version in both packages).

Tolerances (``tests/test_torch_runner.py:31-32``): gate IoUs equal, the
training loss history at rtol 2e-4, ``evaluate()``'s metrics, the CRF's
among them, at atol 1e-3. One JAX run serves every parity case."""
import jax
import numpy as np
import pytest
import torch

from awesome_tpu.nn.flows import NormalizingFlow1D as JNF
from awesome_tpu.nn.icnn import ConvexNextNet as JConvexNextNet
from awesome_tpu.ops.pallas_mlp import FullyFusedConvexNextNet as JFused
from awesome_tpu.runner import functions as JFn
from awesome_tpu.runner.config import AwesomeConfig as JConfig
from awesome_tpu.runner.runner import AwesomeRunner as JRunner
from awesome_tpu_torch.bridge import params_from_jax
from awesome_tpu_torch.nn.convex_diffeo import ConvexDiffeomorphismNet
from awesome_tpu_torch.nn.flows import NormalizingFlow1D
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.ops import crf as TC
from awesome_tpu_torch.ops.mlp import FullyFusedConvexNextNet
from awesome_tpu_torch.runner import functions as TFn
from awesome_tpu_torch.runner.config import AwesomeConfig
from awesome_tpu_torch.runner.runner import AwesomeRunner
from torch_one_thread import one_torch_thread  # noqa: F401

HIST_RTOL = 2e-4
METRIC_ATOL = 1e-3
CRF = "CRFMeanForegroundBinaryMIOU"
PRIOR = "nn.convex_diffeo.ConvexDiffeomorphismNet"


def _kw(folder, **kw):
    base = dict(
        name_experiment="priors_runner",
        dataset_args={"n": 2, "h": 24, "w": 24},
        segmentation_model_args={"n_hidden": 16},
        optimizer_type="adam",
        optimizer_args={"lr": 0.02},
        num_epochs=30,
        compute_metrics_during_training_nth_epoch=10,
        use_extra_penalty_hook=True,
        extra_penalty_after_n_epochs=20,
        compute_crf_with_metrics=True,
        compute_crf_after_training=True,
        pretrain_args={"num_epochs": 30, "proper_prior_fit_retrys": 0},
        runs_path=str(folder),
        output_folder=str(folder),
        seed=5,
    )
    base.update(kw)
    return base


def _jax_runner(folder, **kw):
    return JRunner(JConfig(
        prior_model_type="awesome_tpu." + PRIOR,
        prior_model_args={"flow": JNF(num_coupling=2, width=8),
                          "convex": JFused(JConvexNextNet(n_hidden=8))},
        **_kw(folder, **kw)))


def _port_runner(folder, **kw):
    return AwesomeRunner(AwesomeConfig(
        prior_model_type="awesome_tpu_torch." + PRIOR,
        prior_model_args={
            "flow": NormalizingFlow1D(num_coupling=2, width=8, device="cpu"),
            "convex": FullyFusedConvexNextNet(ConvexNextNet(n_hidden=8,
                                                            device="cpu"))},
        device="cpu", **_kw(folder, **kw)))


def _bridge(jr, tr):
    tr.stacked_params = params_from_jax(jax.device_get(jr.stacked_params),
                                        "cpu", stacked=1)


def _assert_metrics_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_ATOL, (k, got[k], ref[k])


@pytest.fixture
def one_thread():
    """One intra-op thread for the port-only runs: the suite's other
    workers share the cores (each run is held to itself, so the thread
    count cannot change what it checks)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("priors_runner")
    jr, tr = _jax_runner(root / "jax"), _port_runner(root / "port")
    jr.build()
    tr.build()
    _bridge(jr, tr)
    out = {"jr": jr, "tr": tr, "pj": jr.pretrain(), "pt": tr.pretrain()}
    out["rj"], out["rt"] = jr.train(), tr.train()
    jr.sequential_prior_fit(num_steps=20, gate_threshold=None)
    tr.sequential_prior_fit(num_steps=20, gate_threshold=None)
    out["ej"], out["et"] = jr.evaluate(), tr.evaluate()
    return out


def test_convex_diffeo_runner_matches_jax(runs):
    """build -> pretrain (gate) -> train with CRF-refined metrics at each
    evaluation -> evaluate with the CRF after training -> refit ->
    evaluate (the config's ``compute_crf_with_metrics``)."""
    tr, jr = runs["tr"], runs["jr"]
    assert isinstance(tr.wrapper.prior_module, ConvexDiffeomorphismNet)
    np.testing.assert_array_equal(runs["pt"]["gate_iou"],
                                  runs["pj"]["gate_iou"])
    np.testing.assert_allclose(runs["rt"]["loss_hist"],
                               runs["rj"]["loss_hist"], rtol=HIST_RTOL)
    final = runs["rt"]["final_metrics"]
    assert CRF in final and f"train/{CRF}" not in final
    _assert_metrics_close(final, runs["rj"]["final_metrics"])
    _assert_metrics_close(runs["et"], runs["ej"])
    key = (CRF, "epoch", "eval")
    assert tr.tracker.series[key].steps == jr.tracker.series[key].steps
    np.testing.assert_allclose(tr.tracker.series[key].values,
                               jr.tracker.series[key].values,
                               atol=METRIC_ATOL)


def test_evaluate_crf_per_image_shapes_matches_jax(tmp_path):
    """Images of different shapes take the per-image CRF call: the port's
    CRF metrics, per image and over the train/val split, against the JAX
    package's ``dense_crf`` on the same seg outputs."""
    from awesome_tpu.measures.metrics import iou_np
    from awesome_tpu.ops.crf import dense_crf

    tr = _port_runner(tmp_path, do_pretraining=False, dataset_args={
        "shapes": [[24, 24], [20, 28], [24, 24]], "split_ratio": 0.67})
    tr.build()
    got = tr.evaluate(compute_crf=True)
    outputs = tr._forward_all()
    ious = []
    for i, s in enumerate(tr.samples):
        seg = tr._crop_output(outputs, i)[:, 0].reshape(s.shape)
        refined = dense_crf(s.image, seg, is_softmax_unaries=True)
        ious.append(iou_np(refined[..., 0].reshape(-1, 1) > 0.5,
                           s.gt.reshape(-1, 1) > 0.5, invert=True))
    ious = np.asarray(ious)
    assert tr.val_indices and len({s.shape for s in tr.samples}) == 2
    for key, idx in ((CRF, range(3)), (f"train/{CRF}", tr.train_indices),
                     (f"val/{CRF}", tr.val_indices)):
        assert abs(got[key] - ious[list(idx)].mean()) <= METRIC_ATOL, key


@pytest.mark.parametrize("flag", ["compute_crf_with_metrics",
                                  "compute_crf_after_training",
                                  "compute_crf_after_pretraining"])
def test_crf_flags_reach_the_crf(tmp_path, monkeypatch, one_thread, flag):
    """Each flag builds and refines with the CRF where the JAX runner
    does: after the pretrain, at every evaluation, or after training."""
    calls = []
    real = TC.dense_crf_batched

    def spy(*args, **kwargs):
        calls.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(TC, "dense_crf_batched", spy)
    flags = {f: f == flag for f in ("compute_crf_with_metrics",
                                    "compute_crf_after_training",
                                    "compute_crf_after_pretraining")}
    runner = _port_runner(tmp_path, num_epochs=4, **flags,
                          pretrain_args={"num_epochs": 3,
                                         "proper_prior_fit_retrys": 0},
                          compute_metrics_during_training_nth_epoch=2)
    runner.build()
    pre = runner.pretrain()
    assert (CRF in pre.get("metrics", {})) == (
        flag == "compute_crf_after_pretraining")
    res = runner.train()
    assert (CRF in res["final_metrics"]) == (
        flag != "compute_crf_after_pretraining")
    # evaluations at epochs 0 and 2 and the final one
    want = {"compute_crf_with_metrics": 3, "compute_crf_after_training": 1,
            "compute_crf_after_pretraining": 1}[flag]
    assert len(calls) == want and set(calls) == {torch.device("cpu")}


def test_split_model_result_with_crf_matches_jax(runs):
    tr, jr = runs["tr"], runs["jr"]
    s = tr.samples[0]
    px = tr._dense_px(s)
    ref_out = JFn.get_result(jr.wrapper, jr.stacked_params, px, 0)
    out = TFn.get_result(tr.wrapper, tr.stacked_params,
                         torch.as_tensor(px), 0)
    ref = JFn.split_model_result(jr.wrapper, ref_out, image=s.image,
                                 use_crf=True, grid_shape=s.shape)
    got = TFn.split_model_result(tr.wrapper, out, image=s.image,
                                 use_crf=True, grid_shape=s.shape)
    for k in ("seg", "prior", "crf"):
        assert got[k].shape == np.asarray(ref[k]).shape
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=1e-4)
    with pytest.raises(ValueError, match="image and grid_shape"):
        TFn.split_model_result(tr.wrapper, out, use_crf=True)


def test_jax_written_configs_load_the_extra_priors(tmp_path):
    """A config.yaml the JAX package wrote, naming the convex-
    diffeomorphism prior (or the star-shaped one), builds the port's."""
    from awesome_tpu_torch.nn.priors_extra import StarShapedNet

    jr = _jax_runner(tmp_path / "jax")
    path = str(tmp_path / "cd.yaml")
    jr.config.save(path)
    cfg = AwesomeConfig.load(path, device="cpu")
    cfg.device = "cpu"
    model = AwesomeRunner(cfg).build_models().prior_module
    assert isinstance(model, ConvexDiffeomorphismNet)
    assert isinstance(model.convex, FullyFusedConvexNextNet)
    assert model.flow.width == 8 and model.convex.base.n_hidden == 8
    star = JConfig(prior_model_type="awesome_tpu.nn.priors_extra."
                   "StarShapedNet", prior_model_args={"n_hidden": 10})
    star.save(str(tmp_path / "star.yaml"))
    cfg = AwesomeConfig.load(str(tmp_path / "star.yaml"), device="cpu")
    cfg.device, cfg.output_folder = "cpu", str(tmp_path / "out")
    prior = AwesomeRunner(cfg).build_models().prior_module
    assert isinstance(prior, StarShapedNet) and prior.n_hidden == 10
