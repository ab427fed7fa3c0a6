"""Port parity: the prior fits of awesome_tpu_torch's FBMS runner
(``runner/fbms_runner.py``: the spatio-temporal ``pretrain`` and
``evaluate``, plain and in the noisy family with its prefits
(``nn/noisy_path_connected.py``), and the per-frame
``pretrain_joint_priors``) against the JAX package's ``FBMSRunner``, at
the JAX FBMS tests' size: 5 frames of 24x32, the prior 8 hidden x 2
flows with an ICNN 12 x 1. The same numpy sequence goes through both, and
the JAX runner's initial params are bridged into the port's.

Tolerances: the spatio-temporal ``epoch_loss`` and ``cold_loss`` at rtol
2e-4 (``tests/test_fused_fit.py:37``), ``evaluate`` at atol 1e-3. Both
packages fit unfused on the CPU. The config plumbing (the epoch LR
schedule, ``joint_state_kind``, ``from_awesome_config``, the CLI's
resume pretrain-skip predicate) must agree exactly; and ``python -m
awesome_tpu_torch.run`` runs an FBMS config with ``jax`` and
``awesome_tpu`` blocked."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from awesome_tpu.fit.checkpoint import save_pytree as j_save_pytree
from awesome_tpu.runner import fbms_runner as JR
from awesome_tpu.runner.config import AwesomeConfig as JConfig
from awesome_tpu_torch import run as trun
from awesome_tpu_torch.bridge import params_from_jax
from awesome_tpu_torch.data.synthetic import write_synthetic_fbms_sequence
from awesome_tpu_torch.fit.checkpoint import save_pytree
from awesome_tpu_torch.nn import noisy_path_connected as TN
from awesome_tpu_torch.runner import fbms_runner as TR
from awesome_tpu_torch.runner.config import AwesomeConfig
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 2e-4
METRIC_ATOL = 1e-3
SMALL = dict(prior_hidden_units=8, prior_flows=2, convex_hidden_units=12,
             convex_hidden_layers=1)
PRIOR_ARGS = {"hidden_units": 8, "flow_n_flows": 2,
              "convex_net_hidden_units": 12, "convex_net_hidden_layers": 1}


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    return write_synthetic_fbms_sequence(
        str(tmp_path_factory.mktemp("fbms")), n_frames=5, h=24, w=32)


def _bridged(jr, tr):
    jr.build()
    tr.build()
    assert tuple(tr.shape) == tuple(jr.shape)
    tr.params = params_from_jax(jax.device_get(jr.params), "cpu")
    return jr, tr


def _configs(seq, **kw):
    base = dict(dataset_args={"dataset": {"dataset_path": seq}},
                prior_model_args=dict(PRIOR_ARGS, channels=3),
                optimizer_args={"lr": 5e-3}, num_epochs=8, seed=3)
    base.update(kw)
    return JConfig(**base), AwesomeConfig(device="cpu", **base)


def _assert_metrics_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_ATOL, (k, got[k], ref[k])


def test_spatiotemporal_pretrain_matches_jax(seq):
    """The trajectory weak-label fit of one shared (x, y, t) prior, then
    its IoU on the GT frames."""
    kw = dict(dataset_path=seq, num_epochs=10, lr=5e-3, **SMALL)
    jr, tr = _bridged(JR.FBMSRunner(JR.FBMSExperimentConfig(**kw)),
                      TR.FBMSRunner(TR.FBMSExperimentConfig(**kw),
                                    device="cpu"))
    pj, pt = jr.pretrain(), tr.pretrain()
    assert pt["epoch_loss"].shape == (10,)
    np.testing.assert_allclose(pt["epoch_loss"], pj["epoch_loss"],
                               rtol=RTOL)
    assert pt["lr_scale"] == pj["lr_scale"]
    ej, et = jr.evaluate(), tr.evaluate()
    assert et["num_gt_frames"] == 2
    _assert_metrics_close(et, ej)


def test_noisy_spatiotemporal_with_prefits_matches_jax(seq, tmp_path):
    """The noisy spatio-temporal family from its config: 40 % of the
    frames' dense unaries replaced by noise, the flow-identity and convex
    prefits of ``pretrain_args``, then the fit and ``evaluate``; and
    ``save_results`` writes the JAX runner's run folder."""
    pa = {"noisy_percentage": 0.4, "prefit_flow_net_identity": True,
          "prefit_flow_net_identity_num_epochs": 10,
          "prefit_convex_net": True, "prefit_convex_net_num_epochs": 10}
    jcfg, tcfg = _configs(seq, pretrain_args=pa,
                          output_folder=str(tmp_path / "port"))
    jr, tr = _bridged(JR.FBMSRunner.from_awesome_config(jcfg),
                      TR.FBMSRunner.from_awesome_config(tcfg))
    assert tr.config.frame_noise_percentage == 0.4
    assert tr.device.type == "cpu"
    np.testing.assert_array_equal(tr._frame_noise_targets()[0],
                                  jr._frame_noise_targets()[0])
    pj, pt = jr.pretrain(), tr.pretrain()
    np.testing.assert_allclose(pt["epoch_loss"], pj["epoch_loss"],
                               rtol=RTOL)
    _assert_metrics_close(tr.evaluate(), jr.evaluate())
    out = tr.save_results()
    for name in ("config.yaml", "tracker.json", "params.npz",
                 "treedef.txt"):
        assert os.path.exists(os.path.join(out, name)), name


def test_pretrain_noisy_matches_jax(seq):
    """``pretrain_noisy``: prefits and the shared fit in one call."""
    from awesome_tpu.fit.spatiotemporal import sequence_points as jpts
    from awesome_tpu.nn import noisy_path_connected as JN
    from awesome_tpu_torch.fit.spatiotemporal import sequence_points

    tr = TR.FBMSRunner(TR.FBMSExperimentConfig(dataset_path=seq),
                       device="cpu").build()
    targets, labeled = tr._collect()
    kw = dict(hidden_units=8, flow_n_flows=2, convex_net_hidden_units=12,
              convex_net_hidden_layers=1)
    jm = JN.noisy_path_connected_net((24, 32), **kw)
    tm = TN.noisy_path_connected_net((24, 32), device="cpu", **kw)
    jp = jm.init(jax.random.PRNGKey(1))
    fit_kw = dict(num_epochs=4, lr=5e-3, weight_mode="equal",
                  prefit_flow_net_identity=True,
                  prefit_flow_net_identity_num_epochs=5,
                  prefit_convex_net=True, prefit_convex_net_num_epochs=5)
    _, jaux = JN.pretrain_noisy(jm, jp, jpts((24, 32), 5), targets,
                                labeled, **fit_kw)
    _, taux = TN.pretrain_noisy(
        tm, params_from_jax(jax.device_get(jp), "cpu"),
        sequence_points((24, 32), 5, device="cpu"), tr._tensor(targets),
        tr._tensor(labeled), **fit_kw)
    np.testing.assert_allclose(taux["epoch_loss"].numpy(),
                               np.asarray(jaux["epoch_loss"]), rtol=RTOL)


def test_pretrain_joint_priors_matches_jax(seq, tmp_path, monkeypatch):
    """The per-frame pretrain (cold fit on frame 0, warm fits after) with
    the flow-identity and circle prefits, the flow prefit cached in a
    zoo: the cold fit's last loss, and the same again from the zoo."""
    from awesome_tpu_torch.nn.zoo import Zoo
    from awesome_tpu.nn.zoo import Zoo as JZoo

    kw = dict(dataset_path=seq, **SMALL)
    jr, tr = _bridged(JR.FBMSRunner(JR.FBMSExperimentConfig(**kw)),
                      TR.FBMSRunner(TR.FBMSExperimentConfig(**kw),
                                    device="cpu"))
    init = params_from_jax(jax.device_get(
        jr._joint_prior_model().init(jax.random.PRNGKey(4))), "cpu")
    model = tr._joint_prior_model()
    monkeypatch.setattr(model, "init", lambda generator=None: init)
    monkeypatch.setattr(tr, "_joint_prior_model", lambda: model)
    pkw = dict(num_steps=40, reuse_state_steps=10, lr=5e-3, seed=4,
               prefit_flow_identity=True, prefit_flow_identity_steps=10,
               prefit_convex=True, prefit_convex_steps=10)
    rj = jr.pretrain_joint_priors(zoo=JZoo(str(tmp_path / "jzoo")), **pkw)
    zoo = Zoo(str(tmp_path / "zoo"))
    rt = tr.pretrain_joint_priors(zoo=zoo, **pkw)
    np.testing.assert_allclose(rt["cold_loss"], rj["cold_loss"], rtol=RTOL)
    leaves = jax.tree_util.tree_leaves(tr.joint_prior_init)
    assert all(x.shape[0] == 5 for x in leaves)
    assert any(f.endswith(".npz") for f in os.listdir(tmp_path / "zoo"))
    again = tr.pretrain_joint_priors(zoo=zoo, **pkw)  # the zoo's flow
    assert again["cold_loss"] == rt["cold_loss"]


@pytest.mark.parametrize("sched", [
    {"type": "step", "gamma": 0.5, "step_size": 3},
    {"type": "plateau", "factor": 0.3, "patience": 2, "threshold": 1e-2},
    None], ids=["step", "plateau", "none"])
def test_epoch_lr_schedule_matches_jax(sched):
    losses = [1.0, 0.9, 0.899, 0.95, 0.9, 0.91, 0.5, 0.5, 0.5, 0.5, 0.49]
    js, ts = JR._EpochLrSchedule(sched), TR._EpochLrSchedule(sched)
    assert ts.needs_loss == js.needs_loss
    for e, loss in enumerate(losses):
        assert ts.update(e, loss if ts.needs_loss else None) == js.update(
            e, loss if js.needs_loss else None)
        assert ts.state_dict() == js.state_dict()
    fresh = TR._EpochLrSchedule(sched)
    fresh.load_state_dict(json.loads(json.dumps(ts.state_dict())))
    assert fresh.state_dict() == ts.state_dict()


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_run_script", os.path.join(REPO, "scripts", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jax_run_script"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [
    dict(),
    dict(pretrain_only=True, pretrain_args={"num_epochs": 300, "lr": 0.01},
         num_epochs=0),
    dict(dataset_args={"dataset": {"dataset_path": "/x",
                                   "flip_probability": 0.2,
                                   "label_mode": "multiple_objects"}},
         prior_model_args={"hidden_units": 16, "flow_n_flows": 4}),
    dict(pretrain_args={"noisy_percentage": 0.0}, mesh_shape=[2, 1],
         dataset_args={"dataset": {"label_mode":
                                   {"value": "multiple_objects"}}}),
    dict(use_step_lr_scheduler=True, step_lr_scheduler_args={"gamma": 0.5},
         use_lr_stop_training_watchdog=True),
    dict(use_lr_on_plateau_scheduler=True,
         lr_on_plateau_scheduler_args={"factor": 0.2, "patience": 3},
         lr_stop_training_watchdog_args={"learning_rate": 1e-6}),
], ids=["default", "pretrain-only", "flip-multi", "noisy-multi-mesh",
        "step", "plateau"])
def test_config_plumbing_matches_jax(kw):
    jcfg, tcfg = JConfig(**kw), AwesomeConfig(device="cpu", **kw)
    jr = JR.FBMSRunner.from_awesome_config(jcfg, dataset_path="/seq")
    tr = TR.FBMSRunner.from_awesome_config(tcfg, dataset_path="/seq")
    assert dataclasses.asdict(tr.config) == dataclasses.asdict(jr.config)
    assert TR.FBMSRunner.joint_state_kind(tcfg) == \
        JR.FBMSRunner.joint_state_kind(jcfg)
    assert trun._joint_state_kind(tcfg) == _jax_cli()._joint_state_kind(jcfg)
    assert TR.FBMSRunner._scheduler_from_config(tcfg) == \
        JR.FBMSRunner._scheduler_from_config(jcfg)
    assert TR.FBMSRunner._watchdog_lr_from_config(tcfg) == \
        JR.FBMSRunner._watchdog_lr_from_config(jcfg)


def _write_checkpoint(folder, kind, saver):
    d = os.path.join(folder, "checkpoints", "latest")
    os.makedirs(d, exist_ok=True)
    saver((np.zeros(2, np.float32),), os.path.join(d, "train_state"))
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"extra": {"epoch": 3, "state_kind": kind}}, f)


def test_skip_pretrain_on_resume_matches_jax(tmp_path):
    """The CLI's predicate, scenario by scenario, on checkpoints each
    package wrote with its own ``save_pytree``."""
    import torch

    jmod = _jax_cli()

    def both(name, kind=None, **kw):
        out = {}
        for pkg, cls, saver in (
                ("jax", JConfig, j_save_pytree),
                ("port", AwesomeConfig,
                 lambda t, p: save_pytree(tuple(torch.as_tensor(x)
                                                for x in t), p))):
            folder = str(tmp_path / name / pkg)
            if kind is not None:
                _write_checkpoint(folder, kind, saver)
            extra = {} if pkg == "jax" else {"device": "cpu"}
            out[pkg] = cls(output_folder=folder, **extra, **kw)
        return (trun._skip_pretrain_on_resume(out["port"]),
                jmod._skip_pretrain_on_resume(out["jax"]))

    multi = {"dataset": {"label_mode": {"value": "multiple_objects"}}}
    cases = {
        "fresh": (dict(resume=True), None, False),
        "joint": (dict(resume=True), "joint", True),
        "pretrain-only": (dict(resume=True, pretrain_only=True), "joint",
                          False),
        "no-resume": (dict(), "joint", False),
        "cross-kind": (dict(resume=True), "multi", False),
        "multi": (dict(resume=True, dataset_args=multi), "multi", True),
    }
    for name, (kw, kind, expected) in cases.items():
        assert both(name, kind, **kw) == (expected, expected), name


def test_options_left_out_raise(seq):
    """A mesh larger than the world (two positions in one process, no
    process group) raises ``ValueError`` before anything trains, as JAX's
    ``make_mesh`` does for devices."""
    tr = TR.FBMSRunner(TR.FBMSExperimentConfig(dataset_path=seq,
                                               mesh_shape=[2, 1], **SMALL),
                       device="cpu").build()
    with pytest.raises(ValueError, match="needs 2 processes"):
        tr.pretrain()
    with pytest.raises(ValueError, match="needs 2 processes"):
        tr.train_joint(num_epochs=1)


def _cli_args(seq, runs):
    return ["--device", "cpu", "--name-experiment", "fbms_cli",
            "--runs-path", str(runs),
            "--dataset-type", "awesome_tpu.data.fbms.FBMSSequenceDataset",
            "--dataset-args",
            f"{{dataset: {{dataset_path: {seq}, training_batch_size: 2}}}}",
            "--prior-model-args",
            "{hidden_units: 8, flow_n_flows: 2, convex_net_hidden_units: 12,"
            " convex_net_hidden_layers: 1}",
            "--optimizer-args", "{lr: 0.001}",
            "--compute-metrics-during-training-nth-epoch", "1",
            "--pretrain-args", "{num_epochs: 20, reuse_state_epochs: 5}"]


def test_cli_runs_fbms_without_jax(seq, tmp_path):
    """``python -m awesome_tpu_torch.run --device cpu`` on an FBMS joint
    config, with ``jax`` and ``awesome_tpu`` blocked: the pretrain, 2
    joint epochs, the eval and the run folder's checkpoints; then the
    same command with ``--resume true --num-epochs 3`` picks up the run
    folder, skips the pretrain and trains the third epoch."""
    args = _cli_args(seq, tmp_path)
    # one intra-op thread: the suite's other workers share the cores
    code = (
        "import logging, sys\n"
        "for m in ('jax', 'jaxlib', 'awesome_tpu', 'tensorflow'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from awesome_tpu_torch import run\n"
        "run.config_logging()\n"
        f"out = run.main(run.get_config({args!r} + ['--num-epochs', '2']))\n"
        f"again = run.main(run.get_config({args!r} + ['--num-epochs', '3',"
        " '--resume', 'true']))\n"
        "assert again == out, (again, out)\n"
        "print(out)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'awesome_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout.strip().splitlines()[-1]
    assert os.path.dirname(out) == str(tmp_path)
    assert out.endswith("_fbms_cli")
    from awesome_tpu_torch.fit.checkpoint import find_resumable

    epoch, _, _ = find_resumable(os.path.join(out, "checkpoints"), "joint")
    assert epoch == 3
    assert "Prior pretrain" in res.stderr
    assert "skipping the prior pretrain" in res.stderr
    assert res.stderr.count("Joint training done") == 2


def test_pretrain_only_saves_then_loads(seq, tmp_path):
    """The sequential / weight-decay families' pretrain_only flow: the
    first run fits the per-frame priors and saves them at
    ``pretrain_state_path``, the next loads them bitwise instead of
    fitting; ``force_pretrain`` fits again."""
    import torch

    state = str(tmp_path / "state" / "pretrain")
    _, tcfg = _configs(seq, pretrain_only=True, num_epochs=0,
                       pretrain_state_path=state,
                       prior_model_args=PRIOR_ARGS,
                       pretrain_args={"num_epochs": 20,
                                      "reuse_state_epochs": 5, "lr": 5e-3})
    first = TR.FBMSRunner.from_awesome_config(tcfg).build()
    res = first.run_pretrain_only_from_config()
    assert res["loaded"] is False and res["path"] == state
    assert np.isfinite(res["cold_loss"])
    again = TR.FBMSRunner.from_awesome_config(tcfg).build()
    assert again.run_pretrain_only_from_config() == {"loaded": True,
                                                     "path": state}
    for a, b in zip(jax.tree_util.tree_leaves(first.joint_prior_init),
                    jax.tree_util.tree_leaves(again.joint_prior_init)):
        assert torch.equal(a, b)
    tcfg.force_pretrain = True
    assert again.run_pretrain_only_from_config()["loaded"] is False
