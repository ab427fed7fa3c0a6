"""The port's fan-out script (``awesome_tpu_torch.scripts.run_sharded``),
its mesh entry point (``python -m awesome_tpu_torch.run`` with
``mesh_shape``) and the multi-device dry run, on CPU processes;
counterpart of ``tests/test_run_sharded.py``."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _write_configs(cfg_dir, prefix, n=3):
    from awesome_tpu_torch.runner.config import AwesomeConfig
    from awesome_tpu_torch.serialization.jsonconv import save_yaml

    os.makedirs(cfg_dir)
    for i in range(n):
        save_yaml(AwesomeConfig(
            name_experiment=f"{prefix}_{i}",
            dataset_args={"n": 2, "h": 16, "w": 16},
            segmentation_model_args={"n_hidden": 12},
            prior_model_args={"n_hidden": 8, "n_hidden_layers": 1},
            optimizer_args={"lr": 0.02}, num_epochs=10,
            do_pretraining=False,
            compute_metrics_during_training_nth_epoch=None,
            validation_each_nth_epoch=0, seed=i, device="cpu"),
            str(cfg_dir / f"c{i}.yaml"))


def _fan_out(*args):
    return [sys.executable, "-m", "awesome_tpu_torch.scripts.run_sharded",
            *args]


def _check_shards(runs, prefix):
    m0 = json.load(open(runs / "shard_0.json"))
    m1 = json.load(open(runs / "shard_1.json"))
    assert m0["num_shards"] == m1["num_shards"] == 2
    assert m0["device"] == m1["device"] == "cpu"
    assert not m0["failures"] and not m1["failures"], (m0, m1)
    # a disjoint round-robin split covering the 3 configs
    assert len(m0["jobs"]) == 2 and len(m1["jobs"]) == 1
    assert not set(m0["jobs"]) & set(m1["jobs"])
    table = open(runs / "comparison.md").read()
    for i in range(3):
        assert f"{prefix}_{i}" in table
    assert "best-epoch selection" in table


def test_two_process_disjoint_shards(tmp_path):
    """``--spawn``: two worker processes consume disjoint shards of a
    config directory and their runs aggregate into one table."""
    _write_configs(tmp_path / "cfgs", "shardtest")
    runs = tmp_path / "runs"
    proc = subprocess.run(
        _fan_out("--config-dir", str(tmp_path / "cfgs"), "--num-shards", "2",
                "--spawn", "--device", "cpu", "--runs-path", str(runs)),
        env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _check_shards(runs, "shardtest")


def test_multihost_two_processes(tmp_path):
    """The multi-host branch: two processes with ``--coordinator`` on
    127.0.0.1 take their shard ids from ``--process-id``, meet at the
    TCPStore barrier, and process 0 aggregates."""
    _write_configs(tmp_path / "cfgs", "mh")
    runs = tmp_path / "runs"

    def launch():
        # bind-then-close port probing can race another process for the
        # port, so a failed launch is retried once on a fresh one
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        base = _fan_out("--config-dir", str(tmp_path / "cfgs"),
                       "--runs-path", str(runs), "--device", "cpu",
                       "--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", "2")
        procs = [subprocess.Popen(base + ["--process-id", str(i)],
                                  env=_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for i in range(2)]
        try:
            return procs, [p.communicate(timeout=600) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            return procs, None

    for attempt in range(2):
        procs, outs = launch()
        if outs is not None and all(p.returncode == 0 for p in procs):
            break
        assert attempt == 0, (outs[0][1][-3000:] if outs else "timeout")
    assert "wrote" in outs[0][0] and "wrote" not in outs[1][0]
    _check_shards(runs, "mh")


def _entry_config(root, shape):
    from awesome_tpu_torch.runner.config import AwesomeConfig

    return AwesomeConfig(
        name_experiment="entry", dataset_args={"n": 4, "h": 16, "w": 16},
        segmentation_model_args={"n_hidden": 16},
        prior_model_args={"n_hidden": 12, "n_hidden_layers": 1},
        optimizer_type="adam", optimizer_args={"lr": 0.02}, num_epochs=20,
        pretrain_args={"num_epochs": 10}, runs_path=str(root), seed=5,
        mesh_shape=shape, device="cpu")


def test_run_entry_point_starts_the_mesh(tmp_path):
    """``python -m awesome_tpu_torch.run`` with ``mesh_shape: [2, 2]``
    starts four ranks and writes one run folder whose per-epoch training
    losses and final metrics match the one-process runner's (rtol 2e-3,
    atol 2e-4; MIOU within 2e-2)."""
    from awesome_tpu_torch.analytics.result_model import ResultModel
    from awesome_tpu_torch.runner.runner import AwesomeRunner
    from awesome_tpu_torch.serialization.jsonconv import save_yaml

    path = tmp_path / "mesh.yaml"
    save_yaml(_entry_config(tmp_path / "mesh", [2, 2]), str(path))
    proc = subprocess.run(
        [sys.executable, "-m", "awesome_tpu_torch.run", "--config-path",
         str(path)], env=_env(), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh: (data=2, grid=2) on gloo (CPU ranks)" in proc.stdout
    (run_dir,) = os.listdir(tmp_path / "mesh")
    mesh = ResultModel.from_path(str(tmp_path / "mesh" / run_dir),
                                 device="cpu")

    single = AwesomeRunner(_entry_config(tmp_path / "single", None))
    single.build()
    single.pretrain()
    single.train()
    ref = single.evaluate()
    steps, got = mesh.metric_series("Loss", "train")
    want = single.tracker.series[("Loss", "epoch", "train")].values
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert abs(mesh.metrics("eval")["MeanForegroundBinaryMIOU"]
               - ref["MeanForegroundBinaryMIOU"]) < 2e-2


def test_dryrun_multichip_on_cpu_ranks():
    """``dryrun_multichip(4, device='cpu')``: the joint step, the
    config-driven protocol and the FBMS joint loop on a (2, 2) mesh, with
    finite losses that every rank agrees on."""
    from awesome_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device="cpu")
    assert out.pop("ranks") == [{"backend": "gloo", "device": "cpu"}] * 4
    assert set(out) == {"step_loss", "protocol_loss", "protocol_miou",
                        "fbms_loss"}
    assert all(np.isfinite(v) for v in out.values())
    assert 0.0 <= out["protocol_miou"] <= 1.0
