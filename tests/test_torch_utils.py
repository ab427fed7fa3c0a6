"""Port parity: errors, events and the utilities (format, timers,
profiling, logging, shims, corruptions), ``core/affine.py``, the JSON
helpers and the package exports, against the JAX package.

The numpy-only modules (corruptions, format) must be equal exactly; the
tensor modules (affine, the shims' Fourier pair) are held at atol 1e-6."""
import ast
import importlib
import json
import logging
import os
import warnings
from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import affine as JA
from awesome_tpu.serialization import jsonconv as JJ
from awesome_tpu.utils import corruptions as JCOR
from awesome_tpu.utils import format as JFMT
from awesome_tpu.utils import profiling as JPROF
from awesome_tpu.utils import shims as JSH
from awesome_tpu_torch import errors as TERR
from awesome_tpu_torch.core import affine as TA
from awesome_tpu_torch.events import (
    EpochEventArgs,
    Event,
    LearningRateStopWatchdog,
    SaveEventArgs,
    StopTraining,
)
from awesome_tpu_torch.serialization import jsonconv as TJ
from awesome_tpu_torch.utils import corruptions as TCOR
from awesome_tpu_torch.utils import format as TFMT
from awesome_tpu_torch.utils import logging as TLOG
from awesome_tpu_torch.utils import profiling as TPROF
from awesome_tpu_torch.utils import shims as TSH
from awesome_tpu_torch.utils.timer import DeviceTimer, Timer
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
ATOL = 1e-6


# --- errors and events (tests/test_infra.py's behaviours) ---------------


def test_event_attach_notify_cancel_remove():
    ev = Event("test")
    calls = []
    first = ev.attach(lambda s, a: calls.append(1))

    @ev.attach
    def canceler(s, a):
        a.cancel = True
        calls.append(2)

    ev.attach(lambda s, a: calls.append(3))
    ev.notify(None, EpochEventArgs())
    assert calls == [1, 2]
    ev.muted = True
    ev.notify(None, EpochEventArgs())
    assert calls == [1, 2]
    ev.muted = False
    ev.remove(first)
    ev.remove(canceler)
    ev.notify(None, SaveEventArgs(stage="best"))
    assert calls == [1, 2, 3]
    assert len(ev) == 1


def test_lr_watchdog_raises():
    wd = LearningRateStopWatchdog(threshold_scale=0.01)
    with pytest.raises(StopTraining):
        wd(None, EpochEventArgs(metrics={"lr_scale": 0.005}))
    wd(None, EpochEventArgs(metrics={"lr_scale": 0.5}))  # no raise
    wd(None, EpochEventArgs())  # no scale: no raise


def test_errors():
    assert TERR.StopTraining is StopTraining
    err = TERR.ArgumentNoneError("x")
    assert isinstance(err, ValueError) and isinstance(err, TERR.AwesomeError)
    assert str(err) == "Argument 'x' must not be None" and err.name == "x"
    for cls in (TERR.MissingGroundTruthError, TERR.SerializationError,
                TERR.NoTrainableParametersError):
        assert issubclass(cls, TERR.AwesomeError)


# --- format, timers, logging ----------------------------------------------


def test_format_helpers(tmp_path):
    for delta in (timedelta(seconds=3725), 93784, 59.9):
        for fmt in ("{H:02}:{M:02}:{S:02}", "{D}d {H}h {M}m {S}s"):
            assert TFMT.strfdelta(delta, fmt) == JFMT.strfdelta(delta, fmt)
    for name in ("FBMSRunner", "HTTPServerError", "already_snake",
                 "ConvexNextNet2D"):
        assert TFMT.snake_case(name) == JFMT.snake_case(name)
    path = str(tmp_path / "run.json")
    for _ in range(3):
        assert TFMT.numerated_file_name(path) == \
            JFMT.numerated_file_name(path)
        open(TFMT.numerated_file_name(path), "w").close()
    assert sorted(os.listdir(tmp_path)) == ["run.json", "run_1.json",
                                           "run_2.json"]
    tex = ("\\begin{tabular}{lr}\n\\toprule\nrun_name & mean_iou \\\\\n"
           "\\midrule\nnet_xy & \\bfseries 0.8123 \\\\\n"
           "cnn_xy & \\text-decorationunderline 0.7001 \\\\\n"
           "\\bottomrule\n\\end{tabular}\n")
    for kw in ({}, {"escape_underscores": False, "plain_rules": False}):
        assert TFMT.latex_postprocessor(tex, **kw) == \
            JFMT.latex_postprocessor(tex, **kw)


def test_timers_and_phase_timer():
    with Timer("t") as t:
        assert t.delta >= 0.0
    assert t.elapsed > 0.0 and t.delta == t.elapsed
    x = torch.ones(64, 64)
    with DeviceTimer("d") as d:
        d.wait_for({"y": x @ x, "n": None, "k": [3]})  # CPU: nothing to do
    assert d.elapsed > 0.0
    pt = TPROF.PhaseTimer()
    for _ in range(2):
        with pt.phase("fit", wait_on=x):
            x @ x
    with pt.phase("eval"):
        pass
    rep = pt.report()
    assert set(rep) == {"fit", "eval"} and rep["fit"] > 0.0


def test_logging_helpers(tmp_path):
    log_file = str(tmp_path / "logs" / "run.log")
    root = logging.getLogger()
    old = (root.level, list(root.handlers))
    try:
        TLOG.basic_config(log_file=log_file)
        logging.getLogger("x").info("hello")
        for h in root.handlers:
            h.flush()
        with open(log_file) as f:
            assert "hello" in f.read()
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:] = old[1]
        root.setLevel(old[0])
    here = os.path.dirname(os.path.abspath(__file__))
    repo = TLOG.get_project_root_path(here)
    assert os.path.isdir(os.path.join(repo, "awesome_tpu_torch"))
    assert TLOG.get_project_root_path(str(tmp_path)) == str(tmp_path)


# --- profiling ----------------------------------------------------------------


def test_assert_finite_message_equals_jax():
    tree = {"b": np.ones(3, np.float32),
            "a": [None, np.array([[1.0, np.nan], [np.inf, 2.0]],
                                 np.float32)]}
    with pytest.raises(FloatingPointError) as ref:
        JPROF.assert_finite(tree, "params")
    port = {"b": torch.ones(3), "a": [None, torch.tensor(tree["a"][1])]}
    with pytest.raises(FloatingPointError) as got:
        TPROF.assert_finite(port, "params")
    assert str(got.value) == str(ref.value)
    with pytest.raises(FloatingPointError) as got:
        TPROF.assert_finite(tree, "params")  # numpy leaves too
    assert str(got.value) == str(ref.value)
    TPROF.assert_finite({"w": torch.zeros(2, 2), "s": 1.0})


def test_trace_writes_a_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(32, 32)
    with TPROF.trace(log_dir):
        (x @ x).sum()
    files = os.listdir(log_dir)
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    with open(os.path.join(log_dir, files[0])) as f:
        assert "aten::mm" in f.read()


def test_debug_guard_traps_a_backward_nan_and_restores():
    before = (torch.is_anomaly_enabled(),
              torch.is_anomaly_check_nan_enabled())
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # anomaly mode's traceback warning
        with pytest.raises(RuntimeError, match="nan"):
            with TPROF.debug_guard():
                assert torch.is_anomaly_enabled()
                torch.sqrt(x).sum().backward()
    assert (torch.is_anomaly_enabled(),
            torch.is_anomaly_check_nan_enabled()) == before
    x.grad = None
    with TPROF.debug_guard(nans=False):
        torch.sqrt(x).sum().backward()  # NaN grads pass unchecked
    assert torch.isnan(x.grad[0])
    with pytest.raises(NotImplementedError):
        with TPROF.debug_guard(infs=True):
            pass


# --- shims ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 8), (3, 6, 8), (2, 3, 5, 4)])
def test_fourier_pair_matches_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = np.asarray(JSH.fourier(jnp.asarray(x)))
    got = TSH.fourier(torch.tensor(x))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    back = TSH.inverse_fourier(got)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(JSH.inverse_fourier(jnp.asarray(ref))),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(back.real.numpy(), x, atol=ATOL, rtol=0)


def test_pixelize_batcherize_temporary_attrs():
    w = np.random.default_rng(2).normal(size=(3, 2)).astype(np.float32)
    x = np.random.default_rng(3).normal(size=(2, 3, 4, 5)).astype(
        np.float32)

    @JSH.pixelize()
    def jf(p):
        return p @ jnp.asarray(w)

    @TSH.pixelize()
    def tf(p):
        return p @ torch.tensor(w)

    got = tf(torch.tensor(x))
    assert got.shape == (2, 2, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jf(jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    pts = torch.tensor(x[0, :, 0].T)  # (5, 3): points pass through
    np.testing.assert_allclose(tf(pts).numpy(), pts.numpy() @ w,
                               atol=ATOL, rtol=0)

    @TSH.batcherize(expected_dim=4)
    def shape_of(t):
        assert t.ndim == 4
        return t * 2

    assert shape_of(torch.ones(3, 4)).shape == (3, 4)
    assert TSH.batcherize(4, keep=True)(lambda t: t)(
        torch.ones(3, 4)).shape == (1, 1, 3, 4)

    class Box:
        pass

    obj = Box()
    obj.a, obj.inner = 1, Box()
    obj.inner.b = "x"
    with TSH.temporary_attrs(obj, a=2, **{"inner.b": "y"}) as o:
        assert o.a == 2 and o.inner.b == "y"
    assert obj.a == 1 and obj.inner.b == "x"


# --- corruptions ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(JCOR.CORRUPTIONS))
def test_corruption_equals_jax(name):
    """Every corruption at severities 1-5 on one 24x32 image, exactly."""
    x = np.random.default_rng(0).uniform(size=(24, 32, 3)).astype(
        np.float32)
    for severity in range(1, 6):
        got = TCOR.corrupt(x, name, severity, seed=severity)
        ref = JCOR.corrupt(x, name, severity, seed=severity)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_corrupt_rejects_bad_arguments():
    assert sorted(TCOR.CORRUPTIONS) == sorted(JCOR.CORRUPTIONS)
    x = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="Unknown corruption"):
        TCOR.corrupt(x, "rain")
    with pytest.raises(ValueError, match="severity"):
        TCOR.corrupt(x, "fog", 6)


# --- affine ---------------------------------------------------------------------


def test_affine_matches_jax():
    kw2 = dict(rotation=0.3, scale=(1.5, 0.7), shear=(0.1, -0.2),
               translation=(2.0, -1.0))
    kw3 = dict(rotations=((0.2, "x"), (-0.4, "y"), (0.9, "z")),
               scale=(1.0, 2.0, 0.5), translation=(1.0, 2.0, 3.0))
    pairs = [
        (TA.rotation_matrix_2d(0.7, device=CPU), JA.rotation_matrix_2d(0.7)),
        (TA.scale_matrix_2d(2.0, device=CPU), JA.scale_matrix_2d(2.0)),
        (TA.shear_matrix_2d(0.3, 0.1, device=CPU),
         JA.shear_matrix_2d(0.3, 0.1)),
        (TA.transformation_matrix_2d(device=CPU, **kw2),
         JA.transformation_matrix_2d(**kw2)),
        (TA.transformation_matrix_3d(device=CPU, **kw3),
         JA.transformation_matrix_3d(**kw3)),
    ] + [(TA.rotation_matrix_3d(a, 0.5, device=CPU),
          JA.rotation_matrix_3d(a, 0.5)) for a in "xyz"]
    for got, ref in pairs:
        assert got.dtype == torch.float32 and got.device.type == CPU
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
    pts = np.random.default_rng(4).normal(size=(7, 2)).astype(np.float32)
    m2 = TA.transformation_matrix_2d(device=CPU, **kw2)
    np.testing.assert_allclose(
        TA.apply_homogeneous(m2, torch.tensor(pts)).numpy(),
        np.asarray(JA.apply_homogeneous(JA.transformation_matrix_2d(**kw2),
                                        jnp.asarray(pts))),
        atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        TA.rotation_matrix_3d("w", 0.1, device=CPU)


def test_affine_follows_tensor_arguments(monkeypatch):
    theta = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    m = TA.transformation_matrix_2d(rotation=theta, dtype=torch.float64)
    assert m.dtype == torch.float64
    m[0, 0].backward()
    assert torch.allclose(theta.grad, -torch.sin(theta.detach()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.rotation_matrix_2d(0.1)  # Python numbers only: the card


# --- JSON helpers and the package exports --------------------------------------


def test_port_loads_a_jax_written_json(tmp_path):
    from awesome_tpu.runner.config import AwesomeConfig as JConfig

    from awesome_tpu_torch.runner.config import AwesomeConfig

    value = {"cfg": JConfig(num_epochs=7, optimizer_args={"lr": 0.3}),
             "shape": (3, 4), "arr": np.arange(6, dtype=np.float32),
             "s": slice(1, None)}
    path = str(tmp_path / "v.json")
    JJ.save_json(value, path)
    got = TJ.load_json(path, device=CPU)
    assert isinstance(got["cfg"], AwesomeConfig)
    assert got["cfg"].num_epochs == 7
    assert got["cfg"].optimizer_args == {"lr": 0.3}
    assert got["shape"] == (3, 4) and got["s"] == slice(1, None)
    np.testing.assert_array_equal(got["arr"], value["arr"])
    TJ.save_json(got, str(tmp_path / "again" / "v.json"))
    with open(str(tmp_path / "again" / "v.json")) as f:
        assert json.load(f)["cfg"]["__class__"] == \
            "awesome_tpu_torch.runner.config.AwesomeConfig"


@pytest.mark.parametrize("pkg", ["fit", "measures", "data", "events", "nn",
                                 "serialization", "utils"])
def test_package_exports(pkg):
    """Every name a JAX subpackage's ``__init__.py`` imports, its
    counterpart exports."""
    ref = importlib.import_module(f"awesome_tpu.{pkg}")
    with open(ref.__file__) as f:
        tree = ast.parse(f.read())
    names = [a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert names
    got = importlib.import_module(f"awesome_tpu_torch.{pkg}")
    for name in names:
        assert hasattr(got, name), f"awesome_tpu_torch.{pkg} lacks {name}"


def test_every_new_module_is_in_port_modules():
    for mod in ("core.affine", "data.awesome_dataset", "data.mapping",
                "data.sisbosi", "data.subdivisible", "errors",
                "events.event", "events.watchdog", "utils.corruptions",
                "utils.format", "utils.logging", "utils.profiling",
                "utils.shims", "utils.timer"):
        assert TJ.PORT_MODULES[f"awesome_tpu.{mod}"] == \
            f"awesome_tpu_torch.{mod}"
    assert TJ.dynamic_import("awesome_tpu.events.event.Event") is Event
