"""The readers of the port's own spans and fit-loop counters: a value from
the program's state, None where the port has none (a checkout before
them), and the masked share through a whole tiny gated run on the CPU;
``portbench/spans.py``'s phase table on synthetic events."""
import pytest
import torch

from portbench import harness, spec
from portbench import spans as spans_mod
from awesome_tpu_torch.fit import prior_fit
from awesome_tpu_torch.utils import profiling

GATED = "howto_convex.gated_8x480x640"


def read(name, record):
    return spec.reader(name)(record)


def _record(kind="fit", trace=True):
    rec = {"kind": kind, "window_s": 10.0, "work": 5e8, "steps": 1000,
           "flops": 6.7e14, "chips": 1, "setup_s": 7.5, "bounds": {},
           "counters": {}}
    if trace:
        rec["trace"] = {"window_s": 2.0, "busy_s": 1.9, "kernels": {}}
    return rec


@pytest.fixture
def fresh_work(monkeypatch):
    work = prior_fit._LoopWork()
    monkeypatch.setattr(prior_fit, "loop_work", work)
    return work


def test_masked_share(fresh_work):
    fresh_work.add(torch.tensor([True, True]), (2,), 500)
    fresh_work.add(torch.tensor([False, True]), (2,), 500)
    assert read("fit.masked_share", _record()) == pytest.approx(25.0)
    assert read("fit.masked_share", _record("train")) is None


def test_masked_share_silent_without_fits_or_counters(fresh_work,
                                                      monkeypatch):
    assert read("fit.masked_share", _record()) is None
    fresh_work.add(torch.tensor(True), (), 10)
    assert read("fit.masked_share", _record()) == 0.0
    monkeypatch.delattr(prior_fit, "fit_loop_counts")
    assert read("fit.masked_share", _record()) is None


def test_host_ms_per_step(monkeypatch):
    monkeypatch.setattr(profiling.span, "totals", {
        "fit.loop": [2, 9.0], "fit.loss_grad": [1000, 4.0],
        "fit.update": [1000, 1.5]})
    assert read("fit.host_ms_per_step", _record()) == pytest.approx(5.5)
    assert read("fit.host_ms_per_step", _record(trace=False)) is None
    assert read("fit.host_ms_per_step", _record("train")) is None


def test_host_ms_per_step_silent_without_spans(monkeypatch):
    monkeypatch.setattr(profiling.span, "totals", {})
    assert read("fit.host_ms_per_step", _record()) is None
    monkeypatch.delattr(profiling, "span")
    assert read("fit.host_ms_per_step", _record()) is None


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_masked_share_of_a_tiny_gated_run(fresh_work, one_thread):
    """Every gate passes (threshold 0), so each refit masks its whole
    batch: half of the run's image-steps, the warm-up's included."""
    bench = spec.benchmark()
    cell = spec.cell(bench, GATED)
    cfg = dict(spec.config(cell["config"]), num_steps=3, gate_threshold=0.0)
    trf = dict(spec.traffic(cell["traffic"]), height=16, width=16, images=2)
    rec = harness.run_cell(cell, cfg, trf, spec.limits(GATED), 7, 0.0, False,
                           "cpu")
    assert rec["units"] == 1
    counts = prior_fit.fit_loop_counts()
    assert counts["image_steps"] == 2 * (2 * 2 + 2 * 3)
    assert read("fit.masked_share", rec) == pytest.approx(50.0)


# --- portbench/spans.py on synthetic events ----------------------------------

JOINT = [("joint.step", 0.0, 10.0), ("joint.forward", 1.0, 3.0),
         ("joint.backward", 3.0, 7.0), ("joint.update", 7.0, 9.5)]


def test_spans_nesting_and_self_time():
    table = spans_mod.spans([], {}, JOINT, 0.0, 10.0)
    assert table["joint.step"]["count"] == 1
    assert table["joint.step"]["host_s"] == pytest.approx(10.0)
    assert table["joint.step"]["self_s"] == pytest.approx(1.5)
    assert table["joint.backward"]["self_s"] == pytest.approx(4.0)


def test_spans_device_time_by_launch():
    """An op launched in the backward (on the autograd engine's thread:
    the time alone places it), one that runs during the update but was
    launched in the forward (its correlation id says so), and one whose
    launch the trace lacks."""
    ops = [("bwd", 4.5, 6.0, 7, 11), ("fwd", 8.0, 8.5, 7, 12),
           ("lost", 9.0, 9.2, 7, 13)]
    launches = {11: 4.0, 12: 2.0}
    table = spans_mod.spans(ops, launches, JOINT, 0.0, 10.0)
    assert table["joint.backward"]["device_s"] == pytest.approx(1.5)
    assert table["joint.forward"]["device_s"] == pytest.approx(0.5)
    assert table["joint.update"]["device_s"] == 0.0
    assert table["joint.step"]["device_s"] == pytest.approx(2.0)


def test_spans_idle_to_the_innermost_span():
    ops = [("k", 0.0, 0.5, 7, 1), ("k", 1.5, 7.2, 7, 2),
           ("k", 9.0, 10.0, 7, 3)]
    table = spans_mod.spans(ops, {}, JOINT, 0.0, 10.0)
    # 0.5-1.5: middle 1.0 in the forward; 7.2-9.0: middle 8.1 in the update
    assert table["joint.forward"]["idle_s"] == pytest.approx(1.0)
    assert table["joint.update"]["idle_s"] == pytest.approx(1.8)
    assert table["joint.step"]["idle_s"] == 0.0
    table = spans_mod.spans(ops, {}, [("joint.step", 0.0, 10.0)], 0.0, 10.0)
    assert table["joint.step"]["idle_s"] == pytest.approx(2.8)


def test_spans_gate_holds_a_loop_and_per_step():
    program = [("fit.loop", 0.0, 4.0), ("fit.loss_grad", 0.0, 1.0),
               ("fit.update", 1.0, 2.0), ("fit.loss_grad", 2.0, 3.0),
               ("fit.update", 3.0, 4.0), ("fit.gate", 4.0, 9.0),
               ("fit.loop", 5.0, 9.0), ("fit.loss_grad", 5.0, 6.0),
               ("fit.update", 6.0, 7.0), ("fit.loss_grad", 7.0, 8.0),
               ("fit.update", 8.0, 9.0)]
    table = spans_mod.spans([], {}, program, 0.0, 9.0)
    assert table["fit.loop"]["count"] == 2
    assert table["fit.loop"]["self_s"] == pytest.approx(0.0)
    assert table["fit.gate"]["self_s"] == pytest.approx(1.0)
    steps = spans_mod.per_step(table)
    assert steps["fit.update"]["host_s"] == pytest.approx(1e3)


def test_spans_of_a_port_without_spans():
    table = spans_mod.spans([("k", 0.0, 1.0, 7, 1)], {1: 0.0}, [], 0.0, 2.0)
    assert table == {} and spans_mod.per_step(table) == {}
