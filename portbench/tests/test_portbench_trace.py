"""The window, rate and idle arithmetic on synthetic records and traces."""
import pytest

from portbench import spec
from portbench import trace as tr


def test_union_does_not_count_overlap_twice():
    ops = [("a", 0.0, 2.0, 1), ("nccl", 1.0, 3.0, 2), ("b", 5.0, 6.0, 1),
           ("c", 9.0, 12.0, 1)]
    assert tr.merged([(o[1], o[2]) for o in ops], 0.0, 10.0) == \
        [(0.0, 3.0), (5.0, 6.0), (9.0, 10.0)]
    assert tr.busy_seconds(ops, 0.0, 10.0) == 5.0
    assert tr.gaps(ops, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]


def test_breakdown_names_only_the_longest_gaps():
    ops = [("k", float(i), i + 0.5, 1) for i in range(10)]
    b = tr.breakdown(ops, [("step", 0.0, 10.0)], 0.0, 10.0, named=3)
    assert b["idle_gaps"] == [["shorter gaps", 3.5], ["step", 1.5]]


def test_breakdown_names_gaps_by_innermost_host_op():
    ops = [("k1", 0.0, 2.0, 1), ("k2", 4.0, 5.0, 1), ("k1", 8.0, 9.0, 1)]
    host = [("outer", 0.0, 10.0), ("aten::item", 2.5, 3.9),
            ("cudaStreamSynchronize", 5.5, 7.8)]
    b = tr.breakdown(ops, host, 0.0, 10.0)
    assert b["device_ops"] == [["k1", 3.0], ["k2", 1.0]]
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", 3.0]
    assert ["aten::item", 2.0] in b["idle_gaps"]
    assert ["outer", 1.0] in b["idle_gaps"]


def _record(kind, **kw):
    rec = {"kind": kind, "window_s": 10.0, "work": 5e8, "steps": 1000,
           "flops": 6.7e14, "chips": 1, "setup_s": 7.5, "bounds": {},
           "counters": {"flagship": 1000, "flagship_bf16": 0,
                        "icnn_fwd": 0, "icnn_bwd": 0, "fit_steps": 1000}}
    rec.update(kw)
    return rec


def read(name, record):
    return spec.reader(name)(record)


def test_fit_readers():
    rec = _record("fit", bounds={"flagship": 1e-3}, trace={
        "window_s": 2.0, "busy_s": 1.9,
        "kernels": {"flagship": {"launches": 300, "seconds": 1.5}}})
    assert read("fit_point_steps_per_s", rec) == 5e7
    assert read("mfu.fit", rec) == pytest.approx(100.0)
    assert read("fit.launches_per_step", rec) == 1.0
    assert read("flagship.roofline", rec) == pytest.approx(20.0)
    assert read("device_idle.fit", rec) == pytest.approx(5.0)
    assert read("setup_s", rec) == 7.5
    for name in ("train_step_ms", "mfu.train", "device_idle.train",
                 "icnn.roofline"):
        assert read(name, rec) is None


def test_train_readers():
    rec = _record("train", work=20, flops=6.7e13, trace={
        "window_s": 4.0, "busy_s": 3.0, "kernels": {}})
    assert read("train_step_ms", rec) == 500.0
    assert read("mfu.train", rec) == pytest.approx(10.0)
    assert read("device_idle.train", rec) == pytest.approx(25.0)
    assert read("fit_point_steps_per_s", rec) is None


def test_icnn_roofline_and_retry_launches():
    rec = _record("fit", counters={"flagship": 0, "flagship_bf16": 0,
                                   "icnn_fwd": 2004, "icnn_bwd": 2000,
                                   "fit_steps": 2000},
                  bounds={"icnn_fwd": 1e-3, "icnn_bwd": 3e-3},
                  trace={"window_s": 1.0, "busy_s": 0.9, "kernels": {
                      "icnn_fwd": {"launches": 10, "seconds": 0.02},
                      "icnn_bwd": {"launches": 10, "seconds": 0.08}}})
    assert read("fit.launches_per_step", rec) == 2.0
    assert read("icnn.roofline", rec) == pytest.approx(40.0)


def test_readers_without_a_trace_are_silent():
    rec = _record("fit")
    for name in ("flagship.roofline", "icnn.roofline", "device_idle.fit"):
        assert read(name, rec) is None
