"""Port parity: the metric tracker (``fit/tracker.py``) of awesome_tpu_torch
against the JAX package's: the same series give the same best-model flags
and best performance, ``to_dict`` is JSON-equal, and a ``tracker.json``
written by either package loads in the other."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.fit import tracker as JTk
from awesome_tpu_torch.fit import tracker as TTk
from torch_one_thread import one_torch_thread  # noqa: F401


def _feed(tracker, values, value_type):
    """One epoch per value of the primary metric, a batch metric per
    step, and the best-model flags."""
    flags = []
    for v in values:
        tracker.step_metric("Loss", value_type(v * 2))
        tracker.tick_step()
        tracker.epoch_metric("Loss", value_type(v), mode="val")
        tracker.epoch_metric("IoU", value_type(1 - v), mode="eval")
        flags.append(tracker.is_current_state_best_model())
        tracker.tick_epoch()
    return flags


@pytest.mark.parametrize("maximize", [False, True])
def test_tracker_matches_jax(maximize, tmp_path):
    values = [0.9, 0.5, 0.7, 0.3, 0.3, 0.8]
    kw = dict(primary_metric="Loss", primary_mode="val",
              maximize_primary=maximize)
    jt, tt = JTk.Tracker(**kw), TTk.Tracker(**kw)
    jflags = _feed(jt, values, jnp.float32)
    tflags = _feed(tt, values, lambda v: torch.tensor(v, dtype=torch.float32))
    assert tflags == jflags
    assert tt.get_best_performance() == jt.get_best_performance()
    assert json.dumps(tt.to_dict()) == json.dumps(jt.to_dict())
    s = tt.series[("Loss", "epoch", "val")]
    assert s.at(3) == jt.series[("Loss", "epoch", "val")].at(3)
    assert s.at(99) is None and tt.tag("Loss", "epoch", "val") == \
        "val/epoch/Loss"
    # a tracker.json of either package loads in the other and goes on
    tt.save(str(tmp_path / "t" / "tracker.json"))
    jt.save(str(tmp_path / "j" / "tracker.json"))
    from_t = JTk.Tracker.load(str(tmp_path / "t" / "tracker.json"))
    from_j = TTk.Tracker.load(str(tmp_path / "j" / "tracker.json"))
    assert from_t.to_dict() == jt.to_dict()
    assert from_j.to_dict() == tt.to_dict()
    more = [0.1 if not maximize else 0.95, 0.6]
    assert _feed(from_j, more, float) == _feed(from_t, more, float)
    assert from_j.to_dict() == from_t.to_dict()


def test_log_loss_terms_and_data_tracker():
    jt, tt = JTk.Tracker(), TTk.Tracker()
    terms = {"loss": 1.5, "parts": {"seg": 0.5, "prior": {"pen": 0.25}}}
    JTk.log_loss_terms(jt, {"loss": jnp.float32(1.5),
                            "parts": {"seg": jnp.float32(0.5),
                                      "prior": {"pen": jnp.float32(0.25)}}})
    TTk.log_loss_terms(tt, {"loss": torch.tensor(1.5),
                            "parts": {"seg": torch.tensor(0.5),
                                      "prior": {"pen": 0.25}}})
    for scope in ("epoch", "batch"):
        JTk.log_loss_terms(jt, terms, mode="val", scope=scope, prefix="x")
        TTk.log_loss_terms(tt, terms, mode="val", scope=scope, prefix="x")
    assert tt.to_dict() == jt.to_dict()
    assert ("parts/prior/pen", "epoch", "train") in tt.series
    jd, td = JTk.DataTracker(), TTk.DataTracker()
    for i in range(3):
        jd.append(loss=np.float32(i), idx=np.arange(i + 1))
        td.append(loss=torch.tensor(float(i)), idx=torch.arange(i + 1))
    assert td.last_epoch() is None
    jdone, tdone = jd.epoch_end(), td.epoch_end()
    np.testing.assert_array_equal(tdone["loss"], jdone["loss"])
    assert tdone["idx"].dtype == object and len(tdone["idx"]) == 3
    for a, b in zip(tdone["idx"], jdone["idx"]):
        np.testing.assert_array_equal(a, b)
    td.append(loss=torch.ones(2))
    assert td.epoch_end()["loss"].shape == (1, 2)
    assert len(td.epochs) == 2 and td.last_epoch()["loss"].shape == (1, 2)
