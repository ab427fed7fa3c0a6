"""The checkpoint module (``fit/checkpoint.py``) and the model zoo
(``nn/zoo.py``) of awesome_tpu_torch: bitwise round trips, the JAX
package's ``meta.json``, the preemption-safe scan of tags and ``.old``
twins (ports of the checkpoint-only cases of ``tests/test_resume.py``),
the emergency dump, the prior cache, and the zoo's cached flow prefit."""
import json
import logging
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from awesome_tpu.fit import checkpoint as JC
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.fit import checkpoint as TC
from awesome_tpu_torch.fit.optim import adamax_init
from awesome_tpu_torch.fit.prior_fit import apply_prefits
from awesome_tpu_torch.fit.tracker import Tracker
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)
from awesome_tpu_torch.nn.zoo import Zoo
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"


class State(NamedTuple):
    seg: dict
    seg_state: object
    opt: object
    active: torch.Tensor
    step: torch.Tensor


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    children = {"w": torch.randn(3, 2, 4, generator=gen),
                "b": [torch.randn(3, 2, generator=gen)]}
    opt = adamax_init(children, (3, 2))
    opt = opt._replace(count=torch.randint(0, 9, (3, 2), generator=gen,
                                           dtype=torch.int32))
    return State(seg={"z": torch.randn(5, generator=gen),
                      "a": torch.randn(2, 2, generator=gen)
                      .to(torch.bfloat16)},
                 seg_state=None, opt=opt,
                 active=torch.tensor([[True, False]] * 3),
                 step=torch.tensor(7, dtype=torch.int32))


def _assert_bitwise(a, b):
    pa, pb = TT.tree_flatten_with_path(a), TT.tree_flatten_with_path(b)
    assert dict(pa).keys() == dict(pb).keys()
    db = dict(pb)
    for path, x in pa:
        y = db[path]
        if x is None:
            assert y is None, path
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert type(x) is type(y) and np.array_equal(x, y), path


def test_round_trip_is_bitwise(tmp_path):
    """NamedTuples, ``None``, int32 (T, K) counts, a bool mask, bfloat16,
    numpy arrays and Python scalars come back bitwise with their dtypes,
    with or without a template; a template's key order wins."""
    tree = {"state": _state(), "np": np.arange(3, dtype=np.int16),
            "scalars": (3, 2.5, True)}
    path = str(tmp_path / "a" / "tree")
    TC.save_pytree(tree, path)
    assert TC.pytree_exists(path)
    back = TC.load_pytree(path, device=CPU)
    _assert_bitwise(back, tree)
    assert type(back["state"]) is State
    assert type(back["state"].opt).__name__ == "AdamaxState"
    # the template in another key order: leaves matched by path
    reordered = {"scalars": tree["scalars"], "np": tree["np"],
                 "state": tree["state"]._replace(
                     seg={"a": tree["state"].seg["a"],
                          "z": tree["state"].seg["z"]})}
    got = TC.load_pytree(path, template=reordered)
    assert list(got) == ["scalars", "np", "state"]
    assert list(got["state"].seg) == ["a", "z"]
    _assert_bitwise(got, reordered)
    # a NamedTuple in the template restores from its dict form
    as_dict = {"count": tree["state"].opt.count, "m": tree["state"].opt.m,
               "u": tree["state"].opt.u}
    TC.save_pytree(as_dict, str(tmp_path / "d"))
    opt = TC.load_pytree(str(tmp_path / "d"), template=tree["state"].opt)
    assert type(opt) is type(tree["state"].opt)
    _assert_bitwise(opt, tree["state"].opt)
    with pytest.raises(ValueError, match="missing leaf"):
        TC.load_pytree(str(tmp_path / "d"),
                       template={"count": 0, "m": 0, "v": 0})
    with pytest.raises(ValueError, match="share the key path"):
        TC.save_pytree({"a/b": torch.zeros(1), "a": {"b": torch.zeros(1)}},
                       str(tmp_path / "clash"))


def test_agent_checkpoint_meta_matches_jax(tmp_path):
    """The same inputs give the JAX package's meta.json; the bundle loads
    back with the templates' structure."""
    tracker = Tracker(primary_metric="Loss", primary_mode="train")
    tracker.epoch_metric("Loss", 0.5)
    extra = {"epoch": 3, "state_kind": "multi", "stopped_early": False,
             "shape": (480, 640)}
    cfg = {"lr": 1e-4, "batch": 4}
    state = _state()
    TC.AgentCheckpoint("fbms_joint_latest", {"seg": state.seg},
                       opt_state=state.opt, tracker=tracker.to_dict(),
                       config=cfg, extra=extra).save(str(tmp_path / "t"))
    JC.AgentCheckpoint("fbms_joint_latest",
                       {"seg": {"z": np.zeros(5, np.float32)}},
                       opt_state={"c": np.zeros(2, np.int32)},
                       tracker=tracker.to_dict(), config=cfg,
                       extra=extra).save(str(tmp_path / "j"))
    metas = [json.load(open(tmp_path / d / "meta.json")) for d in "tj"]
    assert metas[0] == metas[1]
    back = TC.AgentCheckpoint.load(str(tmp_path / "t"),
                                   params_template={"seg": state.seg},
                                   opt_template=state.opt)
    _assert_bitwise(back.params, {"seg": state.seg})
    _assert_bitwise(back.opt_state, state.opt)
    assert back.extra["shape"] == [480, 640] and back.config == cfg
    assert Tracker.from_dict(back.tracker).to_dict() == tracker.to_dict()


def test_load_tag_with_twin_torn_primary_falls_back(tmp_path):
    """A torn primary tag (meta present, payload unreadable) falls through
    to the ``.old`` twin; neither readable gives None."""
    base = tmp_path / "ck"
    good = torch.arange(4.0)
    for d, arr in (("best.old", good), ("best", good + 1)):
        (base / d).mkdir(parents=True)
        TC.save_pytree((arr,), str(base / d / "params"))
        with open(base / d / "meta.json", "w") as f:
            json.dump({"extra": {}}, f)
    (base / "best" / "params.npz").write_bytes(b"torn")
    got = TC.load_tag_with_twin(str(base), "best", "params", (good,))
    assert got is not None and torch.equal(got[0], good)
    (base / "best.old" / "params.tree.json").write_text('{"tup')
    assert TC.load_tag_with_twin(str(base), "best", "params", (good,)) is None
    assert TC.load_tag_with_twin(str(base), "nope", "params", (good,)) is None


def test_orbax_directory_counts_as_absent(tmp_path, caplog):
    """A directory checkpoint (the JAX package's Orbax format) cannot be
    read here: it counts as absent, with a warning once, and load_pytree
    says why; the port's own saves stay readable beside it."""
    tree = (np.arange(3.0),)
    JC.save_pytree(tree, str(tmp_path / "params"))
    if not (tmp_path / "params").is_dir():  # no Orbax: make its shape
        (tmp_path / "params").mkdir()
        (tmp_path / "params" / "_METADATA").write_text("{}")
    with caplog.at_level(logging.WARNING):
        assert not TC.pytree_exists(str(tmp_path / "params"))
        assert not TC.pytree_exists(str(tmp_path / "params"))
    assert sum("Orbax directory" in r.message for r in caplog.records) == 1
    with pytest.raises(RuntimeError, match="Orbax directory"):
        TC.load_pytree(str(tmp_path / "params"), tree)
    TC.save_pytree(tree, str(tmp_path / "p2"))
    assert TC.pytree_exists(str(tmp_path / "p2"))
    np.testing.assert_array_equal(
        TC.load_pytree(str(tmp_path / "p2"), tree)[0], tree[0])


def _write_ck(d, extra):
    os.makedirs(d, exist_ok=True)
    TC.save_pytree((torch.zeros(2),), os.path.join(d, "train_state"))
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"extra": extra}, f)


def test_find_resumable_torn_meta_old_twin_and_kind(tmp_path):
    """Torn meta.json is skipped, the ``.old`` crash-window twin is found,
    kinds never cross, an early stop wins a tie, and the atomic swap
    leaves no residue."""
    base = str(tmp_path / "ck")
    _write_ck(os.path.join(base, "end"), {"epoch": 4, "state_kind": "joint"})
    _write_ck(os.path.join(base, "latest"),
              {"epoch": 8, "state_kind": "joint"})
    with open(os.path.join(base, "latest", "meta.json"), "w") as f:
        f.write('{"extra": {"epo')  # truncated
    got = TC.find_resumable(base, "joint")
    assert got is not None and got[0] == 4
    os.rename(os.path.join(base, "latest"), os.path.join(base, "latest.old"))
    _write_ck(os.path.join(base, "latest.old"),
              {"epoch": 6, "state_kind": "joint"})
    got = TC.find_resumable(base, "joint")
    assert got is not None and got[0] == 6 and got[1].endswith("latest.old")
    assert TC.find_resumable(base, "multi") is None
    _write_ck(os.path.join(base, "end"),
              {"epoch": 6, "state_kind": "joint", "stopped_early": True})
    assert TC.find_resumable(base, "joint")[1].endswith("end")
    tag = os.path.join(base, "atomic")
    for epoch in (2, 4):
        with TC.atomic_dir(tag) as tmp:
            _write_ck(tmp, {"epoch": epoch, "state_kind": "joint"})
    assert not os.path.exists(tag + ".tmp")
    assert not os.path.exists(tag + ".old")
    got = TC.find_resumable(base, "joint", tags=("atomic",))
    assert got is not None and got[0] == 4


def test_restore_resumable(tmp_path):
    """The newest resumable state rebuilt on the template, the tracker and
    the best tag restored; ``validate`` runs before loading unless the run
    is complete; nothing resumable gives None."""
    base = str(tmp_path / "ck")
    template = _state(0)
    assert TC.restore_resumable(base, "multi", template, 5) is None
    saved = _state(1)
    tracker = Tracker(primary_metric="Loss", primary_mode="train")
    tracker.epoch_metric("Loss", 0.25)
    for tag, st in (("latest", saved), ("best", _state(2))):
        with TC.atomic_dir(os.path.join(base, tag)) as tmp:
            TC.AgentCheckpoint("x", {"seg": st.seg},
                               tracker=tracker.to_dict(),
                               extra={"epoch": 3,
                                      "state_kind": "multi"}).save(tmp)
            TC.save_pytree(tuple(st), os.path.join(tmp, "train_state"))
    seen = []
    res = TC.restore_resumable(base, "multi", template, 5,
                               validate=lambda ep, ex: seen.append(ep))
    assert seen == [3] and res["epoch"] == 3
    assert type(res["state"]) is State
    _assert_bitwise(res["state"], saved)
    _assert_bitwise(State(*res["best"]), _state(2))
    assert res["tracker"].to_dict() == tracker.to_dict()
    done = TC.restore_resumable(base, "multi", template, 3,
                                validate=lambda ep, ex: seen.append(ep))
    assert done["epoch"] == 3 and seen == [3]


def test_emergency_and_prior_cache(tmp_path):
    """``run_with_emergency`` dumps the newest state and the traceback and
    re-raises; ``emergency_save`` skips a part it cannot save; the prior
    cache round trips."""
    state = {"p": torch.ones(2)}

    def boom():
        state["p"] = torch.full((2,), 5.0)
        raise ValueError("boom")

    d = str(tmp_path / "emergency")
    with pytest.raises(ValueError, match="boom"):
        TC.run_with_emergency(boom, d, lambda: state,
                              extra_getter=lambda: {"epoch": 2})
    meta = json.load(open(os.path.join(d, "emergency.json")))
    assert meta["error"] == "ValueError('boom')"
    assert "boom" in meta["traceback"] and meta["extra"] == {"epoch": 2}
    assert torch.equal(TC.load_pytree(os.path.join(d, "params"),
                                      device=CPU)["p"], state["p"])
    assert TC.run_with_emergency(lambda: 3, d, lambda: None) == 3
    d2 = TC.emergency_save(str(tmp_path / "e2"), params={"p": object()},
                           batch={"x": torch.zeros(1)})
    assert not os.path.exists(os.path.join(d2, "params.npz"))
    assert os.path.exists(os.path.join(d2, "batch.npz"))
    stacked = {"w": torch.randn(4, 3), "n": torch.arange(4)}
    TC.save_prior_cache(stacked, str(tmp_path / "cache"))
    _assert_bitwise(TC.load_prior_cache(str(tmp_path / "cache"), stacked),
                    stacked)


def _flagship(h=6, w=6):
    return t_factory(channels=2, hidden_units=8, flow_n_flows=2,
                     flow_output_fn="tanh", spatial_shape=(h, w),
                     convex_net_hidden_units=8, convex_net_hidden_layers=1,
                     device=CPU)


def test_zoo_round_trip_and_cached_prefit(tmp_path):
    """The zoo keys on the model's description and the config, refuses a
    template of another structure, and ``apply_prefits(zoo=...)`` fits the
    flow once and loads it bitwise on the second call."""
    zoo = Zoo(str(tmp_path / "zoo"))
    model = _flagship()
    params = model.init(torch.Generator().manual_seed(0))
    key = zoo.save_model_state("flow", model.flow_net, params["flow"],
                               config={"lr": 1e-2}, context={"n": 36})
    got, ctx = zoo.load_model_state("flow", model.flow_net, params["flow"],
                                    config={"lr": 1e-2})
    assert ctx == {"n": 36} and os.path.exists(
        os.path.join(zoo.path, key + ".json"))
    _assert_bitwise(got, params["flow"])
    assert zoo.load_model_state("flow", model.flow_net, params["flow"],
                                config={"lr": 1e-3}) == (None, {})
    wider = t_factory(channels=2, hidden_units=16, flow_n_flows=2,
                      flow_output_fn="tanh", spatial_shape=(6, 6),
                      device=CPU)
    assert zoo.load_model_state("flow", wider.flow_net, params["flow"],
                                config={"lr": 1e-2}) == (None, {})
    assert zoo.load_model_state("flow", model.flow_net, {"x": 0},
                                config={"lr": 1e-2}) == (None, {})
    ys, xs = np.mgrid[0:6, 0:6]
    pts = torch.tensor(np.stack([xs.ravel() / 6, ys.ravel() / 6], -1),
                       dtype=torch.float32)
    first = apply_prefits(model, params, pts, prefit_flow_identity=True,
                          flow_identity_steps=3, zoo=zoo)
    assert not torch.equal(first["flow"]["steps"][0]["s"]["l1"]["w"],
                           params["flow"]["steps"][0]["s"]["l1"]["w"])
    again = apply_prefits(model, params, pts, prefit_flow_identity=True,
                          flow_identity_steps=3, zoo=zoo)
    _assert_bitwise(again, first)
    # another zoo key is another entry: fitted anew (here for 1 step)
    other = apply_prefits(model, params, pts, prefit_flow_identity=True,
                          flow_identity_steps=1, zoo=zoo, zoo_key="other")
    assert not torch.equal(other["flow"]["steps"][0]["s"]["l1"]["w"],
                           first["flow"]["steps"][0]["s"]["l1"]["w"])


def _sample_config(samples):
    from awesome_tpu_torch.runner.config import AwesomeConfig

    cfg = AwesomeConfig(name_experiment="snap", device=CPU,
                        dataset_args={"seed": 0, "augmentation": True,
                                      **({} if samples is None
                                         else {"samples": samples})})
    cfg.prepare()
    return cfg


def test_checkpoint_samples_round_trip_bitwise(tmp_path):
    """A config with in-memory samples: their arrays go once into the
    checkpoint's ``samples.npz``, ``meta.json`` holds no array, and the
    loaded snapshot rebuilds every sample bit for bit."""
    from awesome_tpu_torch.data.synthetic import make_sample
    from awesome_tpu_torch.serialization.jsonconv import (
        from_jsonable,
        to_jsonable,
    )

    samples = [make_sample(i, h=48, w=64) for i in range(3)]
    cfg = _sample_config(samples)
    snap, arrays = TC.config_snapshot(cfg)
    d = str(tmp_path / "ck")
    with TC.atomic_dir(d) as tmp:
        TC.AgentCheckpoint("snap", {"w": torch.ones(2)}, config=snap,
                           arrays=arrays).save(tmp)
    assert sorted(os.listdir(d)) == ["meta.json", "params.npz",
                                     "params.tree.json", TC.SAMPLES_FILE]
    meta_text = open(os.path.join(d, "meta.json")).read()
    ref = to_jsonable(samples)
    assert len(meta_text) < len(json.dumps(ref)) / 20
    ref_meta = json.loads(meta_text)["config"]["dataset_args"]["samples"]
    assert ref_meta["__npz__"] == TC.SAMPLES_FILE
    assert "\"data\":" not in json.dumps(ref_meta)  # no inline array
    loaded = TC.AgentCheckpoint.load(d, device=CPU)
    back = from_jsonable(loaded.config["dataset_args"]["samples"])
    for a, b in zip(samples, back):
        assert type(a) is type(b)
        for k, v in vars(a).items():
            got = getattr(b, k)
            if isinstance(v, np.ndarray):
                assert got.dtype == v.dtype
                np.testing.assert_array_equal(got, v)
            else:
                assert got == v
    assert to_jsonable(back) == ref
    rest = {k: v for k, v in loaded.config["dataset_args"].items()
            if k != "samples"}
    assert rest == {"seed": 0, "augmentation": True}


def test_checkpoint_without_samples_writes_the_same_files(tmp_path):
    """Without in-memory samples the snapshot is ``to_jsonable(config)``
    and the checkpoint holds the files it always held."""
    from awesome_tpu_torch.serialization.jsonconv import to_jsonable

    cfg = _sample_config(None)
    snap, arrays = TC.config_snapshot(cfg)
    assert arrays == {} and snap == to_jsonable(cfg)
    d = TC.AgentCheckpoint("snap", {"w": torch.ones(2)}, config=snap,
                           arrays=arrays).save(str(tmp_path / "ck"))
    assert sorted(os.listdir(d)) == ["meta.json", "params.npz",
                                     "params.tree.json"]
    assert TC.AgentCheckpoint.load(d, device=CPU).config == json.loads(
        json.dumps(snap))
