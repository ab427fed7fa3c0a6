"""The host side of the mesh across cards, on the CPU: the backend rule
(``parallel.mesh.backend_for``, ``rank_device``) with the card count
patched, the rank's card under ``torchrun``'s environment
(``run.join_torchrun_world``), the smoke's check of that rule
(``chip_smoke._check_where``), the sharded sweep's manifest check, and
``tools.mesh_cards``' checks on hand-made rank results."""
import json
import os

import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import chip_smoke as cs
from awesome_tpu_torch import run
from awesome_tpu_torch.parallel import launch, mesh
from tools import mesh_cards


@pytest.fixture
def cards(monkeypatch):
    """``cards(n)`` makes ``torch.cuda.device_count`` say ``n``."""
    def set_cards(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return set_cards


@pytest.mark.parametrize("n_cards,ranks,want", [
    (4, 4, "nccl"), (4, 2, "nccl"), (2, 2, "nccl"), (1, 2, "gloo"),
    (2, 4, "gloo")])
def test_backend_rule(cards, n_cards, ranks, want):
    """NCCL when the host's ranks have a card each, gloo when they share
    cards; the CPU is gloo whatever the cards."""
    cards(n_cards)
    assert mesh.backend_for(torch.device("cuda"), ranks) == want
    assert mesh.backend_for(torch.device("cpu"), ranks) == "gloo"


def test_backend_rule_other_device_raises(cards):
    cards(4)
    with pytest.raises(ValueError, match="no mesh backend"):
        mesh.backend_for(torch.device("meta"), 2)


def test_rank_device(cards):
    """The cards round robin by the rank's index on its host; the CPU
    whatever the index; no card raises."""
    cards(4)
    assert [mesh.rank_device("cuda", r) for r in range(6)] == [
        torch.device("cuda", r % 4) for r in range(6)]
    assert mesh.rank_device("cpu", 3) == torch.device("cpu")
    cards(0)
    with pytest.raises(RuntimeError, match="needs a card"):
        mesh.rank_device("cuda", 0)


@pytest.mark.parametrize("local_world,want_card,want_backend", [
    (4, 1, "nccl"), (8, 1, "gloo")])
def test_torchrun_rank_takes_its_local_card(cards, monkeypatch, local_world,
                                            want_card, want_backend):
    """Under torchrun (rank 5 of 8, LOCAL_RANK 1) the rank's card is
    ``cuda:LOCAL_RANK``, not ``rank % cards``; it is made current before
    the group starts, and NCCL gets it as ``device_id`` when the host's
    ranks have a card each (4 ranks on 4 cards), gloo when they share
    (8 on 4)."""
    cards(4)
    calls = {}
    monkeypatch.setattr(mesh, "_RANK_DEVICE", None)
    monkeypatch.setattr(torch, "set_num_threads",
                        lambda n: calls.setdefault("threads", n))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("card", torch.device(d)))
    monkeypatch.setattr(launch.dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setattr(launch.dist, "is_initialized", lambda: False)
    for name, value in (("WORLD_SIZE", "8"), ("RANK", "5"),
                        ("LOCAL_RANK", "1"),
                        ("LOCAL_WORLD_SIZE", str(local_world))):
        monkeypatch.setenv(name, value)
    run.join_torchrun_world("cuda")
    assert calls["card"] == torch.device("cuda", want_card)
    assert calls["backend"] == want_backend
    assert (calls["rank"], calls["world_size"]) == (5, 8)
    assert calls["init_method"] == "env://"
    assert calls.get("device_id") == (torch.device("cuda", want_card)
                                      if want_backend == "nccl" else None)
    assert mesh._RANK_DEVICE == torch.device("cuda", want_card)
    assert calls["threads"] == max(1, (os.cpu_count() or 1) // local_world)


def test_torchrun_device_argument():
    """The device a run asks for, read before its config: ``--device``,
    translated as the config would be, the card by default."""
    assert run.device_arg([]) == "cuda"
    assert run.device_arg(["--num-epochs", "3", "--device", "cpu"]) == "cpu"
    assert run.device_arg(["--device", "tpu"]) == "cuda"


def _where(backend, *devices):
    return [{"backend": backend, "device": d} for d in devices]


@pytest.mark.parametrize("n_cards,where,ok", [
    (1, _where("gloo", "cuda:0", "cuda:0"), True),
    (2, _where("nccl", "cuda:0", "cuda:1"), True),
    (4, _where("nccl", "cuda:0", "cuda:1", "cuda:2", "cuda:3"), True),
    (2, _where("nccl", "cuda:0", "cuda:0"), False),
    (2, [{"backend": "nccl", "device": "cuda:0"},
         {"backend": "gloo", "device": "cuda:1"}], False),
    (2, _where("gloo", "cuda:0", "cuda:1"), False),
    (1, _where("nccl", "cuda:0", "cuda:0"), False),
    (1, _where("gloo", "cpu", "cpu"), False)])
def test_smoke_check_where(cards, n_cards, where, ok):
    """The smoke's rule: gloo where the ranks share the one card, NCCL
    with a card of its own per rank where there are enough; never NCCL
    on a shared card, mixed backends, or a rank off the cards."""
    cards(n_cards)
    if ok:
        assert cs._check_where(where, "mesh") == where
    else:
        with pytest.raises(AssertionError):
            cs._check_where(where, "mesh")


def test_smoke_collectives_record():
    assert cs._collectives(_where("gloo", "cuda:0", "cuda:0")) == (
        "gloo between 2 processes on 1 card, not NCCL across cards")
    assert cs._collectives(_where("nccl", "cuda:0", "cuda:1")) == (
        "NCCL between 2 processes on 2 cards")


def _manifests(runs, jobs, devices, names):
    os.makedirs(runs)
    for i, (mine, dev) in enumerate(zip(jobs, devices)):
        with open(os.path.join(runs, f"shard_{i}.json"), "w") as f:
            json.dump({"jobs": mine, "failures": [], "device": dev}, f)
    with open(os.path.join(runs, "comparison.md"), "w") as f:
        f.write(" ".join(names))


@pytest.mark.parametrize("shards,configs", [(2, 3), (4, 4), (4, 6)])
def test_sharded_runs_check(tmp_path, shards, configs):
    """The round-robin deal of ``configs`` configs to ``shards`` workers
    passes; a shard that runs another shard's config as well fails."""
    names = [f"smoke_shard_{i}" for i in range(configs)]
    jobs = [[f"c{j}.yaml" for j in range(i, configs, shards)]
            for i in range(shards)]
    devices = [f"cuda:{i}" for i in range(shards)]
    _manifests(str(tmp_path / "ok"), jobs, devices, names)
    res = cs._check_sharded_runs(str(tmp_path / "ok"), shards, configs)
    assert res["devices"] == devices
    twice = [jobs[0] + jobs[1][:1]] + jobs[1:]
    _manifests(str(tmp_path / "twice"), twice, devices, names)
    with pytest.raises(AssertionError):
        cs._check_sharded_runs(str(tmp_path / "twice"), shards, configs)


def _ranks(n, digest="a"):
    """Hand-made results of the ``ranks`` case on ``n`` cards."""
    key = "fit_%dx%d" % mesh_cards.MESHES[n][0]
    return [{key: {"where": {"backend": "nccl", "device": f"cuda:{r}"},
                   "digest": digest,
                   "reductions": {"grid": {"group": 0,
                                           "digests": ["x", "x"]}}},
             "resume": {"shape": [n // 2, 2], "leaves": 3,
                        "differing_leaves": [], "digest": digest}}
            for r in range(n)], key


def test_mesh_cards_placement(cards):
    """Rank r on ``cuda:r`` over NCCL passes; two ranks on one card, or
    rank r on another card than ``cuda:r``, fails."""
    cards(4)
    ranks, key = _ranks(4)
    assert mesh_cards.check_placement(ranks, 4)[3]["device"] == "cuda:3"
    ranks[1][key]["where"]["device"] = "cuda:0"
    with pytest.raises(AssertionError):
        mesh_cards.check_placement(ranks, 4)
    ranks[1][key]["where"]["device"] = "cuda:2"
    ranks[2][key]["where"]["device"] = "cuda:1"
    with pytest.raises(AssertionError):
        mesh_cards.check_placement(ranks, 4)


def test_mesh_cards_bitwise_checks():
    """Rank results and each group's sums must be equal in every bit;
    a resumed run must equal the uninterrupted one."""
    ranks, key = _ranks(2)
    assert mesh_cards.check_same_bits(ranks, key) == "a"
    assert mesh_cards.check_reductions(ranks, key)["groups"] == 1
    assert mesh_cards.check_resume(ranks)["bitwise"]
    ranks[1][key]["digest"] = "b"
    with pytest.raises(AssertionError):
        mesh_cards.check_same_bits(ranks, key)
    ranks[1][key]["reductions"]["grid"]["digests"] = ["y", "y"]
    with pytest.raises(AssertionError):
        mesh_cards.check_reductions(ranks, key)
    ranks[0][key]["reductions"]["grid"]["digests"] = ["x", "z"]
    with pytest.raises(AssertionError):
        mesh_cards.check_reductions(ranks, key)
    ranks[1]["resume"]["differing_leaves"] = [2]
    with pytest.raises(AssertionError):
        mesh_cards.check_resume(ranks)


def _view(used, processes, named=True):
    return {"processes": processes, "cards": {
        c: {"used_mib": m, "processes": (1 if m and m > 200 else 0)
            if named else None} for c, m in enumerate(used)}}


@pytest.mark.parametrize("views,ok", [
    # two ranks on cards 0 and 1 of 4, then both ended
    ([_view([900, 900, 0, 0], 2), _view([0, 0, 0, 0], 0)], True),
    # nvidia-smi cannot name a process's card, nor show memory
    ([_view([None] * 4, 2, named=False)], True),
    # a third context on the machine: this process's, or a rank's second
    ([_view([900, 900, 0, 0], 3, named=False)], False),
    # a card past the mesh's in use
    ([_view([900, 0, 900, 0], 2)], False),
    # card 1 never in use
    ([_view([900, 0, 0, 0], 1)], False),
    # two processes on card 0
    ([{"processes": 2, "cards": {0: {"used_mib": 900, "processes": 2},
                                 1: {"used_mib": 900, "processes": 0}}}],
     False)])
def test_card_watch_check(views, ok):
    """One context per rank on a card of its own, as nvidia-smi shows it:
    never more compute processes than ranks, none doubled on a card, the
    first cards and only they in use."""
    watch = mesh_cards.CardWatch()
    watch.views = views
    if ok:
        assert watch.check(2, "case")["most_processes_at_once"] == 2
    else:
        with pytest.raises(AssertionError):
            watch.check(2, "case")


def test_card_watch_all_at_once():
    """The ranks case needs every rank's context at one sample."""
    watch = mesh_cards.CardWatch()
    watch.views = [_view([900, 0], 1), _view([0, 900], 1)]
    assert watch.check(2, "case")["cards_in_use"] == [0, 1]
    with pytest.raises(AssertionError):
        watch.check(2, "case", all_at_once=True)
