"""On the card: the device mesh on the backend rule's choice. Two ranks
(on ``cuda:0`` over gloo on one card; on ``cuda:0`` and ``cuda:1`` over
NCCL where there are more): the sharded fused fit (K2) on (2, 1) and
(1, 2) and the convexity runner (K4/K5) on [2, 1] and [1, 2] against
single-process runs, at the smoke's tolerances (``chip_smoke.mesh_path``),
at a smaller size. Then NCCL with a card per rank on 2 and 4 cards
(``tools.mesh_cards``'s matrix at that size): the fit on every mesh of
the card count, the runner, a bitwise resume and ``dryrun_multichip``;
each skipped where the machine has fewer cards.

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_parallel_gpu.py``
(on a machine with four cards for every NCCL case). Without a card its
tests skip."""
import os

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

SHAPE = (64, 64)
STEPS = 50
EPOCHS = 10
PRETRAIN = 20


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _rank(root, at):
    import chip_smoke as cs
    from awesome_tpu_torch.parallel import make_mesh

    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(shape)
        out[f"fit_{shape}"] = cs.mesh_fit("cuda", mesh, shape=SHAPE,
                                          steps=STEPS)
        out[f"fit_{shape}"].update(cs.mesh_steps("cuda", mesh, at,
                                                 shape=SHAPE))
        out[f"fit_{shape}"]["where"] = cs._where(mesh)
        out[f"runner_{shape}"] = cs.mesh_runner(
            "cuda", os.path.join(root, f"runner_{shape[0]}x{shape[1]}"),
            list(shape), epochs=EPOCHS, pretrain=PRETRAIN)
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from awesome_tpu_torch.parallel.launch import spawn

    root = str(tmp_path_factory.mktemp("mesh_gpu"))
    single = {"fit": cs.mesh_fit("cuda", shape=SHAPE, steps=STEPS),
              "runner": cs.mesh_runner("cuda", os.path.join(root, "single"),
                                       epochs=EPOCHS, pretrain=PRETRAIN)}
    at = single["fit"]["params"]
    single["fit"].update(cs.mesh_steps("cuda", None, at, shape=SHAPE))
    return single, spawn(_rank, 2, (root, at), device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_sharded_fused_fit_on_k2(cuda_device, mesh_runs, shape):
    """K2 on every rank (gloo, on the card), as many launches as the
    single fit's (the steps and the gate retry's). On both meshes: one
    step at the inits and at the fitted params, each rank's K2 on its
    block of the images and points, within the loss rtol 1e-5 and the
    grads rtol 5e-4 of the single process; the first steps' losses within
    rtol 1e-5, the final ones within 1e-2 and the same gate outcomes. On
    (1, 2) also every step's loss within rtol 1e-5 and the params within
    1e-4; on (2, 1) bitwise where K2 tiles an image as at the single
    fit's G."""
    import chip_smoke as cs
    from awesome_tpu_torch.ops.flagship import FlagshipSpec, launch_shape

    single, ranks = mesh_runs
    ref = single["fit"]
    res = ranks[0][f"fit_{shape}"]
    assert ref["k2"] == 2 * STEPS
    assert [r[f"fit_{shape}"]["k2"] for r in ranks] == [ref["k2"]] * 2
    cs._check_where([r[f"fit_{shape}"]["where"] for r in ranks], "fit")
    for at in ("init", "fitted"):
        (l1, g1), (lm, gm) = ref[f"step_{at}"], res[f"step_{at}"]
        np.testing.assert_allclose(lm, l1, rtol=cs.LOSS_RTOL)
        np.testing.assert_allclose(gm, g1, rtol=5e-4,
                                   atol=1e-6 * np.abs(g1).max())
    np.testing.assert_allclose(res["loss_hist"][:, :cs.MESH_EXACT_STEPS],
                               ref["loss_hist"][:, :cs.MESH_EXACT_STEPS],
                               rtol=cs.LOSS_RTOL)
    np.testing.assert_allclose(res["loss_hist"][:, -1],
                               ref["loss_hist"][:, -1], rtol=1e-2)
    np.testing.assert_array_equal(res["gate_iou"] >= 0.5,
                                  ref["gate_iou"] >= 0.5)
    if shape[1] == 1:
        n = SHAPE[0] * SHAPE[1]
        spec = FlagshipSpec.of(cs.bench_model(SHAPE, cuda_device))
        dev = torch.device(cuda_device)
        if launch_shape(spec, n, 2, None, dev) == launch_shape(spec, n, 4,
                                                               None, dev):
            for a, b in zip(res["params"], ref["params"]):
                np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(res["loss_hist"], ref["loss_hist"],
                                   rtol=cs.LOSS_RTOL)
        for a, b in zip(res["params"], ref["params"]):
            np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_mesh_runner_on_k4_k5(cuda_device, mesh_runs, shape):
    """The convexity runner on the mesh: one K4 and one K5 launch per rank
    per epoch (K4 once more per evaluation) and the loss history within
    rtol 2e-3, atol 2e-4 of one process."""
    import chip_smoke as cs

    single, ranks = mesh_runs
    res = ranks[0][f"runner_{shape}"]
    assert res["mesh"] == {"data": shape[0], "grid": shape[1]}
    for r in ranks:
        run = r[f"runner_{shape}"]
        assert run["k5"] == EPOCHS
        assert run["k4"] == EPOCHS + run["evals"]
    np.testing.assert_allclose(res["loss_hist"], single["runner"]["loss_hist"],
                               rtol=cs.MESH_RUNNER_RTOL,
                               atol=cs.MESH_RUNNER_ATOL)


# --- NCCL, a card per rank ---------------------------------------------------

NCCL_SIZES = dict(fit_shape=SHAPE, steps=STEPS, epochs=EPOCHS,
                  pretrain=PRETRAIN, k2_reps=3)


def _cards_or_skip(n: int) -> None:
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        pytest.skip(f"needs {n} cards for NCCL with a card per rank; "
                    f"{found} present")


@pytest.fixture(scope="module", params=[2, 4], ids=["2cards", "4cards"])
def nccl_runs(request, tmp_path_factory):
    """``tools.mesh_cards``'s ranks case on ``n`` cards at the small size:
    (n, the sizes, every rank's results)."""
    n = request.param
    _cards_or_skip(n)
    from tools import mesh_cards

    sizes = mesh_cards.Sizes(**NCCL_SIZES)
    root = str(tmp_path_factory.mktemp(f"nccl_{n}"))
    return n, sizes, mesh_cards.run_ranks(n, root, sizes)


def _nccl_where(ranks, n):
    import chip_smoke as cs
    from tools import mesh_cards

    shape = mesh_cards.MESHES[n][0]
    where = cs._check_where([r[f"fit_{shape[0]}x{shape[1]}"]["where"]
                             for r in ranks], "ranks")
    assert where == [{"backend": "nccl", "device": f"cuda:{r}"}
                     for r in range(n)]


@pytest.mark.gpu
def test_nccl_sharded_fused_fit_on_k2(nccl_runs):
    """Rank r on ``cuda:r`` over NCCL. On every mesh of the card count
    ((2, 1) and (1, 2); (4, 1), (2, 2) and (1, 4)): K2 on every rank, as
    many launches as the single fit's, the step at the inits and at the
    fitted params within the loss rtol 1e-5 and the grads rtol 5e-4 of
    the single process, the first steps' losses within rtol 1e-5, the
    final ones within 1e-2, the same gate outcomes
    (``chip_smoke.mesh_fit_entry``); every rank's results and each axis's
    sums equal in every bit; K2 at each rank's shape within its plain
    version's tolerances on the rank's card."""
    from tools import mesh_cards

    n, sizes, ranks = nccl_runs
    _nccl_where(ranks, n)
    fits = mesh_cards.check_fits(ranks, n, sizes)
    for shape in mesh_cards.MESHES[n]:
        entry = fits[f"fit_{shape[0]}x{shape[1]}"]
        assert entry["k2_per_rank"] == [2 * STEPS] * n
        launches = [k["launches"] for k in entry["K2_per_card"]]
        assert launches == [2 * STEPS] * n


@pytest.mark.gpu
def test_nccl_mesh_runner_on_k4_k5(nccl_runs):
    """The convexity runner on every mesh of the card count: one K4 and
    one K5 launch per rank per epoch (K4 once more per evaluation), the
    loss history within rtol 2e-3, atol 2e-4 of one process and equal in
    every bit on every rank; K4/K5 within their plain versions'
    tolerances on each rank's card."""
    from tools import mesh_cards

    n, sizes, ranks = nccl_runs
    runners = mesh_cards.check_runners(ranks, n, sizes)
    for shape in mesh_cards.MESHES[n]:
        assert len(runners[f"runner_{shape[0]}x{shape[1]}"]
                   ["K4_K5_per_card"]) == n


@pytest.mark.gpu
def test_nccl_mesh_resume_bitwise(nccl_runs):
    """A (n // 2, 2) joint-step run saved after 2 of 4 steps, loaded on
    every rank and stepped on, equals the uninterrupted run in every
    bit, on every rank alike."""
    from tools import mesh_cards

    n, _, ranks = nccl_runs
    res = mesh_cards.check_resume(ranks)
    assert res["shape"] == [n // 2, 2] and res["leaves"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
def test_nccl_dryrun_multichip(n):
    """``dryrun_multichip(n)`` on n cards: the joint step, the protocol
    and the FBMS joint loop with finite losses every rank agrees on,
    rank r on ``cuda:r`` over NCCL."""
    _cards_or_skip(n)
    from awesome_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(n)
    assert out.pop("ranks") == [{"backend": "nccl", "device": f"cuda:{r}"}
                                for r in range(n)]
    assert set(out) == {"step_loss", "protocol_loss", "protocol_miou",
                        "fbms_loss"}
    assert all(np.isfinite(v) for v in out.values())
