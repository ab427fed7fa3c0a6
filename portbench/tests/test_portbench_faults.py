"""The rest of a run, without the harness's look for a card, on the CPU at
a small size, with the timed path broken underneath: ``correct`` must come
out false for each fault a cell can have, and true without one.

The faults: a step that returns its state unchanged (every step, or a
sequence's warm fits alone); half of the batch (a
fit's points, a training step's frames) left out and the mean taken over
the rest; an answer (a fit's params, the gate's IoU, a training step's new
params) altered where it is produced; on the mesh, the exchange between
the ranks left out. The mesh cell runs four gloo ranks on the CPU, each
broken alike.

On the card (``-m gpu``) the same faults at each one-chip cell's own size,
on three seeds: the readings the limits' upper ends come from (``-s``
prints them).
"""
import time

import pytest
import torch

from portbench import harness, spec

BENCH = spec.benchmark()
MESH = "fbms_pc.mesh_1x4_480x640"
# small sizes at which the fits converge, so sound runs pass every limit
SIZES = {
    "fbms_pc.pretrain_480x640": ({},
                                 {"height": 48, "width": 64,
                                  "check_units": 1}),
    "howto_convex.gated_8x480x640": ({},
                                     {"height": 48, "width": 64,
                                      "images": 2}),
    "fbms_pc.joint_2x480x640": ({}, {"height": 32, "width": 32}),
    MESH: ({"num_steps": 300}, {"height": 48, "width": 64}),
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def inputs_of(cell: str):
    entry = spec.cell(BENCH, cell)
    over_cfg, over_trf = SIZES[cell]
    cfg = dict(spec.config(entry["config"]), **over_cfg)
    trf = dict(spec.traffic(entry["traffic"]), **over_trf)
    return entry, cfg, trf


def run(cell: str) -> dict:
    entry, cfg, trf = inputs_of(cell)
    return harness.run_cell(entry, cfg, trf, spec.limits(cell), 4242, 0.0,
                            False, "cpu")


# each fault takes a setattr: pytest's monkeypatch.setattr in this
# process, the builtin in a mesh's rank (which ends with the run)

def unchanged(put):
    from awesome_tpu_torch.fit import optim

    for name in ("adam_update", "adamax_update"):
        put(optim, name, lambda params, grads, state, *a, **k:
            (params, state))


def unchanged_warm(put):
    """The sequential fit's warm fits return their carry unchanged."""
    from awesome_tpu_torch.fit import prior_fit

    real = prior_fit.make_fit_fn
    warm_steps = spec.config("fbms_pc")["warm_steps"]

    def make(model, cfg, loss_fn=None):
        fit = real(model, cfg, loss_fn)
        if cfg.num_steps != warm_steps:
            return fit

        def warm(params, *a, **k):
            return params, fit(params, *a, **k)[1]

        return warm

    put(prior_fit, "make_fit_fn", make)


def half_points(put):
    from awesome_tpu_torch.fit import fused_fit, prior_fit

    real = prior_fit.make_point_weights

    def half(target_points, *a, **k):
        w = real(target_points, *a, **k).clone()
        w[w.shape[0] // 2:] = 0.0
        return 2.0 * w

    put(prior_fit, "make_point_weights", half)
    put(fused_fit, "make_point_weights", half)


def half_frames(put):
    from awesome_tpu_torch.fit import trainer

    real = trainer.epoch_batches

    def half(num_images, batch_size, rng):
        idx, wgt = real(num_images, batch_size, rng)
        wgt = wgt.copy()
        wgt[:, batch_size // 2:] = 0.0
        return idx, wgt

    put(trainer, "epoch_batches", half)


def altered_fit(put):
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit import fused_fit, prior_fit

    real = prior_fit.run_fit_loop

    def altered(*a, **k):
        params, hist, scale = real(*a, **k)
        return T.tree_map(lambda t: t + 1.0, params), hist, scale

    altered.steps = 0
    put(prior_fit, "run_fit_loop", altered)
    put(fused_fit, "run_fit_loop", altered)


def altered_step(put):
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit import trainer

    real = trainer._seg_update

    def altered(*a, **k):
        params, opt = real(*a, **k)
        return T.tree_map(lambda t: t + 1e-3, params), opt

    put(trainer, "_seg_update", altered)


def altered_gate(put):
    from awesome_tpu_torch.fit import prior_fit

    real = prior_fit._gate_iou
    put(prior_fit, "_gate_iou", lambda *a, **k: 0.9 * real(*a, **k))


def no_exchange(put):
    from awesome_tpu_torch.parallel.mesh import Mesh

    put(Mesh, "reducer", lambda self, axis, n: None)


FAULTS = {
    "fbms_pc.pretrain_480x640": [unchanged, unchanged_warm, half_points,
                                 altered_fit],
    "howto_convex.gated_8x480x640": [unchanged, half_points, altered_fit,
                                     altered_gate],
    "fbms_pc.joint_2x480x640": [unchanged, half_frames, altered_step],
    MESH: [unchanged, half_points, altered_fit, no_exchange],
}


def broken_rank(fault, ctx, seconds, trace, start_wall):
    """A mesh rank with ``fault`` in place (module level: the spawned
    ranks import it)."""
    from portbench.drivers import mesh_fit

    fault(setattr)
    return mesh_fit.rank_main(ctx, seconds, trace, start_wall)


def run_broken_mesh(fault) -> dict:
    from awesome_tpu_torch.parallel.launch import spawn

    from portbench.drivers import mesh_fit

    entry, cfg, trf = inputs_of(MESH)
    ctx = harness.Context(cfg, trf, 4242, "cpu", entry["chips"])
    results = spawn(broken_rank, ctx.chips, (fault, ctx, 0.0, False,
                                             time.time()), device="cpu")
    record, state = mesh_fit.assemble(ctx, results)
    record["cell"] = MESH
    return harness.judge(mesh_fit, state, record, spec.limits(MESH))


@pytest.mark.parametrize("cell", list(FAULTS))
def test_sound_run_is_correct(cell):
    rec = run(cell)
    assert rec["correct"], rec["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_caught(cell, fault, monkeypatch):
    if cell == MESH:
        rec = run_broken_mesh(fault)
    else:
        fault(monkeypatch.setattr)
        rec = run(cell)
    assert not rec["correct"], rec["checks"]


CARD_SEEDS = (4200000001, 4200000002, 4200000003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs if c != MESH],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_on_the_card(card, cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    entry = spec.cell(BENCH, cell)
    for seed in CARD_SEEDS:
        rec = harness.run_cell(entry, spec.config(entry["config"]),
                               spec.traffic(entry["traffic"]),
                               spec.limits(cell), seed, 0.0, False, "cuda",
                               time.perf_counter())
        print("fault", cell, fault.__name__, seed,
              {k: v["value"] for k, v in rec["checks"].items()})
        assert not rec["correct"], rec["checks"]
