"""On the card: each cell's control (the configuration's next lower
precision: the bf16 build of the fused flagship kernel, the ICNN kernels
on bf16-rounded params and points, TF32 in the joint step) comes out not
correct on three seeds, at the cell's own size; the program as the
configuration states it comes out correct.

    python3 -m pytest portbench/tests -q -m gpu
"""
import time

import pytest

from portbench import harness, spec

BENCH = spec.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"] if c["chips"] == 1]
SEEDS = (4100000001, 4100000002, 4100000003)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run(cell: str, seed: int, control: bool) -> dict:
    entry = spec.cell(BENCH, cell)
    return harness.run_cell(entry, spec.config(entry["config"]),
                            spec.traffic(entry["traffic"]),
                            spec.limits(cell), seed, 0.0, False, "cuda",
                            time.perf_counter(), control=control)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    for seed in SEEDS:
        rec = run(cell, seed, True)
        assert not rec["correct"], (seed, rec["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(card, cell):
    rec = run(cell, SEEDS[0], False)
    assert rec["correct"], rec["checks"]
