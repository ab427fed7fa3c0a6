"""How far the batched fused fit of the smoke's mesh phase moves when only
the order of its sums changes: the single-process fit against (a) the
same fit with its points permuted and (b) the fit on a (1, 2) mesh of
two CPU ranks (the points split over 'grid'). The fit is chaotic in the
order of its sums: both differences stay near float32 rounding for the
first ~100 steps and grow by orders of magnitude by step 200, so the
smoke holds the sharded fit step for step at fixed params and over its
first steps only (``chip_smoke.MESH_EXACT_STEPS``).

    python3 -m tools.mesh_drift [--steps 100 200] [--shape 48 64]

Runs on the CPU (the kernel's plain version). Prints one JSON line per
step count: the largest parameter difference and the largest relative
loss difference over all steps and at every 20th step, for (a) and (b).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def fit(shape, steps, mesh_shape=None, permute=False):
    """The smoke's mesh fit (``chip_smoke.mesh_fit``'s inputs) on the CPU;
    host params and loss history."""
    import torch

    import chip_smoke as cs
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import fit_priors_batched
    from awesome_tpu_torch.parallel import make_mesh

    model, pts, targets, stacked = cs._mesh_fit_inputs("cpu", tuple(shape))
    if permute:
        perm = torch.randperm(pts.shape[0],
                              generator=torch.Generator().manual_seed(0))
        pts, targets = pts[perm], targets[:, perm]
    mesh = make_mesh(mesh_shape) if mesh_shape else None
    fitted, aux = fit_priors_batched(
        model, stacked, pts, targets, cs._mesh_fit_cfg(steps),
        retry_keys=[40 + i for i in range(len(cs.MESH_SHIFTS))], mesh=mesh)
    return ([x.numpy() for x in T.tree_leaves(fitted)],
            aux["loss_hist"].numpy())


def _diff(a, b, steps):
    rel = np.abs(a[1] - b[1]) / np.abs(b[1])
    return {"max_param_diff": float(max(np.abs(x - y).max()
                                        for x, y in zip(a[0], b[0]))),
            "max_loss_rel_diff": float(rel.max()),
            "loss_rel_diff_every_20": [float(rel[:, i].max())
                                       for i in range(0, steps, 20)]}


def main(argv=None) -> None:
    import torch

    from awesome_tpu_torch.parallel.launch import spawn

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, nargs="+", default=[100, 200])
    p.add_argument("--shape", type=int, nargs=2, default=[48, 64])
    args = p.parse_args(argv)
    torch.set_num_threads(2)
    for steps in args.steps:
        ref = fit(args.shape, steps)
        permuted = fit(args.shape, steps, permute=True)
        mesh = spawn(fit, 2, (args.shape, steps, (1, 2)), device="cpu",
                     threads=2)[0]
        print(json.dumps({"steps": steps, "shape": args.shape,
                          "device": "cpu",
                          "points_permuted": _diff(permuted, ref, steps),
                          "mesh_1x2": _diff(mesh, ref, steps)}), flush=True)


if __name__ == "__main__":
    main()
