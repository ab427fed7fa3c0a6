#!/usr/bin/env python
"""How-To: Multiple objects on the PyTorch port — one child prior per
object, grown on demand; counterpart of ``examples/howto_multi_object.py``.

Demonstrates the multi-object machinery end-to-end on a synthetic scene
with two separate objects (spec:
`awesome/model/multiple_object_aware_path_connected_net.py` +
`awesome/model/number_based_multi_prior_module.py`):

1. build a ``MultiPriorModule`` with a static slot capacity,
2. fit BOTH objects' child priors simultaneously against per-object
   unaries (`fit.prior_fit.fit_multi_object_priors` — the image x object
   axes flatten into one batch),
3. grow the active count mid-way (fresh slots join the next fit call),
4. combine the per-object fields into one mask (min over objects = union
   of sub-level sets).

Run: ``python examples/torch_howto_multi_object.py [--device cpu]`` (on
the card by default).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_two_object_scene(h=64, w=96):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    disk = ((yy - h * 0.35) ** 2 + (xx - w * 0.25) ** 2) <= (0.18 * h) ** 2
    ell = (((yy - h * 0.65) / (0.22 * h)) ** 2
           + ((xx - w * 0.7) / (0.14 * w)) ** 2) <= 1.0
    return disk, ell


def ascii_mask(mask, step=2):
    h, w = mask.shape
    return "\n".join(
        "".join("#" if mask[i, j] else "." for j in range(0, w, step))
        for i in range(0, h, step * 2)
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.device import resolve_device
    from awesome_tpu_torch.fit.prior_fit import (
        FitConfig,
        fit_multi_object_priors,
    )
    from awesome_tpu_torch.measures.metrics import iou
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.nn.module import make_generator
    from awesome_tpu_torch.nn.multi_prior import MultiPriorModule

    dev = resolve_device(args.device)
    h, w = 64, 96
    disk, ell = make_two_object_scene(h, w)
    pts = G.flatten_grid(G.pixel_grid((h, w), device=dev))  # (h*w, 2)

    # per-object unaries: fg = 0 within the object, bg = 1 elsewhere
    # (channel k supervises child k; other objects are background for it)
    targets = np.ones((1, 3, h * w, 1), np.float32)  # capacity 3, 1 image
    targets[0, 0, disk.reshape(-1), 0] = 0.0
    targets[0, 1, ell.reshape(-1), 0] = 0.0
    targets = torch.as_tensor(targets, device=dev)

    mp = MultiPriorModule(
        child=ConvexNextNet(in_features=2, n_hidden=64, n_hidden_layers=1,
                            device=dev),
        max_priors=3,
    )
    params = mp.init(make_generator(0))
    stacked = T.tree_map(lambda x: x[None], params["children"])

    # phase 1: only slot 0 active
    cfg = FitConfig(num_steps=args.steps, lr=1e-2, weight_mode="equal")
    active = torch.tensor([[True, False, False]], device=dev)
    fitted, _ = fit_multi_object_priors(mp.child, stacked, pts, targets,
                                        cfg, valid_mask=active)
    # growth: a second object appears -> activate slot 1 (its fresh init
    # simply joins the next fit call; slot 0 passes through untouched)
    active = torch.tensor([[False, True, False]], device=dev)
    fitted, _ = fit_multi_object_priors(mp.child, fitted, pts, targets,
                                        cfg, valid_mask=active)

    with torch.no_grad():
        outs = mp.apply({"children": T.tree_map(lambda x: x[0], fitted)},
                        pts)  # (N, 3)
    probs = torch.sigmoid(outs)
    combined = mp.combine(probs, count=2)  # min over the 2 active objects
    mask = combined.reshape(h, w).cpu().numpy() < 0.5
    both = disk | ell
    print(ascii_mask(mask))
    print("combined IoU vs union of both objects:",
          round(float(iou(torch.as_tensor(mask), torch.as_tensor(both))), 3))
    for k, gt in ((0, disk), (1, ell)):
        mk = probs[:, k].reshape(h, w).cpu().numpy() < 0.5
        print(f"object {k} IoU:",
              round(float(iou(torch.as_tensor(mk), torch.as_tensor(gt))), 3))


if __name__ == "__main__":
    main()
