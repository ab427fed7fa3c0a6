#!/usr/bin/env python
"""How-To: Path-connectedness on the PyTorch port — relax "convex" to
"connected"; counterpart of ``examples/howto_path_connectedness.py``.

Script equivalent of `notebooks/how_to/path-connectedness.ipynb`: a
RealNVP diffeomorphism warps coordinate space in front of the ICNN, so
the thresholded mask is the diffeomorphic image of a convex set — exactly
the path-connected regions. Demonstrates the flagship prior, its
flow-identity prefit, and the analytic inverse (the learned deformation
mapped back).

Uses the reference's shipped scribbled cat when the reference tree is
present (``AWESOME_REFERENCE_ROOT``; ``runner/teaser.py:
reference_data_available``) — delegating to the port's
``run_howto_path_connectedness``, the single source of truth for that
protocol — and a synthetic banana scene otherwise (--synthetic to force
it). Writes overlay PNGs (through PIL) to --out. Runs on the card unless
``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_banana(h=96, w=96):
    """A curved (non-convex but connected) object."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = h * 0.62, w * 0.5
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    theta = np.arctan2(yy - cy, xx - cx)
    band = (np.abs(r - 0.32 * h) < 0.1 * h) & (theta < -0.15)
    img = np.full((h, w, 3), 0.15, np.float32)
    img[band] = (0.9, 0.8, 0.2)
    return img, band


def run_cat(args, dev):
    """The shipped-cat protocol via the teaser replay (exact notebook
    semantics; scored against the reference's own shipped prior mask)."""
    from awesome_tpu_torch.runner.teaser import run_howto_path_connectedness

    steps = args.epochs or 4000
    res = run_howto_path_connectedness(
        steps_scale=steps / 4000.0, down_scale=4, return_fit=True,
        device=dev)
    fit = res.extra["fit"]
    print(f"loss {res.extra['loss']:.5f}, "
          f"IoU vs reference shipped mask {res.iou:.3f}")
    return (fit["image"], fit["likelihood"], res.mask,
            fit["model"], fit["params"])


def run_banana(args, dev):
    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.fit.prior_fit import (
        FitConfig,
        fit_prior,
        learn_flow_identity,
    )
    from awesome_tpu_torch.measures.metrics import iou
    from awesome_tpu_torch.nn.module import make_generator
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    img, band = make_banana(args.size, args.size)
    h, w = band.shape
    unaries = (1.0 - band).astype(np.float32)  # fg = 0

    model = real_nvp_path_connected_net(
        channels=2, flow_n_flows=12, flow_output_fn="tanh",
        spatial_shape=(h, w), hidden_units=32, device=dev,
    )
    params = model.init(make_generator(0))
    points = G.flatten_grid(G.pixel_grid((h, w), device=dev))
    target = torch.as_tensor(unaries, device=dev).reshape(-1, 1)

    # prefit the flow to the identity (reference prefit_flow_net_identity)
    params, _ = learn_flow_identity(model, params, points, max_iter=100)
    cfg = FitConfig(num_steps=args.epochs or 2000, lr=1e-3,
                    gate_threshold=0.5)
    fitted, aux = fit_prior(model, params, points, target, cfg)
    with torch.no_grad():
        prob = torch.sigmoid(model.apply(fitted, points))
    score = float(iou(prob > 0.5, target > 0.5, invert=True))
    print(f"loss {float(aux['loss_hist'][-1]):.5f}, fit IoU {score:.3f}")
    mask = prob.reshape(h, w).cpu().numpy() < 0.5
    return img, band, mask, model, fitted


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=None,
                   help="fit steps (default: 4000 on the cat — the "
                        "scribble seed needs to EXPAND — 2000 synthetic)")
    p.add_argument("--out", type=str, default="howto_pathconn_out")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic banana even if the reference "
                        "cat image is present")
    p.add_argument("--size", type=int, default=96,
                   help="the synthetic scene's side in pixels")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.device import resolve_device
    from awesome_tpu_torch.runner.functions import save_overlay
    from awesome_tpu_torch.runner.teaser import reference_data_available

    dev = resolve_device(args.device)
    on_cat = not args.synthetic and reference_data_available()
    img, band, mask, model, fitted = (
        run_cat(args, dev) if on_cat else run_banana(args, dev))

    os.makedirs(args.out, exist_ok=True)
    save_overlay(img, band, os.path.join(args.out, "gt.png"))
    save_overlay(img, mask, os.path.join(args.out, "mask.png"))

    # the learned deformation is invertible — map the deformed grid back
    points = G.flatten_grid(G.pixel_grid(mask.shape, device=dev))
    with torch.no_grad():
        xd = model.deformation(fitted, points)
        back = model.inverse(fitted, xd)
    err = float((back - points).abs().max())
    print(f"deformation inverse max err: {err:.2e}")
    print(f"wrote {args.out}/gt.png and mask.png")


if __name__ == "__main__":
    main()
