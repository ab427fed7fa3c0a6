#!/usr/bin/env python
"""How-To: Convexity on the PyTorch port — the sequential-fit
(post-processing) demo; counterpart of ``examples/howto_convexity.py``.

Script equivalent of the reference's executable documentation
(`notebooks/how_to/convexity.ipynb`): take a rough thresholding of an
image, then fit a *provably convex* segmentation to it with an
input-convex coordinate network. Occlusions get filled in because the
representable masks are exactly the convex ones.

Uses the reference's shipped how-to image (`notebooks/how_to/data/
cocktail-tomatoes.jpg` under ``AWESOME_REFERENCE_ROOT``) when present,
else a synthetic occluded-tomato scene; pass --image for any other photo.
Writes overlay PNGs (through PIL) to --out. Runs on the card unless
``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_or_make_image(path, down_scale=2):
    from awesome_tpu_torch.runner import teaser

    shipped = os.path.join(teaser.HOWTO_DIR, "cocktail-tomatoes.jpg")
    if path is None and os.path.exists(shipped):
        # the reference's own shipped how-to image (convexity.ipynb cell 2);
        # the red-direction threshold below is the notebook's cell 5
        path = shipped
    if path:
        from PIL import Image

        img = Image.open(path)
        w, h = img.size
        img = img.resize((w // down_scale, h // down_scale))
        return (np.asarray(img, np.float64) / 255.0)[..., :3].astype(
            np.float32
        )
    # synthetic "tomato behind a leaf": red disk, green occluding stripe
    h = w = 96
    rng = np.random.default_rng(7)
    img = rng.uniform(0.05, 0.25, (h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    disk = ((yy - 48) ** 2 + (xx - 48) ** 2) <= 30**2
    img[disk] = (0.85, 0.15, 0.1)
    leaf = (np.abs((yy - 48) * 0.5 + (xx - 48) - 15) < 7) & disk
    img[leaf] = (0.1, 0.5, 0.12)
    return np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(
        np.float32
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image", type=str, default=None)
    p.add_argument("--epochs", type=int, default=2000)
    p.add_argument("--out", type=str, default="howto_convexity_out")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.device import resolve_device
    from awesome_tpu_torch.fit.prior_fit import FitConfig, fit_prior
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.nn.module import make_generator
    from awesome_tpu_torch.runner.functions import save_overlay

    dev = resolve_device(args.device)
    img = load_or_make_image(args.image)
    h, w = img.shape[:2]

    # 1. a rough initial segmentation: color thresholding (reference cell 5)
    likelihood = img[..., 0] - img[..., 1] - img[..., 2] - 0.5
    likelihood = 1.0 / (1.0 + np.exp(-(1 - likelihood)))
    likelihood = (likelihood - likelihood.min()) / max(
        likelihood.max() - likelihood.min(), 1e-9
    )
    unaries = (likelihood < 0.5).astype(np.float32)  # fg = 0 convention

    # 2. the convexity prior: an ICNN queried on the coordinate grid
    points = G.flatten_grid(G.pixel_grid((h, w), device=dev))
    target = torch.as_tensor(1.0 - unaries, device=dev).reshape(-1, 1)
    model = ConvexNextNet(n_hidden=130, n_hidden_layers=1, device=dev)
    params = model.init(make_generator(0))

    # 3. fit (reference cell 9's loop; the steps never wait on the host)
    cfg = FitConfig(num_steps=args.epochs, lr=2e-3, optimizer="adam",
                    fg_weight=0.4, plateau_patience=10**6)
    fitted, aux = fit_prior(model, params, points, target, cfg)
    hist = aux["loss_hist"].cpu().numpy()
    print(f"loss {hist[0]:.4f} -> {hist[-1]:.5f}")

    # 4. voila — a provably convex mask (query at any resolution)
    with torch.no_grad():
        prob = torch.sigmoid(model.apply(fitted, points)).reshape(h, w)
    mask = prob.cpu().numpy() < 0.5
    os.makedirs(args.out, exist_ok=True)
    save_overlay(img, 1 - unaries, os.path.join(args.out, "input_mask.png"))
    save_overlay(img, mask, os.path.join(args.out, "convex_mask.png"))
    print(f"wrote {args.out}/input_mask.png and convex_mask.png")


if __name__ == "__main__":
    main()
