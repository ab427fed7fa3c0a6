#!/usr/bin/env python
"""Repeating-teaser deficit decomposition; counterpart of
``scripts/run_repeating_decomposition.py``.

    python -m awesome_tpu_torch.scripts.run_repeating_decomposition
        [--seed 1] [--n-restarts 8] [--steps-scale S] [--out FILE]
        [--device cuda|cpu]

Replays the protocol of ``runner/teaser.py:run_repeating`` (spec
`notebooks/icml_teaser_code/repeating/repeating.ipynb`) through the
port's :func:`minibatch_fit` but keeps the PER-RESTART logits, then
quantifies where the IoU deficit against the shipped mask lives:

- per-restart raw + phase-aligned IoU at the notebook's -5 logit contour
- status-quo ensemble (mean logits over loss-valid restarts)
- majority vote of per-restart -5 masks
- phase-aligned ensemble: align restarts to the best-tail restart by
  mask cross-correlation over one lattice period (model-side only, no
  reference-mask peeking), then mean logits
- oracle threshold sweep on the ensemble (diagnostic ONLY — peeks at the
  reference mask; never used for the standing score)
- shipped-mask anti-alias ambiguity (binarize at 64/127/192)

Reads the tree under ``AWESOME_REFERENCE_ROOT``; writes the JSON to
``--out``. Runs on the card unless ``--device cpu``; the sampled-SGD draws
are chaotic, so replicas on two devices differ by about the seed spread.
"""
import argparse
import json
import os

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--n-restarts", type=int, default=8)
    p.add_argument("--steps-scale", type=float, default=1.0)
    p.add_argument("--out",
                   default="runs/teasers_torch/repeating_decomposition.json")
    p.add_argument("--device", default="cuda",
                   help="where the restarts fit")
    args = p.parse_args(argv)

    from PIL import Image

    from awesome_tpu_torch.device import resolve_device
    from awesome_tpu_torch.nn.module import make_generator
    from awesome_tpu_torch.nn.priors_extra import PeriodicNet
    from awesome_tpu_torch.runner import teaser as T

    dev = resolve_device(args.device)
    naive = T.load_mask(os.path.join(T.TEASER_DIR, "repeating", "original",
                                     "mask_naive.png"))
    h, w = naive.shape
    im = Image.fromarray(naive.astype(np.uint8) * 255)
    im = im.resize((w // 2, h // 2), Image.NEAREST)
    naive_fit = np.asarray(im) > 127
    fh, fw = naive_fit.shape
    target_np = naive_fit.astype(np.float32)

    model = PeriodicNet(n_hidden=200, use_premap=False, device=dev)
    pts0, pts1 = T._split(T.centered_points(fh, fw, dev), target_np)
    pts_full = T.centered_points(h, w, dev)

    logit_stack, tails = [], []
    for s in range(args.seed, args.seed + args.n_restarts):
        params = model.init(make_generator(s))
        fitted, hist = T.minibatch_fit(
            model, params, pts0=pts0, pts1=pts1,
            steps=T._scaled(10000, args.steps_scale), n_sample=500,
            lr=1e-2, loss="se", coef0=2.0, coef1=1.0, seed=s)
        tails.append(float(hist[-max(hist.shape[0] // 20, 1):].mean()))
        logit_stack.append(T._logits(model, fitted, pts_full, (h, w)))
        print(f"restart {s}: tail {tails[-1]:.4f}", flush=True)

    ref = T.load_mask(os.path.join(T.TEASER_DIR, "repeating", "original",
                                   "mask.png"))
    tails_a = np.asarray(tails)
    valid = np.isfinite(tails_a) & (tails_a <= 1.5 * np.nanmin(tails_a))
    stack = np.asarray(logit_stack)
    out = {"tails": tails, "valid": valid.tolist()}

    per = []
    for i in range(args.n_restarts):
        m = stack[i] > -5.0
        pa, sh = T.phase_aligned_iou(m, ref)
        per.append({"iou": round(T.mask_iou(m, ref), 4),
                    "pa_iou": round(pa, 4), "shift": list(sh),
                    "valid": bool(valid[i])})
    out["per_restart"] = per

    ens = stack[valid].mean(0)
    m_sq = ens > -5.0
    pa_sq, sh_sq = T.phase_aligned_iou(m_sq, ref)
    out["ensemble_status_quo"] = {"iou": round(T.mask_iou(m_sq, ref), 4),
                                  "pa_iou": round(pa_sq, 4),
                                  "shift": list(sh_sq)}

    votes = (stack[valid] > -5.0).mean(0) > 0.5
    pa_v, _ = T.phase_aligned_iou(votes, ref)
    out["majority_vote"] = {"iou": round(T.mask_iou(votes, ref), 4),
                            "pa_iou": round(pa_v, 4)}

    # model-side phase alignment (no reference involved): roll each valid
    # restart onto the best-tail restart's lattice before averaging
    vidx = np.where(valid)[0]
    anchor = vidx[int(np.argmin(tails_a[vidx]))]
    am = stack[anchor] > -5.0
    py, px = T._axis_period(am, 0), T._axis_period(am, 1)
    aligned, shifts = [], []
    for i in vidx:
        mi = stack[i] > -5.0
        best, arg = -1.0, (0, 0)
        for dy in range(-(py // 2), py // 2 + 1):
            for dx in range(-(px // 2), px // 2 + 1):
                v = T._shifted_iou(mi, am, dy, dx)
                if v > best:
                    best, arg = v, (dy, dx)
        shifts.append([int(arg[0]), int(arg[1])])
        aligned.append(np.roll(stack[i], arg, axis=(0, 1)))
    ens_al = np.mean(aligned, 0)
    m_al = ens_al > -5.0
    pa_al, sh_al = T.phase_aligned_iou(m_al, ref)
    out["phase_aligned_ensemble"] = {
        "iou": round(T.mask_iou(m_al, ref), 4), "pa_iou": round(pa_al, 4),
        "shift": list(sh_al), "restart_shifts": shifts,
        "anchor": int(anchor), "period_yx": [int(py), int(px)],
    }

    best_t, best_v = None, -1.0
    for t in np.linspace(-10, 3, 53):
        v = T.mask_iou(ens > t, ref)
        if v > best_v:
            best_v, best_t = v, float(t)
    bt_al, bv_al = max(((float(t), T.mask_iou(ens_al > t, ref))
                        for t in np.linspace(-10, 3, 53)),
                       key=lambda tv: tv[1])
    out["oracle_threshold"] = {
        "status_quo": {"t": round(best_t, 2), "iou": round(best_v, 4)},
        "phase_aligned_ens": {"t": round(bt_al, 2), "iou": round(bv_al, 4)},
    }

    raw = np.asarray(Image.open(os.path.join(
        T.TEASER_DIR, "repeating", "original", "mask.png")).convert("L"))
    for thr in (64, 127, 192):
        out[f"ref_thr_{thr}"] = round(T.mask_iou(m_sq, raw > thr), 4)

    print(json.dumps(out, indent=1))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
