#!/usr/bin/env python
"""Run the real-image parity harness (``awesome_tpu_torch/runner/teaser.py``)
at the reference protocols' full step counts and record IoU against the
shipped result masks; counterpart of ``scripts/run_teasers.py``.

    python -m awesome_tpu_torch.scripts.run_teasers [--names N ...]
        [--steps-scale S] [--out DIR] [--device cuda|cpu]

Reads the tree under ``AWESOME_REFERENCE_ROOT`` (the reference checkout,
or a synthetic tree from ``python -m tools.teaser_tree``). Writes
``DIR/results.json`` (IoU, each mask's fill, seconds and the protocol's
extras; merged into an existing one, so a partial
``--names`` run keeps the other protocols' numbers) plus the produced and
reference mask PNGs. A protocol that raises is recorded as its error and
the run goes on. Runs on the card unless ``--device cpu``.
"""
import argparse
import json
import os
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--names", nargs="*", default=None)
    p.add_argument("--steps-scale", type=float, default=1.0)
    p.add_argument("--out", default="runs/teasers_torch")
    p.add_argument("--device", default="cuda",
                   help="where every protocol fits")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from awesome_tpu_torch.device import resolve_device
    from awesome_tpu_torch.runner import teaser as T

    device = resolve_device(args.device)
    if not T.reference_data_available():
        print("reference data not found; nothing to do")
        return

    os.makedirs(args.out, exist_ok=True)
    results_path = os.path.join(args.out, "results.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    for name in (args.names or T.TEASERS):
        t0 = time.time()
        try:
            r = T.TEASERS[name](steps_scale=args.steps_scale, device=device)
        except Exception as e:  # keep going; record the failure
            results[name] = {"error": repr(e)}
            print(f"{name}: FAILED {e!r}", flush=True)
            continue
        dt = time.time() - t0
        # the share of pixels each mask holds: an all-True or all-False
        # mask scores its reference's own fill or 0, whatever the fit
        results[name] = {"iou": round(r.iou, 4),
                         "fill": round(float(np.mean(r.mask)), 4),
                         "ref_fill": round(float(np.mean(r.ref_mask)), 4),
                         "seconds": round(dt, 1), **{
                             k: v for k, v in r.extra.items()
                             if isinstance(v, (int, float, list, str))
                         }}
        print(f"{name}: IoU {r.iou:.4f}  ({dt:.1f}s)  {results[name]}",
              flush=True)
        mask = np.asarray(r.mask)
        ref = np.asarray(r.ref_mask)
        if mask.ndim == 2:
            mask, ref = mask[None], ref[None]
        for i in range(mask.shape[0]):
            sfx = f"_{i}" if mask.shape[0] > 1 else ""
            Image.fromarray((mask[i] * 255).astype(np.uint8)).save(
                os.path.join(args.out, f"{name}{sfx}_ours.png"))
            Image.fromarray((ref[i] * 255).astype(np.uint8)).save(
                os.path.join(args.out, f"{name}{sfx}_ref.png"))

    with open(results_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
