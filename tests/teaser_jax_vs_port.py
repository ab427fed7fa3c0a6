"""The star and repeating teasers of both packages on one synthetic
reference tree (``tools/teaser_tree.py``), the port's from JAX's init and
with JAX's batch draws (``test_torch_teaser._draws_of_jax``): IoU against
the tree's mask, the mask's fill, the final loss, and how many pixels the
two masks differ by. On the CPU, at sizes and step counts beyond the test
file's budget:

    JAX_PLATFORMS=cpu python tests/teaser_jax_vs_port.py --root DIR \\
        [--h 480 --w 640] [--steps-scale 0.12] [--n-restarts 1]

One JSON line per protocol.
"""
import argparse
import json
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from awesome_tpu.nn import priors_extra as JP  # noqa: E402
from awesome_tpu.runner import teaser as JT  # noqa: E402
from awesome_tpu_torch.nn import priors_extra as TP  # noqa: E402
from awesome_tpu_torch.runner import teaser as TT  # noqa: E402
from test_torch_teaser import _bridge_init, _draws_of_jax  # noqa: E402
from tools.teaser_tree import write_tree  # noqa: E402

BRIDGED = {
    "star": (TP.StarShapedNet, lambda m: JP.StarShapedNet(
        n_hidden=m.n_hidden, train_offset=m.train_offset)),
    "repeating": (TP.PeriodicNet, lambda m: JP.PeriodicNet(
        n_hidden=m.n_hidden, use_premap=m.use_premap)),
}


def summary(r, seconds):
    return {"iou": r.iou, "fill": float(r.mask.mean()),
            "ref_fill": float(r.ref_mask.mean()), "loss": r.extra["loss"],
            "seconds": seconds,
            **{k: v for k, v in r.extra.items()
               if k in ("naive_iou", "phase_aligned_iou")}}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--h", type=int, default=480)
    p.add_argument("--w", type=int, default=640)
    p.add_argument("--steps-scale", type=float, default=0.12)
    p.add_argument("--n-restarts", type=int, default=1)
    p.add_argument("--names", nargs="*", default=list(BRIDGED))
    args = p.parse_args(argv)

    import torch

    torch.set_num_threads(2)
    write_tree(args.root, args.h, args.w,
               frame_shape=(max(args.h // 4, 8), max(args.w // 4, 8)))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JT, TT):
            mp.setattr(mod, "REFERENCE_ROOT", args.root)
            mp.setattr(mod, "TEASER_DIR", os.path.join(
                args.root, "notebooks", "icml_teaser_code"))
            mp.setattr(mod, "HOWTO_DIR", os.path.join(
                args.root, "notebooks", "how_to", "data"))
        mp.setattr(TT, "_draw_indices", _draws_of_jax)
        for name in args.names:
            _bridge_init(mp, *BRIDGED[name])
            kw = {"n_restarts": args.n_restarts} if name == "repeating" \
                else {}
            t0 = time.perf_counter()
            want = JT.TEASERS[name](steps_scale=args.steps_scale, **kw)
            jax.block_until_ready(want.extra["loss"])
            t1 = time.perf_counter()
            got = TT.TEASERS[name](steps_scale=args.steps_scale,
                                   device="cpu", **kw)
            t2 = time.perf_counter()
            print(json.dumps({
                "name": name, "shape": [args.h, args.w],
                "steps_scale": args.steps_scale, **kw,
                "jax": summary(want, t1 - t0),
                "port": summary(got, t2 - t1),
                "mask_diff_pixels": int(np.sum(got.mask != want.mask)),
                "mask_pixels": int(want.mask.size)}), flush=True)


if __name__ == "__main__":
    main()
