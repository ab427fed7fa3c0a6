"""Which ops own the device time of a joint training step: one step of the
smoke's joint path (the flagship wrapper, full-width UNet(4, 1), 2 images)
or of its multi-object path (UNet(4, 2), two children per frame, 2
frames) under ``torch.profiler`` with input shapes recorded.

    python3 -m tools.joint_profile [--shape 480 640] [--multi] [--top 12]

It prints the card, the step's device time, then one JSON line per op:
the ``aten`` ops by the device time of the kernels they launch
themselves, grouped by input shapes, with their share of the step's
device time; then the kernels by device time. A warm-up step runs
first.
"""
from __future__ import annotations

import argparse
import json
import sys


def _step(shape, multi: bool):
    """A joint (or multi-object) step and its arguments at ``shape``."""
    import torch

    import chip_smoke as S
    from awesome_tpu_torch.fit import trainer

    h, w = shape
    cfg = trainer.JointTrainConfig()
    if multi:
        wrapper = S.multi_object_wrapper(h, w, "cuda")
        data, _ = S.multi_object_data(h, w, 2, 8, "cuda")
        state = trainer.multi_object_train_init(
            wrapper, torch.Generator().manual_seed(6), 2, cfg,
            initial_count=2)
        batch = dict(data, index=torch.arange(2, device="cuda"))
        return trainer.make_multi_object_train_step(wrapper, cfg), state, \
            batch
    wrapper = S.flagship_wrapper(h, w, "cuda")
    data = S.joint_data(h, w, 2, 5, "cuda")
    state = trainer.joint_train_init(wrapper, torch.Generator().manual_seed(6),
                                     2, cfg)
    batch = dict(data, index=torch.arange(2, device="cuda"))
    return trainer.make_joint_train_step(wrapper, cfg), state, batch


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("joint_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as S

    print(f"card: {S.nvidia_smi_line()}", flush=True)
    step, state, batch = _step(tuple(args.shape), args.multi)
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    averages = prof.key_averages(group_by_input_shape=True)
    kernels = [e for e in averages if str(e.device_type).endswith("CUDA")]
    total_us = sum(e.self_device_time_total for e in kernels)
    ops = [e for e in averages if e.key.startswith("aten::")
           and e.self_device_time_total > 0]
    print(json.dumps({"step": "multi_object" if args.multi else "joint",
                      "shape": list(args.shape),
                      "device_ms": total_us / 1e3}), flush=True)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:args.top]:
        print(json.dumps({
            "op": e.key, "input_shapes": e.input_shapes, "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3,
            "share": e.self_device_time_total / total_us}), flush=True)
    for e in sorted(kernels,
                    key=lambda e: -e.self_device_time_total)[:args.top]:
        print(json.dumps({"kernel": e.key[:120], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
