"""Rank 0's device time in NCCL kernels over the traced window, in
percent: the grid all_reduce's share of a sharded fit's steps."""


def read(record):
    t = record.get("trace")
    if not t or t["window_s"] <= 0 or t["nccl_s"] <= 0:
        return None
    return 100.0 * t["nccl_s"] / t["window_s"]
