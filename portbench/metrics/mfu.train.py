"""The joint steps' model FLOPs (the UNet's convolutions and each frame's
prior, three passes, ``portbench.counts``) over the window's seconds, the
chips and the FP32 peak, in percent."""
from portbench.counts import PEAK_FP32_FLOPS


def read(record):
    if record["kind"] != "train":
        return None
    return 100.0 * record["flops"] / (record["window_s"] * record["chips"]
                                      * PEAK_FP32_FLOPS)
