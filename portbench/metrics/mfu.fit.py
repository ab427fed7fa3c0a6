"""The fits' model FLOPs (three passes over every weight matrix of the
requested steps, ``portbench.counts``) over the window's seconds, the chips
and the FP32 peak, in percent."""
from portbench.counts import PEAK_FP32_FLOPS


def read(record):
    if record["kind"] != "fit":
        return None
    return 100.0 * record["flops"] / (record["window_s"] * record["chips"]
                                      * PEAK_FP32_FLOPS)
