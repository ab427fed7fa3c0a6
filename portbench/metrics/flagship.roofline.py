"""The fused flagship loss+grad's bound (``portbench.counts``) over its
mean device time per launch in the trace (the kernel and its tile
reduction), in percent."""


def read(record):
    k = record.get("trace", {}).get("kernels", {}).get("flagship")
    bound = record["bounds"].get("flagship")
    if not k or not bound or k["seconds"] <= 0:
        return None
    return 100.0 * bound * k["launches"] / k["seconds"]
