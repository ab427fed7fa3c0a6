"""The ICNN kernels' bounds (K4 forward, K5 backward, ``portbench.counts``)
times their launches in the trace, over their device time there, in
percent."""


def read(record):
    kernels = record.get("trace", {}).get("kernels", {})
    bounds = record["bounds"]
    spent = bound = 0.0
    for kind in ("icnn_fwd", "icnn_bwd"):
        k = kernels.get(kind)
        if k and bounds.get(kind):
            spent += k["seconds"]
            bound += bounds[kind] * k["launches"]
    if spent <= 0:
        return None
    return 100.0 * bound / spent
