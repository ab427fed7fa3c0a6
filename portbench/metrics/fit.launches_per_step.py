"""Launches of the fit's loss+grad kernel (K1/K2 in FP32 or bf16, or K5)
in the window over the fit-loop steps asked for: 1 where every step is
useful work, more where the gate's retry refits."""


def read(record):
    c = record["counters"]
    launches = c["flagship"] + c["flagship_bf16"] + c["icnn_bwd"]
    if record["kind"] != "fit" or launches == 0:
        return None
    return launches / record["steps"]
