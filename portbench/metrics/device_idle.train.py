"""The share of the traced window in which no device op ran (the union of
their intervals), in percent; training cells."""


def read(record):
    t = record.get("trace")
    if record["kind"] != "train" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
