"""The window's host-clock milliseconds over the training steps completed
in it."""


def read(record):
    if record["kind"] != "train":
        return None
    return 1e3 * record["window_s"] / record["work"]
