"""Point-steps the user asked for per second of the window: the points of
every fit that completed in it times its requested steps (retries and gate
passes are time, not work), over the window's host-clock seconds."""


def read(record):
    if record["kind"] != "fit":
        return None
    return record["work"] / record["window_s"]
