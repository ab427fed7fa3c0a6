"""Seconds from the process's start to the first timed unit: imports, the
card's context, the kernel libraries (built on a checkout's first run),
inputs and weights made from the seed, and the warm-up of the cell's own
shapes."""


def read(record):
    return record["setup_s"]
