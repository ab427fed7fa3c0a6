"""Command-line scripts of the port, each run as ``python -m
awesome_tpu_torch.scripts.<name>``."""
