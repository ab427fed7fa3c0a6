"""The benchmark of ``awesome_tpu_torch`` on NVIDIA H100 cards.

Run one cell of ``BENCHMARK.json``::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell's configuration in ``configs/``, its
traffic mix in ``traffic/`` (which names the driver in ``drivers/``), its
correctness limits in ``limits/``, and each metric's reader in
``metrics/``. The operation and byte counts, the card's peaks and the plain
reference live here too (``counts/``, ``reference/``); nothing here imports
the JAX package, and ``reference/`` imports nothing of the port.
"""
