"""The benchmark of `pigeon_tpu_torch` on NVIDIA H100 cards.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line::

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Everything a cell needs is found by name: the configuration in
``configs/<name>.json``, the traffic mix in ``traffic/<name>.json`` (whose
``driver`` names a module of ``drivers/``), each per-layer metric in
``metrics/<name>.py`` and the limits of the correctness check in
``limits/<workload>.json``. The yardstick (FLOP and byte counts, peaks,
kernel groups, the trace's reduction) is in ``yardstick/``; the plain
float32 reference that decides ``correct`` is in ``reference/`` and
imports nothing of the program.
"""
