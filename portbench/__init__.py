"""The benchmark of the PyTorch and CUDA port (``mistra_tpu_torch``).

One command runs one cell once and prints one JSON line::

    python3 -m portbench.run --workload btz96.ens64 --seed 7 \
        --seconds 51 --trace 0

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); each per-layer metric has a
reader of its own (``metrics/<name>.py``), which declares the spans and
counters it reads.  ``registry`` finds all three by name, so a new cell,
mix or metric is new files and entries only.

``reference/`` is a frozen copy of the port's plain path, which decides
``correct``; ``roofline.py`` and the busy-time arithmetic of ``trace.py``
are the frozen yardstick.  Nothing here imports ``jax`` or ``mistra_tpu``,
and nothing in ``reference/`` imports ``mistra_tpu_torch``.
"""
