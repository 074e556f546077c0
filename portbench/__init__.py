"""Benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

One command runs one cell once::

    python3 portbench/run.py --workload livejournal.exact --seed 7 --seconds 24 --trace 0

``BENCHMARK.json`` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix or metric sits in a file of its
own here, found by that name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.  The yardstick is
frozen here too: the on-card graph generator (``generators/``), the plain
reference peel (``reference.py``), the H100 constants (``roofline.py``),
the trace reduction (``trace.py``) and the comparison that decides
``correct`` (``check.py``).  Nothing here imports JAX or the JAX package;
of the port, only its front door and its counters.
"""
