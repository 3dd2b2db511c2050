"""The PyTorch port's benchmark: one cell a run (``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``).

Everything that belongs to one configuration, traffic kind or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<kind>.py`` and ``metrics/<metric>.py``.  The plain references
that decide ``correct`` are in ``reference/``.
"""
