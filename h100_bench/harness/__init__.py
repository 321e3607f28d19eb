"""The benchmark harness of ``montecarlo_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell once.  Everything that belongs to one
configuration, one cell or one per-layer metric sits in a file of its
own (``configs/``, ``workloads/``, ``layer_metrics/``, ``counts/``), found
by the name ``BENCHMARK.json`` gives it.
"""
