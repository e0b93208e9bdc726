"""A benchmark of pysteps_tpu_torch on one card: see ``BENCHMARK.json`` and
``harness/runner.py``."""
