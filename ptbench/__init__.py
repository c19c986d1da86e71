"""The benchmark of ``pathtracerap_tpu_torch``: ``python3 -m ptbench.run``."""
