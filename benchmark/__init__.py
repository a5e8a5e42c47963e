"""The benchmark of ``sda_tpu_torch``: one secure-aggregation round as its
recipient gets it. Run a cell with ``python benchmark/run.py``."""
