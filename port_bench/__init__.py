"""The benchmark of ``ivid_tpu_torch``: one cell run by ``port_bench/run.py``.

See ``port_bench/README.md`` for the command and how to add a configuration,
a traffic mix, a driver kind or a per-layer metric."""
