"""The benchmark of ``evreal_tpu_torch``: cells of ``BENCHMARK.json`` run by
``benchmark/run.py`` (see ``benchmark/README.md``)."""
