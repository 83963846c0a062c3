"""Measurement entry points of the port: ``python -m evreal_tpu_torch.bench
<mode>`` (``__main__.py``). Each mode is a module here: ``flagship`` (the
headline lockstep rate), ``methods``, ``serve_latency``, ``batch_scaling``,
``profile_chunk`` and ``probes``; ``timing`` and ``models`` hold the
helpers ``chip_smoke.py`` shares with them. Nothing runs at import."""
