"""One module per traffic kind (``"kind"`` in ``benchmark/traffic/<mix>.json``),
found by that name: ``setup``, ``window``, ``trace`` and ``check``."""
