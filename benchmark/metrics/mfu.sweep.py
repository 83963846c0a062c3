"""``lib/readers.py:mfu`` over the sweep cells (``sweep_fps``)."""

from benchmark.lib.readers import mfu as read  # noqa: F401
