"""``lib/readers.py:idle_share`` over the sweep cells (``sweep_fps``)."""

from benchmark.lib.readers import idle_share as read  # noqa: F401
