"""``lib/readers.py:idle_share`` over the ET-Net cells (``eval_fps``)."""

from benchmark.lib.readers import idle_share as read  # noqa: F401
