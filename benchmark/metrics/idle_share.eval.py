"""``lib/readers.py:idle_share`` over the eval cells (``eval_fps``)."""

from benchmark.lib.readers import idle_share as read  # noqa: F401
