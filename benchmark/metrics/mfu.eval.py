"""``lib/readers.py:mfu`` over the eval cells (``eval_fps``)."""

from benchmark.lib.readers import mfu as read  # noqa: F401
