"""``lib/readers.py:mfu`` over the ET-Net cells (``eval_fps``)."""

from benchmark.lib.readers import mfu as read  # noqa: F401
