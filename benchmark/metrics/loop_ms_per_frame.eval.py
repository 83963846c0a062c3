"""``lib/readers.py:loop_ms_per_frame`` over the eval cells (``eval_fps``)."""

from benchmark.lib.readers import loop_ms_per_frame as read  # noqa: F401
