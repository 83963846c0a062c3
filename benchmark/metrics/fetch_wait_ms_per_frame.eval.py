"""``lib/spans.py:fetch_wait_ms_per_frame`` over the eval cells (``eval_fps``)."""

from benchmark.lib.spans import fetch_wait_ms_per_frame as read  # noqa: F401
