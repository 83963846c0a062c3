"""``lib/spans.py:fetch_wait_ms_per_frame`` over the ET-Net cells (``eval_fps``)."""

from benchmark.lib.spans import fetch_wait_ms_per_frame as read  # noqa: F401
