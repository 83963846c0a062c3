"""``lib/spans.py:feed_ms_per_frame`` over the ET-Net cells (``eval_fps``)."""

from benchmark.lib.spans import feed_ms_per_frame as read  # noqa: F401
