"""``lib/spans.py:writer_wait_ms_per_frame`` over the ET-Net cells (``eval_fps``)."""

from benchmark.lib.spans import writer_wait_ms_per_frame as read  # noqa: F401
