"""``lib/spans.py:png_busy_ms_per_frame`` over the ET-Net cells (``eval_fps``)."""

from benchmark.lib.spans import png_busy_ms_per_frame as read  # noqa: F401
