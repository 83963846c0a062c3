"""``lib/spans.py:bundle_s`` over the ET-Net cells (``eval_fps``)."""

from benchmark.lib.spans import bundle_s as read  # noqa: F401
