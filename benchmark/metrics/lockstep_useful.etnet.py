"""``lib/spans.py:lockstep_useful`` over the ET-Net cells (``eval_fps``)."""

from benchmark.lib.spans import lockstep_useful as read  # noqa: F401
