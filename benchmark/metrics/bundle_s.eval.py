"""``lib/spans.py:bundle_s`` over the eval cells (``eval_fps``)."""

from benchmark.lib.spans import bundle_s as read  # noqa: F401
