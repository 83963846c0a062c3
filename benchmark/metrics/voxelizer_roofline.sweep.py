"""``lib/readers.py:voxelizer_roofline`` over the sweep cells (``sweep_fps``)."""

from benchmark.lib.readers import voxelizer_roofline as read  # noqa: F401
