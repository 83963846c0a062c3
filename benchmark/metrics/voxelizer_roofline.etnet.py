"""``lib/readers.py:voxelizer_roofline`` over the ET-Net cells (``eval_fps``)."""

from benchmark.lib.readers import voxelizer_roofline as read  # noqa: F401
