from evreal_tpu_torch.parallel.mesh import (
    Mesh,
    dp_devices,
    lane_blocks,
    make_mesh,
    pad_lanes,
    split_lanes,
)
