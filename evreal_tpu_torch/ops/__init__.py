from evreal_tpu_torch.ops.normalize import (
    normalize_event_tensor,
    post_process_normalization,
    robust_normalize,
)
from evreal_tpu_torch.ops.pad import CropParams
from evreal_tpu_torch.ops.voxelize import voxelize_scatter, voxelize_windows
