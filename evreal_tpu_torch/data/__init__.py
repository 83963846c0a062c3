from evreal_tpu_torch.data.memmap import Sequence
from evreal_tpu_torch.data.packing import pack_windows, plan_capacity
