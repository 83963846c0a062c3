from evreal_tpu_torch.convert.checkpoint import (
    load_method_checkpoint,
    save_method_checkpoint,
)
from evreal_tpu_torch.convert.params import (
    from_jax_tree,
    load_params,
    nest,
    save_params,
)
