from evreal_tpu_torch.harness.runner import (
    MethodRunner,
    eval_method_on_sequence,
    evaluate,
)
