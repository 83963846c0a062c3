"""Device selection and the f32 parity precision context."""

import contextlib

import torch


def resolve_device(device=None):
    """``torch.device`` for an entry point: ``cuda`` unless the caller asks
    for another device. Raises when CUDA is asked for (or defaulted to) and
    no card is present — entry points never carry on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run the plain CPU path")
    return dev


@contextlib.contextmanager
def f32_parity():
    """Full-f32 convolutions and matmuls (TF32 off) for the duration — the
    counterpart of the JAX runner's HIGHEST matmul precision
    (``evreal_tpu/harness/runner.py:244-267``). cuDNN convolutions default
    to TF32 on Hopper, which drifts an E2VID rollout by about 1e-3."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
