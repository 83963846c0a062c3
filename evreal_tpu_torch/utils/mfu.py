"""FLOP accounting against the card's peak (``evreal_tpu/utils/mfu.py``).

``count_flops`` counts the FLOPs of one call with
``torch.utils.flop_counter.FlopCounterMode`` on ``meta`` tensors: the
model and its inputs are rebuilt there without data, so nothing is read
and no card time is spent (the counterpart of the JAX package's
``component_cost``, which compiles on the host CPU). Where an op refuses
``meta``, the call is counted on the CPU at the same shapes. The counter
knows convolutions, matrix products and attention; elementwise work,
reductions, sorts and the hand-written CUDA voxelizer add nothing.

The JAX package's ``compiled_cost``, ``component_cost`` and
``composed_cost`` are XLA's: XLA counts a ``while`` body once, so its
looped programs had to be cut into loop-free parts and multiplied by
their trip counts. The port's loop over T runs eagerly, so the counter
sees every window and no trip-count composition is needed. Torch has no
counterpart of XLA's bytes-accessed estimate: the runners'
``cost_analysis`` returns ``None`` for bytes, as the JAX API allows.

The peak is dense bf16 on the tensor cores: the hardware's ceiling, the
honest denominator even for the f32 pipelines.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from evreal_tpu_torch.parallel.mesh import copy_module

# dense bf16 TFLOP/s by ``torch.cuda.get_device_name`` (NVIDIA's data
# sheets; the H100 SXM at its 700 W limit)
BF16_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
    "NVIDIA H200": 989.0,
}


def bf16_peak_tflops(device=None):
    """Dense bf16 peak of a CUDA ``device`` (default: the current card),
    or None for a card this table does not know and for any other device."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    return BF16_PEAK_TFLOPS.get(torch.cuda.get_device_name(device))


def mfu(flops, seconds, device=None):
    """(achieved TFLOP/s, fraction of the bf16 peak or None)."""
    achieved = flops / seconds / 1e12
    peak = bf16_peak_tflops(device)
    return achieved, (achieved / peak if peak else None)


def _like(obj, device):
    """``obj`` rebuilt on ``device``: tensors as new ones of the same shape
    and dtype (zeros on a real device), modules by ``copy_module``, dicts,
    lists and tuples item by item; anything else as it is."""
    if isinstance(obj, torch.nn.Module):
        return copy_module(obj, device)
    if isinstance(obj, torch.Tensor):
        return torch.zeros(obj.shape, dtype=obj.dtype, device=device)
    if isinstance(obj, dict):
        return {k: _like(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_like(v, device) for v in obj)
    return obj


def count_flops(fn, *args):
    """FLOPs of ``fn(*args)``, counted on ``meta`` copies of ``args``
    (modules, tensors, nested dicts/lists/tuples of them), or on CPU copies
    when an op refuses ``meta``. ``args`` themselves are left untouched."""
    for device in ("meta", "cpu"):
        counter = FlopCounterMode(display=False)
        try:
            with torch.no_grad(), counter:
                fn(*_like(args, device))
        except (NotImplementedError, RuntimeError):
            if device == "cpu":
                raise
            continue
        return counter.get_total_flops()
