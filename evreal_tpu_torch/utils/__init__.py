"""Device selection, uploads, bounded downloads and the precision
contexts of f32 stages."""

import contextlib
import os

import numpy as np
import torch

# uint8 frames -> f32 by a table of host-computed (IEEE) x / 255, the values
# numpy's ``u8 / 255.0`` gives: a device divide by 255 may become a
# reciprocal multiply, 1 ulp off for some values
U8_LUT = np.arange(256, dtype=np.float32) / np.float32(255.0)

# the most bytes one device->host copy of ``bounded_fetch`` moves (the JAX
# package's ceiling, ``evreal_tpu/utils/__init__.py:8``)
FETCH_BYTES = 8 * 1024 * 1024


def _host_copy(tensor):
    """A writable numpy array of ``tensor``'s values that shares no memory
    with it (a CPU tensor is copied too)."""
    return tensor.detach().to("cpu", copy=True).numpy()


def bounded_fetch(tensor, max_bytes=FETCH_BYTES):
    """Device->host copy of ``tensor`` in slices of at most ``max_bytes``
    along the leading axis, recursing into an item of that axis when one
    item alone is over the budget. Returns a writable numpy array with the
    tensor's values (the JAX package's ``bounded_fetch``)."""
    nbytes = tensor.numel() * tensor.element_size()
    if tensor.dim() == 0 or nbytes <= max_bytes:
        return _host_copy(tensor)
    n0 = tensor.shape[0]
    item = nbytes // max(n0, 1)
    if item > max_bytes and tensor.dim() > 1:
        return np.stack([bounded_fetch(tensor[i], max_bytes)
                         for i in range(n0)])
    per = max(1, int(max_bytes // max(item, 1)))
    return np.concatenate([_host_copy(tensor[i:i + per])
                           for i in range(0, n0, per)])


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
def allow_tf32(enabled):
    """TF32 in cuDNN convolutions and cuBLAS matmuls on or off for the
    duration; the flags (process-global) are restored on exit, an
    exception's too, so a nested context leaves the outer one's."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# the candidates cuDNN's search times at a new shape, in its heuristic's
# order: at ET-Net's and E2VID's shapes the first 3 hold an algorithm
# within 4% of the fastest that torch's default of 10 finds, for a
# seventh of the search time
CONV_SEARCH_LIMIT = 3


@contextlib.contextmanager
def cudnn_benchmark():
    """cuDNN's benchmark mode on for the duration: each convolution runs
    the fastest of the ``CONV_SEARCH_LIMIT`` algorithms cuDNN times at its
    first call with those shapes, stride, dtype and layout (a search
    cuDNN keeps for the process), in place of its heuristic's pick, which
    sends some f32 stride-1 convolutions to an FFT. cuDNN keeps one plan
    a shape whatever the flag, so a shape first run outside the context
    keeps the heuristic's pick inside it too. The precision stays what
    the TF32 flags say. The flags (process-global) are restored on exit,
    an exception's too, so a nested context leaves the outer one's."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.benchmark_limit)
    cudnn.benchmark, cudnn.benchmark_limit = True, CONV_SEARCH_LIMIT
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = saved


def f32_parity():
    """Full-f32 convolutions and matmuls (TF32 off) for the duration — the
    counterpart of the JAX runner's HIGHEST matmul precision. cuDNN
    convolutions default to TF32 on Hopper, which drifts an E2VID rollout
    by about 1e-3."""
    return allow_tf32(False)


def matmul_precision_ctx(dtype=torch.float32):
    """Convolution and matmul precision of an f32 stage
    (``evreal_tpu/harness/runner.py:matmul_precision_ctx``).

    f32 stages pin full f32 (``f32_parity``) unless ``EVREAL_PRECISION``
    says otherwise: highest (the default) | high | default, any other value
    raising the JAX package's error. TF32 is Hopper's only reduced-precision
    mode for f32 convolutions and matmuls, so both "high" (XLA's 3-pass
    bf16) and "default" (its 1-pass bf16) map to it: TF32 on in cuDNN and
    cuBLAS for the duration. bf16 stages keep the backend's defaults (a
    ``nullcontext``), as in the JAX package. Raises when called, before
    any work, as the JAX function does."""
    if dtype == torch.float32:
        prec = os.environ.get("EVREAL_PRECISION", "highest")
        if prec not in ("highest", "high", "default"):
            raise ValueError(f"EVREAL_PRECISION={prec!r}: expected "
                             "highest|high|default")
        return allow_tf32(prec != "highest")
    return contextlib.nullcontext()


def upload(arrays, device):
    """{name: numpy array} -> {name: tensor on ``device``} (pinned and
    non-blocking on CUDA; the pinned staging copy frees the numpy buffers
    for reuse)."""
    device = torch.device(device)
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
