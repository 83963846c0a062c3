"""Wrapper of the hand-written fused attention (``csrc/attention.cu``):
``attention(q, k, v)`` = softmax(q kᵀ / sqrt(dh)) v over ``(N, h, L, dh)``
tensors, the query sequence of ``Lq`` rows and the key/value sequence of
``Lk``; the kernel takes contiguous float32 ones.

It replaces no TPU kernel (the JAX package left attention to XLA); the
source's header says why it exists, what bounds it on the card and what
its design does about that. A CUDA tensor launches the kernel or raises:
there is no fallback. A CPU tensor, of any float dtype and strides, takes
``attention_plain``, the written-out matmul, scale, softmax, matmul,
which the CPU tests hold the kernel's arithmetic to and which
``chip_smoke.py`` compares it with on the card.

The library is built with ``nvcc`` (``kernels/nvcc.py``) at first use,
keyed by a hash of the source and the flags, and loaded with ``ctypes``
(``PyDLL``: a call holds the GIL). Nothing is built or loaded when this
module is imported.

Counts (plain integers, added by ``attention`` only): ``calls`` (every
call, CPU or CUDA), ``launches`` (kernel launches) and ``products`` (the
sum of N * h * Lq * Lk over the calls); ``counts()`` returns them, and the
eval loops add them to their ``TimingLog`` a chunk at a time.
"""

import ctypes
import math
from pathlib import Path

import torch

from evreal_tpu_torch.kernels import nvcc

_SOURCE = Path(__file__).resolve().parent / "csrc" / "attention.cu"
# FMA contraction on (the products are FMA chains); no --use_fast_math
# (expf, IEEE division, denormals kept); -Xptxas -v reports registers and
# spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIM = 32     # the kernel's dh (csrc/attention.cu:kDh)
MAX_BH = 65535    # N * h: the grid's y limit

# the device type the kernel takes (the CPU tests set "cpu" to reach the
# launch path)
_DEVICE_TYPE = "cuda"
calls = 0
launches = 0
products = 0
_lib = None


def build():
    """Compile the library unless this source's build exists
    (``kernels/nvcc.py:build``). Raises when the build fails."""
    return nvcc.build(_SOURCE, NVCC_FLAGS, "libevreal_attention")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.PyDLL(build()["path"])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.evreal_attention.argtypes = ([ptr] * 4 + [i32] * 4
                                         + [ctypes.c_float, i32, ptr])
        lib.evreal_attention.restype = i32
        lib.evreal_attention_error_string.argtypes = [i32]
        lib.evreal_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def counts():
    """(calls, launches, products) so far."""
    return calls, launches, products


def reset_counts():
    global calls, launches, products
    calls = launches = products = 0


def attention_plain(q, k, v):
    """softmax(q kᵀ / sqrt(dh)) v written out: each (N, h, Lq, Lk) product
    in memory. For CPU tensors, and as the kernel's yardstick."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(logits, dim=-1), v)


def _check(q, k, v):
    """Raise unless q (N, h, Lq, dh), k and v (N, h, Lk, dh) share a
    dtype and a device, with Lq, Lk >= 1."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"attention: {name} must be (N, h, L, dh), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"attention: {name} is {t.dtype} on {t.device}, "
                             f"q {q.dtype} on {q.device}")
    n, h, lq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (n, h) or k.shape[3] != dh:
        raise ValueError(f"attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match")
    if min(lq, k.shape[2]) < 1:
        raise ValueError(f"attention: empty sequence: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def _check_kernel(q, k, v):
    """Raise unless the kernel takes them: float32, contiguous, 16-byte
    aligned, dh = ``HEAD_DIM`` and N * h at most ``MAX_BH``."""
    n, h, _, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError(f"attention (CUDA): {name} is {t.dtype}, not "
                             f"float32")
        if not t.is_contiguous():
            raise ValueError(f"attention (CUDA): {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"attention (CUDA): {name} is not 16-byte "
                             f"aligned")
    if dh != HEAD_DIM:
        raise ValueError(f"attention (CUDA): head width {dh}, the kernel "
                         f"takes {HEAD_DIM}")
    if n * h > MAX_BH:
        raise ValueError(f"attention (CUDA): N * h = {n * h} > {MAX_BH}")


def takes_kernel(t):
    """Whether ``attention`` launches the kernel for tensors on ``t``'s
    device (a CUDA device)."""
    return t.device.type == _DEVICE_TYPE


def attention(q, k, v):
    """softmax(q kᵀ / sqrt(dh)) v of ``(N, h, L, dh)`` tensors: the kernel
    for CUDA tensors (contiguous float32, dh = ``HEAD_DIM``; anything else
    raises), ``attention_plain`` for CPU ones, in their own dtype and
    strides. Counted in ``counts()``."""
    global calls, launches, products
    _check(q, k, v)
    n, h, lq, dh = q.shape
    on_card = takes_kernel(q)
    if on_card:
        _check_kernel(q, k, v)
    elif q.device.type != "cpu":
        raise ValueError(f"attention: tensors on {q.device}: the kernel "
                         f"takes CUDA tensors")
    calls += 1
    products += n * h * lq * k.shape[2]
    if not on_card:
        return attention_plain(q, k, v)
    lib = _lib or _load()
    out = torch.empty_like(q)
    index = q.device.index or 0
    err = lib.evreal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n * h, lq,
        k.shape[2], dh, 1.0 / math.sqrt(dh), index,
        torch._C._cuda_getCurrentRawStream(index))
    if err:
        msg = (lib.evreal_attention_error_string(err).decode() if err > 0
               else "a shape the kernel does not take")
        raise RuntimeError(f"attention (CUDA): launch failed: {msg} ({err})")
    launches += 1
    return out
