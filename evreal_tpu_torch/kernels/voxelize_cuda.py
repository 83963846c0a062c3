"""Wrapper of the hand-written CUDA voxelizer (``csrc/voxelize.cu``).

The kernel replaces the Pallas TPU kernels of
``evreal_tpu/kernels/voxelize_pallas.py`` (``_kernel`` and the f32 variant
of ``_batched_kernel``); the source file's header says what bounds it on
the card and how the design meets that.

The library is built with ``nvcc`` into ``build/evreal_tpu_torch/`` at the
repository root at first use, keyed by a hash of the source and the flags,
and loaded with ``ctypes`` (a plain C interface, so the build takes
seconds). Nothing is built or loaded when this module is imported. The
plain PyTorch version of the same function is
``evreal_tpu_torch.ops.voxelize.voxelize_windows_plain``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "voxelize.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "evreal_tpu_torch"
# --fmad=false: no FMA contraction, so the f32 chain rounds like the
# reference's separate operations; no --use_fast_math (IEEE division,
# denormals kept); -Xptxas -v reports registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_COORD_TYPES = {torch.int16: 0, torch.uint8: 1, torch.int32: 2,
                torch.float32: 3}
_TS_TYPES = {torch.float32: 0, torch.uint16: 1}
_POL_TYPES = {torch.int8: 0, torch.float32: 1}
_U16_TS_SCALE = 65535.0  # the compact wire's scale (data/packing.py)

# Launches of the kernel since the last reset (set to 0 to reset). Only
# the launch site below adds to it.
launches = 0
_lib = None


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in cand:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                       "voxelizer cannot be built")


def library_path():
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libevreal_voxelize-{digest[:16]}.so"


def build():
    """Compile the library unless this source's build exists. Returns
    ``{"path", "seconds", "log", "cached"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, spills) of a fresh build. Raises
    when the build fails."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "log": "", "cached": True}
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds,
            "log": proc.stdout + proc.stderr, "cached": False}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        fn = lib.evreal_voxelize_windows
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.evreal_cuda_error_string.argtypes = [ctypes.c_int]
        lib.evreal_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(xs, ys, ts, ps, count):
    if xs.device.type != "cuda":
        raise ValueError(f"voxelize (CUDA): tensors must lie on a CUDA "
                         f"device, got {xs.device}")
    named = {"xs": xs, "ys": ys, "ts": ts, "ps": ps, "count": count}
    for name, a in named.items():
        if a.device != xs.device:
            raise ValueError(f"voxelize (CUDA): {name} on {a.device}, "
                             f"xs on {xs.device}")
        if not a.is_contiguous():
            raise ValueError(f"voxelize (CUDA): {name} is not contiguous")
    if xs.dim() != 2:
        raise ValueError(f"voxelize (CUDA): xs must be (T, E), got "
                         f"{tuple(xs.shape)}")
    for name in ("ys", "ts", "ps"):
        if named[name].shape != xs.shape:
            raise ValueError(f"voxelize (CUDA): {name} shape "
                             f"{tuple(named[name].shape)} != xs shape "
                             f"{tuple(xs.shape)}")
    if count.shape != xs.shape[:1] or count.dtype != torch.int32:
        raise ValueError(f"voxelize (CUDA): count must be ({xs.shape[0]},) "
                         f"int32, got {tuple(count.shape)} {count.dtype}")
    if ys.dtype != xs.dtype:
        raise ValueError(f"voxelize (CUDA): xs {xs.dtype} != ys {ys.dtype}")
    for name, a, table in (("xs", xs, _COORD_TYPES), ("ts", ts, _TS_TYPES),
                           ("ps", ps, _POL_TYPES)):
        if a.dtype not in table:
            raise ValueError(f"voxelize (CUDA): {name} dtype {a.dtype} not "
                             f"in {sorted(str(d) for d in table)}")


def voxelize(xs, ys, ts, ps, count, num_bins, hw):
    """``(T, E)`` event buffers on a CUDA device plus ``(T,)`` int32
    ``count`` -> ``(T, num_bins, H, W)`` f32, in one kernel launch on the
    current stream. Zero capacity returns zeros without a launch."""
    global launches
    h, w = hw
    _check(xs, ys, ts, ps, count)
    t_n, e = xs.shape
    out = torch.zeros((t_n, num_bins, h, w), dtype=torch.float32,
                      device=xs.device)
    if e == 0 or t_n == 0:
        return out
    if t_n > 65535:
        raise ValueError(f"voxelize (CUDA): T={t_n} exceeds the grid's "
                         f"y limit 65535")
    lib = _load()
    scale = float((num_bins - 1) / _U16_TS_SCALE)  # rounded to f32 by ctypes
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.evreal_voxelize_windows(
            xs.data_ptr(), ys.data_ptr(), ts.data_ptr(), ps.data_ptr(),
            count.data_ptr(), out.data_ptr(), t_n, e, num_bins, h, w,
            _COORD_TYPES[xs.dtype], _TS_TYPES[ts.dtype], _POL_TYPES[ps.dtype],
            scale, stream)
    if err != 0:
        msg = (lib.evreal_cuda_error_string(err).decode() if err > 0
               else "unknown type code")
        raise RuntimeError(f"voxelize (CUDA): launch failed: {msg} ({err})")
    launches += 1
    return out
