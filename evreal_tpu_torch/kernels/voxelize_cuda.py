"""Wrapper of the hand-written CUDA voxelizer (``csrc/voxelize.cu``).

The kernels replace the Pallas TPU kernels of
``evreal_tpu/kernels/voxelize_pallas.py`` (``_kernel`` and both precisions
of ``_batched_kernel``); the source file's header says what bounds them on
the card, how the design meets that, and why their sums are deterministic.
One call bins the events by tile and sums each tile in shared memory
(count, scatter and accumulate kernels); ``tile_plan`` cuts the grid.

The library is built with ``nvcc`` into ``build/evreal_tpu_torch/`` at the
repository root at first use, keyed by a hash of the source and the flags,
and loaded with ``ctypes`` (a plain C interface, so the build takes
seconds; ``PyDLL``, so a call holds the GIL and the library's per-device
launch settings are never written by two threads at once). Nothing is
built or loaded when this module is imported. The plain PyTorch version of
the same function is ``evreal_tpu_torch.ops.voxelize.voxelize_windows_plain``
(with ``accum_dtype=torch.int64`` it does the kernels' arithmetic).
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
# K2's two precisions (voxelize_pallas_windows.supported_precisions):
# "default" rounds each deposit weight to bf16 before the f32 accumulation
PRECISIONS = ("highest", "default")

# One accumulate block's int64 cells: two such blocks fit the 228 KB of
# shared memory of an H100 SM (each block also holds 1 KB for the system
# and a few bytes of its own).
SMEM_BUDGET = 112 * 1024
# The most tiles per window (csrc/voxelize.cu:kMaxTiles): the scatter block
# keeps two int32 per tile within 48 KB of shared memory.
MAX_TILES = 4096

# Calls that launched the kernels since the last reset, by precision (one
# call = the count, scatter and accumulate kernels). Only the launch sites
# below add to them; ``launch_count()`` is their sum.
launches_by_precision = dict.fromkeys(PRECISIONS, 0)
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
        lib = ctypes.PyDLL(build()["path"])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.evreal_voxelize_windows.argtypes = (
            [ptr] * 7 + [i32] * 11 + [ctypes.c_float, ptr])
        lib.evreal_voxelize_windows.restype = i32
        lib.evreal_voxelize_compact4.argtypes = (
            [ptr] * 4 + [i32] * 10 + [ctypes.c_float, ptr])
        lib.evreal_voxelize_compact4.restype = i32
        lib.evreal_cuda_error_string.argtypes = [i32]
        lib.evreal_cuda_error_string.restype = ctypes.c_char_p
        lib.evreal_last_accumulate_grid.argtypes = []
        lib.evreal_last_accumulate_grid.restype = i32
        _lib = lib
    return _lib


def last_accumulate_grid():
    """Blocks of this process's last accumulate launch: its persistent
    grid, ``min(T x tiles, resident blocks)``, the resident count read
    from the card's occupancy at the first launch of a tile size."""
    return int(_load().evreal_last_accumulate_grid())


def check_precision(precision):
    """``None`` (HIGHEST) or a name in ``PRECISIONS`` -> whether the
    deposits take bf16 factors. Raises for any other value."""
    if precision is None or precision == "highest":
        return False
    if precision == "default":
        return True
    raise ValueError(f"voxelize: precision {precision!r} not supported "
                     f"(supported: {', '.join(PRECISIONS)})")


def _check(named, count):
    """Device, contiguity and ``(T, E)`` shapes of the event buffers
    ``named`` ({name: tensor}) and the ``(T,)`` int32 ``count``."""
    first_name, first = next(iter(named.items()))
    if first.device.type != "cuda":
        raise ValueError(f"voxelize (CUDA): tensors must lie on a CUDA "
                         f"device, got {first.device}")
    for name, a in {**named, "count": count}.items():
        if a.device != first.device:
            raise ValueError(f"voxelize (CUDA): {name} on {a.device}, "
                             f"{first_name} on {first.device}")
        if not a.is_contiguous():
            raise ValueError(f"voxelize (CUDA): {name} is not contiguous")
    if first.dim() != 2:
        raise ValueError(f"voxelize (CUDA): {first_name} must be (T, E), got "
                         f"{tuple(first.shape)}")
    for name, a in named.items():
        if a.shape != first.shape:
            raise ValueError(f"voxelize (CUDA): {name} shape "
                             f"{tuple(a.shape)} != {first_name} shape "
                             f"{tuple(first.shape)}")
    if count.shape != first.shape[:1] or count.dtype != torch.int32:
        raise ValueError(f"voxelize (CUDA): count must be "
                         f"({first.shape[0]},) int32, got "
                         f"{tuple(count.shape)} {count.dtype}")


def tile_plan(num_bins, h, w, smem_bytes=SMEM_BUDGET):
    """Tile extent ``(rows, cols)`` in pixels for a ``(num_bins, h, w)``
    grid: each tile's ``num_bins * rows * cols`` int64 cells fit
    ``smem_bytes``. Bands of whole rows (``cols == w``) where a row fits,
    else equal pieces of one row or more; the rows are spread evenly over
    the bands. Tile ``(i, j)`` starts at pixel ``(i * rows, j * cols)`` and
    is cut by the grid's edge. Raises when one pixel's cells do not fit."""
    if min(num_bins, h, w) < 1:
        raise ValueError(f"tile_plan: empty grid {(num_bins, h, w)}")
    pixels = smem_bytes // (8 * num_bins)  # most pixels in a tile
    if pixels < 1:
        raise ValueError(f"tile_plan: {num_bins} int64 cells of one pixel "
                         f"exceed {smem_bytes} bytes")
    pieces = -(-w // pixels)
    cols = -(-w // pieces)
    rows = min(h, pixels // cols)
    bands = -(-h // rows)
    return -(-h // bands), cols


def tile_count(plan, h, w):
    """Tiles per window of a ``tile_plan``."""
    rows, cols = plan
    return -(-h // rows) * -(-w // cols)


def _buffers(first, num_bins, hw):
    """The tile plan and the launch's memory, neither filled here: the f32
    output, and one scratch buffer that holds room for ``(T, E)`` records
    of up to 8 bytes and then the ``3 * T * tiles + T + 1`` int32 counters
    that the call zeroes (per (window, tile) the event count, the segment
    start and the scatter's cursor; per window the count kernel's finished
    blocks; the accumulate kernel's claim counter)."""
    t_n, e = first.shape
    if t_n > 65535:
        raise ValueError(f"voxelize (CUDA): T={t_n} exceeds the grid's "
                         f"y limit 65535")
    plan = tile_plan(num_bins, *hw)
    tiles = tile_count(plan, *hw)
    if tiles > MAX_TILES:
        raise ValueError(f"voxelize (CUDA): {tiles} tiles of {plan} for "
                         f"{(num_bins, *hw)} exceed {MAX_TILES}")
    counters = 3 * t_n * tiles + t_n + 1
    dev = first.device
    return (plan,
            torch.empty((t_n, num_bins) + tuple(hw), dtype=torch.float32,
                        device=dev),
            torch.empty(t_n * e + (counters + 1) // 2, dtype=torch.int64,
                        device=dev))


def reset_launches():
    for k in launches_by_precision:
        launches_by_precision[k] = 0


def launch_count():
    return sum(launches_by_precision.values())


def _launched(lib, err, bf16):
    if err != 0:
        msg = (lib.evreal_cuda_error_string(err).decode() if err > 0
               else "unknown type code, tile plan or wire layout")
        raise RuntimeError(f"voxelize (CUDA): launch failed: {msg} ({err})")
    launches_by_precision[PRECISIONS[int(bf16)]] += 1


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def voxelize(xs, ys, ts, ps, count, num_bins, hw, precision=None):
    """``(T, E)`` event buffers on a CUDA device plus ``(T,)`` int32
    ``count`` -> ``(T, num_bins, H, W)`` f32 on the current stream: the
    counters' zero-fill and the count, scatter and accumulate kernels.
    ``precision``: ``None``/"highest" (f32 weights) or "default" (bf16
    factors). Zero capacity returns zeros without a launch. Polarity is taken as its sign: the
    kernels deposit +w where ``ps > 0`` and -w elsewhere, which is exact
    for the +-1 that every wire of ``data.packing`` holds."""
    bf16 = check_precision(precision)
    named = {"xs": xs, "ys": ys, "ts": ts, "ps": ps}
    _check(named, count)
    if ys.dtype != xs.dtype:
        raise ValueError(f"voxelize (CUDA): xs {xs.dtype} != ys {ys.dtype}")
    for name, a, table in (("xs", xs, _COORD_TYPES), ("ts", ts, _TS_TYPES),
                           ("ps", ps, _POL_TYPES)):
        if a.dtype not in table:
            raise ValueError(f"voxelize (CUDA): {name} dtype {a.dtype} not "
                             f"in {sorted(str(d) for d in table)}")
    h, w = hw
    t_n, e = xs.shape
    if e == 0 or t_n == 0:
        return torch.zeros((t_n, num_bins, h, w), dtype=torch.float32,
                           device=xs.device)
    (rows, cols), out, scratch = _buffers(xs, num_bins, hw)
    lib = _load()
    scale = float((num_bins - 1) / _U16_TS_SCALE)  # rounded to f32 by ctypes
    with torch.cuda.device(xs.device):
        err = lib.evreal_voxelize_windows(
            xs.data_ptr(), ys.data_ptr(), ts.data_ptr(), ps.data_ptr(),
            count.data_ptr(), scratch.data_ptr(), out.data_ptr(), t_n, e,
            num_bins, h, w, rows, cols,
            _COORD_TYPES[xs.dtype], _TS_TYPES[ts.dtype],
            _POL_TYPES[ps.dtype], int(bf16), scale, _stream(xs.device))
    _launched(lib, err, bf16)
    return out


def voxelize_compact4(ev, count, num_bins, hw, layout, precision=None):
    """The packed compact4 wire: ``(T, E)`` uint32 words (``int32`` views
    are taken as the same bits) plus ``count`` -> ``(T, num_bins, H, W)``
    f32, decoded in the kernel. ``layout`` is ``(idx_bits, ts_bits)`` from
    ``data.packing.compact4_layout``."""
    bf16 = check_precision(precision)
    if ev.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"voxelize (CUDA): ev dtype {ev.dtype} is not "
                         f"uint32")
    _check({"ev": ev}, count)
    h, w = hw
    t_n, e = ev.shape
    if e == 0 or t_n == 0:
        return torch.zeros((t_n, num_bins, h, w), dtype=torch.float32,
                           device=ev.device)
    idx_bits, ts_bits = layout
    (rows, cols), out, scratch = _buffers(ev, num_bins, hw)
    lib = _load()
    scale = float((num_bins - 1) / _U16_TS_SCALE)
    with torch.cuda.device(ev.device):
        err = lib.evreal_voxelize_compact4(
            ev.data_ptr(), count.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), t_n, e, num_bins, h, w, rows, cols, idx_bits,
            ts_bits, int(bf16), scale, _stream(ev.device))
    _launched(lib, err, bf16)
    return out
