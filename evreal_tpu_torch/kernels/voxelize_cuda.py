"""Wrapper of the hand-written CUDA voxelizer (``csrc/voxelize.cu``).

The kernels replace the Pallas TPU kernels of
``evreal_tpu/kernels/voxelize_pallas.py`` (``_kernel`` and both precisions
of ``_batched_kernel``); the source file's header says what bounds them on
the card, how the design meets that, and why their sums are deterministic.
A call takes one of two paths, chosen by ``route`` from its shape: one
window (T = 1) the direct path, which adds each deposit with a 64-bit
atomic into an int64 scratch in L2 and converts it (a deposit and a finish
kernel); a chunk the tiled path, which bins the events by tile and sums
each tile in shared memory (count, scatter and accumulate kernels;
``tile_plan`` cuts the grid). The checks, type codes and launch constants
of a call are worked out once per key of device, dtypes, shapes and
precision (``_plan``); the direct path's scratch is kept per device and
stream and is zero between calls.

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
from pathlib import Path

import torch

from evreal_tpu_torch.kernels import nvcc

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "voxelize.cu"
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

# Calls that launched the kernels since the last reset, by precision and by
# path (a direct call is its deposit and finish kernels, a tiled call its
# count, scatter and accumulate kernels). Only ``_launched`` adds to them;
# ``launch_count()`` is their sum.
PATHS = ("direct", "tiled")
launches_by_precision = dict.fromkeys(PRECISIONS, 0)
launches_by_path = dict.fromkeys(PATHS, 0)
# the device type the kernels take (the check cache's CPU tests set "cpu")
_DEVICE_TYPE = "cuda"
_PLAN_CACHE_SIZE = 256
_plans = {}    # key of a call's tensors -> _Plan (``_plan``)
_scratch = {}  # (device index, stream) -> the direct path's int64 cells
_lib = None


def library_path():
    return nvcc.library_path(_SOURCE, NVCC_FLAGS, "libevreal_voxelize")


def build():
    """Compile the library unless this source's build exists
    (``kernels/nvcc.py:build``: ``{"path", "seconds", "log", "cached"}``).
    Raises when the build fails."""
    return nvcc.build(_SOURCE, NVCC_FLAGS, "libevreal_voxelize")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.PyDLL(build()["path"])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.evreal_voxelize_windows.argtypes = (
            [ptr] * 7 + [i32] * 11 + [ctypes.c_float, i32, ptr])
        lib.evreal_voxelize_compact4.argtypes = (
            [ptr] * 4 + [i32] * 10 + [ctypes.c_float, i32, ptr])
        lib.evreal_voxelize_direct.argtypes = [ptr] * 9
        lib.evreal_noop.argtypes = [i32, i32, ptr]
        for fn in (lib.evreal_voxelize_windows, lib.evreal_voxelize_compact4,
                   lib.evreal_voxelize_direct, lib.evreal_noop):
            fn.restype = i32
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
    if first.device.type != _DEVICE_TYPE:
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


class _DirectPlan(ctypes.Structure):
    """``csrc/voxelize.cu:DirectPlan``, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "T", "E", "B", "H", "W", "compact4", "coord_type", "ts_type",
        "pol_type", "idx_bits", "ts_bits", "bf16", "device")] + [
        ("u16_scale", ctypes.c_float)]


class _Plan:
    """What a call takes that its key fixes: the output's shape and device,
    the type codes (``codes``: the split wire's coord, ts and ps codes, or
    compact4's layout), and the direct path's ``_DirectPlan`` at
    ``address``."""
    __slots__ = ("device", "index", "shape", "bf16", "precision", "empty",
                 "codes", "scale", "cells", "direct", "address", "unused",
                 "like")


def _make_plan(events, count, num_bins, hw, bf16, layout):
    """The checks of a call, raising on what the kernels do not take, and
    its ``_Plan``. ``events``: ``(xs, ys, ts, ps)``, or ``(ev,)`` on the
    compact4 wire of ``layout``."""
    if layout is None:
        xs, ys, ts, ps = events
        _check({"xs": xs, "ys": ys, "ts": ts, "ps": ps}, count)
        if ys.dtype != xs.dtype:
            raise ValueError(f"voxelize (CUDA): xs {xs.dtype} != ys "
                             f"{ys.dtype}")
        for name, a, table in (("xs", xs, _COORD_TYPES),
                               ("ts", ts, _TS_TYPES), ("ps", ps, _POL_TYPES)):
            if a.dtype not in table:
                raise ValueError(f"voxelize (CUDA): {name} dtype {a.dtype} "
                                 f"not in {sorted(str(d) for d in table)}")
        codes = (_COORD_TYPES[xs.dtype], _TS_TYPES[ts.dtype],
                 _POL_TYPES[ps.dtype])
    else:
        (ev,) = events
        if ev.dtype not in (torch.uint32, torch.int32):
            raise ValueError(f"voxelize (CUDA): ev dtype {ev.dtype} is not "
                             f"uint32")
        _check({"ev": ev}, count)
        codes = tuple(layout)
    t_n, e = events[0].shape
    h, w = hw
    plan = _Plan()
    plan.device = events[0].device
    plan.index = plan.device.index
    plan.shape = (t_n, num_bins, h, w)
    plan.bf16 = bf16
    plan.precision = PRECISIONS[int(bf16)]
    plan.empty = e == 0 or t_n == 0
    plan.codes = codes
    # rounded to f32 by ctypes, as the kernels take it
    plan.scale = float((num_bins - 1) / _U16_TS_SCALE)
    plan.cells = t_n * num_bins * h * w
    if not plan.empty and t_n > 65535:
        raise ValueError(f"voxelize (CUDA): T={t_n} exceeds the grid's "
                         f"y limit 65535")
    compact4 = layout is not None
    plan.direct = _DirectPlan(
        t_n, e, num_bins, h, w, int(compact4),
        *((0, 0, 0) + codes if compact4 else codes + (0, 0)), int(bf16),
        plan.index or 0, plan.scale)
    plan.address = ctypes.addressof(plan.direct)
    plan.unused = (None,) * (4 - len(events))  # compact4: no ys, ts, ps
    # empty_like of one f32 element expanded to the output's shape gives a
    # fresh contiguous tensor (an expanded input is not dense), without
    # parsing a shape, a dtype and a device on every call
    plan.like = torch.empty(1, device=plan.device).expand(plan.shape)
    return plan


def _plan(events, count, num_bins, hw, precision, layout):
    """The ``_Plan`` of a call, made (and every check run) at the first
    call of its key, then read from the cache: the key holds each tensor's
    dtype, shape, device and contiguity, so a call that the checks would
    refuse never finds a cached plan."""
    bf16 = check_precision(precision)
    key = (tuple([(a.dtype, a.shape, a.device, a.is_contiguous())
                  for a in (*events, count)]), num_bins, tuple(hw), bf16,
           layout)
    plan = _plans.get(key)
    if plan is None:
        plan = _make_plan(events, count, num_bins, tuple(hw), bf16, layout)
        if len(_plans) >= _PLAN_CACHE_SIZE:
            _plans.clear()
        _plans[key] = plan
    return plan


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
    """The tile plan and the tiled launch's memory, neither filled here: the
    f32 output, and one scratch buffer that holds room for ``(T, E)``
    records of up to 8 bytes and then the ``3 * T * tiles + T + 1`` int32
    counters that the call zeroes (per (window, tile) the event count, the
    segment start and the scatter's cursor; per window the count kernel's
    finished blocks; the accumulate kernel's claim counter)."""
    t_n, e = first.shape
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
    for counts in (launches_by_precision, launches_by_path):
        for k in counts:
            counts[k] = 0


def launch_count():
    return sum(launches_by_precision.values())


def _raise_on(lib, err):
    if err != 0:
        msg = (lib.evreal_cuda_error_string(err).decode() if err > 0
               else "unknown type code, shape, tile plan or wire layout")
        raise RuntimeError(f"voxelize (CUDA): launch failed: {msg} ({err})")


def _launched(lib, err, plan, path):
    if err:
        _raise_on(lib, err)
    launches_by_precision[plan.precision] += 1
    launches_by_path[path] += 1


def _stream(index):
    """The current stream of CUDA device ``index``, as its raw handle."""
    return torch._C._cuda_getCurrentRawStream(index)


def route(shape):
    """The path a call of event buffers of ``shape`` takes: "direct" for one
    window (``(1, E)``), "tiled" for any other."""
    return "direct" if len(shape) == 2 and shape[0] == 1 else "tiled"


def _voxelize_direct(events, count, num_bins, hw, precision=None,
                     layout=None):
    """The direct path (a deposit and a finish kernel) for ``events`` of any
    T: ``(xs, ys, ts, ps)``, or ``(ev,)`` on the compact4 wire of
    ``layout``. The public entries take it at T = 1 (``route``)."""
    plan = _plan(events, count, num_bins, hw, precision, layout)
    if plan.empty:
        return torch.zeros(plan.shape, dtype=torch.float32,
                           device=plan.device)
    lib = _lib or _load()
    out = torch.empty_like(plan.like)
    stream = _stream(plan.index)
    key = (plan.index, stream)
    cells = _scratch.get(key)
    if cells is None or cells.numel() < plan.cells:
        # zero-filled on this stream, ahead of the launch
        cells = _scratch[key] = torch.zeros(plan.cells, dtype=torch.int64,
                                            device=plan.device)
    err = lib.evreal_voxelize_direct(
        plan.address, *[x.data_ptr() for x in events], *plan.unused,
        count.data_ptr(), cells.data_ptr(), out.data_ptr(), stream)
    if err:
        del _scratch[key]  # a launch may have left cells non-zero
    _launched(lib, err, plan, "direct")
    return out


def _voxelize_tiled(events, count, num_bins, hw, precision=None,
                    layout=None):
    """The tiled path (count, scatter and accumulate kernels over the
    tiles of ``tile_plan``); arguments as ``_voxelize_direct``'s."""
    plan = _plan(events, count, num_bins, hw, precision, layout)
    if plan.empty:
        return torch.zeros(plan.shape, dtype=torch.float32,
                           device=plan.device)
    t_n, _, h, w = plan.shape
    e = events[0].shape[1]
    (rows, cols), out, scratch = _buffers(events[0], num_bins, (h, w))
    lib = _lib or _load()
    entry = (lib.evreal_voxelize_windows if layout is None
             else lib.evreal_voxelize_compact4)
    err = entry(*[x.data_ptr() for x in events], count.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), t_n, e, num_bins, h, w,
                rows, cols, *plan.codes, int(plan.bf16), plan.scale,
                plan.index, _stream(plan.index))
    _launched(lib, err, plan, "tiled")
    return out


def voxelize(xs, ys, ts, ps, count, num_bins, hw, precision=None):
    """``(T, E)`` event buffers on a CUDA device plus ``(T,)`` int32
    ``count`` -> ``(T, num_bins, H, W)`` f32 on the current stream, by the
    path ``route`` picks. ``precision``: ``None``/"highest" (f32 weights)
    or "default" (bf16 factors). Zero capacity returns zeros without a
    launch. Polarity is taken as its sign: the kernels deposit +w where
    ``ps > 0`` and -w elsewhere, which is exact for the +-1 that every wire
    of ``data.packing`` holds."""
    fn = _voxelize_direct if route(xs.shape) == "direct" else _voxelize_tiled
    return fn((xs, ys, ts, ps), count, num_bins, hw, precision)


def voxelize_compact4(ev, count, num_bins, hw, layout, precision=None):
    """The packed compact4 wire: ``(T, E)`` uint32 words (``int32`` views
    are taken as the same bits) plus ``count`` -> ``(T, num_bins, H, W)``
    f32, decoded in the kernel. ``layout`` is ``(idx_bits, ts_bits)`` from
    ``data.packing.compact4_layout``."""
    fn = _voxelize_direct if route(ev.shape) == "direct" else _voxelize_tiled
    return fn((ev,), count, num_bins, hw, precision, tuple(layout))


def _launch_noop(device, launches=1):
    """``launches`` empty kernels on ``device``'s current stream through the
    binding and device handling of the direct path: the launch floor that
    ``chip_smoke.py`` times beside it. Not counted as a launch."""
    index = torch.device(device).index or 0
    lib = _lib or _load()
    _raise_on(lib, lib.evreal_noop(launches, index, _stream(index)))
