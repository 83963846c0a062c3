"""The host C++ routines of the port, loaded with ``ctypes``:

* the fused event-window packer (``packer.cpp``, a copy of the JAX
  package's ``evreal_tpu/native/packer.cpp``): ``pack_i16``,
  ``pack_compact`` and ``pack_compact4``, one per wire, which
  ``data/packing.py:pack_windows`` calls unless ``EVREAL_NATIVE=0``;
* the sliding-histogram disk rank-equalize of ``histeq=local``
  (``histeq.cpp``), which ``EVREAL_NATIVE`` does not switch off.

Both sources build into one library with the system C++ compiler, into
``build/evreal_tpu_torch/`` at the repository root at first use, keyed by
a hash of the sources and flags, through a temporary file renamed into
place (so parallel processes may build at once); nothing is built when
this module is imported. A build that fails raises, naming the compiler:
there is no silent fallback. The plain versions the tests hold these
routines to are ``data/packing.py``'s numpy loop (also the path of
``EVREAL_NATIVE=0`` and of inputs the packer does not take) and
``harness/histeq.py:rank_equalize_plain``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCES = (_DIR / "packer.cpp", _DIR / "histeq.cpp")
_BUILD_DIR = _DIR.parents[1] / "build" / "evreal_tpu_torch"
# no contraction into fused multiply-adds: the packer's timestamp
# quantization must round as numpy's separate multiply does
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
NO_NATIVE = "EVREAL_NATIVE=0 packs events with numpy"
_lib = None

WIRES = ("f32", "compact", "compact4")
# Calls that ran the native packer since the last reset, by wire
# (``reset_pack_calls``); a call that raises counts nothing.
pack_calls = dict.fromkeys(WIRES, 0)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "evreal_pack_i16": [_P, _P, _P, _I64, _P, _P, _I64, _I64,
                        _P, _P, _P, _P, _P],
    "evreal_pack_compact": [_P, _P, _P, _I64, _P, _P, _I64, _I64,
                            ctypes.c_int, _P, _P, _P, _P, _P],
    "evreal_pack_compact4": [_P, _P, _P, _I64, _P, _P, _I64, _I64,
                             _I64, _I64, ctypes.c_int, ctypes.c_int,
                             _P, _P],
    "evreal_rank_equalize": [_P, _I64, _I64, _I64, _P],
}


def enabled():
    """Whether ``pack_windows`` uses the native packer: ``EVREAL_NATIVE``
    is anything but "0" (read at every call)."""
    return os.environ.get("EVREAL_NATIVE", "1") != "0"


def reset_pack_calls():
    for wire in WIRES:
        pack_calls[wire] = 0


def compiler():
    """The first C++ compiler on PATH (``CXX`` first when set)."""
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError(
        "no C++ compiler (CXX, g++, c++, clang++) on PATH: the event packer "
        "and histeq=local need one to build evreal_tpu_torch/native/"
        f"packer.cpp and histeq.cpp ({NO_NATIVE})")


def library_path():
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in _SOURCES)
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libevreal_native-{digest[:16]}.so"


def build():
    """Compile the library unless this build of the sources exists.
    Returns {"path", "seconds", "cached"}; raises when the compiler is
    missing or fails."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "cached": True}
    cxx = compiler()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, *map(str, _SOURCES), "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{cxx} failed (exit {proc.returncode}) building "
            f"{', '.join(s.name for s in _SOURCES)} ({NO_NATIVE}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "cached": False}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])  # CDLL: the GIL is released
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _require(name, arr, dtype, shape):
    if (arr.dtype != dtype or arr.shape != shape
            or not arr.flags["C_CONTIGUOUS"]):
        raise ValueError(f"{name}: want a C-contiguous {np.dtype(dtype)} "
                         f"array of shape {shape}, got {arr.dtype} "
                         f"{arr.shape}")


def _common(ts, xy, p, idx0, idx1, capacity, out, wants):
    """Check the events and ``out`` buffers (``wants``: {key: dtype} of
    the (T, capacity) rows) as the C routines read and write them; returns
    the int64 window bounds."""
    n = ts.shape[0] if ts.ndim == 1 else -1
    _require("ts", ts, np.float64, (n,))
    _require("xy", xy, np.int16, (n, 2))
    _require("p", p, np.uint8, (n,))
    idx0 = np.ascontiguousarray(idx0, np.int64)
    idx1 = np.ascontiguousarray(idx1, np.int64)
    t = idx0.shape[0]
    _require("idx1", idx1, np.int64, (t,))
    for key, dtype in wants.items():
        _require(f"out[{key!r}]", out[key], dtype, (t, capacity))
    _require("out['count']", out["count"], np.int32, (t,))
    return idx0, idx1


def _call(name, wire, *args):
    rc = getattr(_load(), name)(*args)
    if rc != 0:
        raise ValueError(f"{name}: window exceeds capacity or bounds")
    pack_calls[wire] += 1


def pack_i16(ts, xy, p, idx0, idx1, capacity, out):
    """Fused pack of event windows ``[idx0[r], idx1[r])`` on the f32 wire:
    events ts f64 (N,), xy int16 (N, 2), p u8 (N,); ``out`` holds (T,
    capacity) rows {ts f32, xs/ys int16, ps int8} and count int32 (T,),
    all C-contiguous. Rows are zero past their count. Raises ValueError
    when a window exceeds ``capacity`` or the events."""
    idx0, idx1 = _common(ts, xy, p, idx0, idx1, capacity, out, {
        "ts": np.float32, "xs": np.int16, "ys": np.int16, "ps": np.int8})
    _call("evreal_pack_i16", "f32",
          ts.ctypes.data, xy.ctypes.data, p.ctypes.data, ts.shape[0],
          idx0.ctypes.data, idx1.ctypes.data, idx0.shape[0], capacity,
          out["ts"].ctypes.data, out["xs"].ctypes.data,
          out["ys"].ctypes.data, out["ps"].ctypes.data,
          out["count"].ctypes.data)


def pack_compact(ts, xy, p, idx0, idx1, capacity, u8_coords, out):
    """The compact wire (see ``pack_i16`` for the array contract): ``out``
    rows {ts u16, xs/ys u8 when ``u8_coords`` (out-of-range at the 255
    sentinel) else int16, ps int8}."""
    xy_dtype = np.uint8 if u8_coords else np.int16
    idx0, idx1 = _common(ts, xy, p, idx0, idx1, capacity, out, {
        "ts": np.uint16, "xs": xy_dtype, "ys": xy_dtype, "ps": np.int8})
    _call("evreal_pack_compact", "compact",
          ts.ctypes.data, xy.ctypes.data, p.ctypes.data, ts.shape[0],
          idx0.ctypes.data, idx1.ctypes.data, idx0.shape[0], capacity,
          1 if u8_coords else 0,
          out["ts"].ctypes.data, out["xs"].ctypes.data,
          out["ys"].ctypes.data, out["ps"].ctypes.data,
          out["count"].ctypes.data)


def pack_compact4(ts, xy, p, idx0, idx1, capacity, resolution, out):
    """The packed-u32 wire (see ``pack_i16`` for the array contract):
    ``out`` rows {ev u32}; ``resolution`` (h, w) defines the index and
    timestamp bit split (``data.packing.compact4_layout``), and raises
    ValueError when the sensor has none."""
    from evreal_tpu_torch.data.packing import compact4_layout

    layout = compact4_layout(resolution)
    if layout is None:
        raise ValueError(f"pack_compact4: no compact4 layout for the "
                         f"sensor {resolution}")
    idx0, idx1 = _common(ts, xy, p, idx0, idx1, capacity, out,
                         {"ev": np.uint32})
    h, w = int(resolution[0]), int(resolution[1])
    _call("evreal_pack_compact4", "compact4",
          ts.ctypes.data, xy.ctypes.data, p.ctypes.data, ts.shape[0],
          idx0.ctypes.data, idx1.ctypes.data, idx0.shape[0], capacity,
          h, w, layout[0], layout[1],
          out["ev"].ctypes.data, out["count"].ctypes.data)


def rank_equalize(u8_img, radius):
    """Disk rank-equalize of a uint8 (H, W) image: per pixel
    ``floor(rank * 255 / pop)`` over the disk of ``radius`` clipped to the
    image. Returns uint8 (H, W)."""
    img = np.ascontiguousarray(u8_img)
    if img.dtype != np.uint8 or img.ndim != 2 or min(img.shape) == 0:
        raise ValueError(f"rank_equalize: want a non-empty (H, W) uint8 "
                         f"image, got {img.shape} {img.dtype}")
    if radius <= 0:
        raise ValueError(f"rank_equalize: radius {radius} must be positive")
    out = np.empty_like(img)
    rc = _load().evreal_rank_equalize(img.ctypes.data, img.shape[0],
                                      img.shape[1], int(radius),
                                      out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"evreal_rank_equalize failed (code {rc})")
    return out
