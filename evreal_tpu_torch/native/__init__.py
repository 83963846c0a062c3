"""The host C++ routine of the eval harness: the sliding-histogram disk
rank-equalize of ``histeq=local`` (``histeq.cpp``, a copy of the JAX
package's ``evreal_tpu/native/histeq.cpp``).

It is built with the system C++ compiler into ``build/evreal_tpu_torch/``
at the repository root at first use, keyed by a hash of the source, and
loaded with ``ctypes``; nothing is built when this module is imported. A
build that fails raises, naming the compiler: there is no silent fallback
(``harness/histeq.py:rank_equalize_plain`` is the plain numpy version the
tests hold it to).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "histeq.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "evreal_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None


def compiler():
    """The first C++ compiler on PATH (``CXX`` first when set)."""
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (CXX, g++, c++, clang++) on PATH: "
                       "histeq=local needs one to build "
                       "evreal_tpu_torch/native/histeq.cpp")


def library_path():
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libevreal_histeq-{digest[:16]}.so"


def build():
    """Compile the library unless this source's build exists; returns its
    path. Raises when the compiler is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = compiler()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(_SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed (exit {proc.returncode}) building "
                           f"{_SOURCE.name}: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.evreal_rank_equalize.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.evreal_rank_equalize.restype = ctypes.c_int
        _lib = lib
    return _lib


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
