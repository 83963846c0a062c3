"""Building a hand-written CUDA source into a shared library with ``nvcc``
(a plain C interface, loaded with ``ctypes``): into
``build/evreal_tpu_torch/`` at the repository root, at first use, keyed by
a hash of the source and the flags, so a changed source or flag builds
anew and an unchanged one is loaded as it is. Nothing is built when a
kernel module is imported."""

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "evreal_tpu_torch"


def find_nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in cand:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                       "kernels cannot be built")


def library_path(source, flags, stem):
    """``BUILD_DIR/<stem>-<hash of the source and flags>.so``."""
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:16]}.so"


def build(source, flags, stem):
    """Compile ``source`` with ``flags`` unless its build exists. Returns
    ``{"path", "seconds", "log", "cached"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, spills) of a fresh build. Raises
    when the build fails."""
    path = library_path(source, flags, stem)
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "log": "", "cached": True}
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds,
            "log": proc.stdout + proc.stderr, "cached": False}
