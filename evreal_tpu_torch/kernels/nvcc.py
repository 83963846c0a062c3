"""Building a hand-written CUDA source into a shared library with ``nvcc``
(a plain C interface, loaded with ``ctypes``): into
``build/evreal_tpu_torch/`` at the repository root, at first use, keyed by
a hash of the source and the flags, so a changed source or flag builds
anew and an unchanged one is loaded as it is. Nothing is built when a
kernel module is imported."""

import hashlib
import os
import re
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


def _kernel_name(mangled):
    """The ``..._kernel`` identifier inside an Itanium-mangled name (its
    length prefix read back; the prefix may follow other digits, as after
    an anonymous namespace's hash), else the name as it is."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            part = mangled[m.end():m.end() + int(m.group()[i:])]
            if part.endswith("kernel") and part.isidentifier():
                return part
    return mangled


def ptxas_usage(log):
    """Per kernel of nvcc's ``-Xptxas -v`` report in ``log``: {name:
    {"registers", "spill_stores", "spill_loads", "stack_bytes",
    "smem_bytes"}}, smem_bytes being the static shared memory (dynamic
    shared memory is not in the report). Names are the kernels' own
    identifiers; a kernel's template instances share one entry, holding
    the most any of them uses."""
    out, name = {}, None

    def worst(**use):
        for key, value in use.items():
            out[name][key] = max(out[name][key], value)

    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([^' ]+)'?", line)
        if m:
            name = _kernel_name(m.group(1))
            out.setdefault(name, {"registers": 0, "spill_stores": 0,
                                  "spill_loads": 0, "stack_bytes": 0,
                                  "smem_bytes": 0})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            worst(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                  spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            worst(registers=int(m.group(1)),
                  smem_bytes=int(sm.group(1)) if sm else 0)
    return out
