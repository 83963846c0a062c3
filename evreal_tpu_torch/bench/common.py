"""What the bench modes share: the device and the card's state, the
voxelizer's launch counts, synthetic event buffers and sequences, the
correctness checks and the result line."""

import contextlib
import json
import os
import platform
import subprocess
import time

import numpy as np
import torch

from evreal_tpu_torch.data.packing import encode_compact4
from evreal_tpu_torch.harness.timers import fence
from evreal_tpu_torch.kernels import voxelize_cuda

# NVIDIA's H100 SXM data sheet (dense, at the 700 W limit)
BF16_PEAK_TFLOPS = 989.0
HBM_GB_PER_S = 3350.0
SMI_FIELDS = ("name", "power.limit", "clocks.sm", "power.draw",
              "temperature.gpu")
WINDOW_S = 0.04   # bench.py's synthetic windows: uniform over 40 ms
EVENTS = 30000    # events a window at ECD scale


class BenchError(RuntimeError):
    """A bench mode's correctness or launch check failed."""


def check(cond, msg):
    if not cond:
        raise BenchError(msg)


def smi(fields=("name", "power.limit")):
    """nvidia-smi's first line for ``fields``, as
    ``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def smi_sample():
    """The card's state now: {field: value} of ``SMI_FIELDS``."""
    return dict(zip(SMI_FIELDS, (v.strip() for v in
                                 smi(SMI_FIELDS).split(","))))


def card_line(device):
    """The line that opens a bench run: the card's name and power limit
    (nvidia-smi), or the CPU's name for a ``--device cpu`` run."""
    if device.type == "cuda":
        return smi()
    return f"cpu: {platform.processor() or platform.machine()} (no card)"


def device_info(device):
    """The result line's ``device``: platform, name, count and power
    limit (W; None off the card)."""
    if device.type == "cuda":
        limit = smi(("power.limit",)).split()[0]
        return {"platform": "gpu", "name": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count(),
                "power_limit_w": float(limit)}
    return {"platform": "cpu",
            "name": platform.processor() or platform.machine(),
            "count": 1, "power_limit_w": None}


@contextlib.contextmanager
def env(**values):
    """Set (str) or unset (None) environment variables for the block."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def serving_dtype(dtype):
    """Switches under which a runner is built in ``dtype`` ("float32" or
    "bfloat16") with its default voxelizer precision (HIGHEST in f32,
    bf16 factors in bf16)."""
    return env(EVREAL_DTYPE=dtype, EVREAL_VOXEL_PRECISION=None)


@contextlib.contextmanager
def counted(launches, label):
    """Count the voxelizer's launches of the block under ``label``:
    ``launches[label] = {"highest", "default", "direct", "tiled"}`` (by
    precision and by path; all 0 off the card, where the plain version
    runs)."""
    voxelize_cuda.reset_launches()
    try:
        yield
    finally:
        launches[label] = {**voxelize_cuda.launches_by_precision,
                           **voxelize_cuda.launches_by_path}


def check_launches(device, launches):
    """On the card every counted path launched the voxelizer."""
    if device.type != "cuda":
        return
    for label, n in launches.items():
        check(n["highest"] + n["default"] > 0,
              f"the voxelizer launched no kernel on path {label}")


def event_buffers(rng, lead, capacity, n_events, h, w):
    """f32-wire buffers of uniform synthetic events, as ``bench.py`` makes
    them: ``lead + (capacity,)`` int16 coordinates, sorted f32 timestamps
    over 40 ms from 0 in each window, +-1 polarity, ``n_events`` valid."""
    shape = tuple(lead) + (capacity,)
    bufs = {
        "xs": rng.integers(0, w, shape).astype(np.int16),
        "ys": rng.integers(0, h, shape).astype(np.int16),
        "ts": np.sort(rng.uniform(0, WINDOW_S, shape).astype(np.float32),
                      axis=-1),
        "ps": (rng.integers(0, 2, shape) * 2 - 1).astype(np.int8),
        "count": np.full(tuple(lead), n_events, np.int32),
    }
    bufs["ts"] -= bufs["ts"][..., :1]
    return bufs


def compact4_buffers(bufs, h, w):
    """The same windows on the compact4 wire (one uint32 an event,
    ``data/packing.py:encode_compact4``; slots past the count zero)."""
    ev = np.zeros(bufs["xs"].shape, np.uint32)
    for idx in np.ndindex(bufs["count"].shape):
        n = int(bufs["count"][idx])
        ev[idx][:n] = encode_compact4(
            bufs["xs"][idx][:n], bufs["ys"][idx][:n],
            bufs["ts"][idx][:n].astype(np.float64), bufs["ps"][idx][:n],
            (h, w))
    return {"ev": ev, "count": bufs["count"].copy()}


def write_sequence(out_dir, bufs, h, w):
    """The windows of ``bufs`` (T, E) as an npy-memmap sequence in the
    native packer's layout (f64 timestamps, int16 (N, 2) coordinates,
    uint8 polarity; window t at t * 40 ms); returns the ``Sequence`` with
    one window per row (``k_events``, every row ``count[0]`` events)."""
    from evreal_tpu_torch.data import Sequence

    n = int(bufs["count"][0])
    check(bool((bufs["count"] == n).all()),
          "write_sequence needs windows of one size")
    t_n = bufs["count"].shape[0]
    ts = (bufs["ts"][:, :n].astype(np.float64)
          + WINDOW_S * np.arange(t_n)[:, None])
    xy = np.stack([bufs["xs"][:, :n], bufs["ys"][:, :n]], -1)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "events_ts.npy"), ts.reshape(-1))
    np.save(os.path.join(out_dir, "events_xy.npy"),
            np.ascontiguousarray(xy.reshape(-1, 2)))
    np.save(os.path.join(out_dir, "events_p.npy"),
            (bufs["ps"][:, :n] > 0).astype(np.uint8).reshape(-1))
    with open(os.path.join(out_dir, "metadata.json"), "w",
              encoding="utf-8") as f:
        json.dump({"sensor_resolution": [h, w]}, f)
    return Sequence(out_dir, voxel_method={"method": "k_events", "k": n,
                                           "sliding_window_w": 0})


def lane_packer(out_dir, bufs, h, w):
    """(pack, pool) for a lockstep chunk's host packing: ``pack()`` packs
    lane 0's windows of ``bufs`` (lanes, T, E), written to ``out_dir`` as
    an npy-memmap sequence, into every lane of ``pool``, pooled compact4
    buffers, with ``pack_windows`` (the native packer) as the lockstep
    loop packs them (``harness/batched.py``'s dispatch)."""
    from evreal_tpu_torch.data import pack_windows
    from evreal_tpu_torch.data.packing import alloc_buffers, wire_dtypes

    lanes, chunk_t, capacity = bufs["xs"].shape
    seq = write_sequence(out_dir, {k: v[0] for k, v in bufs.items()}, h, w)
    metas = [seq.window(i) for i in range(chunk_t)]
    pool = alloc_buffers((lanes, chunk_t), capacity,
                         wire_dtypes("compact4", True, (h, w)))

    def pack():
        pool["count"][:] = 0
        for j in range(lanes):
            pack_windows(seq, list(range(chunk_t)), capacity=capacity,
                         out={k: v[j] for k, v in pool.items()},
                         metas=metas, out_zeroed=False)

    return pack, pool


def rate_loop(device, step, chunks, repeats, frames_per_chunk):
    """Frames/s of ``chunks`` calls of ``step()`` (each one chunk of
    ``frames_per_chunk`` frames) on the host clock, the device fenced at
    both ends, for each of ``repeats`` runs."""
    rates = []
    for _ in range(repeats):
        fence(device)
        t0 = time.perf_counter()
        for _ in range(chunks):
            step()
        fence(device)
        rates.append(chunks * frames_per_chunk / (time.perf_counter() - t0))
    return rates


class Finite:
    """Whether every frame handed to ``add`` was finite: the checks stay
    on the device (no synchronize inside a timed loop) until ``ok``."""

    def __init__(self):
        self.flags = []

    def add(self, frames):
        self.flags.append(torch.isfinite(frames).all())

    def ok(self):
        return bool(torch.stack(self.flags).all()) if self.flags else True


def keys_in(obj):
    """Every dict key in the nested dicts and lists of ``obj``."""
    if isinstance(obj, dict):
        return set(obj).union(*(keys_in(v) for v in obj.values()))
    if isinstance(obj, list):
        return set().union(*(keys_in(v) for v in obj))
    return set()


def result(mode, device, seed, metrics, units):
    """The last line of a run: mode, device, seed, the metrics and the
    unit of each metric the line holds."""
    present = keys_in(metrics)
    return {"mode": mode, "device": device_info(device), "seed": seed,
            **metrics,
            "units": {k: v for k, v in units.items() if k in present}}
