"""Push latency of the serving engine (``tools/bench_serve_latency.py``):
per method one ``serve.py:ReconEngine`` stream (``chunk_t=1``: one window
a dispatch, the direct voxelizer path) at 180 x 240, fed a pool of 8
windows of 30,000 uniform synthetic events (``make_window``, the JAX
tool's windows) in turn, ``pushes`` timed after ``warmup`` on the host
clock (a push returns the frame on the host): p50/p90/p99/mean ms with the
sample count (1,000 pushes put ten samples beyond p99). On the card the
device busy ms and idle share of a push come from ``torch.profiler`` over
20 more pushes.

With ``lanes`` > 0 the mode measures a lockstep group instead: one
``push_group`` advances ``lanes`` streams (``open_group``), in the serving
dtype and on the wire asked for, reported as ms per ``push_group`` and
frames/s (``lanes`` over the p50).

Correctness: every frame finite; a stream's first 8 pushes within 1e-5
of the chunked offline runner on the same windows; on the card one
voxelizer launch per push (or ``push_group``).
"""

import numpy as np
import torch

from evreal_tpu_torch.bench import common
from evreal_tpu_torch.bench.models import method_model
from evreal_tpu_torch.bench.timing import latency, profile_calls

DEFAULTS = {"height": 180, "width": 240, "windows": 1000, "warmup": 8,
            "events": common.EVENTS}
DEFAULT_METHODS = ("E2VID", "E2VID+", "FireNet", "FireNet+", "SSL-E2VID")
POOL = 8            # distinct windows, pushed in turn
PROFILED = 20       # pushes under the profiler
TOL_OFFLINE = 1e-5  # pushes vs the chunked offline runner


def make_window(rng, n_events, h, w):
    """One client window (``tools/bench_serve_latency.py:34-39``): int16
    coordinates, sorted f64 timestamps over 40 ms, {0, 1} polarity."""
    xs = rng.integers(0, w, n_events).astype(np.int16)
    ys = rng.integers(0, h, n_events).astype(np.int16)
    ts = np.sort(rng.uniform(0.0, 0.04, n_events))
    ps = rng.integers(0, 2, n_events).astype(np.uint8)
    return xs, ys, ts, ps


def timed(call, n_warm, n_timed, check):
    """Host ms of ``call(k)`` for ``n_timed`` calls after ``n_warm``;
    ``check`` gets each result outside the timed interval."""
    import time

    for k in range(n_warm):
        check(call(k))
    ms = []
    for k in range(n_warm, n_warm + n_timed):
        t0 = time.perf_counter()
        out = call(k)
        ms.append((time.perf_counter() - t0) * 1e3)
        check(out)
    return ms


def offline_err(engine, model, flags, windows, h, w, device):
    """Max abs difference of a fresh stream's first ``len(windows)``
    frames from the chunked offline runner's on the same windows."""
    from evreal_tpu_torch import serve
    from evreal_tpu_torch.data.packing import (bucket_capacity,
                                               wire_dtypes, wire_format)
    from evreal_tpu_torch.harness.runner import MethodRunner

    sid = engine.open_stream(h, w)
    pushed = np.stack([engine.push(sid, *win) for win in windows])
    engine.close(sid)
    dtypes = wire_dtypes(wire_format(), True, (h, w))
    cap = bucket_capacity(max(len(win[0]) for win in windows))
    packed = [serve._pack_window(*win, capacity=cap, dtypes=dtypes,
                                 resolution=(h, w)) for win in windows]
    bufs = {k: np.concatenate([p[k] for p in packed]) for k in packed[0]}
    runner = MethodRunner(model, height=h, width=w, num_bins=5,
                          device=device, chunk_t=len(windows), **flags)
    _, _, clipped = runner.run(runner.init_state(), runner.upload(bufs),
                               len(windows))
    return float(np.abs(pushed - clipped.cpu().numpy()).max())


def bench_stream(engine, windows, dims, device):
    h, w = dims["height"], dims["width"]
    sid = engine.open_stream(h, w)
    finite = []

    def push(k):
        return engine.push(sid, *windows[k % POOL])

    ms = timed(push, dims["warmup"], dims["windows"],
               lambda f: finite.append(bool(np.isfinite(f).all())))
    row = {"ms_per_push": latency(ms)}
    if device.type == "cuda":
        prof = profile_calls(torch, push, PROFILED)
        row["push_profile"] = prof
        if prof["device_busy_ms_per_call"] is None:
            row["device_busy_ms_per_push"] = "not measured"
        else:
            row.update(device_busy_ms_per_push=prof[
                "device_busy_ms_per_call"],
                device_idle_share=prof["device_idle_share"])
    engine.close(sid)
    common.check(all(finite), "a pushed frame is not finite")
    return row


def bench_group(engine, windows, dims, device, lanes):
    h, w = dims["height"], dims["width"]
    gid = engine.open_group(lanes, h, w)
    finite = []

    def push(k):
        return engine.push_group(
            gid, [windows[(k + j) % POOL] for j in range(lanes)])

    ms = timed(push, dims["warmup"], dims["windows"],
               lambda f: finite.append(bool(np.isfinite(f).all())))
    engine.close_group(gid)
    common.check(all(finite), "a group frame is not finite")
    lat = latency(ms)
    return {"lanes": lanes, "ms_per_push_group": lat,
            "frames_per_s": lanes / (lat["p50"] / 1e3)}


def run(dims, device, seed, methods=None, lanes=0, dtype="float32",
        wire="f32"):
    """The serve mode. Returns (metrics, units)."""
    from evreal_tpu_torch.serve import ReconEngine

    h, w = dims["height"], dims["width"]
    rng = np.random.default_rng(seed)
    windows = [make_window(rng, dims["events"], h, w) for _ in range(POOL)]
    launches, rows = {}, {}
    for method in methods or DEFAULT_METHODS:
        model, flags = method_model(torch, method, seed)
        # one card: a group's lanes stay on it (EVREAL_MESH=0)
        with common.env(EVREAL_DTYPE=dtype, EVREAL_WIRE=wire,
                        EVREAL_VOXEL_PRECISION=None, EVREAL_MESH="0"):
            engine = ReconEngine(model, device=device, **flags)
            if lanes:
                with common.counted(launches, method):
                    rows[method] = bench_group(engine, windows, dims, device,
                                               lanes)
                calls = dims["warmup"] + dims["windows"]
            else:
                with common.counted(launches, method):
                    rows[method] = bench_stream(engine, windows, dims,
                                                device)
                calls = dims["warmup"] + dims["windows"] + (
                    PROFILED if device.type == "cuda" else 0)
                if dtype == "float32":
                    err = offline_err(engine, model, flags, windows, h, w,
                                      device)
                    common.check(err <= TOL_OFFLINE,
                                 f"{method}: pushes vs the offline runner "
                                 f"{err} > {TOL_OFFLINE}")
                    rows[method]["offline_max_abs_err"] = err
        if device.type == "cuda":
            n = launches[method]
            common.check(n["highest"] + n["default"] == calls,
                         f"{method}: {n} voxelizer launches for {calls} "
                         "dispatches")
        lat = rows[method].get("ms_per_push",
                               rows[method].get("ms_per_push_group"))
        print(f"{method}: p50 {lat['p50']:.3f} ms", flush=True)
    m = {"height": h, "width": w, "events_per_window": dims["events"],
         "dtype": dtype, "wire": wire, "warmup": dims["warmup"],
         "methods": rows, "voxelize_launches": launches}
    units = {"ms_per_push": "ms (host clock)", "ms_per_push_group":
             "ms (host clock)", "frames_per_s": "frames/s",
             "device_busy_ms_per_push": "ms", "device_idle_share":
             "fraction of a push's wall", "offline_max_abs_err": "abs"}
    return m, units
