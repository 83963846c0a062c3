"""Timing helpers of the bench and of ``chip_smoke.py``: CUDA-event
timings in turns, host-clock enqueue and latency samples, and the device
side of a ``torch.profiler`` trace (busy time as the union of the device
events' intervals, kernels by name).

The functions take the ``torch`` module as their first argument, as
``chip_smoke.py`` and ``tools/voxelizer_ab.py`` call them.
"""

import re
import time

import numpy as np


def time_ms(torch, fn, flush, warmup=5, iters=25):
    """Median ms of ``fn`` by CUDA events, L2 flushed before each run."""
    return time_turns(torch, {"fn": fn}, flush, warmup, iters)["fn"]


def time_turns(torch, fns, flush, warmup=5, iters=25):
    """Median ms of each of ``fns`` ({name: fn}) by CUDA events, L2
    flushed before each run, the functions taken in turns (each round in
    the other order: A B, B A, ...). The events are created (recorded
    once) before the first run: a CUDA event is created at its first
    record, which costs the host tens of microseconds and would otherwise
    fall inside the timed interval of a call whose enqueue outlasts the
    flush."""
    names = list(fns)
    for _ in range(warmup):
        for name in names:
            fns[name]()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(iters * len(names))]
    for start, end in events:
        start.record()
        end.record()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    pairs = iter(events)
    for i in range(iters):
        for name in (names if i % 2 == 0 else names[::-1]):
            start, end = next(pairs)
            flush.zero_()
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: float(np.median(t)) for name, t in times.items()}


def host_enqueue_us(torch, fn, n=200):
    """Host us per call of ``fn`` over ``n`` back-to-back calls, read on
    the host clock before the synchronize: the enqueue, not the device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def path_device_us(torch, fn, n=20):
    """Device us per call of ``fn``: the profiler's sum of the voxelizer's
    kernels (and, apart, of memsets, which only the tiled path issues)
    over ``n`` calls; None where the profile holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy_ms, _, by_name = device_time(torch, prof)
    kernels = voxelize_kernels(by_name)
    if busy_ms is None or not kernels:
        return {"kernels_us": None, "memset_us": None, "kernels": {}}
    memset_us = sum(us for k, (us, _) in by_name.items()
                    if "memset" in k.lower())
    return {"kernels_us": sum(ms for ms, _ in kernels.values()) * 1e3 / n,
            "memset_us": memset_us / n,
            "kernels": {k: ms * 1e3 / c for k, (ms, c) in kernels.items()}}


def union_us(spans):
    """Total length of the union of ``spans`` ((start, end) pairs)."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_time(torch, prof):
    """Device events of a profile: (busy ms as the union of their
    intervals, span ms from the first start to the last end, {name:
    (total us, count)}); the times are None when the profile holds no
    device event (not measured)."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    if not spans:
        return None, None, by_name
    span_us = max(b for _, b in spans) - min(a for a, _ in spans)
    return union_us(spans) / 1e3, span_us / 1e3, by_name


def top_kernels(by_name, n=12):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [[k[:90], t / 1e3, c] for k, (t, c) in top]


def voxelize_kernels(by_name):
    """The voxelizer's kernels in a profile: {name: [ms, launches]}, each
    kernel's template instances folded into its name (csrc/voxelize.cu)."""
    out = {}
    for k, (us, cnt) in by_name.items():
        m = re.search(r"voxelize_\w+_kernel", k)
        if m:
            ms, n = out.get(m.group(0), (0.0, 0))
            out[m.group(0)] = (ms + us / 1e3, n + cnt)
    return {k: list(v) for k, v in sorted(out.items())}


def latency(ms):
    """p50/p90/p99/mean of host-clock samples ``ms``, with their count."""
    a = np.asarray(ms)
    return {"p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)), "mean": float(a.mean()),
            "n": int(a.size)}


def profile_calls(torch, call, n, n_top=6):
    """``call(k)`` for k < n traced on the device only: busy ms (the union
    of device events) against the host's wall ms, per call, and the
    ``n_top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(n):
            call(k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, _, by_name = device_time(torch, prof)
    measured = busy_ms is not None
    return {"calls": n, "wall_ms_per_call": wall_ms / n,
            "device_busy_ms_per_call": busy_ms / n if measured else None,
            "device_idle_share": (1 - busy_ms / wall_ms) if measured
            else None,
            "device_events_per_call": sum(c for _, c in by_name.values()) / n,
            "voxelize_kernels": voxelize_kernels(by_name),
            "top_kernels": top_kernels(by_name, n_top)}


def traced(torch, fn):
    """``fn()`` under ``torch.profiler`` (host and device), the device
    synchronized at both ends: (device busy ms or None, wall ms, {kernel:
    (us, count)}) as ``device_time`` gives them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, _, by_name = device_time(torch, prof)
    return busy_ms, wall_ms, by_name


def host_ms(fn, reps, warmup=1):
    """{"median_ms", "n"} of ``fn()`` on the host clock over ``reps``
    calls after ``warmup`` untimed ones (``fn`` ends its own device work
    where it has any)."""
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": float(np.median(ms)), "n": len(ms)}
