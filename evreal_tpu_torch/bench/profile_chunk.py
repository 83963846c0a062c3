"""Where the time of steady lockstep chunks goes (``tools/profile_chunk.py``).

The flagship's streamed loop (E2VID, 16 lanes x 32 windows at 180 x 240 on
the compact4 wire by default) runs ``windows // chunk_t`` chunks under
``torch.profiler`` after one warm chunk, each chunk as the eval loop runs
it, every step in a ``record_function`` span of this file: ``bench.pack``
(``pack_windows`` from an npy-memmap sequence into the pooled lane views),
``bench.upload`` (``utils.upload``), ``bench.run`` (the runner's chunk and
the u8 quantization) and ``bench.fetch`` (``to_host``, then the wait).
The trace is exported as a Chrome trace and read back from the file, the
same code that ``--trace-only`` runs on a trace exported earlier:

- time per kernel (the device's kernels, copies and memsets), each with a
  coarse category: conv, gemm, voxelize, elementwise (pointwise work and
  reductions), sort/percentile, copy or other;
- device busy time (the union of the device events) and idle time over
  the span of the bench's spans, and the longest idle gaps, each named by
  the bench span the host spent most of the gap in;
- host ms per chunk of each span.

A trace without device events (a ``--device cpu`` run) has no device
metric: only the host spans are reported.
"""

import json
import os
import re
import tempfile

import torch

from evreal_tpu_torch.bench import common
from evreal_tpu_torch.bench.timing import union_us

DEFAULTS = {"lanes": 16, "chunk_t": 32, "height": 180, "width": 240,
            "windows": 64, "events": common.EVENTS}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# matched against the kernel's function name (namespaces and template
# arguments cut off), then, where that names nothing (cuDNN's CUTLASS
# ``Kernel<...fprop...>``), against the whole name; a copy done by an
# elementwise kernel and cuDNN's layout transforms count as copies
CATEGORIES = (
    ("voxelize", re.compile(r"voxelize_")),
    ("conv", re.compile(r"conv|fprop|dgrad|wgrad|winograd", re.I)),
    ("gemm", re.compile(r"gemm|cutlass|cublas|matmul", re.I)),
    ("sort/percentile", re.compile(r"sort|radix|topk|kthvalue", re.I)),
    ("copy", re.compile(r"memcpy|memset|copy|gather|scatter|index|"
                        r"nchwToNhwc|nhwcToNchw|transpose", re.I)),
    ("elementwise", re.compile(r"elementwise|reduce|upsample|pointwise",
                               re.I)),
)
N_GAPS = 10


def categorize(name):
    if "direct_copy_kernel" in name:
        return "copy"
    base = name.removeprefix("void ").replace("(anonymous namespace)", "")
    base = re.split(r"[<(]", base, maxsplit=1)[0].rsplit("::", 1)[-1]
    for text in (base, name):
        for cat, rx in CATEGORIES:
            if rx.search(text):
                return cat
    return "other"


def read_trace(path):
    """(device events [(name, start us, end us)], bench spans [(label,
    start us, end us)], the device's name or None) of a Chrome trace."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    device, spans = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            device.append((e["name"], start, end))
        elif (e.get("cat") == "user_annotation"
              and e["name"].startswith("bench.")):
            spans.append((e["name"][len("bench."):], start, end))
    props = trace.get("deviceProperties") or [{}]
    return device, spans, props[0].get("name")


def idle_gaps(device, lo, hi):
    """Gaps in [lo, hi] not covered by any device event, longest first:
    [(start, end)]."""
    gaps, cursor = [], lo
    for _, a, b in sorted(device, key=lambda e: e[1]):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


def span_over(spans, a, b):
    """The bench span that covers most of [a, b], or "between spans"."""
    best, label = 0.0, "between spans"
    for name, lo, hi in spans:
        overlap = min(b, hi) - max(a, lo)
        if overlap > best:
            best, label = overlap, name
    return label


def analyze(path, chunks, top=20):
    """The report of a Chrome trace of ``chunks`` bench chunks (module
    docstring); device metrics only where the trace holds device events."""
    device, spans, name = read_trace(path)
    common.check(bool(spans), f"{path}: no bench.* spans in the trace")
    lo = min(s[1] for s in spans)
    hi = max(s[2] for s in spans)
    host = {}
    for label, a, b in spans:
        host[label] = host.get(label, 0.0) + (b - a) / 1e3
    out = {"trace": path, "trace_device": name, "chunks": chunks,
           "wall_ms": (hi - lo) / 1e3,
           "host_ms_per_chunk": {k: v / chunks for k, v in host.items()}}
    inside = [(n, max(a, lo), min(b, hi)) for n, a, b in device
              if b > lo and a < hi]
    if not inside:
        return out
    busy = union_us([(a, b) for _, a, b in inside])
    kernels, cats = {}, {}
    for n, a, b in inside:
        ms, count = kernels.get(n, (0.0, 0))
        kernels[n] = (ms + (b - a) / 1e3, count + 1)
        cat = categorize(n)
        cats[cat] = cats.get(cat, 0.0) + (b - a) / 1e3
    total = sum(ms for ms, _ in kernels.values())
    out.update(
        device_busy_ms=busy / 1e3, device_idle_ms=(hi - lo - busy) / 1e3,
        device_busy_share=busy / (hi - lo),
        device_busy_ms_per_chunk=busy / 1e3 / chunks,
        kernel_ms_by_category=cats,
        kernels=[{"name": n[:90], "ms": ms, "share": ms / total,
                  "launches": count, "category": categorize(n)}
                 for n, (ms, count) in sorted(kernels.items(),
                                              key=lambda kv: -kv[1][0])[:top]],
        idle_gaps=[{"ms": (b - a) / 1e3, "at_ms": (a - lo) / 1e3,
                    "host_in": span_over(spans, a, b)}
                   for a, b in idle_gaps(inside, lo, hi)[:N_GAPS]],
        idle_ms_by_host_span=_idle_by_span(inside, spans, lo, hi))
    return out


def _idle_by_span(device, spans, lo, hi):
    """Idle ms summed by the span the host spent most of each gap in."""
    out = {}
    for a, b in idle_gaps(device, lo, hi):
        label = span_over(spans, a, b)
        out[label] = out.get(label, 0.0) + (b - a) / 1e3
    return out


def trace_chunks(dims, device, seed, dtype, path):
    """Run the traced chunks (module docstring); the trace goes to
    ``path``."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)

    from evreal_tpu_torch.bench.flagship import lockstep_runner, make_buffers
    from evreal_tpu_torch.harness.runner import (from_host, quantize_u8,
                                                 to_host)
    from evreal_tpu_torch.models import build_flagship_e2vid
    from evreal_tpu_torch.utils import f32_parity

    lanes, chunk_t = dims["lanes"], dims["chunk_t"]
    h, w = dims["height"], dims["width"]
    f32_bufs, compact = make_buffers(seed, lanes, chunk_t, h, w,
                                     dims["events"])
    model, _ = build_flagship_e2vid(seed=seed)
    runner = lockstep_runner(model, lanes, chunk_t, h, w, device, dtype)
    state = [runner.init_state()]
    finite = common.Finite()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        pack, pool = common.lane_packer(tmp, f32_bufs, h, w)

        def chunk():
            with record_function("bench.pack"):
                pack()
            with record_function("bench.upload"):
                dev = runner.upload(pool)
            with record_function("bench.run"):
                state[0], _, clipped = runner.run(state[0], dev, chunk_t)
                finite.add(clipped)
                frames = quantize_u8(clipped)
            with record_function("bench.fetch"):
                from_host(*to_host({"images": frames}))

        chunks = max(1, dims["windows"] // chunk_t)
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with f32_parity(), common.counted(launches, f"traced_{dtype}"):
            chunk()  # warm
            with profile(activities=activities) as prof:
                for _ in range(chunks):
                    chunk()
    prof.export_chrome_trace(path)
    common.check(finite.ok(), "a traced frame is not finite")
    common.check_launches(device, launches)
    return chunks, launches


def run(dims, device, seed, dtype="float32", trace=None, top=20):
    """The profile mode. Returns (metrics, units)."""
    path = trace or os.path.join(tempfile.gettempdir(),
                                 "evreal_bench_trace.json")
    chunks, launches = trace_chunks(dims, device, seed, dtype, path)
    m = {"lanes": dims["lanes"], "chunk_t": dims["chunk_t"],
         "height": dims["height"], "width": dims["width"], "dtype": dtype,
         "wire": "compact4", **analyze(path, chunks, top),
         "voxelize_launches": launches}
    return m, UNITS


UNITS = {"wall_ms": "ms", "host_ms_per_chunk": "ms",
         "device_busy_ms": "ms", "device_idle_ms": "ms",
         "device_busy_share": "fraction of the traced wall",
         "device_busy_ms_per_chunk": "ms", "kernel_ms_by_category": "ms",
         "idle_ms_by_host_span": "ms"}
