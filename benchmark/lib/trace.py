"""Reading a ``torch.profiler`` Chrome trace: device busy and idle time over
a window, device time by kernel category, and the longest idle gaps named
by what the host was doing. A frozen copy of the arithmetic of
``evreal_tpu_torch/bench/profile_chunk.py`` (``categorize``,
``read_trace``, ``idle_gaps``, ``span_over``) and ``bench/timing.py``
(``union_us``), so that the program may change and the yardstick not."""

import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
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
N_TOP = 10
WINDOW_SPAN = "bench.window"  # the benchmark's span around a traced window


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
    """(device events [(name, start us, end us)], host events [(name,
    start us, end us)]: the annotations and operators, the device's name
    or None) of a Chrome trace."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    device, host = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            device.append((e["name"], start, end))
        elif e.get("cat") in HOST_CATS:
            host.append((e["name"], start, end))
    props = trace.get("deviceProperties") or [{}]
    return device, host, props[0].get("name")


def span(host, name):
    """(start, end) of the first host event called ``name``, or None."""
    for n, a, b in host:
        if n == name:
            return a, b
    return None


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
    """The host event that covers most of [a, b], or "between spans"."""
    best, label = 0.0, "between spans"
    for name, lo, hi in spans:
        overlap = min(b, hi) - max(a, lo)
        if overlap > best:
            best, label = overlap, name
    return label


def inside(device, lo, hi):
    """The device events that overlap [lo, hi], cut to it."""
    return [(n, max(a, lo), min(b, hi)) for n, a, b in device
            if b > lo and a < hi]


class Window:
    """The device's work over the traced window [lo, hi] (trace us)."""

    def __init__(self, device, host, lo, hi):
        self.lo, self.hi = lo, hi
        self.device = inside(device, lo, hi)
        self.host = [h for h in host
                     if h[2] > lo and h[1] < hi and h[0] != WINDOW_SPAN]
        self.busy_us = union_us([(a, b) for _, a, b in self.device])
        self.window_us = hi - lo

    def kernel_us(self, pattern):
        """Summed device time of the kernels whose name matches
        ``pattern`` (a regular expression)."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.device if rx.search(n))

    def by_category(self):
        """{category: device us} (``categorize``)."""
        cats = {}
        for n, a, b in self.device:
            cat = categorize(n)
            cats[cat] = cats.get(cat, 0.0) + (b - a)
        return cats

    def breakdown(self):
        """The result line's ``breakdown``: the device's time by kernel
        category and the longest idle gaps, each named by the host event
        that covers most of it, in seconds, at most ``N_TOP`` each."""
        ops = sorted(self.by_category().items(), key=lambda kv: -kv[1])
        gaps = idle_gaps(self.device, self.lo, self.hi)[:N_TOP]
        return {"device_ops": [[k, v / 1e6] for k, v in ops[:N_TOP]],
                "idle_gaps": [[span_over(self.host, a, b), (b - a) / 1e6]
                              for a, b in gaps]}
