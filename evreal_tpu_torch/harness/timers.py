"""Steady-state wall-clock timing per frame (``evreal_tpu/harness/timers.py``).

A timer spans a sequence's chunk loop; the caller restarts it with
``exclude_warmup`` once the first chunk (which bears the kernel build,
cuDNN's algorithm search and allocator growth) has finished, and every
device the run uses (each card of a mesh) is fenced with
``torch.cuda.synchronize()`` at both boundaries, so the sample is
steady-state ms per frame of the slowest card. Samples go to the
``TimingLog`` the caller passes; ``summary()`` is frame-count weighted
across sequences.

The eval loop also marks its stages with ``span(name)``
(``utils/spans.py``; the ``SPANS`` below): under an active
``torch.profiler`` session a span is a host event of that name in the
same trace as the device's kernels; otherwise it is one shared no-op
context. And it counts, on the ``TimingLog`` (``counts``), the
lane-windows a lockstep group runs against the real ones, the lanes it
drops as they end, the PNG writers' frames, bytes and thread seconds, and
the attention calls of each chunk's model steps.
"""

import time
from collections import Counter, defaultdict

import torch

# the spans of ``evaluate`` (``harness/runner.py``) and of its eval loop
# (``harness/batched.py``)
OPEN = "evreal.open"            # an eval config's datasets opened
BUNDLE = "evreal.bundle"        # MethodBundle: .pth read, model built, cast
SETUP = "evreal.setup"          # a group's or sequence's set-up
PACK = "evreal.pack"            # a chunk's windows packed into the pool
UPLOAD = "evreal.upload"        # the chunk pinned and copied to the device
STEP = "evreal.step"            # voxelizer, model step, post-norm enqueued
SCORE = "evreal.score"          # reference frames loaded, uploaded, scored
FETCH = "evreal.fetch"          # the host waits for the chunk's copies back
RECORD = "evreal.record"        # score rows written, frames handed off
PNG_WAIT = "evreal.png.wait"    # a frame queued to its writer (in RECORD)
PNG_DRAIN = "evreal.png.drain"  # a sequence's writer joined, files closed
SPANS = (OPEN, BUNDLE, SETUP, PACK, UPLOAD, STEP, SCORE, FETCH, RECORD,
         PNG_WAIT, PNG_DRAIN)
# the attention wrapper's counts (``kernels/attention_cuda.py:counts``),
# added a chunk at a time (``harness/runner.py:count_attention``)
ATTENTION_COUNTS = ("attention.calls", "attention.kernel_calls",
                    "attention.products")


def fence(device):
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class TimingLog:
    """Per-name samples ``[(elapsed_ms, frames), ...]``, and ``counts`` of
    the loop's work, updated on the loop's thread:
    ``lane_windows.real`` (windows evaluated) and
    ``lane_windows.computed`` (lanes run times the windows stepped, each
    chunk: a group's running lanes, a mesh group's padded lanes; equal for
    a group of one lane), ``lockstep.narrowed`` (the lanes a group
    dropped at chunk boundaries once their windows ran out), ``png.frames``,
    ``png.bytes`` and ``png.busy_s`` (the PNG writers' frames, encoded
    bytes and thread seconds, added when a sequence's writer is
    joined), and the ``ATTENTION_COUNTS``: ``attention.calls``,
    ``attention.kernel_calls`` (those that launched the fused kernel) and
    ``attention.products`` (the sum of N * heads * Lq * Lk), added a chunk
    at a time."""

    def __init__(self):
        self.samples = defaultdict(list)
        self.counts = Counter()

    def count(self, name, n=1):
        self.counts[name] += n

    def ms_per_frame(self, name):
        samples = self.samples.get(name, [])
        frames = sum(f for _, f in samples)
        return sum(e for e, _ in samples) / frames if frames else None

    def summary(self):
        lines = []
        for name, samples in self.samples.items():
            frames = sum(f for _, f in samples)
            lines.append(f"{name}: {self.ms_per_frame(name):.2f} ms/frame "
                         f"({frames} frames, {len(samples)} sequences)")
        real, computed = (self.counts["lane_windows.real"],
                          self.counts["lane_windows.computed"])
        if computed:
            lines.append(f"lockstep: {real} of {computed} lane-windows "
                         f"real ({100.0 * real / computed:.1f}%), "
                         f"{self.counts['lockstep.narrowed']} lanes "
                         f"narrowed")
        frames, busy_s = self.counts["png.frames"], self.counts["png.busy_s"]
        if frames:
            lines.append(f"png writers: {frames} frames, "
                         f"{self.counts['png.bytes']} bytes, {busy_s:.3f} "
                         f"thread s ({1000.0 * busy_s / frames:.2f} "
                         f"ms/frame)")
        calls, fused, products = (self.counts[n] for n in ATTENTION_COUNTS)
        if calls:
            lines.append(f"attention: {calls} calls, {fused} fused "
                         f"({100.0 * fused / calls:.1f}%), {products} "
                         f"products")
        return lines


class DeviceTimer:
    """Wall clock over a run on ``devices`` (one device, or a list such as
    a mesh's shards), each fenced at the clock's start and stop."""

    def __init__(self, log, name, frames, devices):
        self.log = log
        self.name = name
        self.frames = max(frames, 1)
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = list(dict.fromkeys(torch.device(d) for d in devices))

    def fence(self):
        for device in self.devices:
            fence(device)

    def __enter__(self):
        self.fence()
        self.start = time.perf_counter()
        return self

    def exclude_warmup(self, frames_done):
        """Restart the clock after the first chunk; ``frames_done`` frames
        drop out of the sample."""
        self.fence()
        self.start = time.perf_counter()
        self.frames -= frames_done

    def __exit__(self, *exc):
        self.fence()
        elapsed_ms = (time.perf_counter() - self.start) * 1000.0
        if self.frames > 0 and exc[0] is None:
            self.log.samples[self.name].append((elapsed_ms, self.frames))
