"""Steady-state wall-clock timing per frame (``evreal_tpu/harness/timers.py``).

A timer spans a sequence's chunk loop; the caller restarts it with
``exclude_warmup`` once the first chunk (which bears the kernel build,
cuDNN's algorithm search and allocator growth) has finished, and the
device is fenced with ``torch.cuda.synchronize()`` at both boundaries, so
the sample is steady-state ms per frame. Samples go to the
``TimingLog`` the caller passes; ``summary()`` is frame-count weighted
across sequences.
"""

import time
from collections import defaultdict

import torch


def fence(device):
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class TimingLog:
    """Per-name samples ``[(elapsed_ms, frames), ...]``."""

    def __init__(self):
        self.samples = defaultdict(list)

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
        return lines


class DeviceTimer:
    def __init__(self, log, name, frames, device):
        self.log = log
        self.name = name
        self.frames = max(frames, 1)
        self.device = device

    def __enter__(self):
        fence(self.device)
        self.start = time.perf_counter()
        return self

    def exclude_warmup(self, frames_done):
        """Restart the clock after the first chunk; ``frames_done`` frames
        drop out of the sample."""
        fence(self.device)
        self.start = time.perf_counter()
        self.frames -= frames_done

    def __exit__(self, *exc):
        fence(self.device)
        elapsed_ms = (time.perf_counter() - self.start) * 1000.0
        if self.frames > 0 and exc[0] is None:
            self.log.samples[self.name].append((elapsed_ms, self.frames))
