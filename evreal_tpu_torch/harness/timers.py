"""Steady-state wall-clock timing per frame (``evreal_tpu/harness/timers.py``).

A timer spans a sequence's chunk loop; the caller restarts it with
``exclude_warmup`` once the first chunk (which bears the kernel build,
cuDNN's algorithm search and allocator growth) has finished, and every
device the run uses (each card of a mesh) is fenced with
``torch.cuda.synchronize()`` at both boundaries, so the sample is
steady-state ms per frame of the slowest card. Samples go to the
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
