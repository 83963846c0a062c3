"""The card's state beside a measurement (``bench.py:157-297``): fixed
probes timed on the card, each also given as its share of the published
H100 SXM peak (989 TFLOP/s dense bf16, 3.35 TB/s HBM) with the card's
power limit beside it, and nvidia-smi's clocks, power and temperature
sampled after each probe.

- ``matmul_bf16_tflops``: a chained bf16 matmul, 16 products of
  8192 x 8192 x 8192 (17.6 TFLOP), CUDA events;
- ``hbm_gb_per_s``: a chained in-place elementwise pass over 512 MiB of
  f32, 64 passes (each reads and writes the buffer), CUDA events;
- ``h2d_gb_per_s``: a 64 MiB host-to-device copy from pinned memory,
  CUDA events;
- ``op_latency_us``: per-iteration us of a minimal conv step loop (64
  steps of a 3 x 3, 16-channel convolution and tanh on 64 x 64), host
  clock with the device synchronized;
- the host's 1-minute load and CPU count.

Each probe is the best of ``repeats`` runs after a warm-up. The TPU's
healthy-state constants of ``bench.py:128-155`` have no counterpart.
"""

import os
import time

import torch

from evreal_tpu_torch.bench import common

DEFAULTS = {"repeats": 3}


def events_ms(fn, repeats):
    """Best ms of ``fn()`` by CUDA events over ``repeats`` runs, after one
    warm-up run."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def matmul_tflops(device, repeats=3, n=8192, iters=16):
    a = (torch.randn(n, n, device=device, generator=torch.Generator(
        device).manual_seed(0)) * 0.01).to(torch.bfloat16)

    def chain():
        x = a
        for _ in range(iters):
            x = x @ a  # each product depends on the last (gain ~0.9)
        return x

    ms = events_ms(chain, repeats)
    return 2.0 * n ** 3 * iters / (ms / 1e3) / 1e12


def hbm_gb_per_s(device, repeats=3, n=128 * 1024 * 1024, iters=64):
    x = torch.ones(n, device=device)

    def passes():
        for _ in range(iters):
            x.mul_(1.0000001)

    ms = events_ms(passes, repeats)
    return 2.0 * iters * n * 4 / (ms / 1e3) / 1e9


def h2d_gb_per_s(device, repeats=3, mib=64):
    src = torch.ones(mib << 20, dtype=torch.uint8).pin_memory()
    dst = torch.empty(mib << 20, dtype=torch.uint8, device=device)
    ms = events_ms(lambda: dst.copy_(src, non_blocking=True), repeats)
    return src.numel() / (ms / 1e3) / 1e9


def op_latency_us(device, repeats=3, iters=64):
    x0 = torch.ones(1, 16, 64, 64, device=device)
    k = torch.full((16, 16, 3, 3), 0.01, device=device)

    def loop():
        x = x0
        for _ in range(iters):
            x = torch.tanh(torch.nn.functional.conv2d(x, k, padding=1))
        torch.cuda.synchronize(device)

    loop()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        loop()
        best = min(best, time.perf_counter() - t0)
    return best / iters * 1e6


def host_load():
    """1-minute load average and CPU count of the host."""
    out = {"host_cpus": os.cpu_count() or 1}
    try:
        out["host_load_1m"] = os.getloadavg()[0]
    except OSError:  # a platform without getloadavg
        pass
    return out


def run_probes(device, repeats=3):
    """The probes on ``device``'s card, each with nvidia-smi sampled after
    it; the host's load."""
    out = {"power_limit_w": common.device_info(device)["power_limit_w"]}
    with torch.no_grad():
        for key, fn in (("matmul_bf16_tflops", matmul_tflops),
                        ("hbm_gb_per_s", hbm_gb_per_s),
                        ("h2d_gb_per_s", h2d_gb_per_s),
                        ("op_latency_us", op_latency_us)):
            out[key] = fn(device, repeats)
            out[key + "_smi"] = common.smi_sample()
            torch.cuda.empty_cache()
    out["matmul_share_of_bf16_peak"] = (out["matmul_bf16_tflops"]
                                        / common.BF16_PEAK_TFLOPS)
    out["hbm_share_of_peak"] = out["hbm_gb_per_s"] / common.HBM_GB_PER_S
    return out


def run(dims, device, seed):
    """The probes mode (``seed`` unused: the probes are fixed). Off the
    card only the host's load is written."""
    m = host_load()
    if device.type == "cuda":
        m.update(run_probes(device, dims["repeats"]))
    return m, UNITS


UNITS = {"matmul_bf16_tflops": "TFLOP/s", "hbm_gb_per_s": "GB/s",
         "h2d_gb_per_s": "GB/s", "op_latency_us": "us per iteration",
         "matmul_share_of_bf16_peak": "fraction of 989 TFLOP/s",
         "hbm_share_of_peak": "fraction of 3350 GB/s",
         "power_limit_w": "W", "host_load_1m": "runnable tasks"}
