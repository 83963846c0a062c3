"""ms per frame of each method on the single-sequence path
(``tools/bench_methods.py``): chunks of 32 windows at 180 x 240, 30,000
uniform synthetic events a window on the f32 wire, each chunk uploaded
through ``utils.upload`` as the eval loop uploads it, the models at their
published widths with seeded random weights (``bench/models.py``; weights
do not change the work).

Per method: steady ms per frame (the first chunk, which bears cuDNN's
algorithm search, excluded; the median over the runs, every run listed),
GFLOP per window (``MethodRunner.cost_analysis``: convolutions and matrix
products only), and on the card one steady chunk's device-busy ms and
MFU (those FLOPs over the busy time, against the dense bf16 peak). The
default methods are the five whose widths are published; ET-Net,
SPADE-E2VID and HyperE2VID run when named (``-m``) and are marked
``"guessed_width": true``. Every frame must be finite and, on the card,
every method's chunks must launch the voxelizer.
"""

import numpy as np
import torch

from evreal_tpu_torch.bench import common
from evreal_tpu_torch.bench.models import GUESSED_WIDTH, method_model
from evreal_tpu_torch.bench.timing import top_kernels, traced
from evreal_tpu_torch.data.packing import bucket_capacity

DEFAULTS = {"chunk_t": 32, "height": 180, "width": 240, "windows": 256,
            "repeats": 3, "events": common.EVENTS}
DEFAULT_METHODS = ("E2VID", "E2VID+", "FireNet", "FireNet+", "SSL-E2VID")


def bench_method(method, dims, device, seed, launches):
    from evreal_tpu_torch.harness.runner import MethodRunner
    from evreal_tpu_torch.utils.mfu import mfu

    chunk_t, h, w = dims["chunk_t"], dims["height"], dims["width"]
    chunks = max(1, dims["windows"] // chunk_t)
    model, flags = method_model(torch, method, seed)
    with common.serving_dtype("float32"):
        runner = MethodRunner(model, height=h, width=w, num_bins=5,
                              device=device, chunk_t=chunk_t, **flags)
    bufs = common.event_buffers(np.random.default_rng(seed), (chunk_t,),
                                bucket_capacity(dims["events"]),
                                dims["events"], h, w)
    finite = common.Finite()
    holder = [runner.init_state()]

    def step():
        holder[0], _, clipped = runner.run(holder[0], runner.upload(bufs),
                                           chunk_t)
        finite.add(clipped)

    with common.counted(launches, method):
        step()  # the first chunk: excluded
        rates = common.rate_loop(device, step, chunks, dims["repeats"],
                                 chunk_t)
    flops = runner.cost_analysis(runner.init_state(), bufs)[0]
    row = {"ms_per_frame": 1e3 / float(np.median(rates)),
           "ms_per_frame_runs": [1e3 / r for r in rates],
           "gflop_per_window": flops / chunk_t / 1e9,
           "guessed_width": method in GUESSED_WIDTH}
    if device.type == "cuda":
        busy, _, by_name = traced(torch, step)  # one steady chunk
        if busy is None:
            row["device_busy_ms_per_chunk"] = "not measured"
        else:
            tflops, frac = mfu(flops, busy / 1e3, device)
            row.update(device_busy_ms_per_chunk=busy,
                       model_tflops_per_s=tflops, mfu_vs_bf16_peak=frac,
                       top_kernels=top_kernels(by_name, 6))
    common.check(finite.ok(), f"{method}: a frame is not finite")
    return row


def run(dims, device, seed, methods=None):
    """The methods mode. Returns (metrics, units)."""
    from evreal_tpu_torch.utils import f32_parity

    launches, rows = {}, {}
    with f32_parity():
        for method in methods or DEFAULT_METHODS:
            rows[method] = bench_method(method, dims, device, seed, launches)
            print(f"{method}: {rows[method]['ms_per_frame']:.3f} ms/frame",
                  flush=True)
    common.check_launches(device, launches)
    m = {"chunk_t": dims["chunk_t"], "height": dims["height"],
         "width": dims["width"], "events_per_window": dims["events"],
         "wire": "f32", "methods": rows, "voxelize_launches": launches}
    units = {"ms_per_frame": "ms", "gflop_per_window": "GFLOP",
             "device_busy_ms_per_chunk": "ms", "model_tflops_per_s":
             "TFLOP/s", "mfu_vs_bf16_peak": "fraction of 989 TFLOP/s"}
    return m, units
