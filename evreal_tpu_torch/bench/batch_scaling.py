"""Frames/s of the flagship lockstep runner against its lane count
(``tools/bench_batch_scaling.py``): flagship E2VID at 180 x 240, chunks of
32 windows of 30,000 uniform synthetic events on the f32 wire, uploaded
once (device-resident), for each lane count of ``batches`` in f32 (TF32
off) and bf16. Per (lanes, dtype): frames/s (median over the runs, every
run listed), ms per frame of a lane, and on the card the peak device
memory of the runs (``max_memory_allocated`` after
``reset_peak_memory_stats``, buffers and model included). Every frame
must be finite and, on the card, every leg must launch the voxelizer.
"""

import numpy as np
import torch

from evreal_tpu_torch.bench import common
from evreal_tpu_torch.bench.flagship import lockstep_runner
from evreal_tpu_torch.data.packing import bucket_capacity

DEFAULTS = {"chunk_t": 32, "height": 180, "width": 240, "windows": 128,
            "repeats": 3, "events": common.EVENTS}
DEFAULT_BATCHES = (8, 16, 32, 64)
DTYPES = ("float32", "bfloat16")


def run(dims, device, seed, batches=None, dtypes=DTYPES):
    """The scaling mode. Returns (metrics, units)."""
    from evreal_tpu_torch.models import build_flagship_e2vid
    from evreal_tpu_torch.utils import f32_parity

    chunk_t, h, w = dims["chunk_t"], dims["height"], dims["width"]
    chunks = max(1, dims["windows"] // chunk_t)
    model, _ = build_flagship_e2vid(seed=seed)
    launches, rows = {}, []
    finite = common.Finite()
    on_card = device.type == "cuda"
    for n in batches or DEFAULT_BATCHES:
        host = common.event_buffers(
            np.random.default_rng(seed), (n, chunk_t),
            bucket_capacity(dims["events"]), dims["events"], h, w)
        row = {"lanes": n}
        for dtype in dtypes:
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            runner = lockstep_runner(model, n, chunk_t, h, w, device, dtype)
            dev = runner.upload(host)
            state = [runner.init_state()]

            def step(runner=runner, dev=dev, state=state):
                state[0], _, clipped = runner.run(state[0], dev, chunk_t)
                finite.add(clipped)

            label = f"{n}_lanes_{dtype}"
            with f32_parity(), common.counted(launches, label):
                step()  # warm
                rates = common.rate_loop(device, step, chunks,
                                         dims["repeats"], n * chunk_t)
            fps = float(np.median(rates))
            row[dtype] = {"frames_per_s": fps, "frames_per_s_runs": rates,
                          "ms_per_frame_per_lane": 1e3 / fps * n}
            if on_card:
                row[dtype]["peak_mib"] = (torch.cuda.max_memory_allocated(
                    device) / 2 ** 20)
            print(f"{label}: {fps:.1f} frames/s", flush=True)
            del runner, dev, state, step  # free the leg before the next
        rows.append(row)
    common.check(finite.ok(), "a scaling frame is not finite")
    common.check_launches(device, launches)
    m = {"chunk_t": chunk_t, "height": h, "width": w,
         "events_per_window": dims["events"], "wire": "f32",
         "rows": rows, "voxelize_launches": launches}
    units = {"frames_per_s": "frames/s", "ms_per_frame_per_lane": "ms",
             "peak_mib": "MiB"}
    return m, units
