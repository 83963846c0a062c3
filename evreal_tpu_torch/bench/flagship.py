"""The headline (``bench.py:capture``, ``bench.py:446-750``): flagship
E2VID, 16 lanes in lockstep, chunks of 32 windows at 180 x 240, 30,000
uniform synthetic events a window (capacity 32768), on the compact4 wire,
in f32 (TF32 off) with event norm and robust post-norm.

Legs, each timed over ``windows // chunk_t`` chunks a run and reported as
the median over the runs (every run listed beside it):

- ``value``: the streamed loop, one pinned upload of the chunk's compact4
  buffers a chunk through ``utils.upload`` (as the eval loop uploads), then
  the chunk;
- ``device_resident_fps``: the same chunks on buffers uploaded once;
- ``f32_wire_fps``: the streamed loop on the f32 wire (9 bytes an event);
- ``bf16_device_resident_fps``: the bf16 serving mode
  (``EVREAL_DTYPE=bfloat16``: the voxelizer with bf16 factors) on the
  resident compact4 buffers.

On the card one steady resident chunk is traced with ``torch.profiler``:
its device busy share and top kernels, and the model's FLOPs
(``MethodRunner.cost_analysis``: convolutions and matrix products only,
no voxelizer or elementwise work) over its device-busy time as TFLOP/s and
MFU against the dense bf16 peak (``utils/mfu.py:mfu``). The host's share,
timed in this file around each layer's call: ms per chunk to pack the
chunk's windows with ``pack_windows`` (the native packer, from an
npy-memmap sequence of the same events, into pooled lane views as the
lockstep loop packs), to upload it, to fetch its u8 frames (``to_host``)
and to encode them as PNG (``harness/outputs.py``).

Correctness: the first chunk's lane-0 frames against a single-sequence
``MethodRunner`` on the same windows (1e-4), every timed frame finite, and
on the card the voxelizer launched on every leg; a failure raises
``BenchError``.

Not ported (TPU-only, ROADMAP "Not ported, by decision"): the prestaged
leg and its tunnel canary (``bench.py:555-590``), ``SCAN_UNROLL=4`` and
``EVREAL_UPFUSE=1`` (``bench.py:470-485``), ``_backend_guard`` and
``retry_for_healthy_window`` (``bench.py:302-445``), and ``vs_baseline``
(a rate of the TPU host's CPU).
"""

import tempfile

import numpy as np
import torch

from evreal_tpu_torch.bench import common
from evreal_tpu_torch.bench.timing import host_ms, top_kernels, traced
from evreal_tpu_torch.data.packing import bucket_capacity
from evreal_tpu_torch.harness.timers import fence

DEFAULTS = {"lanes": 16, "chunk_t": 32, "height": 180, "width": 240,
            "windows": 128, "repeats": 3, "events": common.EVENTS}
TOL_SINGLE = 1e-4  # lockstep lane vs single path, card (TF32 off)


def metric_name(lanes, chunk_t, h, w):
    """``bench.py:121-123``: the headline's name at the default shape, a
    self-describing one at any other."""
    if (lanes, chunk_t, h, w) == (16, 32, 180, 240):
        return "e2vid_recon_fps_ecd_b16"
    return f"e2vid_recon_fps_{h}x{w}_b{lanes}_t{chunk_t}"


def make_buffers(seed, lanes, chunk_t, h, w, n_events):
    """(f32-wire, compact4) host buffers of one chunk, (lanes, chunk_t, E),
    from ``np.random.default_rng(seed)`` (``bench.py:525-553``)."""
    rng = np.random.default_rng(seed)
    bufs = common.event_buffers(rng, (lanes, chunk_t),
                                bucket_capacity(n_events), n_events, h, w)
    return bufs, common.compact4_buffers(bufs, h, w)


def lockstep_runner(model, lanes, chunk_t, h, w, device, dtype="float32"):
    """The flagship's ``BatchedRunner``: event norm, robust post-norm,
    5 bins, in ``dtype``."""
    from evreal_tpu_torch.harness.batched import BatchedRunner

    with common.serving_dtype(dtype):
        return BatchedRunner(model, n=lanes, event_norm=True,
                             post_norm="robust", height=h, width=w,
                             num_bins=5, device=device, chunk_t=chunk_t)


def single_runner(model, chunk_t, h, w, device):
    from evreal_tpu_torch.harness.runner import MethodRunner

    with common.serving_dtype("float32"):
        return MethodRunner(model, event_norm=True, post_norm="robust",
                            height=h, width=w, num_bins=5, device=device,
                            chunk_t=chunk_t)


def host_legs(runner, hw, f32_bufs, compact, clipped, reps):
    """Host ms per chunk of packing, upload, fetch and PNG encoding,
    each {"median_ms", "n"} over ``reps`` calls."""
    from evreal_tpu_torch import native
    from evreal_tpu_torch.harness.outputs import encode_png_gray8
    from evreal_tpu_torch.harness.runner import (from_host, quantize_u8,
                                                 to_host)

    h, w = hw
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pack, pool = common.lane_packer(tmp, f32_bufs, h, w)
        pack()  # the first pack builds the native packer
        native.reset_pack_calls()
        out["pack"] = host_ms(pack, reps, 0)
        out["pack"]["native_pack_calls"] = native.pack_calls["compact4"]
        common.check(bool((pool["count"] == compact["count"]).all()),
                     "the packer's counts differ from the bench's windows")
    out["upload"] = host_ms(lambda: (runner.upload(compact),
                                     fence(runner.device)), reps)
    frames = quantize_u8(clipped)
    fence(runner.device)
    host = {}
    out["fetch"] = host_ms(
        lambda: host.update(from_host(*to_host({"images": frames}))), reps)
    images = host["images"].reshape((-1, h, w))
    out["png"] = host_ms(lambda: [encode_png_gray8(im) for im in images],
                         reps)
    return out


def run(dims, device, seed):
    """The flagship mode; ``dims`` {lanes, chunk_t, height, width,
    windows, repeats, events}. Returns (metrics, units)."""
    from evreal_tpu_torch.models import build_flagship_e2vid
    from evreal_tpu_torch.utils import f32_parity
    from evreal_tpu_torch.utils.mfu import mfu

    lanes, chunk_t = dims["lanes"], dims["chunk_t"]
    h, w, reps = dims["height"], dims["width"], dims["repeats"]
    chunks = max(1, dims["windows"] // chunk_t)
    frames = lanes * chunk_t
    f32_bufs, compact = make_buffers(seed, lanes, chunk_t, h, w,
                                     dims["events"])
    model, _ = build_flagship_e2vid(seed=seed)
    runner = lockstep_runner(model, lanes, chunk_t, h, w, device)
    launches, finite = {}, common.Finite()
    m = {"metric": metric_name(lanes, chunk_t, h, w), "lanes": lanes,
         "chunk_t": chunk_t, "height": h, "width": w,
         "events_per_window": dims["events"],
         "capacity": int(compact["ev"].shape[-1]), "wire": "compact4",
         "wire_mb_per_chunk": sum(v.nbytes for v in compact.values()) / 1e6,
         "chunks_per_run": chunks, "runs": reps}
    with f32_parity():
        dev = runner.upload(compact)
        with common.counted(launches, "first_chunk_f32_compact4"):
            state, _, first = runner.run(runner.init_state(), dev, chunk_t)
            single = single_runner(model, chunk_t, h, w, device)
            _, _, alone = single.run(
                single.init_state(),
                single.upload({k: v[0] for k, v in compact.items()}),
                chunk_t)
        finite.add(first)
        err = float((first[0] - alone).abs().max())
        common.check(err <= TOL_SINGLE,
                     f"lane 0 vs the single path: {err} > {TOL_SINGLE}")

        def resident():
            nonlocal state
            state, _, clipped = runner.run(state, dev, chunk_t)
            finite.add(clipped)

        def streamed(host_bufs, holder):
            def step():
                holder[0], _, clipped = runner.run(
                    holder[0], runner.upload(host_bufs), chunk_t)
                finite.add(clipped)
            return step

        with common.counted(launches, "device_resident_f32_compact4"):
            m["device_resident_fps_runs"] = common.rate_loop(
                device, resident, chunks, reps, frames)
        with common.counted(launches, "streamed_f32_compact4"):
            m["value_runs"] = common.rate_loop(
                device, streamed(compact, [state]), chunks, reps, frames)
        with common.counted(launches, "streamed_f32_f32wire"):
            wire_state = [runner.init_state()]
            streamed(f32_bufs, wire_state)()  # warm: the f32 wire's shapes
            m["f32_wire_fps_runs"] = common.rate_loop(
                device, streamed(f32_bufs, wire_state), chunks, reps, frames)

        r16 = lockstep_runner(model, lanes, chunk_t, h, w, device,
                              "bfloat16")
        s16 = [r16.init_state()]

        def bf16_step():
            s16[0], _, clipped = r16.run(s16[0], dev, chunk_t)
            finite.add(clipped)

        with common.counted(launches, "device_resident_bf16_compact4"):
            bf16_step()  # warm
            m["bf16_device_resident_fps_runs"] = common.rate_loop(
                device, bf16_step, chunks, reps, frames)
        for key in ("value", "device_resident_fps", "f32_wire_fps",
                    "bf16_device_resident_fps"):
            m[key] = float(np.median(m[key + "_runs"]))

        flops = runner.cost_analysis(runner.init_state(), compact)[0]
        m["gflop_per_window"] = flops / frames / 1e9
        m["flops_count"] = ("convolutions and matrix products of the model "
                            "and post-norm; no voxelizer or elementwise "
                            "FLOPs")
        if device.type == "cuda":
            busy, wall, by_name = traced(
                torch, lambda: runner.run(state, dev, chunk_t))
            if busy is None:
                m["device_busy_share"] = "not measured"
            else:
                tflops, frac = mfu(flops, busy / 1e3, device)
                m.update(device_busy_ms_per_chunk=busy,
                         device_wall_ms_per_chunk=wall,
                         device_busy_share=busy / wall,
                         model_tflops_per_s=tflops,
                         mfu_vs_bf16_peak=frac,
                         top_kernels=top_kernels(by_name))
        m["host_ms_per_chunk"] = host_legs(runner, (h, w), f32_bufs,
                                           compact, first, reps)
    common.check(finite.ok(), "a flagship frame is not finite")
    common.check_launches(device, launches)
    m["voxelize_launches"] = launches
    m["lane0_vs_single_max_abs_err"] = err
    units = {"value": "frames/s", "device_resident_fps": "frames/s",
             "f32_wire_fps": "frames/s", "bf16_device_resident_fps":
             "frames/s", "wire_mb_per_chunk": "MB", "gflop_per_window":
             "GFLOP", "model_tflops_per_s": "TFLOP/s", "mfu_vs_bf16_peak":
             "fraction of 989 TFLOP/s", "device_busy_share":
             "fraction of the chunk's wall", "device_busy_ms_per_chunk":
             "ms", "device_wall_ms_per_chunk": "ms",
             "host_ms_per_chunk": "ms (median, n samples)",
             "lane0_vs_single_max_abs_err": "abs"}
    return m, units
