#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (``evreal_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name, the device count, nvidia-smi's name and power
   limit;
2. build — builds the CUDA voxelizer from ``evreal_tpu_torch/kernels/csrc``
   and prints nvcc's ``-Xptxas -v`` report;
3. kernel — runs the voxelizer at the eval path's shape (T = 32 windows,
   E = 32768 slots, 5 bins, 180 x 240) on every wire it takes, with edge
   cases (count 0 and E, a degenerate dt, out-of-bounds and fractional
   negative coordinates, an unsorted timestamp with t_norm <= -1, zero
   capacity), against its plain PyTorch version run on the same CUDA
   tensors with float64 accumulation (CUDA ``index_add_`` itself uses
   atomics): max abs err <= 2e-5. Times the kernel, the plain version and
   ``index_add_`` (CUDA events, median of 25 after warm-up, L2 flushed);
4. main path — writes a synthetic 180 x 240 sequence (96 windows of ~30k
   events, a moving blob) and random-init full-width E2VID weights
   (seed 0), runs the port's ``evaluate`` on ``cuda`` with
   ``-c std -qm mse ssim``, and checks the output tree, the finite scores
   and that the voxelizer launched once per chunk of 32 windows. Then the
   first 8 windows run again on the CPU through the plain path: raw
   reconstructions agree within 1e-4, the written frames within 1 grey
   level and the scores within 1e-3 (TF32 off on the card);
   profile — torch.profiler over one steady chunk of 32 windows on the
   card: device busy time against wall time, and the costliest kernels;
5. the ``kernels`` line: per ported kernel its launches on the main path,
   error and times beside its bound;

then nvidia-smi's name and power-limit line, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line; without a CUDA device the script fails at once.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL_KERNEL = 2e-5  # tests/test_pallas_voxelize.py:25
TOL_RECON = 1e-4   # raw E2VID output, card (TF32 off) vs CPU, 8 steps
TOL_SCORE = 1e-3   # mse / ssim rows, card vs CPU
ECD = dict(t=32, e=32768, h=180, w=240, b=5)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM, f32 outside the tensor cores
EVENTS_PER_WINDOW = 30000
N_WINDOWS = 96
CHUNK_T = 32


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, flush, warmup=5, iters=25):
    """Median ms of ``fn`` by CUDA events, L2 flushed before each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: the voxelizer against its plain version
# ---------------------------------------------------------------------------

def make_events(rng, t, e, h, w, float_coords=False):
    """(T, E) f32-wire buffers with the edge cases in the first windows:
    0 count 0; 1 count E; 2 degenerate dt; 3 an unsorted timestamp with
    t_norm <= -1; out-of-bounds coordinates throughout."""
    if float_coords:  # fractional, incl. negative (-0.5 truncates to 0)
        xs = rng.uniform(-2.0, w + 2.0, (t, e)).astype(np.float32)
        ys = rng.uniform(-2.0, h + 2.0, (t, e)).astype(np.float32)
        xs[:, :64] = -0.5
        ys[:, 64:128] = -0.9
    else:
        xs = rng.integers(-3, w + 3, (t, e)).astype(np.int16)
        ys = rng.integers(-3, h + 3, (t, e)).astype(np.int16)
    ts = np.sort(rng.uniform(0.0, 0.05, (t, e)), axis=1)
    ts = (ts - ts[:, :1]).astype(np.float32)
    ps = (rng.integers(0, 2, (t, e)) * 2 - 1).astype(np.int8)
    count = rng.integers(e // 2, e + 1, t).astype(np.int32)
    count[0], count[1] = 0, e
    ts[2] = 0.0                       # dt < 1e-9: linspace spread
    n3 = int(count[3])
    ts[3, 10] = -ts[3, n3 - 1]        # t_norm = -(B - 1) <= -1
    return xs, ys, ts, ps, count


def phase_kernel(torch, vc, vox):
    c = ECD
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    from evreal_tpu_torch.data.packing import encode_compact4, quantize_ts

    def cuda(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    xs, ys, ts, ps, count = make_events(rng, c["t"], c["e"], c["h"], c["w"])
    cases = {"f32 wire": cuda(xs, ys, ts, ps, count)}
    fxs, fys, fts, fps, fcount = make_events(rng, c["t"], c["e"], c["h"],
                                             c["w"], float_coords=True)
    cases["f32 wire, fractional coords"] = cuda(fxs, fys, fts, fps, fcount)
    # compact (uint16 ts, uint8 coords at this sensor) and compact4 (packed
    # u32, decoded on the device) encodings of the same windows
    q = np.zeros_like(ts, dtype=np.uint16)
    ev = np.zeros(ts.shape, np.uint32)
    for i in range(c["t"]):
        n = int(count[i])
        q[i, :n] = quantize_ts(ts[i, :n], 65535.0).astype(np.uint16)
        ev[i, :n] = encode_compact4(xs[i, :n], ys[i, :n], ts[i, :n],
                                    ps[i, :n], (c["h"], c["w"]))
    u8 = lambda a: np.where((a >= 0) & (a < 256), a, 255).astype(np.uint8)
    cases["uint16 wire"] = cuda(u8(xs), u8(ys), q, ps, count)
    ev_t, count_t = cuda(ev, count)
    cases["compact4 wire (decoded)"] = list(
        vox.decode_compact4(ev_t, (c["h"], c["w"]))) + [count_t]

    hw = (c["h"], c["w"])
    errs = {}
    for name, args in cases.items():
        got = vox.voxelize_windows(*args, c["b"], hw)
        want = vox.voxelize_windows_plain(*args, c["b"], hw,
                                          accum_dtype=torch.float64)
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        check(errs[name] <= TOL_KERNEL,
              f"voxelizer {name}: max abs err {errs[name]} > {TOL_KERNEL}")
    before = vc.launches
    z = [a[:, :0].contiguous() for a in cases["f32 wire"][:4]]
    empty = vox.voxelize_windows(*z, cases["f32 wire"][4], c["b"], hw)
    check(vc.launches == before and not bool(empty.abs().sum()),
          "zero capacity must return zeros without a launch")

    # times at the main path's wire (int16 coords, f32 ts, int8 ps)
    args = cases["f32 wire"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = time_ms(torch, lambda: vox.voxelize_windows(*args, c["b"], hw),
                 flush)
    plain_ms = time_ms(torch, lambda: vox.voxelize_windows_plain(
        *args, c["b"], hw), flush)
    idx, wgt = vox.event_deposits(*args, c["b"], hw)
    acc = torch.zeros(c["t"] * c["b"] * c["h"] * c["w"], device=dev)
    library_ms = time_ms(torch, lambda: acc.index_add_(0, idx, wgt), flush)
    n_valid = int(count.sum())
    in_bytes = n_valid * (2 * 2 + 4 + 1) + count.nbytes
    out_bytes = c["t"] * c["b"] * c["h"] * c["w"] * 4
    ops = n_valid * 8  # sub, div, mul, floor, sub, sub, 2 mul per event
    bound_s = max((in_bytes + out_bytes) / HBM_BYTES_PER_S,
                  ops / F32_OPS_PER_S)
    bound_by = ("bytes" if (in_bytes + out_bytes) / HBM_BYTES_PER_S
                >= ops / F32_OPS_PER_S else "operations")
    result = {"phase": "kernel", "max_abs_err": errs, "ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": bound_s * 1e3, "bound_by": bound_by,
              "bytes": in_bytes + out_bytes, "valid_events": n_valid,
              "shape": c}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def make_sequence(out_dir, height, width, n_windows, events_per_window,
                  seed=0, fps=25):
    """EVREAL npy-memmap sequence: a moving Gaussian blob; events fire where
    the brightness changes between frames (tools/make_synthetic_sequence.py
    in the repository writes the same format)."""
    rng = np.random.default_rng(seed)
    n_frames = n_windows + 1
    duration = n_frames / fps
    frame_times = np.arange(n_frames) / fps
    yy, xx = np.mgrid[0:height, 0:width]

    def blob(t):
        cy = height / 2 + height / 4 * np.sin(2 * np.pi * t / duration)
        cx = width / 2 + width / 4 * np.cos(2 * np.pi * t / duration)
        return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 12.0 ** 2))

    frames = [blob(t) for t in frame_times]
    images = np.stack([(f * 200 + 30).astype(np.uint8) for f in frames])
    all_ts, all_xy, all_p = [], [], []
    for i in range(n_windows):
        d = frames[i + 1] - frames[i]
        prob = np.abs(d).ravel()
        idx = rng.choice(prob.size, size=events_per_window,
                         p=prob / prob.sum())
        ys, xs = np.unravel_index(idx, (height, width))
        all_ts.append(np.sort(rng.uniform(frame_times[i], frame_times[i + 1],
                                          events_per_window)))
        all_xy.append(np.stack([xs, ys], 1).astype(np.int16))
        all_p.append((d.ravel()[idx] > 0).astype(np.uint8))
    events_ts = np.concatenate(all_ts)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "events_ts.npy"), events_ts)
    np.save(os.path.join(out_dir, "events_xy.npy"), np.concatenate(all_xy))
    np.save(os.path.join(out_dir, "events_p.npy"), np.concatenate(all_p))
    np.save(os.path.join(out_dir, "images.npy"), images)
    np.save(os.path.join(out_dir, "images_ts.npy"),
            frame_times.reshape(-1, 1))
    iei = np.maximum(np.searchsorted(events_ts, frame_times, "right") - 1, 0)
    np.save(os.path.join(out_dir, "image_event_indices.npy"),
            iei.reshape(-1, 1).astype(np.int64))
    with open(os.path.join(out_dir, "metadata.json"), "w",
              encoding="utf-8") as f:
        json.dump({"sensor_resolution": [height, width]}, f)


def read_rows(path):
    rows = [line.split() for line in open(path, encoding="utf-8")]
    return {int(i): float(v) for i, v in rows}


def phase_main_path(torch, vc, work, card, device="cuda"):
    from evreal_tpu_torch.convert.params import flatten, save_params
    from evreal_tpu_torch.harness.outputs import decode_png_gray8
    from evreal_tpu_torch.harness.runner import (MethodBundle, evaluate,
                                                 get_method_config)
    from evreal_tpu_torch.harness.timers import TimingLog
    from evreal_tpu_torch.metrics.functional import mse, ssim
    from evreal_tpu_torch.models import flagship_e2vid_kwargs
    from evreal_tpu_torch.models.init import init_e2vid
    from evreal_tpu_torch.data import Sequence, pack_windows
    from evreal_tpu_torch.ops.normalize import post_process_normalization

    c = ECD
    t0 = time.perf_counter()
    seq_dir = os.path.join(work, "data", "SYN", "seq0")
    make_sequence(seq_dir, c["h"], c["w"], N_WINDOWS, EVENTS_PER_WINDOW)
    kw = flagship_e2vid_kwargs()
    tree = init_e2vid(seed=0, num_bins=kw["num_bins"],
                      base_num_channels=kw["base_num_channels"],
                      kernel_size=kw["kernel_size"],
                      num_encoders=kw["num_encoders"],
                      num_residual_blocks=kw["num_residual_blocks"])
    npz = os.path.join(work, "weights", "E2VID.npz")
    os.makedirs(os.path.dirname(npz))
    save_params(npz, flatten(tree), {"class": "E2VIDRecurrent",
                                     "kwargs": kw, "model_name": "E2VID"})
    for group, name, cfg in (
            ("method", "E2VID", {"model_name": "E2VID", "model_path": npz,
                                 "event_tensor_normalization": True,
                                 "post_process_norm": "robust"}),
            ("dataset", "SYN", {"root_path": os.path.join(work, "data",
                                                          "SYN"),
                                "sequences": {"seq0": {}}})):
        os.makedirs(os.path.join(work, "config", group), exist_ok=True)
        with open(os.path.join(work, "config", group, name + ".json"), "w",
                  encoding="utf-8") as f:
            json.dump(cfg, f)
    setup_s = time.perf_counter() - t0

    os.chdir(work)  # config/ and outputs/ resolve here; std from the repo
    timings = TimingLog()
    vc.launches = 0
    t0 = time.perf_counter()
    evaluate(["E2VID"], ["std"], ["SYN"], ["mse", "ssim"], device=device,
             timings=timings)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = vc.launches
    n_chunks = -(-N_WINDOWS // CHUNK_T)
    check(launches == n_chunks, f"voxelizer launched {launches} times on "
          f"the main path, want one per chunk ({n_chunks})")

    out = os.path.join(work, "outputs", "std", "SYN", "seq0", "E2VID")
    scores = {m: read_rows(os.path.join(out, m + ".txt"))
              for m in ("mse", "ssim")}
    for m, rows in scores.items():
        check(sorted(rows) == list(range(N_WINDOWS)),
              f"{m}.txt rows {len(rows)} != {N_WINDOWS}")
        check(all(np.isfinite(v) for v in rows.values()),
              f"{m}.txt has non-finite scores")
    frames = []
    for i in range(N_WINDOWS):
        with open(os.path.join(out, f"frame_{i:010d}.png"), "rb") as f:
            frames.append(decode_png_gray8(f.read()))
    check(all(f.shape == (c["h"], c["w"]) for f in frames),
          "frame PNGs have the wrong shape")

    # the first 8 windows again: card vs the plain CPU path
    method_config = get_method_config("E2VID")
    n = 8
    seq = Sequence(seq_dir, num_bins=c["b"],
                   voxel_method={"method": "between_frames"})
    bufs, metas = pack_windows(seq, list(range(n)))
    refs = np.stack([seq.frame_u8(m["frame_index"]) for m in metas])
    res, runners = {}, {}
    for dev in (device, "cpu"):
        bundle = MethodBundle("E2VID", method_config, dev)
        runner = runners[dev] = bundle.runner_for(seq.sensor_resolution,
                                                  method_config, c["b"])
        vox = runner.voxelize(runner.upload(bufs))
        _, raw = runner.reconstruct(runner.init_state(), vox)
        clipped = post_process_normalization(raw, runner.post_norm).clamp(
            0.0, 1.0)
        sc = runner.metric_scores([("mse", mse), ("ssim", ssim)], clipped,
                                  runner.upload({"r": refs})["r"])
        res[dev] = {"raw": raw.cpu(), "u8": runner.quantize_u8(clipped).cpu(),
                    "scores": {k: v.cpu().numpy() for k, v in sc.items()}}
    recon_err = float((res[device]["raw"] - res["cpu"]["raw"]).abs().max())
    check(recon_err <= TOL_RECON,
          f"E2VID reconstruction card vs CPU: {recon_err} > {TOL_RECON}")
    png_err = max(int(np.abs(frames[i].astype(int)
                             - res["cpu"]["u8"][i].numpy().astype(int)).max())
                  for i in range(n))
    check(png_err <= 1, f"written frames vs CPU: {png_err} grey levels")
    score_err = max(abs(scores[m][i] - float(res["cpu"]["scores"][m][i]))
                    for m in scores for i in range(n))
    check(score_err <= TOL_SCORE, f"scores vs CPU: {score_err} > {TOL_SCORE}")
    result = {"phase": "main_path", "method": "E2VID", "width": "full",
              "kwargs": kw, "sensor": [c["h"], c["w"]],
              "windows": N_WINDOWS, "chunk_t": CHUNK_T,
              "voxelize_launches": launches,
              "ms_per_frame_steady": timings.ms_per_frame("E2VID"),
              "card": card,
              "wall_s": wall_s, "setup_s": setup_s,
              "mean_mse": float(np.mean(list(scores["mse"].values()))),
              "mean_ssim": float(np.mean(list(scores["ssim"].values()))),
              "recon_max_abs_err_vs_cpu": recon_err,
              "png_max_diff_vs_cpu": png_err,
              "score_max_abs_err_vs_cpu": score_err}
    emit(result)
    phase_profile(torch, runners[device], seq, CHUNK_T)
    return result


def phase_profile(torch, runner, seq, n):
    """Where one steady chunk's time goes (voxelize, n model steps,
    post-norm): torch.profiler's device events against the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from evreal_tpu_torch.data import pack_windows

    bufs = runner.upload(pack_windows(seq, list(range(n)))[0])
    runner.run(runner.init_state(), bufs, n)  # warm
    acts = [ProfilerActivity.CPU]
    if runner.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.run(runner.init_state(), bufs, n)
        if runner.device.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy_us, end = 0.0, None
    for a, b in sorted(spans):  # union of the device intervals
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy_ms = busy_us / 1e3 if spans else None  # None: not measured
    emit({"phase": "profile", "windows": n, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (1 - busy_ms / wall_ms) if spans else None,
          "voxelize_ms": sum(t for k, (t, _) in by_name.items()
                             if "voxelize" in k) / 1e3 if spans else None,
          "top_kernels": [[k[:90], t / 1e3, c] for k, (t, c) in top]})


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    from evreal_tpu_torch.kernels import voxelize_cuda as vc
    from evreal_tpu_torch.ops import voxelize as vox

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": name, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    info = vc.build()
    emit({"phase": "build", "seconds": info["seconds"],
          "cached": info["cached"], "ptxas": info["log"].splitlines()})

    kern = phase_kernel(torch, vc, vox)
    with tempfile.TemporaryDirectory() as work:
        cwd = os.getcwd()
        try:
            main_res = phase_main_path(torch, vc, work, smi)
        finally:
            os.chdir(cwd)

    emit({"kernels": [{
        "name": "voxelize_windows", "route": "cuda",
        "source": "evreal_tpu_torch/kernels/csrc/voxelize.cu",
        "replaces": "evreal_tpu/kernels/voxelize_pallas.py:249",
        "replaces_also": "evreal_tpu/kernels/voxelize_pallas.py:93",
        "launches": main_res["voxelize_launches"],
        "max_abs_err": max(kern["max_abs_err"].values()),
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_us": kern["bound_ms"] * 1e3,
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "card": smi}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})


if __name__ == "__main__":
    main()
