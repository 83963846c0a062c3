#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (``evreal_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name, the device count, nvidia-smi's name and power
   limit;
2. build — builds the CUDA voxelizer from ``evreal_tpu_torch/kernels/csrc``
   and prints nvcc's ``-Xptxas -v`` report;
3. kernel — runs the voxelizer (its tiled path: count, scatter and
   accumulate kernels) at the single-sequence path's shape (T = 32 windows, E = 32768 slots, 5
   bins, 180 x 240) in both precisions (HIGHEST: f32 weights; DEFAULT: bf16
   factors) on every wire it takes, compact4 decoded in the kernels, and on
   grids that cross many tiles (625 x 970 on the f32 wire, 8 windows of
   E = 131072; 260 x 346 on compact4), with edge cases (count 0 and E, a
   degenerate dt, out-of-bounds and fractional negative coordinates, an
   unsorted timestamp with t_norm <= -1, zero capacity), against its plain
   PyTorch version run on the same CUDA tensors (bf16 factors where
   asked): bit-equal to its int64 fixed-point sums, and within 2e-5 of its
   float64 sums. Checks determinism: two launches on the same inputs, and
   one launch over all windows against two over the halves, are
   bit-identical. Holds the direct path (deposit and finish kernels) to
   the tiled launch bit for bit: every window of every case alone (T = 1,
   routed there; zero capacity returns zeros without a launch) and all of
   a case's windows in one direct call, its scratch zero after each.
   Times the kernels, the plain version and ``index_add_`` (CUDA events,
   median of 25 after warm-up, L2 flushed);
4. main path (single sequence) — writes a synthetic 180 x 240 sequence (96
   windows of ~30k events, a moving blob) and random-init full-width E2VID
   weights (seed 0), runs the port's ``evaluate`` on ``cuda`` with
   ``-c std -qm mse ssim`` (f32, the f32 wire), and checks the output tree,
   the finite scores and that the voxelizer launched once per chunk of 32
   windows. Then the first 8 windows run again on the CPU through the plain
   path: raw reconstructions agree within 1e-4, the written frames within
   1 grey level and the scores within 1e-3 (TF32 off on the card);
   profile — torch.profiler over one steady chunk of 32 windows;
5. lockstep — writes 16 synthetic sequences (distinct seeds) and runs
   ``evaluate`` over them as one lockstep group, first in the bf16 serving
   mode on the compact4 wire (``EVREAL_DTYPE=bfloat16``,
   ``EVREAL_WIRE=compact4``), then in f32 on the f32 wire, then two of them
   one at a time (``EVREAL_BATCHED=0``). Checks the 16 output trees, finite
   scores, one voxelizer launch per chunk (DEFAULT precision in bf16,
   HIGHEST in f32), every window scored (in bf16 all but window 0 of a
   lane, whose empty window gives a flat frame), f32 lockstep score rows
   against the single-sequence rows within 1e-4, raw reconstructions of
   the first 8 windows of two sequences lockstep against single within
   1e-4, and bf16 against f32 raw reconstructions (before post-norm)
   within mean 0.02 / max 0.2. Holds both precisions at the lockstep
   launch's shape (512 windows, on its data: compact4 in bf16, the f32
   wire in f32) bit-equal to the int64 plain version and within 2e-5 of
   the float64 one, and times them; profile — one steady bf16 lockstep
   chunk, then a whole bf16 lockstep ``evaluate`` traced on the device
   (busy against wall: the run's idle share); each profile names the
   voxelizer's kernels with their times;
6. methods — writes random-weight reference-schema ``.pth`` checkpoints
   (seed 0, explicit generators) of all eight method configs at their
   published widths (``published_methods``), one 128-window synthetic
   sequence and 4 more of the same resolution, and runs ``evaluate`` for
   each method on ``cuda`` three times: the sequence in f32, the 4 in f32
   lockstep and in bf16 on compact4. Fails on any exception ``evaluate``
   contains (its stdout is captured), checks every output tree, finite
   scores and one voxelizer launch per chunk at the path's precision (the
   counts set to 0 before each run); holds the voxelizer at the three
   paths' launches on their data (chunk 0: 32 windows of the sequence on
   the f32 wire at HIGHEST; 4 x 32 windows of the lanes in one launch, on
   the f32 wire at HIGHEST and on compact4 at DEFAULT) bit-equal to the
   int64 plain version and within 2e-5 of the float64 one, and times
   them; holds the raw reconstructions of the
   first 8 windows: f32 lockstep against each lane alone within 1e-4, bf16
   against f32 within mean 0.02 / max 0.2, and, for the classes this slice
   added (FireNet_legacy, HyperE2VID, SPADE-E2VID, ET-Net), the card (TF32
   off) against the CPU path within 1e-4; steady ms/frame per method and
   path; the attention wrapper's counts in each run (set to 0 before it):
   ET-Net launches K3 for every call, 21 a window step, N x 8 x L x L
   products each (L = 23 x 30 at 184 x 240), the other methods none;
   profile — one steady chunk each of ET-Net and HyperE2VID;
7. eval configs — with phase 6's E2VID and FireNet+ ``.pth`` files:
   ``-c color`` for E2VID on a synthetic 260 x 346 sequence (CED's
   sensor; 64 windows, one HIGHEST voxelizer launch per chunk of 16) and
   for FireNet+ at an odd 259 x 345 (16 windows: the even crop and the
   stretch), checking the three-channel PNGs, the timestamps and the empty
   metric files; the color launch (T = 16) bit-equal to the int64 plain
   version, within 2e-5 of the float64 one, and timed; the first 8 windows
   of both sensors again on the CPU with E2VID's weights (channel images
   within 1 grey level, the merge of the same channels bit-equal, merged
   frames within 2); a steady color chunk profiled, and the merge timed
   alone. Hist-eq: ``global``, ``clahe`` and ``local`` configs on phase
   4's sequence (32 windows) on the card and (8 windows) on the CPU:
   processed PNGs present, finite scores, frames within 1 grey level;
   ``global``'s processed frames within 1 grey level on all but 1% of the
   pixels and its score rows within 1e-3; ``clahe`` and ``local``, which
   turn one grey level on a plateau into many, held instead to the host
   equalizer on the card run's own frames (bit-equal) and to its scores
   recomputed on the CPU (2e-5); ``global`` on 4 of phase 5's sequences in
   lockstep against one at a time (frames within 1 grey level, processed
   frames and rows held as ``global`` against the CPU); each equalizer's
   host ms per frame. Resume: phase 4's run again
   under ``EVREAL_RESUME=1`` skips with no launch and the recorded means;
   with ``save_images`` changed it runs again. Video: with ffmpeg on PATH
   a ``create_video`` run writes ``<dir>_<fps>Hz.mp4``; without it
   ``evaluate`` raises the error naming ffmpeg before any launch (the line
   says which case held);
8. metrics — with phase 4's E2VID weights and sequence and phase 5's 16,
   and parameter files it writes from seed 0 (LPIPS at AlexNet's widths in
   the JAX layout; NIQE pristine statistics and a BRISQUE SVR as the JAX
   tests build them; MANIQA at IIGROUP/MANIQA's published widths, ViT-B/8
   with 12 heads, embed 768, Swin [2, 2] x 4 heads, window 4):
   ``-qm mse ssim lpips`` single f32 on 96 windows (and ``-qm mse ssim``
   for the ms/frame without LPIPS), the first 8 windows on the CPU (rows
   within 1e-3), 16-lane bf16 compact4 lockstep, 2-lane f32 lockstep
   against one at a time (rows within 1e-4); with the LPIPS file absent
   the skip line and the same mse/ssim rows; LPIPS alone on a single and
   a 16-lane chunk, profiled; on an events-only 260 x 346 sequence (40 ms
   windows to 0.6 s, events spread over the sensor) ``-qm niqe brisque``
   and ``-qm mse niqe``: their rows held to the host functions on the
   frames the run scored, no mse rows, host ms per frame;
   ``-qm mse nosuch`` (its line, the run goes on); MANIQA
   through ``evaluate`` on 2 windows (20 crops), one frame card vs CPU at
   one crop (1e-3), ms per frame at 20 crops with peak memory; the
   voxelizer held to its int64 plain version at these paths' first
   launches;
9. serve — the serving engine (``evreal_tpu_torch/serve.py``) at 180 x 240
   on windows of 30,000 synthetic events (capacity 32768), engines from
   phase 6's ``.pth`` files through ``ReconEngine.from_method``: one
   stream per method, 8 warm-up and 64 timed pushes, ms per push (p50,
   p90, p99, mean) for f32 frames and ``u8`` (E2VID, E2VID+, FireNet,
   FireNet+, SSL-E2VID; 8 pushes as a run check for ET-Net, SPADE-E2VID
   and HyperE2VID, whose widths are guessed); E2VID groups of 4 and 16
   lanes, f32 on the f32 wire and bf16 on compact4 (ms per push_group,
   aggregate frames/s); the Unix-socket round trip with the server in a
   thread, beside the in-process p50; 32 pushes against the chunked
   offline runner (1e-5), 4 against the CPU engine (raw frames, 1e-4), a
   4-lane group with an idle lane against solo streams (5e-4), 4 threads
   on 4 streams and 2 groups against the same pushes made serially
   (1e-4; bit-equality reported); an E2VID stream in bf16 on compact4;
   one voxelizer launch per push, on the direct path, and per push_group,
   on the tiled path (counts set to 0 before each path); the voxelizer at
   the serve shapes and the training launch's (T = 1, 4, 8, 16 windows on
   the packer's buffers; HIGHEST on the f32 wire, DEFAULT on compact4):
   the routed call and both paths bit-equal to its int64 plain version;
   then, in a fresh process of this script (``--serve-voxelizer-times``:
   this one has run the profiler, which slows every later enqueue), the
   routed call timed beside its plain version, ``index_add_`` and its
   bound, both paths timed in turns (CUDA events) with their host enqueue
   (host clock over 200 calls before the synchronize) and device time
   (profiler, last); the launch floor: 1 and 2 empty kernels through the
   direct path's binding, timed the same way;
10. train — training (``evreal_tpu_torch/train_cli.py``, ``train.py``) on
   two synthetic 180 x 240 sequences with frames (48 windows of 30,000
   events), both archs at their published widths (FireNet base 16, E2VID
   base 32 with 3 ConvLSTM encoders) from random weights (seed 0):
   12 steps of ``train_cli.main`` at ``--batch 4 --chunk-t 8`` on
   ``cuda`` (every loss finite, ms per step as the median over the steps
   after the first 2, exactly one HIGHEST voxelizer launch per sampled
   chunk, the ``model.npz`` read back through ``load_method_params`` and
   run once); the loss falling over 5 steps on one fixed batch at lr
   1e-3; peak memory and ms per step with remat on and off; the shipped
   step (channels-last, deterministic cuDNN) against cuDNN's default
   algorithms and against NCHW tensors, in turns; one step profiled on
   the device; one E2VID step on the card against the CPU from the same
   weights and batch (batch 1, 2 windows; the loss within 1e-5 relative
   of the CPU's, every gradient within 1e-4 x its max of the CPU's float64
   gradient, or no further from it than the CPU's own f32 gradient, for
   mse and mse+lpips with random LPIPS weights; the NCHW step's error
   reported); 2 steps with a checkpoint each resumed to 4 against 4
   uninterrupted steps (FireNet within 1e-5; E2VID reported); one step's
   4 launches (T = 8, f32 wire) bit-equal to the int64 plain version, one
   of them timed beside the plain version, ``index_add_`` and its bound;
11. mesh — the device mesh (``evreal_tpu_torch/parallel/mesh.py``) over
   every visible card, or over ``[cuda:0, cuda:0]`` with one card (the
   line names the cards and the shards): phase 5's 16 lanes x 96 windows
   through ``evaluate`` with E2VID at its published width, f32 and bf16
   on compact4, sharded against unsharded (f32 rows within 1e-4, bf16
   within mean 0.02 / max 0.2, frames/s of each; one voxelizer launch per
   shard per chunk, counted); each shard's chunk-0 launch on its device
   bit-equal to the int64 plain version, shard 0's timed; a 16-lane bf16
   compact4 serve group sharded against unsharded (frames within the bf16
   bounds, ms per push_group, frames/s, one launch per shard per push);
   one training step at dp = 2 against the meshless step for both archs
   at ``--batch 4 --chunk-t 8`` (loss within 1e-5 relative, parameters
   within 3e-4, the first replica's reduced gradient within 1e-4 x
   max|g| of the meshless one; ms per step of each); ``cost_analysis`` FLOPs of the
   E2VID f32 lockstep chunk and its MFU against the card's dense bf16
   peak from the chunk's device busy time;
12. native — the host side of the main path: the native event packer
   (``evreal_tpu_torch/native/packer.cpp``, built from the checkout at the
   start of the run with the system C++ compiler; its build seconds and
   whether the build was cached) bit-equal to the port's numpy packer
   (``EVREAL_NATIVE=0``) at the main path's pack calls on this machine's
   host: the single path's T = 32 f32 chunk, the 16 x 32 lockstep chunk
   on compact4 into pooled views over the previous chunk
   (``out_zeroed=False``), a ``--batch 4 --chunk-t 8`` training batch, the
   color path's T = 16 at 260 x 346, and the compact wire with uint8
   (180 x 240) and int16 (260 x 346) coordinates, each timed in turns
   (host ms per chunk, median of 5); E2VID single f32 and 16-lane bf16
   compact4 lockstep through ``evaluate`` with ``EVREAL_NATIVE`` unset
   and ``=0`` in turns, 3 runs each (ms/frame, the trees byte-equal, the
   native pack calls counted from 0: one per chunk and lane with the
   default, none with ``=0``), and 2 ``train_cli`` steps (one native pack
   per sampled chunk); ``EVREAL_PRECISION=high`` against ``highest`` in
   turns on the single f32 E2VID run and the color run (TF32 seen on in
   every convolution of the model stage under ``high``, off under
   ``highest``, off again after each run; score rows, or color frames
   (max, mean, share over 3 grey levels), of ``high`` against
   ``highest``; ms/frame); ``fastest`` contained as the JAX package
   contains it (f32: the dataset fails in its containment, no frame
   written; bf16: each metric dropped at runtime, frames written);
   ``EVREAL_PROFILE`` over a 32-window run under ``EVREAL_PRECISION=high``:
   one Chrome trace naming the voxelizer's kernels and a cuDNN
   convolution (and how many convolution kernels are TF32 ones);
13. bench — every mode of the port's measurement entry point
   (``python -m evreal_tpu_torch.bench``), each in a fresh process on the
   card at full width but short: ``probes``; ``flagship`` (16 lanes, 3
   steady chunks a leg); ``methods`` on E2VID and FireNet; ``serve``, 200
   pushes of an E2VID stream; ``scaling`` at 16 lanes; ``profile`` over 2
   chunks. Each opens with nvidia-smi's name and power-limit line and ends
   with its JSON line, which the phase checks: the device platform
   ``gpu``, every MFU in (0, 1.05], every device busy share at most 1 (the
   modes hold their own outputs and launch counts and exit non-zero when
   one fails); the phase's seconds;
14. sweep — the robustness sweep (``python -m evreal_tpu_torch.sweep``)
   at its own dataset size (two synthetic 180 x 240 sequences, 3 s at 25
   fps, 24,000 events a frame) with E2VID and FireNet+ at their published
   widths (seeded ``.pth`` files): before it, each condition's chunk-0
   launch as ``evaluate`` packs it (2 lanes x 32 windows at the planned
   capacity: 8,192 slots at t10ms and k5k, 65,536 at t100ms and k45k,
   524,288 at kr0.1, 32,768 at kr1.0; k45k again in bf16) bit-equal to the
   int64 plain version, within 2e-5 of the float64 one, and timed beside
   ``index_add_`` and its bound; then the sweep in a process per family on
   the card over ``t10ms t100ms``, ``k5k k45k`` and ``kr0.1 kr1.0`` (one
   CLI process a condition): every condition ok with no contained
   exception, one voxelizer launch per chunk and method (the CLI's count),
   a timestamp row for every window and a finite score row for every
   scored window (the frame within 1 ms of the window's end), a mean for
   every (method, condition), no new build entry after the first
   condition; FireNet+'s first 4 scored windows a lane of ``k5k`` (96
   windows: it scores one in 24) and ``t100ms`` (8 windows) again on the
   CPU (scores within 1e-3); ``k45k`` again through ``evaluate`` under
   ``EVREAL_DTYPE=bfloat16`` (DEFAULT launches, its trees and means
   checked the same way); the phase's seconds;
15. writer — the background PNG writer (one thread per sequence) on the
   three eval paths, with full-width E2VID (seed 0) on 16 synthetic 180 x
   240 sequences of 128 windows (4 chunks a lane): 16-lane f32 lockstep on
   the f32 wire, the same in bf16 on compact4, and single f32, each with
   ``-c std`` (images on) and with ``save_images`` off. Checks one PNG a
   window, each decoded with ``outputs.decode_png``; the first 8 windows
   of two lanes within 1 grey level of the CPU in f32 and of the card's
   own recomputation in bf16 (bf16 on the CPU rounds otherwise; its
   difference is printed beside); timestamps, score and event-rate rows
   byte-equal between the images-on and images-off runs; ``done.json``;
   no writer thread alive afterwards and the most alive at once (16, 1,
   or 0 without images); one voxelizer launch a chunk. Prints each run's
   steady ms/frame, the whole wall of ``evaluate`` (``finalize``'s drain
   included), the host's core count, and the host's PNG frames/s on 256
   of the run's frames with 1, 2, 4, 8 and 16 writers and without one;
16. attention — the fused float32 attention
   (``evreal_tpu_torch/kernels/csrc/attention.cu``, K3): built, its
   ``-Xptxas -v`` report; against ``attention_plain`` on the card (TF32
   off) at L = 1, 47, 48 and 130, self- and cross-attention, flat and
   sharp logits, at the rehearsal shape (10, 8, 48, 32) and at the main
   path's (10, 8, 9638, 32) (every lane against the plain version one lane
   at a time, since its (10, 8, L, L) scores do not fit): the max abs gap
   of each, within 2e-5;
   the main shape timed (25 CUDA-event timings, L2 flushed) beside its
   bound, ``attention_plain`` at N = 1 and
   ``scaled_dot_product_attention`` (``library_ms``: a yardstick only, the
   port never calls it); ``python3 chip_smoke.py --attention`` runs this
   phase alone;
17. the ``kernels`` line: per ported kernel its launches on its path (and
   per method and path in the methods, eval-config, metrics, serve, train
   and mesh phases), error and times beside its bound, its serve shapes,
   its training launch, a mesh shard's launch and the sweep's chunk-0
   launches with the launches of their CLI runs; K1 (the direct path)
   with its stream launches, its T = 1 times on both wires beside the
   tiled path's, the host/device split, the launch floor and the
   crossover at T = 4, 8, 16;

then nvidia-smi's name and power-limit line, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line; without a CUDA device the script fails at once. Kernel times
are medians of CUDA-event timings whose events exist before the first
run (an event is created at its first record, at a cost to the host that
would otherwise fall inside the timed interval).
"""

import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager

import numpy as np

from evreal_tpu_torch.bench.common import env
from evreal_tpu_torch.bench.models import (published_methods,
                                          write_method_checkpoints)
from evreal_tpu_torch.bench.timing import (
    device_time,
    host_enqueue_us,
    latency,
    path_device_us,
    profile_calls,
    time_ms,
    time_turns,
    top_kernels,
    voxelize_kernels,
)

TOL_KERNEL = 2e-5  # tests/test_pallas_voxelize.py:25
TOL_RECON = 1e-4   # raw E2VID output, card (TF32 off) vs CPU, 8 steps
TOL_SCORE = 1e-3   # mse / ssim rows, card vs CPU
TOL_LOCKSTEP = 1e-4  # f32 lockstep vs single on the card (TF32 off)
BF16_MEAN, BF16_MAX = 0.02, 0.2  # tests/test_bf16_mode.py:39-40
ECD = dict(t=32, e=32768, h=180, w=240, b=5)
MVSEC = (260, 346)
BS_ERGB = (625, 970)  # tools/bs_ergb_to_npy.py:15-16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM, f32 outside the tensor cores
EVENTS_PER_WINDOW = 30000
N_WINDOWS = 96
CHUNK_T = 32
N_LANES = 16
MODEL_WINDOWS = 128  # the methods phase: one sequence, and 4 in lockstep
MODEL_LANES = 4
SCRIPT = os.path.abspath(__file__)


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

def time_variant(torch, vox, bufs, precision, hw, num_bins):
    """The kernel (one ``voxelize_windows`` call as the runner makes it),
    its plain version and one ``index_add_`` of the same deposits, timed on
    ``bufs``; the bound from this input's valid events (each read once)
    and the f32 output (written once)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf16 = precision == "default"
    ms = time_ms(torch, lambda: vox.voxelize_windows(
        bufs, num_bins, hw, precision=precision), flush)
    plain_ms = time_ms(torch, lambda: vox.voxelize_buffers_plain(
        bufs, num_bins, hw, bf16_factors=bf16), flush)
    if "ev" in bufs:
        split = vox.decode_compact4(bufs["ev"], hw)
        event_bytes = 4
    else:
        split = [bufs[k] for k in ("xs", "ys", "ts", "ps")]
        event_bytes = sum(a.element_size() for a in split)
    idx, wgt = vox.event_deposits(*split, bufs["count"], num_bins, hw, bf16)
    t_n = bufs["count"].shape[0]
    acc = torch.zeros(t_n * num_bins * hw[0] * hw[1], device="cuda")
    library_ms = time_ms(torch, lambda: acc.index_add_(0, idx, wgt), flush)
    n_valid = int(bufs["count"].sum())
    in_bytes = n_valid * event_bytes + t_n * 4
    out_bytes = t_n * num_bins * hw[0] * hw[1] * 4
    # sub, div, mul, floor, sub, sub, 2 mul per event (+ 6 integer decode
    # operations on compact4, + 2 roundings for bf16 factors)
    ops = n_valid * (8 + (6 if "ev" in bufs else 0) + (2 if bf16 else 0))
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": in_bytes + out_bytes, "valid_events": n_valid,
            "windows": t_n}


def path_fn(vc, bufs, num_bins, hw, precision, path):
    """A call of the voxelizer's private ``path`` ("direct" or "tiled"; the
    public entries pick one by ``vc.route``) on a wire buffer dict, its
    arguments bound once, so that a timed call adds nothing of its own."""
    from evreal_tpu_torch.data.packing import compact4_layout

    fn = vc._voxelize_direct if path == "direct" else vc._voxelize_tiled
    if "ev" in bufs:
        return functools.partial(fn, (bufs["ev"],), bufs["count"], num_bins,
                                 hw, precision, compact4_layout(hw))
    return functools.partial(fn, tuple(bufs[k] for k in ("xs", "ys", "ts",
                                                         "ps")),
                             bufs["count"], num_bins, hw, precision)


def scratch_is_zero(vc):
    """The direct path's cached int64 cells are all zero (as every call
    must leave them)."""
    return all(not bool(c.any()) for c in vc._scratch.values())


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


def hold_to_plain(torch, vox, bufs, num_bins, hw, prec, name):
    """One launch against the plain version on the same tensors: bit-equal
    to its int64 fixed-point sums (checked), within TOL_KERNEL of its
    float64 sums (checked). Returns the max abs error against float64 and
    the launch's output."""
    bf16 = prec == "default"
    got = vox.voxelize_windows(bufs, num_bins, hw, precision=prec)
    exact = vox.voxelize_buffers_plain(bufs, num_bins, hw,
                                       accum_dtype=torch.int64,
                                       bf16_factors=bf16)
    torch.cuda.synchronize()
    check(torch.equal(got, exact), f"voxelizer {name} ({prec}): "
          f"{int((got != exact).sum())} cells differ from the int64 plain "
          f"version")
    del exact
    want = vox.voxelize_buffers_plain(bufs, num_bins, hw,
                                      accum_dtype=torch.float64,
                                      bf16_factors=bf16)
    err = float((got - want).abs().max())
    check(err <= TOL_KERNEL, f"voxelizer {name} ({prec}): max abs err "
          f"{err} > {TOL_KERNEL}")
    return err, got


def phase_kernel(torch, vc, vox):
    c = ECD
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    from evreal_tpu_torch.data.packing import encode_compact4, quantize_ts

    def cuda(keys, *arrays):
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for k, a in zip(keys, arrays)}

    def packed(xs, ys, ts, ps, count, hw):
        ev = np.zeros(ts.shape, np.uint32)
        for i, n in enumerate(count):
            ev[i, :n] = encode_compact4(xs[i, :n], ys[i, :n], ts[i, :n],
                                        ps[i, :n], hw)
        return cuda(("ev", "count"), ev, count)

    split = ("xs", "ys", "ts", "ps", "count")
    ecd = (c["h"], c["w"])
    xs, ys, ts, ps, count = make_events(rng, c["t"], c["e"], *ecd)
    cases = {"f32 wire": (cuda(split, xs, ys, ts, ps, count), ecd)}
    cases["f32 wire, fractional coords"] = (cuda(
        split, *make_events(rng, c["t"], c["e"], *ecd, float_coords=True)),
        ecd)
    # compact (uint16 ts, uint8 coords at this sensor) and compact4 (packed
    # u32) encodings of the same windows
    q = np.zeros_like(ts, dtype=np.uint16)
    for i, n in enumerate(count):
        q[i, :n] = quantize_ts(ts[i, :n], 65535.0).astype(np.uint16)
    u8 = lambda a: np.where((a >= 0) & (a < 256), a, 255).astype(np.uint8)  # noqa: E731
    cases["uint16 wire"] = (cuda(split, u8(xs), u8(ys), q, ps, count), ecd)
    cases["compact4 wire"] = (packed(xs, ys, ts, ps, count, ecd), ecd)
    # grids of many tiles: BS-ERGB on the f32 wire (no compact4 layout
    # there), MVSEC/CED on compact4
    for name, hw, t, e in (("f32 wire 625x970", BS_ERGB, 8, 131072),
                           ("compact4 wire 260x346", MVSEC, 16, 32768)):
        ev_args = make_events(rng, t, e, *hw)
        cases[name] = ((cuda(split, *ev_args) if name.startswith("f32")
                        else packed(*ev_args, hw)), hw)

    errs = {p: {} for p in vc.PRECISIONS}
    deterministic = {}
    direct_windows = {}
    for name, (bufs, hw) in cases.items():
        t_n = bufs["count"].shape[0]
        tiles = vc.tile_count(vc.tile_plan(c["b"], *hw), *hw)
        for prec in vc.PRECISIONS:
            errs[prec][name], got = hold_to_plain(torch, vox, bufs, c["b"],
                                                  hw, prec, name)
            again = vox.voxelize_windows(bufs, c["b"], hw, precision=prec)
            halves = torch.cat([vox.voxelize_windows(
                {k: v[sl].contiguous() for k, v in bufs.items()}, c["b"], hw,
                precision=prec) for sl in (slice(0, t_n // 2),
                                           slice(t_n // 2, t_n))])
            torch.cuda.synchronize()
            deterministic[f"{name} ({prec}, {tiles} tiles)"] = same = (
                torch.equal(got, again) and torch.equal(got, halves))
            check(same, f"voxelizer {name} ({prec}): not bit-identical "
                  f"across launches or across {t_n} vs {t_n // 2} + "
                  f"{t_n - t_n // 2} windows")
            # the direct path: each window alone as the routed T = 1 call,
            # and all of them in one call, bit-equal to the tiled launch
            # (itself bit-equal to the int64 plain version)
            for t in range(t_n):
                one = {k: v[t:t + 1].contiguous() for k, v in bufs.items()}
                events = one["ev" if "ev" in one else "xs"]
                check(vc.route(events.shape) == "direct"
                      and torch.equal(vox.voxelize_windows(
                          one, c["b"], hw, precision=prec), got[t:t + 1]),
                      f"voxelizer {name} ({prec}): window {t} alone (the "
                      f"direct path) differs from the tiled launch")
            whole = path_fn(vc, bufs, c["b"], hw, prec, "direct")()
            torch.cuda.synchronize()
            check(torch.equal(whole, got) and scratch_is_zero(vc),
                  f"voxelizer {name} ({prec}): the direct path over {t_n} "
                  f"windows differs from the tiled one, or left its "
                  f"scratch non-zero")
            direct_windows[f"{name} ({prec})"] = t_n
            del got, again, halves, whole
    f32_wire = cases["f32 wire"][0]
    for bad in ("high", "bf16"):
        try:
            vox.voxelize_windows(f32_wire, c["b"], ecd, precision=bad)
        except ValueError:
            continue
        fail(f"precision {bad!r} must raise")
    before = vc.launch_count()
    z = {k: (v[:, :0].contiguous() if k != "count" else v)
         for k, v in f32_wire.items()}
    empty = vox.voxelize_windows(z, c["b"], ecd)
    check(vc.launch_count() == before and not bool(empty.abs().sum()),
          "zero capacity must return zeros without a launch")
    empty = vox.voxelize_windows({k: v[:1].contiguous() for k, v in z.items()},
                                 c["b"], ecd)
    check(vc.launch_count() == before and empty.shape == (1, c["b"], *ecd)
          and not bool(empty.abs().sum()),
          "zero capacity at T = 1 must return zeros without a launch")

    # times at the single-sequence path's wire (int16 coords, f32 ts, int8
    # ps), both precisions; HIGHEST at the BS-ERGB sensor
    times = {p: time_variant(torch, vox, f32_wire, p, ecd, c["b"])
             for p in vc.PRECISIONS}
    bs_bufs, bs_hw = cases["f32 wire 625x970"]
    result = {"phase": "kernel", "max_abs_err": errs,
              "bit_equal_int64_plain": True,
              "bit_identical": deterministic,
              "direct_path_bit_equal_windows": direct_windows,
              "times_f32_wire": times,
              "times_625x970_highest": time_variant(
                  torch, vox, bs_bufs, "highest", bs_hw, c["b"]),
              "shape": c}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 4: the main path, one sequence
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


def write_config(work, group, name, cfg):
    os.makedirs(os.path.join(work, "config", group), exist_ok=True)
    with open(os.path.join(work, "config", group, name + ".json"), "w",
              encoding="utf-8") as f:
        json.dump(cfg, f)


def read_rows(path):
    rows = [line.split() for line in open(path, encoding="utf-8")]
    return {int(i): float(v) for i, v in rows}


def check_tree(out, n_windows, hw, decode_frames=True, may_skip=()):
    """A complete output tree: a timestamp row and a frame PNG for every
    window, and finite score rows of every window but those in
    ``may_skip`` (in bf16 the flat frame of a lane's empty first window
    makes the robust post-norm divide by zero, and the tracker then drops
    the score, as the reference does). Returns ({metric: {window: score}},
    decoded frames)."""
    from evreal_tpu_torch.harness.outputs import decode_png_gray8

    stamps = read_rows(os.path.join(out, "timestamps.txt"))
    check(sorted(stamps) == list(range(n_windows)),
          f"{out}/timestamps.txt rows {len(stamps)} != {n_windows}")
    scores = {m: read_rows(os.path.join(out, m + ".txt"))
              for m in ("mse", "ssim")}
    for m, rows in scores.items():
        missing = sorted(set(range(n_windows)) - set(rows))
        check(set(rows) <= set(range(n_windows))
              and set(missing) <= set(may_skip),
              f"{out}/{m}.txt: windows {missing[:8]} of {n_windows} "
              f"unscored (only {sorted(may_skip)} may be)")
        check(all(np.isfinite(v) for v in rows.values()),
              f"{out}/{m}.txt has non-finite scores")
    names = [f"frame_{i:010d}.png" for i in range(n_windows)]
    check(all(os.path.exists(os.path.join(out, n)) for n in names),
          f"{out}: frame PNGs missing")
    frames = []
    for n in (names if decode_frames else names[:1]):
        with open(os.path.join(out, n), "rb") as f:
            frames.append(decode_png_gray8(f.read()))
    check(all(f.shape == tuple(hw) for f in frames),
          f"{out}: frame PNGs have the wrong shape")
    return scores, frames


def phase_main_path(torch, vc, work, card, device="cuda"):
    from evreal_tpu_torch.convert.params import flatten, save_params
    from evreal_tpu_torch.harness.runner import (MethodBundle, evaluate,
                                                 get_method_config,
                                                 quantize_u8)
    from evreal_tpu_torch.harness.timers import TimingLog
    from evreal_tpu_torch.metrics.registry import resolve
    from evreal_tpu_torch.models import flagship_e2vid_kwargs
    from evreal_tpu_torch.models.init import init_e2vid
    from evreal_tpu_torch.data import Sequence, pack_windows

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
    write_config(work, "method", "E2VID",
                 {"model_name": "E2VID", "model_path": npz,
                  "event_tensor_normalization": True,
                  "post_process_norm": "robust"})
    write_config(work, "dataset", "SYN",
                 {"root_path": os.path.join(work, "data", "SYN"),
                  "sequences": {"seq0": {}}})
    setup_s = time.perf_counter() - t0

    os.chdir(work)  # config/ and outputs/ resolve here; std from the repo
    timings = TimingLog()
    vc.reset_launches()
    t0 = time.perf_counter()
    with env(EVREAL_DTYPE=None, EVREAL_WIRE=None):
        evaluate(["E2VID"], ["std"], ["SYN"], ["mse", "ssim"], device=device,
                 timings=timings)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(vc.launches_by_precision)
    n_chunks = -(-N_WINDOWS // CHUNK_T)
    check(launches == {"highest": n_chunks, "default": 0},
          f"voxelizer launched {launches} on the single-sequence path, want "
          f"one HIGHEST launch per chunk ({n_chunks})")

    out = os.path.join(work, "outputs", "std", "SYN", "seq0", "E2VID")
    scores, frames = check_tree(out, N_WINDOWS, (c["h"], c["w"]))

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
        _, clipped = runner.post(raw)
        sc = runner.metric_scores(resolve(["mse", "ssim"]), clipped,
                                  runner.upload({"r": refs})["r"])
        res[dev] = {"raw": raw.cpu(), "u8": quantize_u8(clipped).cpu(),
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
              "voxelize_launches": launches["highest"],
              "ms_per_frame_steady": timings.ms_per_frame("E2VID"),
              "card": card,
              "wall_s": wall_s, "setup_s": setup_s,
              "mean_mse": float(np.mean(list(scores["mse"].values()))),
              "mean_ssim": float(np.mean(list(scores["ssim"].values()))),
              "recon_max_abs_err_vs_cpu": recon_err,
              "png_max_diff_vs_cpu": png_err,
              "score_max_abs_err_vs_cpu": score_err}
    emit(result)
    bufs = runners[device].upload(pack_windows(seq, list(range(CHUNK_T)))[0])
    phase_profile(torch, runners[device], bufs, CHUNK_T, "single")
    return result


def phase_profile(torch, runner, bufs, n, label):
    """Where one steady chunk's time goes (voxelize, n model steps,
    post-norm): torch.profiler's device events against the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    runner.run(runner.init_state(), bufs, n)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(runner.init_state(), bufs, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, _, by_name = device_time(torch, prof)
    voxelizer = voxelize_kernels(by_name)
    emit({"phase": "profile", "path": label, "lanes": runner.lanes,
          "windows": n, "dtype": str(runner.dtype), "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (1 - busy_ms / wall_ms)
          if busy_ms is not None else None,
          "voxelize_ms": sum(ms for ms, _ in voxelizer.values())
          if busy_ms is not None else None,
          "voxelize_kernels": voxelizer,
          "kernel_launches": sum(n for _, n in by_name.values()),
          "top_kernels": top_kernels(by_name)})


def phase_run_profile(torch, dataset, switches, n_frames, label,
                      device="cuda"):
    """A whole ``evaluate`` call (packing, uploads, voxelizer, model,
    post-norm, metrics, u8, PNG writing, drain) traced on the device
    only: device busy time against the call's wall clock, and against the
    span from its first device event to its last."""
    from torch.profiler import ProfilerActivity, profile
    from evreal_tpu_torch.harness.runner import evaluate
    from evreal_tpu_torch.harness.timers import TimingLog

    timings = TimingLog()
    torch.cuda.synchronize()
    with env(**switches), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate(["E2VID"], ["std"], [dataset], ["mse", "ssim"],
                 device=device, timings=timings)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, span_ms, by_name = device_time(torch, prof)
    measured = busy_ms is not None
    emit({"phase": "run_profile", "path": label, "frames": n_frames,
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_span_ms": span_ms,
          "device_busy_ms_per_frame": busy_ms / n_frames if measured
          else None,
          "device_idle_share": (1 - busy_ms / wall_ms) if measured else None,
          "device_idle_share_in_span": (1 - busy_ms / span_ms) if measured
          else None,
          "ms_per_frame_steady_traced": timings.ms_per_frame("E2VID"),
          "voxelize_kernels": voxelize_kernels(by_name),
          "top_kernels": top_kernels(by_name, 8)})


# ---------------------------------------------------------------------------
# phase 5: the lockstep path, 16 sequences
# ---------------------------------------------------------------------------

def pack_lanes(seqs, n, capacity, wire):
    """The first ``n`` windows of every sequence as (N, n, E) buffers."""
    from evreal_tpu_torch.data import pack_windows

    packed = [pack_windows(s, list(range(n)), capacity=capacity,
                           wire=wire)[0] for s in seqs]
    return {k: np.stack([p[k] for p in packed]) for k in packed[0]}


def lockstep_raw(runner, bufs):
    """Raw reconstructions (N, n, H, W) of the runner's lanes over the
    windows of ``bufs`` (N, n, E), before post-norm."""
    dev = runner.upload(bufs)
    n, t = dev["count"].shape
    vox = runner.voxelize({k: v.reshape((n * t,) + tuple(v.shape[2:]))
                           for k, v in dev.items()})
    _, raw = runner.rollout(runner.init_state(),
                            vox.view((n, t) + tuple(vox.shape[1:])))
    return raw.cpu()


def phase_lockstep(torch, vc, vox, work, card, device="cuda"):
    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.data.packing import bucket_capacity
    from evreal_tpu_torch.harness.runner import (MethodBundle, evaluate,
                                                 get_method_config)
    from evreal_tpu_torch.harness.timers import TimingLog

    c = ECD
    hw = (c["h"], c["w"])
    t0 = time.perf_counter()
    names = [f"seq{j:02d}" for j in range(N_LANES)]
    root = os.path.join(work, "data", "LOCK")
    for j, name in enumerate(names):
        make_sequence(os.path.join(root, name), c["h"], c["w"], N_WINDOWS,
                      EVENTS_PER_WINDOW, seed=100 + j)
    write_config(work, "dataset", "LOCK",
                 {"root_path": root, "sequences": {n: {} for n in names}})
    write_config(work, "dataset", "LOCK2",
                 {"root_path": root, "sequences": {n: {} for n in names[:2]}})
    setup_s = time.perf_counter() - t0
    os.chdir(work)
    n_chunks = -(-N_WINDOWS // CHUNK_T)

    runs = {}
    for label, dataset, switches, want in (
            ("bf16_compact4", "LOCK", dict(EVREAL_DTYPE="bfloat16",
                                           EVREAL_WIRE="compact4"),
             {"highest": 0, "default": n_chunks}),
            ("f32_f32wire", "LOCK", dict(EVREAL_DTYPE=None, EVREAL_WIRE=None),
             {"highest": n_chunks, "default": 0}),
            ("f32_single", "LOCK2", dict(EVREAL_DTYPE=None, EVREAL_WIRE=None,
                                         EVREAL_BATCHED="0"),
             {"highest": 2 * n_chunks, "default": 0})):
        timings = TimingLog()
        vc.reset_launches()
        t1 = time.perf_counter()
        with env(**switches):
            evaluate(["E2VID"], ["std"], [dataset], ["mse", "ssim"],
                     device=device, timings=timings)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t1
        launches = dict(vc.launches_by_precision)
        check(launches == want, f"{label}: voxelizer launches {launches}, "
              f"want {want} (one per chunk of {CHUNK_T} windows)")
        lanes = names if dataset == "LOCK" else names[:2]
        trees = {n: check_tree(os.path.join("outputs", "std", dataset, n,
                                            "E2VID"), N_WINDOWS, hw,
                               decode_frames=False,
                               may_skip={0} if label.startswith("bf16")
                               else ())[0]
                 for n in lanes}
        ms = timings.ms_per_frame("E2VID")
        runs[label] = {"launches": launches, "wall_s": wall_s,
                       "scored_windows": sum(len(t["mse"])
                                             for t in trees.values()),
                       "unscored": sorted({i for t in trees.values()
                                           for i in set(range(N_WINDOWS))
                                           - set(t["mse"])}),
                       "ms_per_frame_steady": ms,
                       "frames_per_s_steady": 1e3 / ms if ms else None,
                       "scores": trees}
        os.rename(os.path.join("outputs", "std", dataset),
                  os.path.join("outputs", "std", f"{dataset}_{label}"))

    score_err = max(abs(runs["f32_f32wire"]["scores"][n][m][i]
                        - runs["f32_single"]["scores"][n][m][i])
                    for n in names[:2] for m in ("mse", "ssim")
                    for i in range(N_WINDOWS))
    check(score_err <= TOL_LOCKSTEP, f"f32 lockstep vs single score rows: "
          f"{score_err} > {TOL_LOCKSTEP}")

    # raw reconstructions of the first 8 windows: lockstep (16 lanes) vs
    # single (f32), and bf16 on compact4 vs f32 (before post-norm)
    method_config = get_method_config("E2VID")
    seqs = [Sequence(os.path.join(root, n), num_bins=c["b"]) for n in names]
    cap = bucket_capacity(EVENTS_PER_WINDOW)
    raw = {}
    with env(EVREAL_DTYPE=None):
        bundle = MethodBundle("E2VID", method_config, device)
        f32_bufs = pack_lanes(seqs, 8, cap, "f32")
        raw["f32"] = lockstep_raw(bundle.batched_runner_for(
            hw, method_config, c["b"], N_LANES), f32_bufs)
        single = bundle.runner_for(hw, method_config, c["b"])
        raw["single"] = torch.stack([single.reconstruct(
            single.init_state(), single.voxelize(single.upload(
                {k: v[j] for k, v in f32_bufs.items()})))[1].cpu()
            for j in range(2)])
    with env(EVREAL_DTYPE="bfloat16"):
        bundle = MethodBundle("E2VID", method_config, device)
        bf16_runner = bundle.batched_runner_for(hw, method_config, c["b"],
                                                N_LANES)
        raw["bf16"] = lockstep_raw(bf16_runner,
                                   pack_lanes(seqs, 8, cap, "compact4"))
    recon_err = float((raw["f32"][:2] - raw["single"]).abs().max())
    check(recon_err <= TOL_LOCKSTEP, f"f32 lockstep vs single raw "
          f"reconstructions: {recon_err} > {TOL_LOCKSTEP}")
    d = (raw["bf16"][:2] - raw["f32"][:2]).abs()
    bf16_mean, bf16_max = float(d.mean()), float(d.max())
    check(bf16_mean < BF16_MEAN and bf16_max < BF16_MAX,
          f"bf16 vs f32 raw reconstructions: mean {bf16_mean} (< "
          f"{BF16_MEAN}), max {bf16_max} (< {BF16_MAX})")
    check(bf16_max > 0, "bf16 and f32 reconstructions are identical: the "
          "bf16 mode did not run")

    # the bf16-factor kernel at the lockstep launch's shape, on its data:
    # chunk 0 of the 16 lanes on compact4, (512, E) windows in one launch
    chunk = bf16_runner.upload(pack_lanes(seqs, CHUNK_T, cap, "compact4"))
    flat = {k: v.reshape((N_LANES * CHUNK_T,) + tuple(v.shape[2:]))
            for k, v in chunk.items()}
    lock_err = hold_to_plain(torch, vox, flat, c["b"], hw, "default",
                             "bf16 lockstep launch")[0]
    kernel_times = {"default_compact4": time_variant(
        torch, vox, flat, "default", hw, c["b"])}
    f32_chunk = {k: torch.from_numpy(v).cuda().reshape(
        (N_LANES * CHUNK_T,) + v.shape[2:])
        for k, v in pack_lanes(seqs, CHUNK_T, cap, "f32").items()}
    lock_err_f32 = hold_to_plain(torch, vox, f32_chunk, c["b"], hw,
                                 "highest", "f32 lockstep launch")[0]
    kernel_times["highest_f32"] = time_variant(torch, vox, f32_chunk,
                                               "highest", hw, c["b"])
    result = {"phase": "lockstep", "method": "E2VID", "width": "full",
              "lanes": N_LANES, "windows_per_lane": N_WINDOWS,
              "chunk_t": CHUNK_T, "card": card, "setup_s": setup_s,
              "runs": {k: {kk: vv for kk, vv in v.items() if kk != "scores"}
                       for k, v in runs.items()},
              "mean_mse": {k: float(np.mean([np.mean(list(t["mse"].values()))
                                             for t in v["scores"].values()]))
                           for k, v in runs.items()},
              "score_max_abs_err_lockstep_vs_single": score_err,
              "recon_max_abs_err_lockstep_vs_single": recon_err,
              "bf16_vs_f32_raw": {"mean": bf16_mean, "max": bf16_max},
              "kernel_lockstep_max_abs_err": {"default_compact4": lock_err,
                                              "highest_f32": lock_err_f32},
              "kernel_lockstep_bit_equal_int64_plain": True,
              "kernel_at_lockstep_shape": kernel_times}
    emit(result)
    phase_profile(torch, bf16_runner, chunk, CHUNK_T, "lockstep_bf16")
    phase_run_profile(torch, "LOCK", dict(EVREAL_DTYPE="bfloat16",
                                          EVREAL_WIRE="compact4"),
                      N_LANES * N_WINDOWS, "lockstep_bf16_whole_run", device)
    return result


# ---------------------------------------------------------------------------
# phase 6: all eight method configs from reference-schema checkpoints
# ---------------------------------------------------------------------------

NEW_CLASS_METHODS = ("FireNet", "HyperE2VID", "SPADE-E2VID", "ET-Net")


def write_methods(torch, root):
    """Reference-schema ``.pth`` files of all eight methods (seed 0,
    ``write_method_checkpoints``) and the method configs of the repository
    naming them."""
    from evreal_tpu_torch.harness.config import REPO_ROOT, read_json

    for method, path in write_method_checkpoints(torch, root).items():
        cfg = read_json(os.path.join(REPO_ROOT, "config", "method",
                                     method + ".json"))
        write_config(root, "method", method, dict(cfg, model_path=path))


def contained(out, label):
    """Fail on any exception ``evaluate`` contained (it prints it and goes
    on, exit code 0)."""
    bad = [line for line in out.splitlines() if "Exception while" in line]
    if bad:
        print(out[-20000:], file=sys.stderr)
    check(not bad, f"{label}: evaluate contained {bad[:2]}")


ATTENTION_CALLS_A_STEP = 21  # ET-Net: 3 scales x (3 + 2 x 2) attentions


def attention_want(method, lanes, steps, hw, device="cuda"):
    """The attention counts (calls, kernel launches, products N h Lq Lk)
    of ``steps`` window steps of ``lanes`` lanes at ``hw``: ET-Net's 21
    calls a step, each a K3 launch on the card, over its (lanes, 8, L, L)
    products at L = (H/8) x (W/8) of the frame padded to a multiple of 8;
    0 for the other methods."""
    if method != "ET-Net":
        return 0, 0, 0
    calls = ATTENTION_CALLS_A_STEP * steps
    tokens = -(-hw[0] // 8) * -(-hw[1] // 8)
    return (calls, calls if device == "cuda" else 0,
            calls * lanes * 8 * tokens * tokens)


def run_evaluate(vc, method, dataset, switches, want, label, device,
                 want_attention=(0, 0, 0)):
    """``evaluate`` of one method with its stdout captured; the launches
    of the voxelizer in this run (counts set to 0 just before) must be
    ``want``, and the attention counts (``TimingLog``'s, and the
    wrapper's own, set to 0 just before) ``want_attention``. Returns
    (launches, steady ms per frame, wall s, attention counts)."""
    import io
    from contextlib import redirect_stdout

    from evreal_tpu_torch.harness.runner import evaluate
    from evreal_tpu_torch.harness.timers import ATTENTION_COUNTS, TimingLog
    from evreal_tpu_torch.kernels import attention_cuda

    timings, buf = TimingLog(), io.StringIO()
    vc.reset_launches()
    attention_cuda.reset_counts()
    t0 = time.perf_counter()
    with env(**switches), redirect_stdout(buf):
        evaluate([method], ["std"], [dataset], ["mse", "ssim"],
                 device=device, timings=timings)
    wall_s = time.perf_counter() - t0
    launches = dict(vc.launches_by_precision)
    contained(buf.getvalue(), f"{method} {label}")
    check(launches == want, f"{method} {label}: voxelizer launches "
          f"{launches}, want {want} (one per chunk of {CHUNK_T} windows)")
    counted = tuple(timings.counts[n] for n in ATTENTION_COUNTS)
    check(counted == attention_cuda.counts() == tuple(want_attention),
          f"{method} {label}: attention (calls, kernel calls, products) "
          f"{counted} in the run's counts, {attention_cuda.counts()} in "
          f"the wrapper's, want {tuple(want_attention)}")
    attention = dict(zip(("calls", "kernel_calls", "products"), counted))
    return launches, timings.ms_per_frame(method), wall_s, attention


def phase_methods(torch, vc, vox, work, card, device="cuda"):
    from evreal_tpu_torch.data import Sequence, pack_windows, plan_capacity
    from evreal_tpu_torch.data.packing import bucket_capacity
    from evreal_tpu_torch.harness.runner import (MethodBundle,
                                                 get_method_config)

    c = ECD
    hw = (c["h"], c["w"])
    root = os.path.join(work, "methods")
    t0 = time.perf_counter()
    write_methods(torch, root)
    lanes = [f"lane{j}" for j in range(MODEL_LANES)]
    make_sequence(os.path.join(root, "data", "MSYN", "seq0"), *hw,
                  MODEL_WINDOWS, EVENTS_PER_WINDOW, seed=7)
    for j, name in enumerate(lanes):
        make_sequence(os.path.join(root, "data", "MLOCK", name), *hw,
                      MODEL_WINDOWS, EVENTS_PER_WINDOW, seed=200 + j)
    for ds, names in (("MSYN", ["seq0"]), ("MLOCK", lanes)):
        write_config(root, "dataset", ds,
                     {"root_path": os.path.join(root, "data", ds),
                      "sequences": {n: {} for n in names}})
    setup_s = time.perf_counter() - t0
    os.chdir(root)
    n_chunks = -(-MODEL_WINDOWS // CHUNK_T)
    f32 = dict(EVREAL_DTYPE=None, EVREAL_WIRE=None)
    bf16 = dict(EVREAL_DTYPE="bfloat16", EVREAL_WIRE="compact4")
    paths = (("single_f32", "MSYN", f32, "highest"),
             ("lockstep_f32", "MLOCK", f32, "highest"),
             ("lockstep_bf16_compact4", "MLOCK", bf16, "default"))
    seq = Sequence(os.path.join(root, "data", "MSYN", "seq0"),
                   num_bins=c["b"])
    seqs = [Sequence(os.path.join(root, "data", "MLOCK", n),
                     num_bins=c["b"]) for n in lanes]
    cap = bucket_capacity(EVENTS_PER_WINDOW)
    first8 = pack_windows(seq, list(range(8)))[0]

    # the voxelizer at the launches the three paths make, on their data:
    # chunk 0 at the capacity evaluate plans, MODEL_LANES x CHUNK_T windows
    # in one launch in lockstep
    def capacity(ss):
        return plan_capacity(m["event_count"] for s in ss
                             for m in s.windows())

    launch = {"single_f32": (pack_windows(seq, list(range(CHUNK_T)),
                                          capacity=capacity([seq]))[0],
                             "highest")}
    for label, wire, prec in (("lockstep_f32", "f32", "highest"),
                              ("lockstep_bf16_compact4", "compact4",
                               "default")):
        packed = pack_lanes(seqs, CHUNK_T, capacity(seqs), wire)
        launch[label] = ({k: v.reshape((-1,) + v.shape[2:])
                          for k, v in packed.items()}, prec)
    kernel_at_launch = {}
    for label, (arrays, prec) in launch.items():
        bufs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrays.items()}
        err = hold_to_plain(torch, vox, bufs, c["b"], hw, prec,
                            f"methods {label} launch")[0]
        kernel_at_launch[label] = dict(
            time_variant(torch, vox, bufs, prec, hw, c["b"]),
            precision=prec, max_abs_err=err,
            capacity=int(bufs["xs" if "xs" in bufs else "ev"].shape[1]))
    emit({"phase": "methods_kernel", "card": card,
          "bit_equal_int64_plain": True, "at_launch": kernel_at_launch})
    results = {}
    for method in published_methods():
        res = {"launches": {}, "ms_per_frame_steady": {}, "wall_s": {},
               "attention": {}}
        for label, ds, switches, prec in paths:
            want = {"highest": 0, "default": 0, prec: n_chunks}
            lanes_run = 1 if ds == "MSYN" else MODEL_LANES
            (res["launches"][label], res["ms_per_frame_steady"][label],
             res["wall_s"][label], res["attention"][label]) = run_evaluate(
                vc, method, ds, switches, want, label, device,
                attention_want(method, lanes_run, MODEL_WINDOWS, hw, device))
            for name in (["seq0"] if ds == "MSYN" else lanes):
                check_tree(os.path.join("outputs", "std", ds, name, method),
                           MODEL_WINDOWS, hw, decode_frames=False,
                           may_skip={0})
            os.rename(os.path.join("outputs", "std", ds),
                      os.path.join("outputs", "std", f"{ds}_{method}_"
                                                     f"{label}"))
        method_config = get_method_config(method)
        raw = {}
        with env(EVREAL_DTYPE=None):
            bundle = MethodBundle(method, method_config, device)
            single = bundle.runner_for(hw, method_config, c["b"])
            lock_bufs = pack_lanes(seqs, 8, cap, "f32")
            raw["lockstep_f32"] = lockstep_raw(bundle.batched_runner_for(
                hw, method_config, c["b"], MODEL_LANES), lock_bufs)
            raw["single_lanes"] = torch.stack([single.reconstruct(
                single.init_state(), single.voxelize(single.upload(
                    {k: v[j] for k, v in lock_bufs.items()})))[1].cpu()
                for j in range(MODEL_LANES)])
            if method in NEW_CLASS_METHODS:
                cpu = MethodBundle(method, method_config, "cpu").runner_for(
                    hw, method_config, c["b"])
                for key, runner in (("card", single), ("cpu", cpu)):
                    raw[key] = runner.reconstruct(
                        runner.init_state(),
                        runner.voxelize(runner.upload(first8)))[1].cpu()
                if method in ("ET-Net", "HyperE2VID"):
                    phase_profile(torch, single, single.upload(pack_windows(
                        seq, list(range(CHUNK_T)))[0]), CHUNK_T,
                        f"{method}_single_f32")
        with env(EVREAL_DTYPE="bfloat16"):
            bundle = MethodBundle(method, method_config, device)
            raw["lockstep_bf16"] = lockstep_raw(bundle.batched_runner_for(
                hw, method_config, c["b"], MODEL_LANES),
                pack_lanes(seqs, 8, cap, "compact4"))
        err = float((raw["lockstep_f32"] - raw["single_lanes"]).abs().max())
        check(err <= TOL_LOCKSTEP, f"{method}: f32 lockstep vs single raw "
              f"reconstructions {err} > {TOL_LOCKSTEP}")
        res["recon_max_abs_err_lockstep_vs_single"] = err
        d = (raw["lockstep_bf16"] - raw["lockstep_f32"]).abs()
        res["bf16_vs_f32_raw"] = {"mean": float(d.mean()),
                                  "max": float(d.max())}
        check(0 < d.max() and d.mean() < BF16_MEAN and d.max() < BF16_MAX,
              f"{method}: bf16 vs f32 raw reconstructions mean "
              f"{float(d.mean())} (< {BF16_MEAN}), max {float(d.max())} "
              f"(< {BF16_MAX}, > 0)")
        if "cpu" in raw:
            err = float((raw["card"] - raw["cpu"]).abs().max())
            check(err <= TOL_RECON, f"{method}: card vs CPU raw "
                  f"reconstructions {err} > {TOL_RECON}")
            res["recon_max_abs_err_vs_cpu"] = err
        res["raw_range_f32"] = [float(raw["lockstep_f32"].min()),
                                float(raw["lockstep_f32"].max())]
        results[method] = res
        emit({"phase": "method", "method": method, "card": card, **res})
    result = {"phase": "methods", "sensor": list(hw),
              "windows": MODEL_WINDOWS, "lanes": MODEL_LANES,
              "chunk_t": CHUNK_T, "setup_s": setup_s, "card": card,
              "kernel_at_launch": kernel_at_launch,
              "ms_per_frame_steady": {m: r["ms_per_frame_steady"]
                                      for m, r in results.items()},
              "launches": {m: r["launches"] for m, r in results.items()},
              "attention": {m: r["attention"] for m, r in results.items()}}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 7: the remaining eval configs (color, hist-eq, resume, videos)
# ---------------------------------------------------------------------------

COLOR_HW = (260, 346)   # CED's sensor, the dataset the color config is for
COLOR_WINDOWS = 64
COLOR_CHUNK_T = 16      # the color runner's default chunk
ODD_HW = (259, 345)
ODD_WINDOWS = 16
HEQ_WINDOWS = 32
HEQ_LANES = 4
HEQ_MODES = ("global", "clahe", "local")
CPU_WINDOWS = 8
HEQ_SHARE = 0.01        # global hist-eq: processed frames card vs CPU more
                        # than 1 grey level apart on at most this share
TOL_RESCORE = 2e-5      # score rows (written to 5 decimals) against the
                        # same scores recomputed on the CPU
TOL_MERGE = 2           # merged frames, card vs CPU (grey levels)


def check_color_tree(out, n_windows, hw):
    """A color output tree: a timestamp row and a three-channel PNG per
    window, the metric files present and empty (color is not scored)."""
    from evreal_tpu_torch.harness.outputs import decode_png

    stamps = read_rows(os.path.join(out, "timestamps.txt"))
    check(sorted(stamps) == list(range(n_windows)),
          f"{out}/timestamps.txt rows {len(stamps)} != {n_windows}")
    for m in ("mse", "ssim"):
        path = os.path.join(out, m + ".txt")
        check(os.path.exists(path) and os.path.getsize(path) == 0,
              f"{path}: a color run must leave it present and empty")
    frames = []
    for i in range(n_windows):
        with open(os.path.join(out, f"frame_{i:010d}.png"), "rb") as f:
            frames.append(decode_png(f.read()))
    check(all(fr.shape == tuple(hw) + (3,) for fr in frames),
          f"{out}: color PNGs are not {tuple(hw) + (3,)}")
    return frames


def capture_evaluate(vc, methods, config, dataset, label, device,
                     switches=None, metrics=("mse", "ssim")):
    """``evaluate`` with its stdout captured and the voxelizer's launch
    counts set to 0 just before; fails on any contained exception.
    Returns (results, launches by precision, steady ms/frame of the first
    method, wall s, stdout)."""
    import io
    from contextlib import redirect_stdout

    from evreal_tpu_torch.harness.runner import evaluate
    from evreal_tpu_torch.harness.timers import TimingLog

    timings, buf = TimingLog(), io.StringIO()
    vc.reset_launches()
    t0 = time.perf_counter()
    with env(**(switches or {})), redirect_stdout(buf):
        results = evaluate(methods, [config], [dataset], list(metrics),
                           device=device, timings=timings)
    wall_s = time.perf_counter() - t0
    launches = dict(vc.launches_by_precision)
    contained(buf.getvalue(), label)
    return (results, launches, timings.ms_per_frame(methods[0]), wall_s,
            buf.getvalue())


def write_eval_config(root, name, **changes):
    from evreal_tpu_torch.harness.config import REPO_ROOT, read_json

    cfg = read_json(os.path.join(REPO_ROOT, "config", "eval", "std.json"))
    write_config(root, "eval", name, dict(cfg, **changes))


def cut_after(seq_dir, n, num_bins):
    """The end_time_s that keeps a sequence's first ``n`` windows."""
    from evreal_tpu_torch.data import Sequence

    metas = Sequence(seq_dir, num_bins=num_bins).windows()
    return float(metas[n - 1]["voxel_timestamp"])


def phase_color(torch, vc, vox, root, card, device):
    """-c color, E2VID at its published width on a 260 x 346 sequence, and
    FireNet+ at an odd 259 x 345; the color launch held to its plain
    version and timed; the first windows again on the CPU; a profile."""
    from evreal_tpu_torch.data import Sequence, pack_windows, plan_capacity
    from evreal_tpu_torch.harness.runner import (MethodBundle,
                                                 get_method_config)

    b = ECD["b"]
    res = {}
    for method, ds, hw, n in (("E2VID", "CSYN", COLOR_HW, COLOR_WINDOWS),
                              ("FireNet+", "CODD", ODD_HW, ODD_WINDOWS)):
        want = {"highest": -(-n // COLOR_CHUNK_T), "default": 0}
        _, launches, ms, wall_s, _ = capture_evaluate(
            vc, [method], "color", ds, f"{method} color", device,
            dict(EVREAL_DTYPE=None, EVREAL_WIRE=None, EVREAL_CHUNK_T=None))
        check(launches == want, f"{method} color: voxelizer launches "
              f"{launches}, want {want} (one HIGHEST launch per chunk of "
              f"{COLOR_CHUNK_T} windows, f32 always)")
        frames = check_color_tree(os.path.join(
            "outputs", "color", ds, "seq0", method), n, hw)
        res[method] = {"sensor": list(hw), "windows": n,
                       "launches": launches, "ms_per_frame_steady": ms,
                       "wall_s": wall_s,
                       "frame_mean": float(np.mean([f.mean()
                                                    for f in frames]))}

    # the color launch (chunk 0, T = 16 at 260 x 346) on its own data
    seq_dir = os.path.join(root, "data", "CSYN", "seq0")
    seq = Sequence(seq_dir, num_bins=b)
    cap = plan_capacity(m["event_count"] for m in seq.windows())
    arrays = pack_windows(seq, list(range(COLOR_CHUNK_T)), capacity=cap)[0]
    bufs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}
    err = hold_to_plain(torch, vox, bufs, b, COLOR_HW, "highest",
                        "color launch")[0]
    kernel = dict(time_variant(torch, vox, bufs, "highest", COLOR_HW, b),
                  max_abs_err=err, capacity=cap, sensor=list(COLOR_HW))

    # the first windows again: card against the plain CPU path, with
    # E2VID's weights at both sensors (the random FireNet+ frames clip to
    # black, which would leave the odd sensor's merge untested)
    method_config = get_method_config("E2VID")
    vs_cpu = {}
    for ds, hw in (("CSYN", COLOR_HW), ("CODD", ODD_HW)):
        first = pack_windows(Sequence(os.path.join(root, "data", ds, "seq0"),
                                      num_bins=b),
                             list(range(CPU_WINDOWS)))[0]
        out, runners = {}, {}
        for dev in (device, "cpu"):
            runner = runners[dev] = MethodBundle(
                "E2VID", method_config, dev).color_runner_for(
                    hw, method_config, b)
            vgrid = runner.voxel_stage(runner.upload(first))
            _, chans, gray = runner.reconstruct(runner.init_state(), vgrid)
            out[dev] = {"chans": chans.cpu(), "gray": gray.cpu(),
                        "merged": runner.merge(chans, gray).cpu()}
        chan_err = max(int((out[device][k].int() - out["cpu"][k].int())
                           .abs().max()) for k in ("chans", "gray"))
        check(chan_err <= 1, f"color channels card vs CPU at {hw}: "
              f"{chan_err} grey levels > 1")
        same = runners["cpu"].merge(out[device]["chans"],
                                    out[device]["gray"])
        check(torch.equal(same, out[device]["merged"]),
              f"the merge of the same channels differs between card and "
              f"CPU at {hw}")
        d = (out[device]["merged"].int() - out["cpu"]["merged"].int()).abs()
        check(int(d.max()) <= TOL_MERGE, f"merged frames card vs CPU at "
              f"{hw}: {int(d.max())} grey levels > {TOL_MERGE}")
        vs_cpu["x".join(map(str, hw))] = {
            "windows": CPU_WINDOWS, "channels_max_diff": chan_err,
            "merged_max_diff": int(d.max()),
            "merged_share_differing": float((d > 0).float().mean()),
            "merged_frame_mean": float(out[device]["merged"].float().mean())}
        if hw == COLOR_HW:
            card_runner = runners[device]

    # one steady chunk under the profiler, and the merge alone
    dev_bufs = card_runner.upload(arrays)
    phase_profile(torch, card_runner, dev_bufs, COLOR_CHUNK_T, "color_e2vid")
    _, chans, gray = card_runner.reconstruct(
        card_runner.init_state(), card_runner.voxel_stage(dev_bufs))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    merge_ms = time_ms(torch, lambda: card_runner.post(
        card_runner.merge(chans, gray)), flush)
    chunk_ms = time_ms(torch, lambda: card_runner.run(
        card_runner.init_state(), dev_bufs, COLOR_CHUNK_T), flush,
        warmup=1, iters=5)
    result = {"phase": "color", "card": card, "runs": res,
              "kernel_at_color_launch": kernel,
              "bit_equal_int64_plain": True, "e2vid_vs_cpu": vs_cpu,
              "merge_post_ms_per_chunk": merge_ms,
              "chunk_ms": chunk_ms,
              "merge_share_of_chunk": merge_ms / chunk_ms}
    emit(result)
    return result


def phase_histeq(torch, vc, root, card, device):
    """global, clahe and local configs, single on the card and on the CPU
    (the first windows), then global in 4-lane lockstep against single."""
    from evreal_tpu_torch.harness import histeq

    hw = (ECD["h"], ECD["w"])
    res, rows = {}, {}
    for mode in HEQ_MODES:
        for dev, ds, n in ((device, "HEQ", HEQ_WINDOWS),
                           ("cpu", "HEQ_CPU", CPU_WINDOWS)):
            _, launches, ms, wall_s, _ = capture_evaluate(
                vc, ["E2VID"], f"heq_{mode}", ds, f"hist-eq {mode} {dev}",
                dev, dict(EVREAL_DTYPE=None, EVREAL_WIRE=None))
            out = os.path.join("outputs", f"heq_{mode}", ds, "seq0", "E2VID")
            scores, frames = check_tree(out, n, hw)
            proc = [histeq_frame(out + "_processed", i) for i in range(n)]
            rows[(mode, dev)] = (scores, frames, proc)
            if dev == device:
                want = {"highest": -(-n // CHUNK_T), "default": 0}
                check(launches == want, f"hist-eq {mode}: voxelizer "
                      f"launches {launches}, want {want}")
                res[mode] = {"launches": launches, "ms_per_frame_steady": ms,
                             "wall_s": wall_s}
        ((card_scores, card_frames, card_proc),
         (cpu_scores, cpu_frames, cpu_proc)) = (rows[(mode, device)],
                                                rows[(mode, "cpu")])
        first = range(CPU_WINDOWS)
        frame_err = max(int(np.abs(card_frames[i].astype(int)
                                   - cpu_frames[i].astype(int)).max())
                        for i in first)
        check(frame_err <= 1, f"hist-eq {mode}: frames card vs CPU differ by "
              f"{frame_err} grey levels > 1")
        d = np.stack([np.abs(card_proc[i].astype(int)
                             - cpu_proc[i].astype(int)) for i in first])
        score_err = max(abs(card_scores[m][i] - cpu_scores[m][i])
                        for m in card_scores for i in cpu_scores[m])
        res[mode].update(frames_max_diff_vs_cpu=frame_err,
                         processed_max_diff_vs_cpu=int(d.max()),
                         processed_share_over_1_vs_cpu=float((d > 1).mean()),
                         score_max_abs_err_vs_cpu=score_err)
        if mode == "global":
            # equalize_hist sees the f32 frame, so its output moves about
            # as smoothly as the frame does between card and CPU
            check(res[mode]["processed_share_over_1_vs_cpu"] <= HEQ_SHARE,
                  f"hist-eq global: processed frames card vs CPU: "
                  f"{res[mode]['processed_share_over_1_vs_cpu']} of the "
                  f"pixels differ by more than 1")
            check(score_err <= TOL_SCORE, f"hist-eq global: score rows card "
                  f"vs CPU {score_err} > {TOL_SCORE}")
        else:
            # CLAHE and the rank filter see the uint8 frame, and a frame
            # one grey level apart on a plateau of equal values moves its
            # rank or LUT entry by many levels; so the card run is held to
            # the host equalizer on its own frames, bit for bit, and its
            # score rows to the same scores recomputed on the CPU
            redo_err, rescore_err = rescore_processed(
                torch, os.path.join(os.path.dirname(root), "data", "SYN",
                                    "seq0"),
                card_frames, card_proc, card_scores, mode)
            check(redo_err == 0, f"hist-eq {mode}: the card run's processed "
                  f"frames differ from the equalizer on its own frames by "
                  f"{redo_err}")
            check(rescore_err <= TOL_RESCORE, f"hist-eq {mode}: the card's "
                  f"score rows differ by {rescore_err} > {TOL_RESCORE} from "
                  f"the CPU's scores of its processed frames")
            res[mode].update(processed_redo_max_diff=redo_err,
                             rescore_max_abs_err_cpu=rescore_err)

    # global in lockstep (HEQ_LANES lanes) against each lane alone
    lock = {}
    for label, switches in (("lockstep", {}), ("single", {"EVREAL_BATCHED":
                                                          "0"})):
        _, launches, ms, wall_s, _ = capture_evaluate(
            vc, ["E2VID"], "heq_global", "HEQ_LOCK", f"hist-eq {label}",
            device, dict(EVREAL_DTYPE=None, EVREAL_WIRE=None, **switches))
        per_chunk = -(-HEQ_WINDOWS // CHUNK_T)
        want = {"highest": per_chunk * (1 if label == "lockstep"
                                        else HEQ_LANES), "default": 0}
        check(launches == want, f"hist-eq global {label}: launches "
              f"{launches}, want {want}")
        lanes = []
        for j in range(HEQ_LANES):
            out = os.path.join("outputs", "heq_global", "HEQ_LOCK",
                               f"lane{j}", "E2VID")
            scores, frames = check_tree(out, HEQ_WINDOWS, hw)
            lanes.append((scores, frames, [
                histeq_frame(out + "_processed", i)
                for i in range(HEQ_WINDOWS)]))
        lock[label] = {"launches": launches, "ms_per_frame_steady": ms,
                       "wall_s": wall_s, "lanes": lanes}
        os.rename(os.path.join("outputs", "heq_global", "HEQ_LOCK"),
                  os.path.join("outputs", "heq_global", f"HEQ_LOCK_{label}"))
    # the raw reconstructions agree within TOL_LOCKSTEP (phase 5), but
    # equalize_hist's bin counts are discontinuous in its input: held like
    # the card against the CPU above
    pairs = list(zip(lock["lockstep"].pop("lanes"),
                     lock["single"].pop("lanes")))
    lock_frames = max(int(np.abs(f.astype(int) - g.astype(int)).max())
                      for a, b in pairs for f, g in zip(a[1], b[1]))
    lock_proc = float(np.mean([(np.abs(f.astype(int) - g.astype(int)) > 1)
                               .mean() for a, b in pairs
                               for f, g in zip(a[2], b[2])]))
    lock_err = max(abs(a[0][m][i] - b[0][m][i])
                   for a, b in pairs for m in a[0] for i in a[0][m])
    check(lock_frames <= 1, f"hist-eq global lockstep vs single: frames "
          f"{lock_frames} grey levels apart > 1")
    check(lock_proc <= HEQ_SHARE, f"hist-eq global lockstep vs single: "
          f"{lock_proc} of the processed pixels differ by more than 1")
    check(lock_err <= TOL_SCORE, f"hist-eq global lockstep vs single "
          f"rows {lock_err} > {TOL_SCORE}")

    # host cost of each equalizer on one frame of the sequence
    frame = np.clip(histeq_frame(os.path.join(
        "outputs", "heq_global", "HEQ", "seq0", "E2VID"), 5) / 255.0, 0, 1)
    host_ms = {}
    for mode in HEQ_MODES:
        histeq.histogram_equalization(frame, mode)  # builds the native lib
        t0 = time.perf_counter()
        for _ in range(10):
            histeq.histogram_equalization(frame, mode)
        host_ms[mode] = (time.perf_counter() - t0) * 100
    result = {"phase": "histeq", "card": card, "method": "E2VID",
              "sensor": list(hw), "windows": HEQ_WINDOWS, "runs": res,
              "lockstep": lock,
              "lockstep_vs_single": {
                  "frames_max_diff": lock_frames,
                  "processed_share_over_1": lock_proc,
                  "score_max_abs_err": lock_err},
              "equalizer_host_ms_per_frame": host_ms}
    emit(result)
    return result


def rescore_processed(torch, seq_dir, frames, processed, scores, mode):
    """A hist-eq run's own frames (of the sequence in ``seq_dir``)
    equalized again on the host, and its processed frames scored again on
    the CPU against the equalized references. Returns (max grey-level
    difference of the processed PNGs, max abs difference of the score
    rows)."""
    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.harness import histeq
    from evreal_tpu_torch.harness.runner import equalized_refs
    from evreal_tpu_torch.metrics.registry import resolve

    redo = max(int(np.abs(np.round(np.clip(histeq.histogram_equalization(
        f / 255.0, mode), 0, 1) * 255).astype(int) - p.astype(int)).max())
        for f, p in zip(frames, processed))
    seq = Sequence(seq_dir, num_bins=ECD["b"])
    metas = seq.windows()
    idx = sorted(scores["mse"])
    imgs = torch.from_numpy(np.stack(
        [(processed[i] / 255.0).astype(np.float32) for i in idx]))
    refs = torch.from_numpy(equalized_refs(seq, [metas[i] for i in idx],
                                           mode))
    err = 0.0
    for spec in resolve(["mse", "ssim"]):
        got = spec.score(imgs, refs).numpy()
        err = max(err, max(abs(scores[spec.name][i] - float(g))
                           for i, g in zip(idx, got)))
    return redo, err


def histeq_frame(folder, i):
    from evreal_tpu_torch.harness.outputs import decode_png_gray8

    path = os.path.join(folder, f"frame_{i:010d}.png")
    check(os.path.exists(path), f"{path} missing")
    with open(path, "rb") as f:
        return decode_png_gray8(f.read())


def phase_resume(torch, vc, work, card, device):
    """Phase 4's single E2VID run again under EVREAL_RESUME=1: skipped, no
    launch, the recorded means; with save_images changed it runs again."""
    os.chdir(work)
    done_path = os.path.join("outputs", "std", "SYN", "seq0", "E2VID",
                             "done.json")
    with open(done_path, encoding="utf-8") as f:
        recorded = json.load(f)["mean_scores"]
    switches = dict(EVREAL_RESUME="1", EVREAL_DTYPE=None, EVREAL_WIRE=None)
    results, launches, _, wall_s, out = capture_evaluate(
        vc, ["E2VID"], "std", "SYN", "resume", device, switches)
    check("Skipping finished" in out, "EVREAL_RESUME did not skip phase 4's "
          "finished run")
    check(launches == {"highest": 0, "default": 0},
          f"a resumed run launched the voxelizer: {launches}")
    means = {m: results["std"][0][0].get_average(m) for m in recorded}
    check(all(abs(means[m] - recorded[m]) <= 1e-12 for m in recorded),
          f"resumed means {means} != recorded {recorded}")
    # a changed output-affecting setting runs again
    write_eval_config(work, "std", save_images=False)
    try:
        _, relaunch, _, _, out2 = capture_evaluate(
            vc, ["E2VID"], "std", "SYN", "resume, save_images changed",
            device, switches)
    finally:
        os.remove(os.path.join(work, "config", "eval", "std.json"))
    n_chunks = -(-N_WINDOWS // CHUNK_T)
    check("Skipping finished" not in out2 and relaunch == {
        "highest": n_chunks, "default": 0},
        f"a changed save_images must run again: launches {relaunch}")
    result = {"phase": "resume", "card": card, "skipped_launches": launches,
              "recorded_means": recorded, "resumed_means": means,
              "skip_wall_s": wall_s, "changed_setting_launches": relaunch}
    emit(result)
    return result


def phase_video(torch, vc, root, card, device):
    """create_video: a non-empty <dir>_<fps>Hz.mp4 with ffmpeg on PATH;
    without it, evaluate raises the named error before any launch."""
    import shutil

    os.chdir(root)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        vc.reset_launches()
        try:
            from evreal_tpu_torch.harness.runner import evaluate

            evaluate(["FireNet+"], ["vid"], ["HEQ"], ["mse"], device=device)
        except RuntimeError as e:
            check("ffmpeg" in str(e), f"create_video without ffmpeg raised "
                  f"an error that does not name it: {e}")
            error = str(e)
        else:
            fail("create_video without ffmpeg on PATH did not raise")
        launches = dict(vc.launches_by_precision)
        check(launches == {"highest": 0, "default": 0},
              f"the ffmpeg check came after a launch: {launches}")
        result = {"phase": "video", "card": card, "ffmpeg": None,
                  "case": "no ffmpeg: evaluate raised before any launch",
                  "error": error, "launches": launches}
    else:
        _, launches, _, wall_s, _ = capture_evaluate(
            vc, ["FireNet+"], "vid", "HEQ", "video", device)
        base = os.path.join("outputs", "vid", "HEQ", "seq0")
        made = [f for f in os.listdir(base) if f.endswith("Hz.mp4")]
        check(len(made) == 1 and os.path.getsize(os.path.join(
            base, made[0])) > 0, f"create_video made {made} in {base}")
        result = {"phase": "video", "card": card, "ffmpeg": ffmpeg,
                  "case": "ffmpeg on PATH: video written", "video": made[0],
                  "bytes": os.path.getsize(os.path.join(base, made[0])),
                  "launches": launches, "wall_s": wall_s}
    emit(result)
    return result


def phase_eval_configs(torch, vc, vox, work, card, device="cuda"):
    """The eval configs of this slice: color (two sensors), hist-eq (three
    modes, single and lockstep), resume, videos. Weights: phase 6's
    E2VID and FireNet+ .pth files at their published widths."""
    from evreal_tpu_torch.harness.config import REPO_ROOT, read_json

    root = os.path.join(work, "eval_configs")
    t0 = time.perf_counter()
    for method in ("E2VID", "FireNet+"):
        cfg = read_json(os.path.join(REPO_ROOT, "config", "method",
                                     method + ".json"))
        write_config(root, "method", method, dict(cfg, model_path=os.path.join(
            work, "methods", "pretrained", method, "model.pth")))
    for ds, hw, n in (("CSYN", COLOR_HW, COLOR_WINDOWS),
                      ("CODD", ODD_HW, ODD_WINDOWS)):
        make_sequence(os.path.join(root, "data", ds, "seq0"), *hw, n,
                      EVENTS_PER_WINDOW, seed=11)
        write_config(root, "dataset", ds,
                     {"root_path": os.path.join(root, "data", ds),
                      "sequences": {"seq0": {}}})
    syn = os.path.join(work, "data", "SYN", "seq0")  # phase 4's sequence
    for ds, n in (("HEQ", HEQ_WINDOWS), ("HEQ_CPU", CPU_WINDOWS)):
        write_config(root, "dataset", ds, {"root_path": os.path.dirname(syn),
                                           "sequences": {"seq0": {
                                               "sequence_path": syn,
                                               "end_time_s": cut_after(
                                                   syn, n, ECD["b"])}}})
    lock = os.path.join(work, "data", "LOCK")  # phase 5's sequences
    write_config(root, "dataset", "HEQ_LOCK", {
        "root_path": lock, "sequences": {
            f"lane{j}": {"sequence_path": os.path.join(lock, f"seq{j:02d}"),
                         "end_time_s": cut_after(os.path.join(
                             lock, f"seq{j:02d}"), HEQ_WINDOWS, ECD["b"])}
            for j in range(HEQ_LANES)}})
    for mode in HEQ_MODES:
        write_eval_config(root, f"heq_{mode}", histeq=mode)
    write_eval_config(root, "vid", create_video=True)
    setup_s = time.perf_counter() - t0
    os.chdir(root)
    color = phase_color(torch, vc, vox, root, card, device)
    heq = phase_histeq(torch, vc, root, card, device)
    resume = phase_resume(torch, vc, work, card, device)
    video = phase_video(torch, vc, root, card, device)
    result = {"phase": "eval_configs", "card": card, "setup_s": setup_s,
              "color_ms_per_frame_steady": {
                  m: r["ms_per_frame_steady"]
                  for m, r in color["runs"].items()},
              "histeq_ms_per_frame_steady": {
                  m: r["ms_per_frame_steady"] for m, r in heq["runs"].items()},
              "resume_skipped": True, "video_case": video["case"]}
    emit(result)
    return {"color": color, "histeq": heq, "resume": resume,
            "video": video}


# ---------------------------------------------------------------------------
# phase 8: the metrics (registry, LPIPS, NIQE, BRISQUE, MANIQA, no-reference)
# ---------------------------------------------------------------------------

METRIC_CPU_WINDOWS = 8  # the LPIPS run on the CPU
NOREF_END_S = 0.6       # the events-only sequence: t40ms windows to 0.6 s
MANIQA_WINDOWS = 2      # MANIQA through evaluate (20 crops a frame)
MANIQA_TIMED = 3        # frames timed at 20 crops
MANIQA_WIDTHS = {}      # maniqa.random_params' defaults: the published ones
LPIPS_CONVS = ((0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3),
               (8, 384, 256, 3), (10, 256, 256, 3))  # AlexNet's widths


def write_lpips_npz(path, seed=0):
    """Random LPIPS weights at AlexNet's widths (He-scaled convolutions,
    non-negative lin heads), written as tools/convert_lpips.py writes
    them: every 4-D array HWIO."""
    rng = np.random.default_rng(seed)
    w = {}
    for i, (idx, cin, cout, k) in enumerate(LPIPS_CONVS):
        w[f"features.{idx}.weight"] = rng.normal(
            0, (2.0 / (cin * k * k)) ** 0.5, (cout, cin, k, k))
        w[f"features.{idx}.bias"] = rng.normal(0, 0.01, cout)
        w[f"lin.{i}.weight"] = np.abs(rng.normal(0, 0.1, (1, cout, 1, 1)))
    np.savez(path, **{k: (v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
                      .astype(np.float32) for k, v in w.items()})


def write_nr_params(root, seq_dir):
    """NIQE pristine statistics from the features of smooth synthetic
    frames (``tests/test_niqe.py``'s recipe), and a hand-built BRISQUE SVR
    (``tests/test_brisque.py``'s form) whose feature ranges span the
    sequence's reference frames, smooth frames and uniform noise. Returns
    the two paths."""
    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.metrics import brisque, niqe

    yy, xx = np.mgrid[0:96, 0:192].astype(np.float64)
    rng = np.random.default_rng(0)
    clean = [np.clip(0.5 + 0.3 * np.sin(xx / (8 + s % 5)) * np.cos(yy / 11)
                     + rng.normal(0, 0.01, xx.shape), 0, 1) for s in range(8)]
    feats = np.concatenate([niqe.niqe_features(c) for c in clean])
    niqe_path = os.path.join(root, "niqe_params.npz")
    np.savez(niqe_path, mu=feats.mean(0),
             cov=np.cov(feats, rowvar=False) + np.eye(36) * 1e-6)
    seq = Sequence(seq_dir, num_bins=ECD["b"])
    f = np.stack([brisque.brisque_features(im) for im in
                  [seq.frame(m["frame_index"]) for m in seq.windows()[:4]]
                  + clean[:4] + list(rng.random((4, 96, 192)))])
    brisque_path = os.path.join(root, "brisque_svm.npz")
    np.savez(brisque_path, sv=rng.uniform(-1, 1, (8, 36)),
             sv_coef=rng.normal(0, 1, 8), gamma=np.float64(0.02),
             rho=np.float64(0.1), scale_min=f.min(0) - 1e-3,
             scale_max=f.max(0) + 1e-3)
    return niqe_path, brisque_path


def write_events_only(dst, hw, duration_s, rate, seed=0):
    """A sequence without reference frames (the TPAMI20_HDR case) of
    ``rate`` events a second spread uniformly over the sensor: its
    reconstructions are textured everywhere, so NIQE's sharpness rule
    keeps several of its 96-px patches (on the blob sequences it keeps
    one, and NIQE has no covariance: NaN, dropped)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * rate)
    os.makedirs(dst)
    np.save(os.path.join(dst, "events_ts.npy"),
            np.sort(rng.uniform(0, duration_s, n)))
    np.save(os.path.join(dst, "events_xy.npy"), np.stack(
        [rng.integers(0, hw[1], n), rng.integers(0, hw[0], n)],
        1).astype(np.int16))
    np.save(os.path.join(dst, "events_p.npy"),
            rng.integers(0, 2, n).astype(np.uint8))
    with open(os.path.join(dst, "metadata.json"), "w",
              encoding="utf-8") as f:
        json.dump({"sensor_resolution": list(hw)}, f)


def metric_rows(out, metric, n):
    """{window: score} of ``metric`` in ``out``: a finite score for each of
    the ``n`` windows."""
    rows = read_rows(os.path.join(out, metric + ".txt"))
    check(sorted(rows) == list(range(n)) and all(
        np.isfinite(v) for v in rows.values()),
        f"{out}/{metric}.txt: {len(rows)} rows, want {n} finite")
    return rows


def rescored(out, metric, redo):
    """The rows of ``metric`` in ``out`` against ``redo``, the host
    function's scores of the frames the run scored: a row exactly where
    that score is finite (the tracker drops NaN: NIQE has no covariance
    below two selected patches), within TOL_RESCORE of it. Returns (rows,
    max abs error)."""
    rows = read_rows(os.path.join(out, metric + ".txt"))
    redo = [float(v) for v in redo]
    finite = [i for i, v in enumerate(redo) if np.isfinite(v)]
    check(sorted(rows) == finite and finite, f"{out}/{metric}.txt: rows "
          f"{sorted(rows)[:8]}, the host function scores {finite[:8]} of "
          f"{len(redo)}")
    return rows, max((abs(rows[i] - redo[i]) for i in finite), default=0.0)


def rows_err(a, b, idx=None):
    idx = sorted(a) if idx is None else idx
    return max(abs(a[i] - b[i]) for i in idx)


def profile_metric(torch, runner, spec, clipped, refs, label):
    """One call of ``spec`` on a chunk's frames: device busy ms under
    torch.profiler, CUDA-event ms (median of 5 after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    runner.metric_scores([spec], clipped, refs)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.metric_scores([spec], clipped, refs)
        torch.cuda.synchronize()
    busy_ms, _, by_name = device_time(torch, prof)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=clipped.device)
    ms = time_ms(torch, lambda: runner.metric_scores([spec], clipped, refs),
                 flush, warmup=1, iters=5)
    return {"path": label, "frames": int(np.prod(clipped.shape[:-2])),
            "device_busy_ms": busy_ms, "ms": ms,
            "top_kernels": top_kernels(by_name, 6)}


def phase_metrics(torch, vc, vox, work, card, device="cuda"):
    """``-qm mse ssim lpips`` single (card and CPU) and in lockstep, with
    a random AlexNet-width LPIPS file and without one; NIQE and BRISQUE
    rows against the host functions on the run's own frames; MANIQA at its
    published widths; an events-only sequence with ``-qm mse niqe``; an
    unknown name. The voxelizer held to its plain version at the new
    paths' first launches."""
    from evreal_tpu_torch.data import Sequence, pack_windows, plan_capacity
    from evreal_tpu_torch.harness.config import read_json
    from evreal_tpu_torch.harness.runner import (MethodBundle,
                                                 get_method_config)
    from evreal_tpu_torch.metrics import brisque, maniqa, niqe, registry
    from evreal_tpu_torch.utils import f32_parity

    c = ECD
    hw = (c["h"], c["w"])
    root = os.path.join(work, "metrics")
    t0 = time.perf_counter()
    os.makedirs(root)
    write_config(root, "method", "E2VID", read_json(os.path.join(
        work, "config", "method", "E2VID.json")))
    syn = os.path.join(work, "data", "SYN", "seq0")  # phase 4's sequence
    lock = os.path.join(work, "data", "LOCK")  # phase 5's sequences
    cuts = {"SYN": N_WINDOWS, "LPCPU": METRIC_CPU_WINDOWS,
            "MQ": MANIQA_WINDOWS}
    for ds, n in cuts.items():
        seq = {"sequence_path": syn}
        if n < N_WINDOWS:
            seq["end_time_s"] = cut_after(syn, n, c["b"])
        write_config(root, "dataset", ds, {"root_path": os.path.dirname(syn),
                                           "sequences": {"seq0": seq}})
    for ds, k in (("LOCK", N_LANES), ("LOCK2", 2)):
        write_config(root, "dataset", ds, {"root_path": lock, "sequences": {
            f"seq{j:02d}": {} for j in range(k)}})
    # the no-reference metrics at CED's 260 x 346 (2 x 3 NIQE patches)
    noref = os.path.join(root, "data", "NOREF", "hdr0")
    write_events_only(noref, COLOR_HW, NOREF_END_S + 0.04,
                      EVENTS_PER_WINDOW / 0.04)
    write_config(root, "dataset", "NOREF", {
        "root_path": os.path.dirname(noref),
        "sequences": {"hdr0": {"end_time_s": NOREF_END_S}}})
    lpips_path = os.path.join(root, "lpips_alex.npz")
    write_lpips_npz(lpips_path)
    niqe_path, brisque_path = write_nr_params(root, syn)
    maniqa_path = os.path.join(root, "maniqa.npz")
    np.savez(maniqa_path, **maniqa.random_params(0, **MANIQA_WIDTHS))
    setup_s = time.perf_counter() - t0
    os.chdir(root)
    f32 = dict(EVREAL_DTYPE=None, EVREAL_WIRE=None, EVREAL_BATCHED=None,
               EVREAL_LPIPS_WEIGHTS=lpips_path,
               EVREAL_NIQE_PARAMS=niqe_path,
               EVREAL_BRISQUE_PARAMS=brisque_path,
               EVREAL_MANIQA_PARAMS=maniqa_path, EVREAL_MANIQA_CROPS=None)
    n_chunks = -(-N_WINDOWS // CHUNK_T)
    runs = {}

    def run(label, dataset, metrics, want, dev=device, config="std",
            **switches):
        """One evaluate with the launches it must make; its outputs move
        to outputs/<config>/<dataset>_<label>."""
        _, launches, ms, wall_s, out = capture_evaluate(
            vc, ["E2VID"], config, dataset, f"metrics {label}", dev,
            dict(f32, **switches), metrics)
        if dev == device:
            check(launches == dict({"highest": 0, "default": 0}, **want),
                  f"metrics {label}: voxelizer launches {launches}, want "
                  f"{want}")
        base = os.path.join("outputs", config)
        os.rename(os.path.join(base, dataset),
                  os.path.join(base, f"{dataset}_{label}"))
        runs[label] = {"launches": launches, "ms_per_frame_steady": ms,
                       "wall_s": wall_s}
        return os.path.join(base, f"{dataset}_{label}"), out

    # LPIPS: single f32 with and without it, the CPU on the first windows
    base, _ = run("mse_ssim_single_f32", "SYN", ["mse", "ssim"],
                  {"highest": n_chunks})
    plain = check_tree(os.path.join(base, "seq0", "E2VID"), N_WINDOWS, hw,
                       decode_frames=False)[0]
    base, _ = run("lpips_single_f32", "SYN", ["mse", "ssim", "lpips"],
                  {"highest": n_chunks})
    out = os.path.join(base, "seq0", "E2VID")
    single = check_tree(out, N_WINDOWS, hw, decode_frames=False)[0]
    single["lpips"] = metric_rows(out, "lpips", N_WINDOWS)
    base, _ = run("lpips_cpu", "LPCPU", ["mse", "ssim", "lpips"], {},
                  dev="cpu")
    cpu = {m: metric_rows(os.path.join(base, "seq0", "E2VID"), m,
                          METRIC_CPU_WINDOWS) for m in ("mse", "ssim",
                                                        "lpips")}
    cpu_err = {m: rows_err(cpu[m], single[m]) for m in cpu}
    check(max(cpu_err.values()) <= TOL_SCORE, f"metrics: score rows card vs "
          f"CPU {cpu_err} > {TOL_SCORE}")
    same = rows_err(plain["mse"], single["mse"]) + rows_err(plain["ssim"],
                                                            single["ssim"])
    check(same == 0, f"metrics: lpips changed the mse/ssim rows by {same}")

    # no LPIPS file: the skip line, the mse/ssim rows, the run goes on
    base, out_text = run("no_lpips_file", "SYN", ["mse", "ssim", "lpips"],
                         {"highest": n_chunks},
                         EVREAL_LPIPS_WEIGHTS=os.path.join(root, "none.npz"))
    check("lpips weights unavailable (see tools/convert_lpips.py); skipping "
          "lpips" in out_text, "metrics: no skip line without the LPIPS file")
    out = os.path.join(base, "seq0", "E2VID")
    check(not os.path.exists(os.path.join(out, "lpips.txt")),
          "metrics: lpips.txt written without the LPIPS file")
    skipped = check_tree(out, N_WINDOWS, hw, decode_frames=False)[0]
    no_file_err = max(rows_err(skipped[m], plain[m]) for m in skipped)
    check(no_file_err <= TOL_LOCKSTEP, f"metrics: rows without the LPIPS "
          f"file differ by {no_file_err}")

    # LPIPS in lockstep: 16 lanes bf16 compact4; 2 lanes f32 vs single
    base, _ = run("lpips_lockstep_bf16_compact4", "LOCK",
                  ["mse", "ssim", "lpips"], {"default": n_chunks},
                  EVREAL_DTYPE="bfloat16", EVREAL_WIRE="compact4")
    for j in range(N_LANES):
        out = os.path.join(base, f"seq{j:02d}", "E2VID")
        check_tree(out, N_WINDOWS, hw, decode_frames=False, may_skip={0})
        rows = read_rows(os.path.join(out, "lpips.txt"))
        check(set(range(1, N_WINDOWS)) <= set(rows) and all(
            np.isfinite(v) for v in rows.values()),
            f"{out}/lpips.txt: {len(rows)} rows")
    lanes = {}
    for label, want, switches in (
            ("lpips_lockstep_f32", n_chunks, {}),
            ("lpips_single_lanes_f32", 2 * n_chunks, {"EVREAL_BATCHED": "0"})):
        base, _ = run(label, "LOCK2", ["mse", "ssim", "lpips"],
                      {"highest": want}, **switches)
        lanes[label] = [metric_rows(os.path.join(base, f"seq{j:02d}",
                                                 "E2VID"), "lpips", N_WINDOWS)
                        for j in range(2)]
    lock_err = max(rows_err(a, b) for a, b in zip(
        lanes["lpips_lockstep_f32"], lanes["lpips_single_lanes_f32"]))
    check(lock_err <= TOL_LOCKSTEP, f"metrics: lpips rows f32 lockstep vs "
          f"single {lock_err} > {TOL_LOCKSTEP}")

    # LPIPS alone on a chunk: the single path's 32 frames and a 16-lane
    # chunk's 512, profiled
    method_config = get_method_config("E2VID")
    seq = Sequence(syn, num_bins=c["b"])
    with env(**f32):
        runner = MethodBundle("E2VID", method_config, device).runner_for(
            hw, method_config, c["b"])
        (lp_spec,) = registry.resolve(["lpips"])
        bufs, metas = pack_windows(seq, list(range(CHUNK_T)))
        _, _, clipped = runner.run(runner.init_state(), runner.upload(bufs),
                                   CHUNK_T)
        refs = runner.upload({"r": np.stack([seq.frame_u8(m["frame_index"])
                                             for m in metas])})["r"]
        lpips_profile = [profile_metric(torch, runner, lp_spec, clipped,
                                        refs, "single_chunk")]
        lpips_profile.append(profile_metric(
            torch, runner, lp_spec, clipped.repeat(N_LANES, 1, 1)
            .view(N_LANES, CHUNK_T, *hw), refs.repeat(N_LANES, 1, 1)
            .view(N_LANES, CHUNK_T, *hw), f"lockstep_chunk_{N_LANES}_lanes"))

    # NIQE and BRISQUE: rows against the host functions on the frames the
    # run scored (a host metric that keeps them: no PNG round trip)
    frames = []

    def keep(imgs):
        frames.append(np.array(imgs))
        return np.zeros(len(imgs), np.float32)

    def run_kept(label, dataset, metrics, want, n, **kw):
        """``run`` with a host metric that keeps the frames the host
        metrics saw; returns (outputs, the n frames)."""
        frames.clear()
        registry.register("smoke_frames", keep, no_ref=True, host=True)
        try:
            base, _ = run(label, dataset, metrics + ["smoke_frames"], want,
                          **kw)
        finally:
            registry._REGISTRY.pop("smoke_frames")
        kept = np.concatenate(frames)
        check(kept.shape == (n,) + COLOR_HW, f"metrics {label}: the host "
              f"metrics saw {kept.shape}")
        return base, kept

    n_noref = len([m for m in Sequence(noref, num_bins=c["b"], voxel_method={
        "method": "t_seconds", "t": 0.04, "sliding_window_t": 0}).windows()
        if m["voxel_timestamp"] <= NOREF_END_S])
    noref_want = {"highest": -(-n_noref // CHUNK_T)}
    base, scored = run_kept("niqe_brisque_single_f32", "NOREF",
                            ["niqe", "brisque"], noref_want, n_noref,
                            config="t40ms")
    out = os.path.join(base, "hdr0", "E2VID")
    mu, cov = niqe.load_params(niqe_path)
    svr = brisque.load_params(brisque_path)
    host_ms, nr_rows, nr_err = {}, {}, {}
    for name, fn in (("niqe", lambda f: niqe.niqe(f, mu, cov)),
                     ("brisque", lambda f: brisque.brisque(f, svr))):
        t1 = time.perf_counter()
        redo = [fn(f) for f in scored]
        host_ms[name] = (time.perf_counter() - t1) * 1e3 / len(scored)
        # scores leave the host metric as float32, as in the JAX package
        nr_rows[name], nr_err[name] = rescored(out, name, np.float32(redo))
    check(max(nr_err.values()) <= TOL_RESCORE, f"metrics: NIQE/BRISQUE rows "
          f"vs the host functions on the run's frames {nr_err} > "
          f"{TOL_RESCORE}")

    # no reference frames and -qm mse niqe: NIQE rows, no mse rows
    base, kept = run_kept("noref_mse_niqe", "NOREF", ["mse", "niqe"],
                          noref_want, n_noref, config="t40ms")
    out = os.path.join(base, "hdr0", "E2VID")
    noref_rows, noref_err = rescored(out, "niqe", np.float32([
        niqe.niqe(f, mu, cov) for f in kept]))
    check(noref_err <= TOL_RESCORE, f"metrics: events-only NIQE rows vs the "
          f"host function {noref_err} > {TOL_RESCORE}")
    mse_path = os.path.join(out, "mse.txt")
    check(not os.path.exists(mse_path) or os.path.getsize(mse_path) == 0,
          "metrics: mse rows on a sequence without reference frames")
    with open(os.path.join(out, "done.json"), encoding="utf-8") as f:
        done = json.load(f)
    check(done["metrics"] == ["niqe", "smoke_frames"]
          and done["num_evaluated"] == n_noref,
          f"metrics: done.json of the events-only run: {done}")

    # an unknown name: its line, and the run goes on
    base, out_text = run("unknown_name", "LPCPU", ["mse", "nosuch"],
                         {"highest": 1})
    check("Unknown metric nosuch" in out_text, "metrics: no 'Unknown "
          "metric nosuch' line")
    metric_rows(os.path.join(base, "seq0", "E2VID"), "mse",
                METRIC_CPU_WINDOWS)

    # MANIQA at its published widths: through evaluate (20 crops a frame),
    # one frame card vs CPU at one crop, 20 crops timed with peak memory
    base, _ = run("maniqa_single_f32", "MQ", ["maniqa"], {"highest": 1})
    maniqa_rows = metric_rows(os.path.join(base, "seq0", "E2VID"), "maniqa",
                              MANIQA_WINDOWS)
    params = maniqa.load_params(maniqa_path)
    scored = scored[:, :hw[0], :hw[1]]  # ECD's size: upscaled to 224 x 299
    frame = torch.from_numpy(np.clip(scored[-1], 0, 1))
    one = {}
    with f32_parity():
        for dev in (device, "cpu"):
            w = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                     else v) for k, v in params.items()}
            with torch.no_grad():
                one[dev] = float(maniqa.maniqa(
                    w, frame.to(dev), n_crops=1,
                    window_size=w["_meta_window"], scale=w["_meta_scale"]))
        maniqa_err = abs(one[device] - one["cpu"])
        check(maniqa_err <= TOL_SCORE, f"metrics: MANIQA card vs CPU "
              f"{maniqa_err} > {TOL_SCORE}")
        w = {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
                 else v) for k, v in params.items()}
        timed = torch.from_numpy(np.clip(scored[:MANIQA_TIMED], 0, 1)).to(
            device)

        def maniqa_frames():
            with torch.no_grad():
                return torch.stack([maniqa.maniqa(
                    w, f, window_size=w["_meta_window"],
                    scale=w["_meta_scale"]) for f in timed])

        maniqa_frames()  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        maniqa_ms = time_ms(torch, maniqa_frames, flush, warmup=0,
                            iters=2) / MANIQA_TIMED
        peak = torch.cuda.max_memory_allocated()
    n_params = sum(v.size for v in params.values()
                   if isinstance(v, np.ndarray))

    # the voxelizer at the new paths' first launches, on their data: the
    # first n windows of each sequence, empty windows to CHUNK_T
    def first_launch(seqs, wire, n=CHUNK_T):
        cap = plan_capacity(m["event_count"] for s in seqs
                            for m in s.windows()[:n])
        packed = []
        for s in seqs:
            t = min(n, CHUNK_T)
            p = pack_windows(s, list(range(t)), capacity=cap, wire=wire)[0]
            packed.append({k: np.concatenate([v, np.zeros(
                (CHUNK_T - t,) + v.shape[1:], v.dtype)]) for k, v in p.items()})
        return {k: torch.from_numpy(np.concatenate(
            [p[k] for p in packed])).to(device) for k in packed[0]}

    tsec = {"method": "t_seconds", "t": 0.04, "sliding_window_t": 0}
    at_launch = {}
    for label, seqs, wire, prec, grid, n in (
            ("lpips_single_f32", [seq], "f32", "highest", hw, N_WINDOWS),
            ("noref_t40ms", [Sequence(noref, num_bins=c["b"],
                                      voxel_method=tsec)], "f32", "highest",
             COLOR_HW, n_noref),
            ("lpips_lockstep_bf16_compact4",
             [Sequence(os.path.join(lock, f"seq{j:02d}"), num_bins=c["b"])
              for j in range(N_LANES)], "compact4", "default", hw,
             N_WINDOWS)):
        at_launch[label] = {"precision": prec, "max_abs_err": hold_to_plain(
            torch, vox, first_launch(seqs, wire, n), c["b"], grid, prec,
            f"metrics {label} launch")[0]}
    result = {"phase": "metrics", "card": card, "setup_s": setup_s,
              "sensor": list(hw), "runs": runs,
              "ms_per_frame_steady": {k: v["ms_per_frame_steady"]
                                      for k, v in runs.items()},
              "lpips_score_err_vs_cpu": cpu_err,
              "lpips_lockstep_vs_single_f32": lock_err,
              "no_lpips_file_rows_err": no_file_err,
              "lpips_chunk": lpips_profile,
              "mean_lpips_single": float(np.mean(list(
                  single["lpips"].values()))),
              "nr_rows_err_vs_host": nr_err,
              "nr_host_ms_per_frame": host_ms,
              "mean_brisque": float(np.mean(list(
                  nr_rows["brisque"].values()))),
              "nr_rows_scored": {m: len(r) for m, r in nr_rows.items()},
              "noref_windows": n_noref, "noref_niqe_rows": len(noref_rows),
              "noref_niqe_err_vs_host": noref_err,
              "maniqa": {"params": n_params, "rows": maniqa_rows,
                         "card_vs_cpu_1_crop": maniqa_err,
                         "ms_per_frame_20_crops": maniqa_ms,
                         "peak_mem_bytes": peak},
              "kernel_at_launch": at_launch, "bit_equal_int64_plain": True}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 9: the serving engine (evreal_tpu_torch/serve.py)
# ---------------------------------------------------------------------------

SERVE_LATENCY_METHODS = ("E2VID", "E2VID+", "FireNet", "FireNet+",
                         "SSL-E2VID")
SERVE_CHECK_METHODS = ("ET-Net", "SPADE-E2VID", "HyperE2VID")  # guessed
SERVE_WARMUP, SERVE_TIMED = 8, 64      # pushes per stream run
SERVE_CHECK_PUSHES = 8
SERVE_LANES = (4, 16)
SERVE_GROUP_WARMUP, SERVE_GROUP_TIMED = 4, 16
SERVE_OFFLINE = 32    # pushes held to the chunked offline runner
SERVE_CPU = 4         # pushes held to the CPU engine
SERVE_THREAD_PUSHES = 8
SERVE_SHAPES = (("T1_stream", 1), ("T4_group", 4), ("T8_train", 8),
                ("T16_group", 16))
SERVE_POOL = 80       # synthetic windows of EVENTS_PER_WINDOW events
TOL_SERVE_OFFLINE = 1e-5
TOL_SERVE_GROUP = 5e-4  # tests/test_serve.py:191-195


def serve_windows(n, hw, seed=0):
    """``n`` windows of ``EVENTS_PER_WINDOW`` uniform events over 30 ms
    each, as a client pushes them: int16 coordinates, absolute float64
    timestamps, on-disk {0,1} polarity."""
    rng = np.random.default_rng(seed)
    e = EVENTS_PER_WINDOW
    out = []
    for i in range(n):
        out.append((rng.integers(0, hw[1], e).astype(np.int16),
                    rng.integers(0, hw[0], e).astype(np.int16),
                    np.sort(rng.uniform(0.03 * i, 0.03 * (i + 1), e)),
                    rng.integers(0, 2, e).astype(np.uint8)))
    return out


def timed_calls(call, args, warmup, timed):
    """``call(args(k))`` for ``warmup`` then ``timed`` calls, each timed on
    the host clock (a push returns host frames, so the device is done);
    returns (ms of the timed calls, the last result)."""
    for k in range(warmup):
        call(args(k))
    ms = []
    for k in range(warmup, warmup + timed):
        t0 = time.perf_counter()
        out = call(args(k))
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


def host_pack_ms(serve, windows, hw, cap, wire, reps=5):
    """Median host ms to pack ``windows`` into one pooled (n, 1, E)
    buffer set on ``wire``, as ``push_group`` does."""
    from evreal_tpu_torch.data.packing import alloc_buffers, wire_dtypes

    dtypes = wire_dtypes(wire, True, hw)
    bufs = alloc_buffers((len(windows), 1), cap, dtypes)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for j, w in enumerate(windows):
            serve._pack_window(*w, capacity=cap, dtypes=dtypes, resolution=hw,
                               out={k: v[j] for k, v in bufs.items()})
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def phase_serve(torch, vc, vox, work, card, device="cuda"):
    """The serving engine at ECD's 180 x 240 on windows of 30,000
    synthetic events (capacity 32768), engines from phase 6's ``.pth``
    files through ``ReconEngine.from_method``: push latency per method
    (f32 frames and ``u8``), run checks of the methods with guessed widths,
    E2VID groups of 4 and 16 lanes (f32 on the f32 wire, bf16 on
    compact4), the socket round trip, the engine against the chunked
    offline runner, the CPU engine and solo streams, 4 threads at once;
    device profiles of E2VID pushes and of each group's pushes; an E2VID
    stream in bf16 on compact4; the voxelizer at the serve shapes and the
    training launch's (T = 1, 4, 8, 16) bit-equal to its int64 plain
    version on both paths, timed, the two paths in turns, with the launch
    floor. Launches are counted per run and per voxelizer path, the counts
    set to 0 just before each run."""
    import threading

    from evreal_tpu_torch import serve
    from evreal_tpu_torch.data.packing import alloc_buffers, bucket_capacity
    from evreal_tpu_torch.harness.runner import MethodRunner

    c = ECD
    hw = (c["h"], c["w"])
    cap = bucket_capacity(EVENTS_PER_WINDOW)
    t_phase = time.perf_counter()
    pretrained = os.path.join(work, "methods", "pretrained")
    wins = serve_windows(SERVE_POOL, hw)
    f32 = dict(EVREAL_DTYPE=None, EVREAL_WIRE=None)
    bf16 = dict(EVREAL_DTYPE="bfloat16", EVREAL_WIRE="compact4")
    launches, paths = {}, {}

    def engine(method, dev=device, **cfg):
        cfg["model_path"] = os.path.join(pretrained, method, "model.pth")
        return serve.ReconEngine.from_method(method, cfg, device=dev)

    def counted(method, path, prec, want, fn, route="direct"):
        """``fn()`` with the voxelizer's counts set to 0 just before and
        read just after: ``want`` launches at ``prec``, none at the
        other, all of them on ``route`` (a stream's pushes take the
        direct path, a group's the tiled one)."""
        vc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(vc.launches_by_precision)
        by_path = dict(vc.launches_by_path)
        expect = dict(dict.fromkeys(vc.PRECISIONS, 0), **{prec: want})
        expect_path = dict(dict.fromkeys(vc.PATHS, 0), **{route: want})
        check(got == expect and by_path == expect_path,
              f"serve {method} {path}: voxelizer launches {got} by path "
              f"{by_path}, want {expect} on the {route} path (one per push)")
        launches.setdefault(method, {})[path] = got
        paths.setdefault(method, {})[path] = by_path
        return out

    def window(k):
        return wins[k % len(wins)]

    # push latency, one stream per method
    lat = {}
    with env(**f32):
        for method in SERVE_LATENCY_METHODS + SERVE_CHECK_METHODS:
            eng = engine(method)
            sid = eng.open_stream(*hw)
            res = {}
            if method in SERVE_LATENCY_METHODS:
                for label, u8 in (("f32", False), ("u8", True)):
                    eng.reset(sid)
                    ms, frame = counted(
                        method, f"stream_{label}", "highest",
                        SERVE_WARMUP + SERVE_TIMED,
                        lambda: timed_calls(
                            lambda w: eng.push(sid, *w, u8=u8), window,
                            SERVE_WARMUP, SERVE_TIMED))
                    check(frame.shape == hw and frame.dtype == (
                        np.uint8 if u8 else np.float32)
                        and np.isfinite(frame).all(),
                        f"serve {method} {label}: frame {frame.shape} "
                        f"{frame.dtype}")
                    res[f"ms_per_push_{label}"] = latency(ms)
                if method == "E2VID":
                    res["profile_f32"] = profile_calls(
                        torch, lambda k: eng.push(sid, *window(k)), 16)
                    res["host_pack_ms"] = host_pack_ms(
                        serve, [window(0)], hw, cap, "f32")
            else:
                frames = counted(method, "stream_f32", "highest",
                                 SERVE_CHECK_PUSHES,
                                 lambda: [eng.push(sid, *window(k))
                                          for k in range(SERVE_CHECK_PUSHES)])
                check(all(f.shape == hw and np.isfinite(f).all()
                          for f in frames), f"serve {method}: frames")
                res["run_check_pushes"] = SERVE_CHECK_PUSHES
            lat[method] = res
            emit({"phase": "serve_latency", "method": method, "card": card,
                  "sensor": list(hw), "events_per_window": EVENTS_PER_WINDOW,
                  "capacity": cap, "launches": launches[method], **res})
            del eng
    # a bf16 stream on compact4: its T = 1 launch at DEFAULT, direct too
    with env(**bf16):
        eng = engine("E2VID")
        sid = eng.open_stream(*hw)
        ms, frame = counted(
            "E2VID", "stream_bf16_compact4", "default",
            SERVE_WARMUP + SERVE_TIMED,
            lambda: timed_calls(lambda w: eng.push(sid, *w), window,
                                SERVE_WARMUP, SERVE_TIMED))
        check(frame.shape == hw and np.isfinite(frame).all(),
              f"serve E2VID bf16 stream: frame {frame.shape}")
        lat["E2VID"]["ms_per_push_bf16_compact4"] = latency(ms)
        emit({"phase": "serve_latency", "method": "E2VID", "card": card,
              "stream": "bf16_compact4",
              "launches": launches["E2VID"]["stream_bf16_compact4"],
              "ms_per_push": lat["E2VID"]["ms_per_push_bf16_compact4"]})
        del eng

    # E2VID groups: ms per push_group and aggregate frames/s
    groups = {}
    for label, switches, prec in (("f32", f32, "highest"),
                                  ("bf16_compact4", bf16, "default")):
        with env(**switches):
            eng = engine("E2VID")
            for n in SERVE_LANES:
                gid = eng.open_group(n, *hw)
                ms, frames = counted(
                    "E2VID", f"group{n}_{label}", prec,
                    SERVE_GROUP_WARMUP + SERVE_GROUP_TIMED,
                    lambda: timed_calls(
                        lambda ws: eng.push_group(gid, ws),
                        lambda k: [window(k * n + j) for j in range(n)],
                        SERVE_GROUP_WARMUP, SERVE_GROUP_TIMED),
                    route=vc.route((n, cap)))
                check(frames.shape == (n,) + hw and np.isfinite(frames).all(),
                      f"serve group {n} {label}: frames {frames.shape}")
                ms = latency(ms)
                groups[f"{n}_lanes_{label}"] = {
                    "ms_per_push_group": ms,
                    "frames_per_s": n * 1e3 / ms["mean"],
                    "frames_per_s_at_p50": n * 1e3 / ms["p50"],
                    "profile": profile_calls(torch, lambda k: eng.push_group(
                        gid, [window(k * n + j) for j in range(n)]), 4),
                    "host_pack_ms": host_pack_ms(
                        serve, [window(j) for j in range(n)], hw, cap,
                        switches["EVREAL_WIRE"] or "f32")}
                eng.close_group(gid)
            del eng
    emit({"phase": "serve_groups", "card": card, "groups": groups,
          "launches": {k: v for k, v in launches["E2VID"].items()
                       if k.startswith("group")}})

    with env(**f32):
        # the socket round trip, the server in a thread of this process
        eng = engine("E2VID")
        path = os.path.join(work, "serve.sock")
        server = serve.ReconServer(eng, path)
        thread = threading.Thread(target=server.serve_forever,
                                  kwargs={"poll_interval": 0.05},
                                  daemon=True)
        thread.start()
        try:
            client = serve.ReconClient(path)
            client._sock.settimeout(120)
            sid = client.open_stream(*hw)
            ms, frame = counted(
                "E2VID", "socket_f32", "highest", SERVE_WARMUP + SERVE_TIMED,
                lambda: timed_calls(lambda w: client.push(sid, *w), window,
                                    SERVE_WARMUP, SERVE_TIMED))
            stats = client.stats()
            client.close()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(60)
        check(not thread.is_alive(), "serve: the server thread did not end")
        check(frame.shape == hw and stats["frames"] == len(ms) + SERVE_WARMUP,
              f"serve socket: frame {frame.shape}, stats {stats}")
        sock = {"round_trip_ms": latency(ms),
                "in_process_p50_ms": lat["E2VID"]["ms_per_push_f32"]["p50"],
                "stats": stats}
        emit({"phase": "serve_socket", "card": card, **sock})

        # 32 pushes against the chunked offline runner on the card
        eng = engine("E2VID")
        sid = eng.open_stream(*hw)
        stream = np.stack([eng.push(sid, *window(k))
                           for k in range(SERVE_OFFLINE)])
        runner = MethodRunner(eng.model, event_norm=eng.event_norm,
                              post_norm=eng.post_norm, height=hw[0],
                              width=hw[1], num_bins=eng.num_bins,
                              device=device, chunk_t=SERVE_OFFLINE)
        dtypes = eng._streams[sid].dtypes
        host = alloc_buffers((SERVE_OFFLINE,), cap, dtypes)
        for k in range(SERVE_OFFLINE):
            serve._pack_window(*window(k), capacity=cap, dtypes=dtypes,
                               resolution=hw, out={
                                   key: v[k:k + 1]
                                   for key, v in host.items()})
        _, _, clipped = runner.run(runner.init_state(), runner.upload(host),
                                   SERVE_OFFLINE)
        offline_err = float(np.abs(stream - clipped.cpu().numpy()).max())
        check(offline_err <= TOL_SERVE_OFFLINE, f"serve: {SERVE_OFFLINE} "
              f"pushes vs the offline runner {offline_err} > "
              f"{TOL_SERVE_OFFLINE}")

        # 4 pushes against the CPU engine: raw frames (post-norm 'none')
        # at the raw reconstructions' bound; the robust frames reported
        raw = {}
        for dev in (device, "cpu"):
            for norm in ("none", "robust"):
                e = engine("E2VID", dev, post_process_norm=norm)
                s = e.open_stream(*hw)
                raw[dev, norm] = np.stack([e.push(s, *window(k))
                                           for k in range(SERVE_CPU)])
        cpu_err = float(np.abs(raw[device, "none"] - raw["cpu", "none"]).max())
        check(cpu_err <= TOL_RECON, f"serve: card vs CPU engine raw frames "
              f"{cpu_err} > {TOL_RECON}")
        robust_cpu_err = float(np.abs(raw[device, "robust"]
                                      - raw["cpu", "robust"]).max())

        # a 4-lane group with an idle lane against solo streams
        lanes = [[window(40 + 3 * j + t) for t in range(3)] for j in range(4)]
        idle = (1, 3)
        gid = eng.open_group(4, *hw)
        got = [eng.push_group(gid, [None if (t, j) == idle else lanes[j][t]
                                    for j in range(4)]) for t in range(3)]
        group_err = 0.0
        for j in range(4):
            s = eng.open_stream(*hw)
            for t in range(3):
                w = serve._empty_window() if (t, j) == idle else lanes[j][t]
                group_err = max(group_err, float(np.abs(
                    got[t][j] - eng.push(s, *w)).max()))
        check(group_err <= TOL_SERVE_GROUP, f"serve: 4-lane group vs solo "
              f"streams {group_err} > {TOL_SERVE_GROUP}")

        # 4 threads at once on 4 streams and 2 groups of 4 lanes (threads 0
        # and 1 push to a group between their stream's pushes), against the
        # same pushes made one thread after another
        def job(e, ids, k):
            out = []
            for t in range(SERVE_THREAD_PUSHES):
                out.append(e.push(ids[k], *window(10 * k + t)))
                if k < 2:
                    out.append(e.push_group(ids[4 + k], [
                        window(50 + 8 * k + t + j) for j in range(4)]))
            return out

        def open_all(e):
            return ([e.open_stream(*hw) for _ in range(4)]
                    + [e.open_group(4, *hw) for _ in range(2)])

        serial_eng = engine("E2VID")
        ids = open_all(serial_eng)
        serial = [job(serial_eng, ids, k) for k in range(4)]
        threaded_eng = engine("E2VID")
        ids = open_all(threaded_eng)
        threaded, errors = [None] * 4, []
        barrier = threading.Barrier(4)

        def worker(k):
            try:
                barrier.wait(60)
                threaded[k] = job(threaded_eng, ids, k)
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(repr(exc))

        workers = [threading.Thread(target=worker, args=(k,), daemon=True)
                   for k in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(300)
        check(not errors and not any(w.is_alive() for w in workers),
              f"serve threads: {errors or 'a thread did not end'}")
        thread_err = max(float(np.abs(a - b).max())
                         for s, t in zip(serial, threaded)
                         for a, b in zip(s, t))
        check(thread_err <= TOL_LOCKSTEP, f"serve threads vs serial "
              f"{thread_err} > {TOL_LOCKSTEP}")
    emit({"phase": "serve_correctness", "card": card,
          "offline_pushes": SERVE_OFFLINE,
          "max_abs_err_vs_offline_runner": offline_err,
          "cpu_pushes": SERVE_CPU, "raw_max_abs_err_vs_cpu": cpu_err,
          "robust_frames_max_abs_err_vs_cpu": robust_cpu_err,
          "group_idle_lane_max_abs_err_vs_solo": group_err,
          "threads_max_abs_err_vs_serial": thread_err,
          "threads_bit_equal_to_serial": thread_err == 0.0})

    # the voxelizer at the serve shapes and the training launch's T = 8, on
    # the packer's buffers: the routed call and both private paths held to
    # the int64 plain version here, the tiled accumulate kernel's grid as
    # its launch reports it; the timings from a fresh process
    tiles = vc.tile_count(vc.tile_plan(c["b"], *hw), *hw)
    checked = {}
    for prec, wire in SERVE_WIRES:
        for label, t_n in SERVE_SHAPES:
            bufs = serve_shape_bufs(torch, serve, wins, hw, cap, wire, t_n,
                                    device)
            err, got = hold_to_plain(torch, vox, bufs, c["b"], hw, prec,
                                     f"serve {label} ({wire} wire)")
            fns = {p: path_fn(vc, bufs, c["b"], hw, prec, p)
                   for p in ("direct", "tiled")}
            for p, fn in fns.items():
                out = fn()
                torch.cuda.synchronize()
                check(torch.equal(out, got), f"voxelizer serve {label} "
                      f"({wire} wire, {prec}): the {p} path differs from "
                      f"the int64 plain version")
            checked.setdefault(prec, {})[label] = dict(
                max_abs_err=err, route=vc.route((t_n, cap)),
                tiles_per_window=tiles,
                accumulate_blocks=vc.last_accumulate_grid(),
                # beside the fresh process's: this one has run the profiler
                host_enqueue_us_profiled_process={
                    p: host_enqueue_us(torch, fn) for p, fn in fns.items()})
            check(scratch_is_zero(vc), f"voxelizer serve {label}: the "
                  f"direct path left its scratch non-zero")
    timed = serve_voxelizer_times()
    shapes = {prec: {label: dict(timed["shapes"][prec][label], **v)
                     for label, v in by_label.items()}
              for prec, by_label in checked.items()}
    floor = timed["launch_floor"]
    emit({"phase": "serve_voxelizer", "card": card, "shapes": shapes,
          "launch_floor": floor, "timed_in": timed["timed_in"]})
    result = {"phase": "serve", "card": card, "sensor": list(hw),
              "events_per_window": EVENTS_PER_WINDOW, "capacity": cap,
              "latency": lat, "groups": groups, "socket": sock,
              "launches": launches, "launches_by_path": paths,
              "voxelize_at_serve_shapes": shapes, "launch_floor": floor,
              "bit_equal_int64_plain": True,
              "phase_s": time.perf_counter() - t_phase}
    emit(result)
    return result


SERVE_WIRES = (("highest", "f32"), ("default", "compact4"))


def serve_shape_bufs(torch, serve, windows, hw, cap, wire, t_n, device):
    """The packer's ``(t_n, cap)`` buffers of ``windows[:t_n]`` on
    ``wire``, on ``device``: a push's (T = 1) or a group's."""
    from evreal_tpu_torch.data.packing import alloc_buffers, wire_dtypes

    dtypes = wire_dtypes(wire, True, hw)
    host = alloc_buffers((t_n, 1), cap, dtypes)
    for j in range(t_n):
        serve._pack_window(*windows[j], capacity=cap, dtypes=dtypes,
                           resolution=hw,
                           out={k: v[j] for k, v in host.items()})
    return {k: torch.from_numpy(v.reshape((t_n,) + v.shape[2:])).to(device)
            for k, v in host.items()}


def time_serve_voxelizer(torch, vc, vox, device="cuda"):
    """The voxelizer's times at the serve shapes (phase 9's buffers): per
    precision and shape the routed call beside its plain version,
    ``index_add_`` and its bound (``time_variant``), both paths in turns
    (CUDA events) and their host enqueue (two rounds in turns); the launch
    floor (1 and 2 empty kernels through the direct path's binding); last,
    each path's device time from the profiler, since a process that has
    run the profiler enqueues every operation more slowly afterwards."""
    from evreal_tpu_torch import serve
    from evreal_tpu_torch.data.packing import bucket_capacity

    hw = (ECD["h"], ECD["w"])
    cap = bucket_capacity(EVENTS_PER_WINDOW)
    wins = serve_windows(SERVE_POOL, hw)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    shapes, calls = {}, {}
    for prec, wire in SERVE_WIRES:
        for label, t_n in SERVE_SHAPES:
            bufs = serve_shape_bufs(torch, serve, wins, hw, cap, wire, t_n,
                                    device)
            fns = {p: path_fn(vc, bufs, ECD["b"], hw, prec, p)
                   for p in vc.PATHS}
            ms = time_turns(torch, fns, flush)
            host_us = {p: [] for p in vc.PATHS}
            for p in ("tiled", "direct", "direct", "tiled"):
                host_us[p].append(host_enqueue_us(torch, fns[p]))
            shapes.setdefault(prec, {})[label] = dict(
                time_variant(torch, vox, bufs, prec, hw, ECD["b"]),
                wire=wire, capacity=cap,
                paths={p: {"ms": ms[p], "host_enqueue_us": host_us[p]}
                       for p in vc.PATHS})
            calls[prec, label] = fns
    noop = {n: (lambda n=n: vc._launch_noop(device, n)) for n in (1, 2)}
    noop_ms = time_turns(torch, noop, flush)
    floor = {f"{n}_launches": {"ms": noop_ms[n],
                               "host_enqueue_us": host_enqueue_us(torch, fn)}
             for n, fn in noop.items()}
    for (prec, label), fns in calls.items():
        for p, fn in fns.items():
            shapes[prec][label]["paths"][p]["device_us"] = path_device_us(
                torch, fn)
    return {"shapes": shapes, "launch_floor": floor}


def serve_voxelizer_times():
    """``time_serve_voxelizer`` in a fresh process of this script (``python3
    chip_smoke.py --serve-voxelizer-times``, on the same card): this
    process has run the profiler, which slows its enqueues by 1.5-2x."""
    proc = subprocess.run([sys.executable, SCRIPT, "--serve-voxelizer-times"],
                          capture_output=True, text=True, timeout=900,
                          check=False)
    check(proc.returncode == 0, f"serve voxelizer times: exit "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    return dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                timed_in="a fresh process (--serve-voxelizer-times)")


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("firenet", "e2vid")
TRAIN_SEQS = 2          # synthetic 180 x 240 sequences with frames
TRAIN_WINDOWS = 48      # windows a sequence (30,000 events each)
TRAIN_BATCH = 4
TRAIN_CHUNK_T = 8
TRAIN_STEPS = 12        # CLI steps an arch; ms/step over the steps after 2
TRAIN_LEARN_STEPS = 5   # make_train_step on one fixed batch, lr 1e-3
TRAIN_TIMED = 3         # steps timed per variant (remat, deterministic)
TOL_TRAIN_LOSS = 1e-5   # card vs CPU loss, relative
TOL_TRAIN_GRAD = 1e-4   # card vs CPU (float64) gradient, x max|g| of
                        # the tensor, or the CPU's own f32 error if larger
TOL_TRAIN_RESUME = 1e-5  # tests/test_train_cli.py:50-53
TRAIN_VARIANTS = ("nhwc_deterministic", "nhwc_default_algorithms",
                  "nchw_deterministic")


def train_cli_run(torch, argv, sync):
    """``train_cli.main(argv)`` with its stdout captured and the host clock
    read after each step (the step's loss synchronized, as ``--log-every
    1`` does): (stdout, the clock readings, the losses of the log)."""
    import contextlib
    import io

    from evreal_tpu_torch import train, train_cli

    stamps = []
    real = train.make_train_step

    def make(*a, **k):
        step, opt = real(*a, **k)

        def timed(batch):
            loss = step(batch)
            sync()
            stamps.append(time.perf_counter())
            return loss
        return timed, opt

    buf = io.StringIO()
    train.make_train_step = make
    try:
        with contextlib.redirect_stdout(buf):
            train_cli.main(argv)
    finally:
        train.make_train_step = real
    out = buf.getvalue()
    losses = [float(m.group(1)) for m in re.finditer(
        r"^step \d+: loss (\S+)", out, re.M)]
    return out, stamps, losses


def train_setup(torch, arch, data, device, lr=1e-4, remat=True):
    """The CLI's pieces built by hand: (model, step, sample) where
    ``sample(seed, k, batch, chunk_t)`` is the batch the CLI samples at
    step k, and ``sample.launched`` the buffers of its voxelizer
    launches."""
    import glob

    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.harness.runner import make_voxel_stage
    from evreal_tpu_torch.ops.pad import CropParams
    from evreal_tpu_torch.train import build_optimizer, make_train_step
    from evreal_tpu_torch.train_cli import build, sample_batch
    from evreal_tpu_torch.utils import upload

    seqs = [Sequence(d, num_bins=ECD["b"],
                     voxel_method={"method": "between_frames"})
            for d in sorted(glob.glob(os.path.join(data, "*")))]
    h, w = seqs[0].sensor_resolution
    crop = CropParams(w, h, 3)
    stage = make_voxel_stage(ECD["b"], (h, w), False)
    launched = []

    def voxelize(buffers):
        bufs = upload(buffers, device)
        launched.append(bufs)
        return crop.pad(stage(bufs))

    def sample(seed, k, batch=TRAIN_BATCH, chunk_t=TRAIN_CHUNK_T):
        launched.clear()
        return sample_batch(seqs, voxelize, np.random.default_rng((seed, k)),
                            batch, chunk_t, ECD["b"], crop)

    model, _ = build(arch, ECD["b"], device)
    step, _ = make_train_step(model, build_optimizer(lr), remat=remat)
    sample.launched = launched
    return model, step, sample


def loss_and_grads(torch, model, batch, loss, lpips_weights):
    """The chunk's loss and every parameter's gradient (host float64
    copies), forward and backward under the trainer's precision context,
    in the model's dtype (LPIPS in float64 too, given float64 weights)."""
    from evreal_tpu_torch import train

    model.zero_grad(set_to_none=True)
    dtype = next(model.parameters()).dtype
    with train.training_precision():
        val = train.sequence_loss(
            model, batch["voxels"].to(dtype), batch["frames"].to(dtype),
            loss=loss, lpips_weights=lpips_weights,
            mask=batch["mask"].to(dtype))
        val.backward()
    return float(val.detach()), {
        k: p.grad.detach().cpu().double().numpy()
        for k, p in model.named_parameters()}


def grad_err(got, want):
    """The largest per-tensor error of ``got`` against ``want``, in units
    of the tensor's max |want|: (error, tensor name)."""
    return max((float(np.abs(got[k] - want[k]).max()
                      / max(np.abs(want[k]).max(), 1e-30)), k) for k in want)


@contextmanager
def train_variant(torch, model, label):
    """The training step as shipped ("nhwc_deterministic"), with cuDNN's
    default algorithms ("nhwc_default_algorithms"), or with NCHW tensors
    ("nchw_deterministic"), for ``model`` (on the card) in the block."""
    from evreal_tpu_torch import train
    from evreal_tpu_torch.utils import f32_parity

    saved = (train.training_precision, train.channels_last)
    if label == "nhwc_default_algorithms":
        train.training_precision = f32_parity
    if label == "nchw_deterministic":
        train.channels_last = lambda tree: tree
        model.to(memory_format=torch.contiguous_format)
    try:
        yield
    finally:
        train.training_precision, train.channels_last = saved
        model.to(memory_format=torch.channels_last)


def timed_steps(step, batch, n, sync):
    """Host ms of ``n`` steps on ``batch``, each ending synchronized."""
    return timed_calls(lambda b: (step(b), sync()), lambda k: batch, 0,
                       n)[0]


def phase_train(torch, vc, vox, work, card, device="cuda"):
    """Training on the card (``evreal_tpu_torch/train_cli.py``,
    ``train.py``) at the published widths on synthetic 180 x 240 sequences
    with frames: both archs through ``train_cli.main`` (every loss finite,
    ms per step, the launches counted, ``model.npz`` loaded back and run);
    the loss falling over 5 steps on a fixed batch; peak memory and step
    time with remat on and off; the shipped step against cuDNN's default
    algorithms and NCHW tensors; one profiled step; a card step against
    the CPU in f32 and float64 (loss and every gradient) for mse and
    mse+lpips; resume against an uninterrupted run; the voxelizer at the
    training launch (T = 8, f32 wire) bit-equal to its int64 plain version
    and timed."""
    from evreal_tpu_torch.harness.runner import load_method_params
    from evreal_tpu_torch.models import build_from_meta
    from evreal_tpu_torch.utils import f32_parity

    def sync():
        torch.cuda.synchronize()

    hw = (ECD["h"], ECD["w"])
    t_phase = time.perf_counter()
    root = os.path.join(work, "train")
    data = os.path.join(root, "data")
    for j in range(TRAIN_SEQS):
        make_sequence(os.path.join(data, f"seq{j}"), *hw, TRAIN_WINDOWS,
                      EVENTS_PER_WINDOW, seed=200 + j)
    common = ["--data", data, "--batch", str(TRAIN_BATCH), "--chunk-t",
              str(TRAIN_CHUNK_T), "--log-every", "1", "--device", device]
    result = {"phase": "train", "card": card, "sensor": list(hw),
              "batch": TRAIN_BATCH, "chunk_t": TRAIN_CHUNK_T,
              "events_per_window": EVENTS_PER_WINDOW, "archs": {},
              "launches": {}}
    f32 = dict(EVREAL_DTYPE=None, EVREAL_WIRE=None,
               EVREAL_VOXEL_PRECISION=None)
    with env(**f32):
        for arch in TRAIN_ARCHS:
            res = {}
            out_dir = os.path.join(root, arch)
            vc.reset_launches()
            _, stamps, losses = train_cli_run(torch, common + [
                "--arch", arch, "--steps", str(TRAIN_STEPS), "--out",
                out_dir], sync)
            sync()
            got = dict(vc.launches_by_precision)
            want = dict(dict.fromkeys(vc.PRECISIONS, 0),
                        highest=TRAIN_BATCH * TRAIN_STEPS)
            check(got == want, f"train {arch}: voxelizer launches {got}, "
                  f"want {want} (one per sampled chunk)")
            result["launches"][f"train_{arch}"] = got
            check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
                  f"train {arch}: losses {losses}")
            ms = np.diff(stamps)[1:] * 1e3  # the steps after the first 2
            res.update(losses=losses, ms_per_step=float(np.median(ms)),
                       ms_per_step_all=[float(x) for x in ms],
                       steps_per_s=float(1e3 / np.median(ms)))
            # the trained model.npz through the eval loader, one forward
            sd, meta = load_method_params({"model_name": arch, "model_path":
                                           os.path.join(out_dir,
                                                        "model.npz")})
            model = build_from_meta(meta, sd)
            model.load_state_dict(sd, strict=True)
            model = model.to(device).eval()
            ph, pw = -(-hw[0] // 8) * 8, -(-hw[1] // 8) * 8
            with torch.no_grad(), f32_parity():
                out, _ = model(torch.randn(1, ECD["b"], ph, pw,
                                           device=device),
                               model.init_state(1, ph, pw, device=device))
            check(bool(torch.isfinite(out["image"]).all()),
                  f"train {arch}: the reloaded model.npz gives non-finite "
                  f"frames")
            res["reloaded_meta"] = meta

            # learning: 5 steps on one fixed batch at lr 1e-3
            _, step, sample = train_setup(torch, arch, data, device, lr=1e-3)
            fixed = sample(0, 1)
            learn = [float(step(fixed)) for _ in range(TRAIN_LEARN_STEPS)]
            check(np.isfinite(learn).all() and learn[-1] < learn[0],
                  f"train {arch}: the loss did not fall on a fixed batch: "
                  f"{learn}")
            res["fixed_batch_losses_lr1e-3"] = learn

            # peak memory and step time, remat on and off
            for remat in (True, False):
                model, step, _ = train_setup(torch, arch, data, device,
                                             remat=remat)
                step(fixed)  # the optimizer state exists after one step
                sync()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                ms = timed_steps(step, fixed, TRAIN_TIMED, sync)
                res[f"remat_{'on' if remat else 'off'}"] = {
                    "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                    "resident_mib": base / 2**20,
                    "ms_per_step_fixed_batch": float(np.median(ms))}
                del model, step

            # the shipped step against cuDNN's default algorithms and
            # against NCHW tensors, in turns
            model, step, _ = train_setup(torch, arch, data, device)
            step(fixed)
            times = {label: [] for label in TRAIN_VARIANTS}
            for _ in range(2):
                for label in TRAIN_VARIANTS:
                    with train_variant(torch, model, label):
                        times[label] += timed_steps(step, fixed,
                                                    TRAIN_TIMED, sync)
            res["ms_per_step_by_variant"] = {
                k: float(np.median(v)) for k, v in times.items()}

            # one profiled step as the CLI makes it (sample, step, loss)
            res["profile"] = profile_calls(
                torch, lambda k: float(step(sample(0, 100 + k))), 1,
                n_top=12)
            del model, step
            result["archs"][arch] = res
            emit({"phase": "train_arch", "arch": arch, "card": card, **res,
                  "launches": got})

        # card vs CPU: one E2VID step at full width from the same params
        # and batch (batch 1, chunk 2), TF32 off. The gradients are held
        # to the CPU's in float64: the CPU's own f32 gradient of the pred
        # bias (a sum over 44,160 pixels) is further from it than the
        # card's (reported)
        lw_path = os.path.join(root, "lpips_alex.npz")
        write_lpips_npz(lw_path)
        from evreal_tpu_torch.metrics.lpips import load_weights

        lw = {k: torch.from_numpy(v) for k, v in load_weights(
            lw_path).items()}
        lw_card = {k: v.to(device) for k, v in lw.items()}
        lw64 = {k: v.double() for k, v in lw.items()}
        card_model, _, sample = train_setup(torch, "e2vid", data, device)
        cpu_model = train_setup(torch, "e2vid", data, "cpu")[0]
        cpu64 = train_setup(torch, "e2vid", data, "cpu")[0].double()
        small = sample(0, 1, batch=1, chunk_t=2)
        small_cpu = {k: v.cpu() for k, v in small.items()}
        vs_cpu = {}
        for loss in ("mse", "mse+lpips"):
            c_loss, c_grads = loss_and_grads(torch, card_model, small, loss,
                                             lw_card)
            h_loss, h_grads = loss_and_grads(torch, cpu_model, small_cpu,
                                             loss, lw)
            d_loss, d_grads = loss_and_grads(torch, cpu64, small_cpu, loss,
                                             lw64)
            loss_err = abs(c_loss - h_loss) / abs(h_loss)
            err, name = grad_err(c_grads, d_grads)
            vs_cpu[loss] = {
                "loss_card": c_loss, "loss_cpu": h_loss,
                "loss_cpu_f64": d_loss, "loss_rel_err": loss_err,
                "grad_err_vs_cpu_f64": [err, name],
                "grad_err_vs_cpu_f32": list(grad_err(c_grads, h_grads)),
                "cpu_f32_grad_err_vs_cpu_f64": list(grad_err(h_grads,
                                                             d_grads))}
            if loss == "mse":
                with train_variant(torch, card_model, "nchw_deterministic"):
                    nchw = loss_and_grads(torch, card_model, small, loss,
                                          lw_card)[1]
                vs_cpu[loss]["nchw_grad_err_vs_cpu_f64"] = list(
                    grad_err(nchw, d_grads))
        result["card_vs_cpu_e2vid"] = vs_cpu
        emit({"phase": "train_card_vs_cpu", "card": card, **vs_cpu})
        # the card within 1e-4 x max|g| of the float64 gradient, or no
        # further from it than the CPU's own f32 gradient (LPIPS's f32
        # backward is conditioned beyond 1e-4 on any device)
        for loss, r in vs_cpu.items():
            bound = max(TOL_TRAIN_GRAD, r["cpu_f32_grad_err_vs_cpu_f64"][0])
            check(r["loss_rel_err"] <= TOL_TRAIN_LOSS
                  and r["grad_err_vs_cpu_f64"][0] <= bound,
                  f"train card vs CPU ({loss}): loss rel err "
                  f"{r['loss_rel_err']} (<= {TOL_TRAIN_LOSS}), gradient err "
                  f"{r['grad_err_vs_cpu_f64']} x max|g| against the CPU in "
                  f"float64 (<= {bound})")

        # resume: 2 steps with a checkpoint each, then --resume to 4,
        # against 4 uninterrupted steps
        resume = {}
        for arch in TRAIN_ARCHS:
            base = common + ["--arch", arch]
            full, part = (os.path.join(root, f"{arch}_{n}")
                          for n in ("full", "resumed"))
            train_cli_run(torch, base + ["--steps", "4", "--out", full],
                          sync)
            train_cli_run(torch, base + ["--steps", "2", "--save-every",
                                         "1", "--out", part], sync)
            out, _, _ = train_cli_run(torch, base + [
                "--steps", "4", "--save-every", "1", "--resume", "--out",
                part], sync)
            check("resumed from step 2" in out,
                  f"train {arch} resume: {out[:200]!r}")
            a = np.load(os.path.join(full, "model.npz"))
            b = np.load(os.path.join(part, "model.npz"))
            err = max(float(np.abs(a[k] - b[k]).max()) for k in a.files)
            resume[arch] = {"max_abs_err_vs_uninterrupted": err,
                            "bit_equal": err == 0.0}
        # FireNet is all convolutions: deterministic cuDNN makes it exact;
        # E2VID's bilinear upsample has an atomic backward (reported)
        check(resume["firenet"]["max_abs_err_vs_uninterrupted"]
              <= TOL_TRAIN_RESUME, f"train resume: {resume}")
        result["resume"] = resume

        # the voxelizer at the training launch: one step's launches on
        # their own buffers (T = 8, f32 wire), counted, held bit-equal to
        # the int64 plain version and timed
        _, _, sample = train_setup(torch, "e2vid", data, device)
        vc.reset_launches()
        sample(0, 1)
        sync()
        got = dict(vc.launches_by_precision)
        want = dict(dict.fromkeys(vc.PRECISIONS, 0), highest=TRAIN_BATCH)
        check(got == want, f"train: one step's voxelizer launches {got}, "
              f"want {want}")
        errs = [hold_to_plain(torch, vox, bufs, ECD["b"], hw, "highest",
                              f"train launch {j}")[0]
                for j, bufs in enumerate(sample.launched)]
        check(all(b["count"].shape == (TRAIN_CHUNK_T,)
                  for b in sample.launched),
              "train: a launch is not T = chunk_t windows")
        result["train_launch"] = dict(
            time_variant(torch, vox, sample.launched[0], "highest", hw,
                         ECD["b"]),
            max_abs_err=max(errs), launches_per_step=got["highest"],
            wire="f32")
    result["phase_s"] = time.perf_counter() - t_phase
    emit({k: v for k, v in result.items() if k != "archs"})
    return result


# ---------------------------------------------------------------------------
# phase 11: the device mesh (data parallel over the cards)
# ---------------------------------------------------------------------------

MESH_SERVE_WARMUP = 4   # push_group calls of the 16-lane group, untimed
MESH_SERVE_TIMED = 16   # and timed (host clock, frames on the host)
MESH_TRAIN_TIMED = 3    # steps timed after the checked one
MESH_TRAIN_DP = 2       # the training mesh's dp
TOL_MESH_PARAM = 3e-4   # tests/test_train_parallel.py:69


def mesh_devices(torch, device):
    """Every visible card when there are more than one, else the one card
    named twice (the split, per-shard dispatch and gather still run)."""
    if device == "cuda" and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device, 0) if device == "cuda"
            else torch.device(device)] * 2


def chunk_busy_ms(torch, runner, host, n):
    """Device busy ms and wall ms of one steady ``run`` of ``runner`` on
    the host buffers ``host`` (profiled after one warm run)."""
    from torch.profiler import ProfilerActivity, profile

    runner.run(runner.init_state(), runner.upload(host), n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(runner.init_state(), runner.upload(host), n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_time(torch, prof)[0], wall_ms


def phase_mesh(torch, vc, vox, work, card, device="cuda"):
    """The device mesh (``evreal_tpu_torch/parallel/mesh.py``) over every
    visible card, or over ``[cuda:0, cuda:0]`` on a one-card machine (then
    the split's overhead is measured, not scaling): E2VID at its published
    width on phase 5's 16 lanes x 96 windows, f32 and bf16 on compact4,
    sharded (``harness/batched.py:_EVAL_MESH``) against unsharded through
    ``evaluate`` (f32 rows within 1e-4, bf16 within mean 0.02 / max 0.2,
    frames/s of each, one voxelizer launch per shard per chunk); each
    shard's launch of chunk 0 bit-equal to the int64 plain version; a
    16-lane bf16 compact4 serve group sharded against unsharded; one
    training step at dp = 2 against the meshless one for both archs (loss
    1e-5 relative, parameters 3e-4, the reduced gradient 1e-4 x max|g|);
    ``cost_analysis`` FLOPs of the E2VID
    f32 chunk and its MFU from the chunk's device busy time."""
    from evreal_tpu_torch import serve, train
    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.data.packing import bucket_capacity
    from evreal_tpu_torch.harness import batched
    from evreal_tpu_torch.harness.runner import (MethodBundle, evaluate,
                                                 get_method_config)
    from evreal_tpu_torch.harness.timers import TimingLog
    from evreal_tpu_torch.parallel.mesh import make_mesh, split_lanes
    from evreal_tpu_torch.train_cli import build
    from evreal_tpu_torch.utils import upload
    from evreal_tpu_torch.utils.mfu import bf16_peak_tflops, mfu

    def sync():
        torch.cuda.synchronize()

    c = ECD
    hw = (c["h"], c["w"])
    t_phase = time.perf_counter()
    devices = mesh_devices(torch, device)
    dp = len(devices)
    mesh = make_mesh(dp, axes=("dp",), devices=devices)
    os.chdir(work)
    names = [f"seq{j:02d}" for j in range(N_LANES)]
    root = os.path.join(work, "data", "LOCK")
    n_chunks = -(-N_WINDOWS // CHUNK_T)
    result = {"phase": "mesh", "card": card,
              "cards": torch.cuda.device_count() if device == "cuda" else 0,
              "cards_smi": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True, text=True,
                  check=True).stdout.strip().splitlines()
              if device == "cuda" else [],
              "shards": [str(d) for d in devices], "dp": dp,
              "lanes": N_LANES, "windows_per_lane": N_WINDOWS,
              "launches": {}}
    f32 = dict(EVREAL_DTYPE=None, EVREAL_WIRE=None)
    bf16 = dict(EVREAL_DTYPE="bfloat16", EVREAL_WIRE="compact4")

    # lockstep through evaluate, unsharded then sharded, in each precision
    runs, trees = {}, {}
    try:
        for label, switches, prec in (("f32", f32, "highest"),
                                      ("bf16_compact4", bf16, "default")):
            for sharded in (False, True):
                key = f"{label}_{'sharded' if sharded else 'unsharded'}"
                batched._EVAL_MESH = mesh if sharded else None
                timings = TimingLog()
                vc.reset_launches()
                t1 = time.perf_counter()
                with env(**switches):
                    evaluate(["E2VID"], ["std"], ["LOCK"], ["mse", "ssim"],
                             device=device, timings=timings)
                sync()
                wall_s = time.perf_counter() - t1
                launches = dict(vc.launches_by_precision)
                want = dict(dict.fromkeys(vc.PRECISIONS, 0),
                            **{prec: n_chunks * (dp if sharded else 1)})
                check(launches == want, f"mesh {key}: voxelizer launches "
                      f"{launches}, want {want} (one per shard per chunk)")
                out = os.path.join("outputs", "std", "LOCK")
                trees[key] = {n: check_tree(
                    os.path.join(out, n, "E2VID"), N_WINDOWS, hw,
                    decode_frames=False,
                    may_skip={0} if prec == "default" else ())[0]
                    for n in names}
                os.rename(out, f"{out}_mesh_{key}")
                ms = timings.ms_per_frame("E2VID")
                runs[key] = {"launches": launches, "wall_s": wall_s,
                             "ms_per_frame_steady": ms,
                             "frames_per_s_steady": 1e3 / ms if ms else None}
                result["launches"][f"mesh_lockstep_{key}"] = launches
    finally:
        batched._EVAL_MESH = None
    rows = {}
    for label in ("f32", "bf16_compact4"):
        a, b = trees[f"{label}_unsharded"], trees[f"{label}_sharded"]
        check(all(a[n][m].keys() == b[n][m].keys() for n in names
                  for m in ("mse", "ssim")),
              f"mesh {label}: sharded and unsharded runs scored different "
              f"windows")
        d = np.array([abs(a[n][m][i] - b[n][m][i]) for n in names
                      for m in ("mse", "ssim") for i in a[n][m]])
        rows[label] = {"max_abs_err": float(d.max()),
                       "mean_abs_err": float(d.mean())}
    check(rows["f32"]["max_abs_err"] <= TOL_LOCKSTEP,
          f"mesh f32 rows sharded vs unsharded: {rows['f32']} > "
          f"{TOL_LOCKSTEP}")
    check(rows["bf16_compact4"]["mean_abs_err"] < BF16_MEAN
          and rows["bf16_compact4"]["max_abs_err"] < BF16_MAX,
          f"mesh bf16 rows sharded vs unsharded: {rows['bf16_compact4']}")
    result.update(lockstep=runs, rows_sharded_vs_unsharded=rows)

    # each shard's launch of chunk 0, on its device, bit-equal to the int64
    # plain version; shard 0's timed
    seqs = [Sequence(os.path.join(root, n), num_bins=c["b"]) for n in names]
    cap = bucket_capacity(EVENTS_PER_WINDOW)
    shard_launch = {}
    for wire, prec in (("f32", "highest"), ("compact4", "default")):
        errs, flats = [], []
        for s, (block, d) in enumerate(zip(
                split_lanes(pack_lanes(seqs, CHUNK_T, cap, wire), dp),
                devices)):
            flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                    for k, v in upload(block, d).items()}
            errs.append(hold_to_plain(torch, vox, flat, c["b"], hw, prec,
                                      f"mesh shard {s} {d} ({wire})")[0])
            flats.append(flat)
        shard_launch[prec] = dict(
            time_variant(torch, vox, flats[0], prec, hw, c["b"]),
            max_abs_err=max(errs), wire=wire, shards=dp)
    result["shard_launch"] = shard_launch

    # a 16-lane bf16 compact4 serve group, unsharded then sharded
    wins = serve_windows(SERVE_POOL, hw)
    served = {}
    try:
        with env(**bf16):
            for sharded in (False, True):
                key = "sharded" if sharded else "unsharded"
                batched._EVAL_MESH = mesh if sharded else None
                engine = serve.ReconEngine.from_method("E2VID",
                                                       device=device)
                gid = engine.open_group(N_LANES, *hw)
                check(isinstance(engine._groups[gid].runner,
                                 batched.ShardedRunner) == sharded,
                      f"mesh serve: the {key} group's runner")
                frames = []

                def push(ws):
                    frames.append(engine.push_group(gid, ws))

                vc.reset_launches()
                ms, _ = timed_calls(push, lambda k: [
                    wins[(k * N_LANES + j) % len(wins)]
                    for j in range(N_LANES)], MESH_SERVE_WARMUP,
                    MESH_SERVE_TIMED)
                sync()
                launches = dict(vc.launches_by_precision)
                n_push = MESH_SERVE_WARMUP + MESH_SERVE_TIMED
                want = dict(dict.fromkeys(vc.PRECISIONS, 0),
                            default=n_push * (dp if sharded else 1))
                check(launches == want, f"mesh serve {key}: voxelizer "
                      f"launches {launches}, want {want}")
                result["launches"][f"mesh_serve_bf16_{N_LANES}_lanes_{key}"] \
                    = launches
                served[key] = {"frames": np.stack(frames),
                               "ms_per_push_group": latency(ms),
                               "frames_per_s": N_LANES * 1e3
                               / float(np.median(ms))}
    finally:
        batched._EVAL_MESH = None
    a, b = served["unsharded"].pop("frames"), served["sharded"].pop("frames")
    check(np.array_equal(np.isnan(a), np.isnan(b)),
          "mesh serve: NaN frames differ sharded vs unsharded")
    d = np.abs(a - b)[np.isfinite(a)]
    serve_err = {"mean_abs_err": float(d.mean()),
                 "max_abs_err": float(d.max())}
    check(serve_err["mean_abs_err"] < BF16_MEAN
          and serve_err["max_abs_err"] < BF16_MAX,
          f"mesh serve frames sharded vs unsharded: {serve_err}")
    result["serve_group"] = dict(served, frames_sharded_vs_unsharded=serve_err)

    # one training step at dp = 2 against the meshless step
    data = os.path.join(work, "train", "data")
    train_mesh = make_mesh(MESH_TRAIN_DP, axes=("dp",),
                           devices=devices[:MESH_TRAIN_DP])
    trained = {}
    with env(**f32, EVREAL_VOXEL_PRECISION=None):
        for arch in TRAIN_ARCHS:
            model0, step0, sample = train_setup(torch, arch, data, device)
            batch = sample(0, 1)
            loss0 = float(step0(batch))
            model1, _ = build(arch, c["b"], device)
            step1, _ = train.make_train_step(model1, train.build_optimizer(),
                                             mesh=train_mesh)
            vc.reset_launches()
            batch = sample(0, 1)
            loss1 = float(step1(batch))
            sync()
            launches = dict(vc.launches_by_precision)
            # the first replica's reduced gradient against the meshless
            # one (Adam is invariant to a uniform scale of the gradient, so
            # the parameters alone cannot tell a sum from a mean)
            grad_err = max(
                float((p1.grad - p0.grad).abs().max()
                      / p0.grad.abs().max().clamp(min=1e-30))
                for p0, p1 in zip(model0.parameters(), model1.parameters()))
            result["launches"][f"mesh_train_{arch}_dp{MESH_TRAIN_DP}"] = \
                launches
            param_err = max(float((a - b).abs().max()) for a, b in zip(
                model0.state_dict().values(), model1.state_dict().values()))
            rel = abs(loss1 - loss0) / abs(loss0)
            check(rel <= TOL_TRAIN_LOSS and param_err <= TOL_MESH_PARAM
                  and grad_err <= TOL_TRAIN_GRAD,
                  f"mesh train {arch}: loss {loss1} vs meshless {loss0} "
                  f"(rel {rel}), parameters {param_err}, gradients "
                  f"{grad_err} x max|g|")
            trained[arch] = {
                "loss": loss1, "loss_meshless": loss0, "loss_rel_err": rel,
                "param_max_abs_err": param_err,
                "grad_max_err_x_max_g": grad_err, "launches": launches,
                "ms_per_step_meshless": float(np.median(timed_steps(
                    step0, batch, MESH_TRAIN_TIMED, sync))),
                "ms_per_step_dp": float(np.median(timed_steps(
                    step1, batch, MESH_TRAIN_TIMED, sync)))}
            del model0, model1, step0, step1
    result["train"] = trained

    # FLOPs of the E2VID f32 lockstep chunk and its MFU
    with env(**f32):
        cfg = get_method_config("E2VID")
        runner = MethodBundle("E2VID", cfg, device).batched_runner_for(
            hw, cfg, c["b"], N_LANES)
        host = pack_lanes(seqs, CHUNK_T, cap, "f32")
        vc.reset_launches()
        t1 = time.perf_counter()
        flops, nbytes = runner.cost_analysis(runner.init_state(), host)
        count_s = time.perf_counter() - t1
        check(vc.launch_count() == 0 and nbytes is None and flops > 0,
              f"mesh cost_analysis: flops {flops}, bytes {nbytes}, "
              f"launches {vc.launch_count()}")
        busy_ms, wall_ms = chunk_busy_ms(torch, runner, host, CHUNK_T)
    achieved, frac = (mfu(flops, busy_ms / 1e3, device) if busy_ms
                      else (None, None))
    result["cost"] = {
        "path": f"E2VID f32 lockstep chunk, {N_LANES} x {CHUNK_T} windows",
        "flops": flops, "flops_per_window": flops / (N_LANES * CHUNK_T),
        "count_s": count_s, "device_busy_ms": busy_ms, "wall_ms": wall_ms,
        "tflops_per_s_busy": achieved, "mfu_busy": frac,
        "tflops_per_s_wall": flops / (wall_ms / 1e3) / 1e12,
        "peak_tflops_bf16": bf16_peak_tflops(device)}
    result["phase_s"] = time.perf_counter() - t_phase
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 12: the native packer, EVREAL_PRECISION and EVREAL_PROFILE
# ---------------------------------------------------------------------------

PACK_ROUNDS = 5       # host ms per chunk: medians of rounds in turns
NATIVE_RUNS = ("native", "numpy", "numpy", "native", "native", "numpy")
PROFILE_WINDOWS = 32  # the EVREAL_PROFILE run: one chunk of phase 4's


def pack_chunks(shape, way):
    """Pack one of ``phase_native``'s shapes with the native packer
    (``EVREAL_NATIVE`` unset) or numpy (``=0``); returns the buffers."""
    from evreal_tpu_torch.data import pack_windows

    with env(EVREAL_NATIVE=None if way == "native" else "0"):
        if shape["kind"] == "train":
            return [pack_windows(seq, idxs)[0]
                    for seq, idxs in shape["chunks"]]
        pool = shape["pool"]()
        for lanes in shape["chunks"]:  # each chunk over the last one's
            if shape["lanes"]:
                pool["count"][:] = 0  # harness/batched.py's dispatch
            for j, (seq, idxs) in enumerate(lanes):
                pack_windows(seq, idxs, capacity=shape["capacity"],
                             out={k: (v[j] if shape["lanes"] else v)[
                                 :len(idxs)] for k, v in pool.items()},
                             out_zeroed=False)
        return [pool]


def native_shapes(work, eval_root):
    """The main path's pack calls, by the shapes and buffers each path
    gives the packer: {label: shape}."""
    from evreal_tpu_torch.data import Sequence, plan_capacity
    from evreal_tpu_torch.data.packing import alloc_buffers, wire_dtypes

    b = ECD["b"]
    syn = Sequence(os.path.join(work, "data", "SYN", "seq0"), num_bins=b)
    lock = [Sequence(os.path.join(work, "data", "LOCK", f"seq{j:02d}"),
                     num_bins=b) for j in range(N_LANES)]
    csyn = Sequence(os.path.join(eval_root, "data", "CSYN", "seq0"),
                    num_bins=b)
    train = [Sequence(os.path.join(work, "train", "data", f"seq{j}"),
                      num_bins=b) for j in range(TRAIN_SEQS)]
    rng = np.random.default_rng(0)
    train_chunks = []
    for _ in range(TRAIN_BATCH):  # train_cli.sample_batch's draws
        seq = train[rng.integers(len(train))]
        start = int(rng.integers(max(len(seq) - TRAIN_CHUNK_T, 1)))
        train_chunks.append((seq, list(range(start, start + TRAIN_CHUNK_T))))

    def single(seq, t, wire):
        cap = plan_capacity(m["event_count"] for m in seq.windows())
        dtypes = wire_dtypes(wire, True, seq.sensor_resolution)
        return {"kind": "pool", "lanes": False, "wire": wire,
                "capacity": cap,
                "windows": t, "sensor": list(seq.sensor_resolution),
                "dtypes": {k: np.dtype(v).name for k, v in dtypes.items()},
                "pool": lambda: alloc_buffers((t,), cap, dtypes),
                "chunks": [[(seq, list(range(k * t, (k + 1) * t)))]
                           for k in range(2)]}

    lock_cap = plan_capacity(m["event_count"] for s in lock
                             for m in s.windows())
    lock_dtypes = wire_dtypes("compact4", True, lock[0].sensor_resolution)
    return {
        "single_f32_T32": single(syn, CHUNK_T, "f32"),
        "lockstep_compact4_16x32": {
            "kind": "pool", "lanes": True, "wire": "compact4",
            "capacity": lock_cap,
            "windows": N_LANES * CHUNK_T,
            "sensor": list(lock[0].sensor_resolution),
            "dtypes": {k: np.dtype(v).name for k, v in lock_dtypes.items()},
            "pool": lambda: alloc_buffers((N_LANES, CHUNK_T), lock_cap,
                                          lock_dtypes),
            "chunks": [[(s, list(range(k * CHUNK_T, (k + 1) * CHUNK_T)))
                        for s in lock] for k in range(2)]},
        "train_batch_4x8_f32": {
            "kind": "train", "wire": "f32", "windows": TRAIN_BATCH
            * TRAIN_CHUNK_T, "sensor": list(train[0].sensor_resolution),
            "chunks": train_chunks},
        "color_T16_260x346_f32": single(csyn, COLOR_CHUNK_T, "f32"),
        "compact_u8_T32": single(syn, CHUNK_T, "compact"),
        "compact_i16_T16_260x346": single(csyn, COLOR_CHUNK_T, "compact"),
    }


def tree_digest(base):
    """{relative path: sha256 of the file's bytes} of a tree."""
    import hashlib

    out = {}
    for dirpath, _, files in os.walk(base):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, base)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def native_evaluate(native, vc, label, dataset, config, switches, device,
                    tag):
    """One ``evaluate`` of E2VID with its stdout captured (no contained
    exception), the native pack calls and the voxelizer's launches counted
    from 0; its output tree moved to ``outputs_native/<tag>``. Returns
    (ms/frame, wall s, pack calls, launches, tree dir)."""
    native.reset_pack_calls()
    _, launches, ms, wall_s, _ = capture_evaluate(
        vc, ["E2VID"], config, dataset, label, device, switches)
    calls = dict(native.pack_calls)
    dst = os.path.join("outputs_native", tag)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    os.rename(os.path.join("outputs", config, dataset), dst)
    return ms, wall_s, calls, launches, dst


def phase_native(torch, vc, work, card, build_info, device="cuda"):
    """The native event packer (``evreal_tpu_torch/native/packer.cpp``),
    ``EVREAL_PRECISION`` and ``EVREAL_PROFILE`` on the card's machine."""
    import io
    import shutil
    from contextlib import redirect_stdout

    from evreal_tpu_torch import native
    from evreal_tpu_torch.harness.runner import evaluate

    t_phase = time.perf_counter()
    eval_root = os.path.join(work, "eval_configs")
    result = {"phase": "native", "card": card, "build": build_info}

    # bit-equality and host ms per chunk at the main path's shapes
    shapes = native_shapes(work, eval_root)
    pack = {}
    for label, shape in shapes.items():
        got = {way: pack_chunks(shape, way) for way in ("native", "numpy")}
        equal = all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                    for a, b in zip(got["native"], got["numpy"]) for k in a)
        check(equal, f"native packer vs numpy at {label}: not bit-equal")
        native.reset_pack_calls()
        pack_chunks(shape, "native")
        calls = sum(native.pack_calls.values())
        check(calls == sum(len(c) if shape["kind"] == "pool" else 1
                           for c in shape["chunks"]),
              f"{label}: {calls} native pack calls")
        n_chunks = len(shape["chunks"]) if shape["kind"] == "pool" else 1
        times = {"native": [], "numpy": []}
        for r in range(PACK_ROUNDS):
            for way in (("native", "numpy") if r % 2 == 0
                        else ("numpy", "native")):
                t0 = time.perf_counter()
                pack_chunks(shape, way)
                times[way].append((time.perf_counter() - t0) * 1e3
                                  / n_chunks)
        ms = {w: float(np.median(v)) for w, v in times.items()}
        pack[label] = {k: shape[k] for k in ("wire", "windows", "sensor")
                       if k in shape}
        pack[label].update(
            capacity=shape.get("capacity"), bit_equal=True,
            native_calls_per_pack=calls, host_ms_per_chunk=ms,
            host_ms_per_chunk_rounds={w: [float(x) for x in v]
                                      for w, v in times.items()},
            numpy_over_native=ms["numpy"] / ms["native"])
    result["pack"] = pack

    # end to end: single f32 and 16-lane bf16 compact4 lockstep with the
    # native packer and EVREAL_NATIVE=0, in turns; the trees byte-equal
    os.chdir(work)
    n_chunks = -(-N_WINDOWS // CHUNK_T)
    e2e = {}
    for label, dataset, switches, want in (
            ("single_f32", "SYN", dict(EVREAL_DTYPE=None, EVREAL_WIRE=None),
             {"f32": n_chunks, "compact": 0, "compact4": 0}),
            ("lockstep_bf16_compact4", "LOCK",
             dict(EVREAL_DTYPE="bfloat16", EVREAL_WIRE="compact4"),
             {"f32": 0, "compact": 0, "compact4": N_LANES * n_chunks})):
        runs = []
        for k, way in enumerate(NATIVE_RUNS):
            ms, wall_s, calls, launches, dst = native_evaluate(
                native, vc, f"{label} {way}", dataset, "std",
                dict(switches, EVREAL_NATIVE=None if way == "native"
                     else "0", EVREAL_PRECISION=None), device,
                f"{label}_{k}_{way}")
            check(calls == (want if way == "native"
                            else dict.fromkeys(native.WIRES, 0)),
                  f"{label} {way}: native pack calls {calls}")
            runs.append({"way": way, "ms_per_frame_steady": ms,
                         "wall_s": wall_s, "native_pack_calls": calls,
                         "voxelize_launches": launches, "tree": dst})
        trees = [tree_digest(r.pop("tree")) for r in runs]
        check(trees[0] == trees[1] and len(trees[0]) > N_WINDOWS,
              f"{label}: the native and EVREAL_NATIVE=0 trees differ "
              f"({sum(trees[0].get(p) != v for p, v in trees[1].items())} "
              f"files)")
        by_way = {w: [r["ms_per_frame_steady"] for r in runs
                      if r["way"] == w] for w in ("native", "numpy")}
        e2e[label] = {"runs": runs, "trees_byte_equal": True,
                      "trees_all_four_equal": all(t == trees[0]
                                                  for t in trees),
                      "files": len(trees[0]),
                      "ms_per_frame": by_way,
                      "ms_per_frame_delta_numpy_minus_native": float(
                          np.mean(by_way["numpy"])
                          - np.mean(by_way["native"]))}
    # the training path: train_cli's sampled chunks through the packer
    native.reset_pack_calls()
    train_cli_run(torch, [
        "--data", os.path.join(work, "train", "data"), "--batch",
        str(TRAIN_BATCH), "--chunk-t", str(TRAIN_CHUNK_T), "--device",
        device, "--arch", "firenet", "--steps", "2", "--out",
        os.path.join(work, "train_native")], torch.cuda.synchronize)
    train_calls = dict(native.pack_calls)
    check(train_calls == {"f32": 2 * TRAIN_BATCH, "compact": 0,
                          "compact4": 0},
          f"train_cli: native pack calls {train_calls}")
    e2e["train_firenet_2_steps"] = {"native_pack_calls": train_calls}
    result["end_to_end"] = e2e

    # EVREAL_PRECISION: TF32 inside the model stage under "high", off
    # after it; rows and ms/frame against "highest"; "fastest" contained
    seen = []

    def record(module, args, out):
        if isinstance(module, torch.nn.Conv2d):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))

    saved_flags = (torch.backends.cudnn.allow_tf32,
                   torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    precision = {}
    try:
        for label, dataset, config, root in (
                ("single_f32", "SYN", "std", work),
                ("color_f32", "CSYN", "color", eval_root)):
            os.chdir(root)
            runs, flags_in = [], {}
            for k, prec in enumerate(("high", "highest", "highest", "high")):
                seen.clear()
                hook = torch.nn.modules.module.register_module_forward_hook(
                    record)
                try:
                    ms, wall_s, _, _, dst = native_evaluate(
                        native, vc, f"{label} {prec}", dataset, config,
                        dict(EVREAL_DTYPE=None, EVREAL_WIRE=None,
                             EVREAL_CHUNK_T=None, EVREAL_PRECISION=prec),
                        device, f"precision_{label}_{k}_{prec}")
                finally:
                    hook.remove()
                after = (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32)
                want = (prec == "high",) * 2
                check(seen and set(seen) == {want}, f"{label} "
                      f"EVREAL_PRECISION={prec}: TF32 flags {set(seen)} in "
                      f"the model stage, want {want}")
                check(after == (False, False), f"{label} {prec}: TF32 "
                      f"flags {after} after the run, want them off")
                flags_in[prec] = list(want)
                runs.append({"precision": prec, "ms_per_frame_steady": ms,
                             "wall_s": wall_s, "dir": dst})
            by_prec = {p: [r for r in runs if r["precision"] == p]
                       for p in ("high", "highest")}
            hw = COLOR_HW if config == "color" else (ECD["h"], ECD["w"])
            if config == "color":
                frames = {p: check_color_tree(os.path.join(
                    v[0]["dir"], "seq0", "E2VID"), COLOR_WINDOWS, hw)
                    for p, v in by_prec.items()}
                d = np.abs(np.stack(frames["high"]).astype(int)
                           - np.stack(frames["highest"]).astype(int))
                diff = {"frames_max_grey_levels": int(d.max()),
                        "frames_mean_grey_levels": float(d.mean()),
                        "pixels_over_3_levels_share": float((d > 3).mean())}
            else:
                rows = {p: check_tree(os.path.join(v[0]["dir"], "seq0",
                                                   "E2VID"), N_WINDOWS,
                                      hw)[0] for p, v in by_prec.items()}
                diff = {f"{m}_rows_max_abs": max(
                    abs(rows["high"][m][i] - rows["highest"][m][i])
                    for i in rows["high"][m]) for m in ("mse", "ssim")}
            precision[label] = {
                "tf32_in_model_stage": flags_in, "flags_after": [False,
                                                                 False],
                "ms_per_frame": {p: [r["ms_per_frame_steady"] for r in v]
                                 for p, v in by_prec.items()},
                "high_vs_highest": diff}
        # "fastest": the JAX package's containment, by dtype
        os.chdir(work)
        fastest = {}
        for dtype, want in (("float32", "Exception while evaluating method "
                             "E2VID on SYN dataset:"),
                            ("bfloat16", "Metric mse failed at runtime; "
                             "dropping it for the rest of this sequence")):
            buf = io.StringIO()
            vc.reset_launches()
            with env(EVREAL_PRECISION="fastest", EVREAL_DTYPE=dtype,
                     EVREAL_WIRE=None), redirect_stdout(buf):
                evaluate(["E2VID"], ["std"], ["SYN"], ["mse", "ssim"],
                         device=device)
            lines = [ln for ln in buf.getvalue().splitlines()
                     if "EVREAL_PRECISION='fastest'" in ln
                     or "Exception while" in ln or "failed at runtime" in ln]
            frames = [n for n in os.listdir(os.path.join(
                "outputs", "std", "SYN", "seq0", "E2VID"))
                if n.endswith(".png")]
            check(any(want in ln for ln in lines) and any(
                "EVREAL_PRECISION='fastest': expected highest|high|default"
                in ln for ln in lines),
                f"EVREAL_PRECISION=fastest ({dtype}): lines {lines[:4]}")
            check(bool(frames) == (dtype == "bfloat16"),
                  f"EVREAL_PRECISION=fastest ({dtype}): {len(frames)} "
                  f"frames written")
            shutil.rmtree(os.path.join("outputs", "std", "SYN"))
            fastest[dtype] = {"lines": [re.sub(r"\x1b\[[0-9;]*m", "", ln)
                                        for ln in lines[:4]],
                              "frames": len(frames),
                              "voxelize_launches": dict(
                                  vc.launches_by_precision)}
        precision["fastest"] = fastest
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved_flags
    result["precision"] = precision

    # EVREAL_PROFILE: one short run's trace names the voxelizer's kernels
    # and a cuDNN convolution; under EVREAL_PRECISION=high, whose
    # convolutions should then be cuDNN's TF32 kernels
    os.chdir(work)
    write_config(work, "dataset", "SYN_PROFILE", {
        "root_path": os.path.join(work, "data", "SYN"),
        "sequences": {"seq0": {"end_time_s": cut_after(
            os.path.join(work, "data", "SYN", "seq0"), PROFILE_WINDOWS,
            ECD["b"])}}})
    trace_dir = os.path.join(work, "profile_trace")
    t0 = time.perf_counter()
    with env(EVREAL_PROFILE=trace_dir, EVREAL_DTYPE=None, EVREAL_WIRE=None,
             EVREAL_PRECISION="high"), redirect_stdout(io.StringIO()):
        evaluate(["E2VID"], ["std"], ["SYN_PROFILE"], ["mse", "ssim"],
                 device=device)
    profile_s = time.perf_counter() - t0
    traces = [n for n in os.listdir(trace_dir)
              if n.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"EVREAL_PROFILE wrote {traces}")
    path = os.path.join(trace_dir, traces[0])
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    cpu_ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    vox_kernels = sorted({m.group(0) for k in kernels for m in [
        re.search(r"voxelize_\w+_kernel", k)] if m})
    conv_kernels = sorted(k for k in kernels if re.search(
        r"conv|fprop|xmma|implicit|winograd|cudnn", k, re.I))
    check(vox_kernels and "aten::cudnn_convolution" in cpu_ops
          and conv_kernels, f"EVREAL_PROFILE trace: voxelizer kernels "
          f"{vox_kernels}, cudnn ops {'aten::cudnn_convolution' in cpu_ops}"
          f", conv kernels {conv_kernels[:3]}")
    result["profile"] = {"windows": PROFILE_WINDOWS, "wall_s": profile_s,
                         "trace_mb": os.path.getsize(path) / 2**20,
                         "events": len(events), "kernels": len(kernels),
                         "voxelize_kernels": vox_kernels,
                         "precision": "high",
                         "conv_kernels": [k[:90] for k in conv_kernels[:3]],
                         "tf32_conv_kernels": sum("tf32" in k.lower()
                                                  for k in conv_kernels),
                         "conv_kernel_names": len(conv_kernels)}
    result["phase_s"] = time.perf_counter() - t_phase
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 13: the measurement entry point, every mode
# ---------------------------------------------------------------------------

BENCH_RUNS = (
    ("probes",),
    ("flagship", "--windows", "96", "--repeats", "1"),
    ("methods", "-m", "E2VID", "FireNet", "--windows", "64", "--repeats",
     "1"),
    ("serve", "-m", "E2VID", "--windows", "200"),
    ("scaling", "--batches", "16", "--windows", "64", "--repeats", "1"),
    ("profile", "--windows", "64"),
)
MFU_MAX = 1.05  # MFU against the bf16 peak, f32 runs: far below 1


def bench_values(obj, key):
    """Every value of ``key`` in the nested dicts and lists of ``obj``."""
    if isinstance(obj, dict):
        return ([obj[key]] if key in obj else []) + [
            v for x in obj.values() for v in bench_values(x, key)]
    if isinstance(obj, list):
        return [v for x in obj for v in bench_values(x, key)]
    return []


def phase_bench(card):
    """``python -m evreal_tpu_torch.bench`` in every mode, one process
    each: the card line first, the JSON line last, its device, MFUs and
    busy shares in range."""
    t_phase = time.perf_counter()
    for argv in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "evreal_tpu_torch.bench", *argv],
            cwd=os.path.dirname(SCRIPT), capture_output=True, text=True,
            timeout=600, check=False)
        check(proc.returncode == 0, f"bench {' '.join(argv)} exited "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        check(lines[0] == card, f"bench {argv[0]}: first line {lines[0]!r}")
        line = json.loads(lines[-1])
        check(line["mode"] == argv[0] and line["device"]["platform"] == "gpu",
              f"bench {argv[0]}: mode or device {line['device']}")
        metrics = {k: v for k, v in line.items() if k != "units"}
        mfus = bench_values(metrics, "mfu_vs_bf16_peak")
        check(all(isinstance(v, float) and 0 < v <= MFU_MAX for v in mfus),
              f"bench {argv[0]}: MFU {mfus} outside (0, {MFU_MAX}]")
        shares = bench_values(metrics, "device_busy_share")
        check(all(isinstance(v, float) and 0 < v <= 1 for v in shares),
              f"bench {argv[0]}: busy share {shares} outside (0, 1]")
        check(argv[0] not in ("flagship", "methods") or mfus,
              f"bench {argv[0]}: no MFU (no device time in its profile)")
        emit({"phase": "bench", "argv": list(argv),
              "seconds": time.perf_counter() - t0, "result": line})
    emit({"phase": "bench", "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# phase 14: the robustness sweep (python -m evreal_tpu_torch.sweep)
# ---------------------------------------------------------------------------

SWEEP_METHODS = ("E2VID", "FireNet+")  # published widths
SWEEP_RUNS = (("t", ("t10ms", "t100ms")), ("k", ("k5k", "k45k")),
              ("kr", ("kr0.1", "kr1.0")))  # each family at its extremes
# base seed of the sweep's .pth files: FireNet+ takes seed 1 + 3, whose
# random output lies inside (0, 1); at phase 6's seed it is below 0 on
# every pixel, and its clipped frames would not depend on the events
SWEEP_SEED = 1
SWEEP_BF16 = "k45k"             # run again under EVREAL_DTYPE=bfloat16
SWEEP_CPU = ("k5k", "t100ms")   # FireNet+ again on the CPU
SWEEP_CPU_METHOD = "FireNet+"
SWEEP_CPU_SCORED = 4            # scored windows a lane in the CPU run


def sweep_windows(condition):
    """(eval config, sequences as ``evaluate`` builds them, each lane's
    window metas, each lane's processed windows) of ``condition``, with
    the configs of the working directory."""
    from evreal_tpu_torch.harness.config import (get_dataset_configs,
                                                 get_eval_configs)
    from evreal_tpu_torch.harness.runner import gate_windows, get_datasets
    from evreal_tpu_torch.sweep import DATASET

    cfg = get_eval_configs([condition])[0]
    seqs = get_datasets(get_dataset_configs([DATASET]),
                        cfg.get("dataset_kwargs", {}))[0]["sequences"]
    metas = [s["dataset"].windows() for s in seqs]
    procs = [gate_windows(m, s["start_time_s"], s["end_time_s"],
                          cfg.get("eval_infer_all", False))
             for s, m in zip(seqs, metas)]
    return cfg, seqs, metas, procs


def scored_windows(cfg, seq, metas, proc):
    """The windows whose scores the tracker records: inside the
    sequence's cut, the frame within ``ts_tol_ms`` of the window's end."""
    return [i for i in proc
            if seq["start_time_s"] <= metas[i]["voxel_timestamp"]
            <= seq["end_time_s"]
            and abs(metas[i]["frame_timestamp"]
                    - metas[i]["voxel_timestamp"]) * 1000
            <= cfg["ts_tol_ms"]]


def sweep_chunk0(seqs, metas, procs):
    """Chunk 0 of a lockstep group as ``eval_method_on_sequence_group``
    packs it (at the capacity it plans, or the chunk's own bucket above
    it), lanes flattened into the launch's T. Returns (buffers, capacity,
    valid windows)."""
    from evreal_tpu_torch.data import pack_windows, plan_capacity
    from evreal_tpu_torch.data.packing import alloc_buffers, bucket_capacity
    from evreal_tpu_torch.harness.runner import DEFAULT_CHUNK_T, event_dtypes

    n = len(seqs)
    capacity = plan_capacity(metas[j][i]["event_count"]
                             for j in range(n) for i in procs[j])
    idxs = [p[:DEFAULT_CHUNK_T] for p in procs]
    chunk_max = max(metas[j][i]["event_count"]
                    for j in range(n) for i in idxs[j])
    cap = capacity if chunk_max <= capacity else bucket_capacity(chunk_max)
    bufs = alloc_buffers((n, DEFAULT_CHUNK_T), cap,
                         event_dtypes([s["dataset"] for s in seqs]))
    for j, ix in enumerate(idxs):
        pack_windows(seqs[j]["dataset"], ix, capacity=cap,
                     out={k: v[j, :len(ix)] for k, v in bufs.items()},
                     metas=[metas[j][i] for i in ix], out_zeroed=True)
    return ({k: v.reshape((-1,) + v.shape[2:]) for k, v in bufs.items()},
            cap, sum(len(ix) for ix in idxs))


def run_sweep(root, family, conditions, device, switches=None):
    """``python -m evreal_tpu_torch.sweep`` on ``device``; its summary."""
    argv = ["--family", family, "--methods", *SWEEP_METHODS, "--conditions",
            *conditions, "--root", root, "--device", device]
    with env(**(switches or {})):
        proc = subprocess.run(
            [sys.executable, "-m", "evreal_tpu_torch.sweep", *argv],
            cwd=os.path.dirname(SCRIPT), capture_output=True, text=True,
            timeout=600, check=False)
    check(proc.returncode == 0, f"sweep {' '.join(argv)} exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    check(summary["ok"], f"sweep {family}: {summary}")
    return summary


def check_sweep_run(summary, windows, precision):
    """Every condition of a sweep run: its voxelizer launches (one per
    chunk of each method), every window's timestamp row, a finite score
    row for every scored window (an empty window's may be dropped), the
    mean of every (method, condition) pair. Returns {condition: score
    rows a method}."""
    from evreal_tpu_torch.harness.runner import DEFAULT_CHUNK_T

    rows = {}
    for rec in summary["conditions"]:
        cond = rec["condition"]
        cfg, seqs, metas, procs = windows[cond]
        chunks = max(-(-len(p) // DEFAULT_CHUNK_T) for p in procs)
        want = {"highest": 0, "default": 0,
                precision: len(SWEEP_METHODS) * chunks}
        check(rec["voxelize_launches"] == want, f"sweep {cond}: voxelizer "
              f"launches {rec['voxelize_launches']}, want {want}")
        for method in SWEEP_METHODS:
            check(cond in summary["means"].get(method, {}),
                  f"sweep {cond}: no mean for {method}")
            n = 0
            for seq, meta, proc in zip(seqs, metas, procs):
                out = os.path.join("outputs", cond, "SYN_SWEEP",
                                   seq["name"], method)
                stamps = read_rows(os.path.join(out, "timestamps.txt"))
                check(sorted(stamps) == proc, f"{out}: timestamp rows "
                      f"{len(stamps)} != {len(proc)} windows")
                scored = scored_windows(cfg, seq, meta, proc)
                empty = {i for i in scored if meta[i]["event_count"] == 0}
                for m in ("mse", "ssim"):
                    got = read_rows(os.path.join(out, m + ".txt"))
                    check(set(got) <= set(scored)
                          and set(scored) - set(got) <= empty
                          and all(np.isfinite(v) for v in got.values()),
                          f"{out}/{m}.txt: rows {sorted(got)[:8]}..., "
                          f"scored windows {scored[:8]}..., or non-finite")
                n += len(got) // 2  # the mse and the ssim rows
            rows.setdefault(cond, {})[method] = n
    return rows


def card_vs_cpu(torch, vc, condition):
    """FireNet+'s first scored windows of ``condition`` again through
    ``evaluate`` on the CPU (each lane cut after its SWEEP_CPU_SCORED-th
    scored window): the same score rows as the card's sweep, within
    TOL_SCORE. Returns (max abs error, windows a lane run)."""
    cfg, seqs, metas, procs = sweep_windows(condition)
    name = f"SWEEP_CPU_{condition}"
    ends, last = {}, []
    for seq, meta, proc in zip(seqs, metas, procs):
        scored = scored_windows(cfg, seq, meta, proc)
        check(len(scored) >= SWEEP_CPU_SCORED, f"sweep {condition}: "
              f"{len(scored)} scored windows")
        last.append(scored[SWEEP_CPU_SCORED - 1])
        ends[seq["name"]] = {"end_time_s": float(
            meta[last[-1]]["voxel_timestamp"])}
    write_config(".", "dataset", name, {"root_path": "data/SYN_SWEEP",
                                        "sequences": ends})
    capture_evaluate(vc, [SWEEP_CPU_METHOD], condition, name,
                     f"sweep {condition} cpu", "cpu")
    err = 0.0
    for seq, n in zip(seqs, last):
        for m in ("mse", "ssim"):
            base = os.path.join(seq["name"], SWEEP_CPU_METHOD, m + ".txt")
            cpu = read_rows(os.path.join("outputs", condition, name, base))
            card = read_rows(os.path.join("outputs", condition, "SYN_SWEEP",
                                          base))
            card = {i: v for i, v in card.items() if i <= n}
            check(sorted(cpu) == sorted(card) and len(cpu) >= 1,
                  f"sweep {condition} {m}: CPU rows {sorted(cpu)} vs card "
                  f"{sorted(card)}")
            err = max([err] + [abs(cpu[i] - card[i]) for i in cpu])
    check(err <= TOL_SCORE, f"sweep {condition}: card vs CPU scores {err} "
          f"> {TOL_SCORE}")
    return err, [n + 1 for n in last]


def phase_sweep(torch, vc, vox, work, card, device="cuda"):
    """The sweep through its entry point on the card, two conditions of
    each family; K2 held at each condition's chunk-0 launch before."""
    from evreal_tpu_torch import sweep
    from evreal_tpu_torch.analysis import read_scores

    t_phase = time.perf_counter()
    root = os.path.join(work, "sweep")
    sweep.provision_dataset(root)
    write_method_checkpoints(torch, root, SWEEP_METHODS, seed=SWEEP_SEED)
    os.chdir(root)
    windows = {c: sweep_windows(c) for _, conds in SWEEP_RUNS
               for c in conds}
    hw = windows["t10ms"][1][0]["dataset"].sensor_resolution
    at_launch = {"highest": {}, "default": {}}
    for prec, conds, switches in (
            ("highest", list(windows), {}),
            ("default", [SWEEP_BF16], {"EVREAL_DTYPE": "bfloat16"})):
        for cond in conds:
            with env(**switches):
                arrays, cap, valid = sweep_chunk0(*windows[cond][1:])
            bufs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in arrays.items()}
            err = hold_to_plain(torch, vox, bufs, ECD["b"], hw, prec,
                                f"sweep {cond} launch")[0]
            at_launch[prec][cond] = dict(
                time_variant(torch, vox, bufs, prec, hw, ECD["b"]),
                capacity=cap, valid_windows=valid, max_abs_err=err,
                wire="f32")
            del bufs
    kernel_s = time.perf_counter() - t_phase

    summaries = [run_sweep(root, family, conds, device)
                 for family, conds in SWEEP_RUNS]
    records = [r for s in summaries for r in s["conditions"]]
    rows = {}
    for s in summaries:
        rows.update(check_sweep_run(s, windows, "highest"))
    check(all(r["new_build_entries"] == 0 for r in records[1:]),
          f"sweep: new build entries after the first condition "
          f"{[r['new_build_entries'] for r in records]}")
    cpu = {c: card_vs_cpu(torch, vc, c) for c in SWEEP_CPU}
    # bf16 through evaluate in this process (two process starts fewer)
    _, launches, ms, wall_s, _ = capture_evaluate(
        vc, list(SWEEP_METHODS), SWEEP_BF16, sweep.DATASET,
        f"sweep {SWEEP_BF16} bf16", device,
        switches={"EVREAL_DTYPE": "bfloat16"})
    bf16 = {"conditions": [{"condition": SWEEP_BF16, "wall_s": wall_s,
                            "ms_per_frame": {SWEEP_METHODS[0]: ms},
                            "voxelize_launches": launches}],
            "means": read_scores("outputs", SWEEP_BF16, "mse",
                                 datasets=[sweep.DATASET])}
    check_sweep_run(bf16, windows, "default")
    for prec, runs in (("highest", records), ("default", bf16["conditions"])):
        for r in runs:
            if r["condition"] in at_launch[prec]:
                at_launch[prec][r["condition"]]["launches"] = \
                    r["voxelize_launches"][prec]
    seconds = time.perf_counter() - t_phase
    result = {"phase": "sweep", "card": card, "seconds": seconds,
              "kernel_s": kernel_s, "methods": list(SWEEP_METHODS),
              "conditions": {r["condition"]: {k: r[k] for k in (
                  "wall_s", "ms_per_frame", "new_build_entries",
                  "voxelize_launches")} for r in records},
              "score_rows": rows,
              "means": {m: {c: v for s in summaries
                            for c, v in s["means"][m].items()}
                        for m in SWEEP_METHODS},
              "bf16": {k: bf16["conditions"][0][k] for k in (
                  "condition", "wall_s", "ms_per_frame",
                  "voxelize_launches")},
              "card_vs_cpu": {c: {"max_abs_err": e, "windows_a_lane": n}
                              for c, (e, n) in cpu.items()},
              "kernel_at_launch": at_launch,
              "bit_equal_int64_plain": True}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 15: the background PNG writer on the eval paths
# ---------------------------------------------------------------------------

WRITER_WINDOWS = 128    # 4 chunks of CHUNK_T windows a lane
WRITER_CPU_WINDOWS = 8  # the first windows of WRITER_CPU_LANES lanes on the CPU
WRITER_CPU_LANES = 2
WRITER_RUNS = (  # (label, lanes, switches, voxelizer precision, wire)
    ("lockstep_f32", N_LANES, dict(EVREAL_DTYPE=None, EVREAL_WIRE=None),
     "highest", "f32"),
    ("lockstep_bf16_compact4", N_LANES,
     dict(EVREAL_DTYPE="bfloat16", EVREAL_WIRE="compact4"), "default",
     "compact4"),
    ("single_f32", 1, dict(EVREAL_DTYPE=None, EVREAL_WIRE=None), "highest",
     "f32"))
WRITER_TEXT = ("timestamps.txt", "mse.txt", "ssim.txt", "event_rate.txt")
WRITER_SCALING = (1, 2, 4, 8, 16)  # writers sharing the same frames
WRITER_SCALING_FRAMES = 16         # a lane's first frames of the f32 run


def writer_threads():
    from evreal_tpu_torch.harness.outputs import AsyncImageWriter

    return [t for t in threading.enumerate()
            if t.name == AsyncImageWriter.THREAD_NAME]


@contextmanager
def writer_thread_peak(period_s=0.005):
    """The most frame-writer threads alive at once while the block runs,
    sampled every ``period_s``: yields a dict whose "peak" is set at the
    block's end."""
    out, stop = {"peak": 0}, threading.Event()

    def sample():
        while True:
            out["peak"] = max(out["peak"], len(writer_threads()))
            if stop.wait(period_s):
                return

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        yield out
    finally:
        stop.set()
        sampler.join()


def writer_frames(torch, seqs, wire, switches, device):
    """u8 frames (lanes, WRITER_CPU_WINDOWS, H, W) of the first windows of
    ``seqs`` in one lockstep group on ``device``, under ``switches``."""
    from evreal_tpu_torch.data.packing import bucket_capacity
    from evreal_tpu_torch.harness.runner import (MethodBundle,
                                                 get_method_config,
                                                 quantize_u8)

    method_config = get_method_config("E2VID")
    with env(**switches):
        runner = MethodBundle("E2VID", method_config, device) \
            .batched_runner_for(tuple(seqs[0].sensor_resolution),
                                method_config, ECD["b"], len(seqs))
        bufs = pack_lanes(seqs, WRITER_CPU_WINDOWS,
                          bucket_capacity(EVENTS_PER_WINDOW), wire)
        _, _, clipped = runner.run(runner.init_state(), runner.upload(bufs),
                                   WRITER_CPU_WINDOWS)
    return quantize_u8(clipped).cpu().numpy()


def frames_diff(frames, ref, lane, first):
    """Max grey-level difference of a lane's first windows (from window
    ``first``) against ``ref`` (lanes, windows, H, W)."""
    return max(int(np.abs(frames[i].astype(int)
                          - ref[lane, i].astype(int)).max())
               for i in range(first, WRITER_CPU_WINDOWS))


def encode_scaling(frames, folder):
    """PNG frames/s of the host: ``save_inferred_image`` on the loop's
    thread, then ``n`` writers taking ``frames`` in turn, for each ``n``
    of WRITER_SCALING (every writer joined inside the clock)."""
    from evreal_tpu_torch.harness.outputs import (AsyncImageWriter,
                                                  save_inferred_image)

    os.makedirs(folder)
    t0 = time.perf_counter()
    for i, frame in enumerate(frames):
        save_inferred_image(folder, frame, i)
    out = {"synchronous": len(frames) / (time.perf_counter() - t0)}
    for n in WRITER_SCALING:
        t0 = time.perf_counter()
        writers = [AsyncImageWriter() for _ in range(n)]
        for i, frame in enumerate(frames):
            writers[i % n].submit(folder, frame, i)
        for w in writers:
            w.close()
        out[f"writers_{n}"] = len(frames) / (time.perf_counter() - t0)
    return out


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


ATTENTION_MAIN = (10, 8, 9638, 32)   # BS-ERGB's 10 lanes, L = 79 x 122
ATTENTION_REHEARSAL = (10, 8, 48, 32)  # the cell's 48 x 64 rehearsal
ATTENTION_EDGES = ((1, 1), (47, 47), (48, 48), (130, 130), (130, 47),
                   (1, 130))  # (Lq, Lk): below, at and across the tiles
TOL_ATTENTION = 2e-5


def attention_inputs(torch, n, h, lq, lk, dh, sharp=False, seed=0):
    """q, k, v on the card: unit normal, so the logits are about unit
    scale; ``sharp`` scales q 16-fold, so most rows put nearly all their
    weight on one key."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((n, h, lq, dh), generator=gen, device="cuda")
    k = torch.randn((n, h, lk, dh), generator=gen, device="cuda")
    v = torch.randn((n, h, lk, dh), generator=gen, device="cuda")
    return (q * 16 if sharp else q), k, v


def phase_attention(torch, card):
    """K3 against its plain version and timed (module docstring, 16)."""
    from evreal_tpu_torch.kernels import attention_cuda as ac

    info = ac.build()
    emit({"phase": "attention_build", "seconds": info["seconds"],
          "cached": info["cached"], "ptxas": info["log"].splitlines()})
    torch.backends.cuda.matmul.allow_tf32 = False
    ac.reset_counts()
    gaps = {}
    for lq, lk in ATTENTION_EDGES:
        for sharp in (False, True):
            q, k, v = attention_inputs(torch, 2, 8, lq, lk, 32, sharp)
            got = ac.attention(q, k, v)
            gaps[f"{lq}x{lk}{'_sharp' if sharp else ''}"] = float(
                (got - ac.attention_plain(q, k, v)).abs().max())
    n, h, length, dh = ATTENTION_REHEARSAL
    q, k, v = attention_inputs(torch, n, h, length, length, dh)
    gaps["rehearsal"] = float((ac.attention(q, k, v)
                               - ac.attention_plain(q, k, v)).abs().max())
    n, h, length, dh = ATTENTION_MAIN
    q, k, v = attention_inputs(torch, n, h, length, length, dh)
    out = ac.attention(q, k, v)
    gaps["main"] = max(float((out[j:j + 1] - ac.attention_plain(
        q[j:j + 1], k[j:j + 1], v[j:j + 1])).abs().max()) for j in range(n))
    torch.cuda.synchronize()
    launches = ac.launches
    check(launches == len(ATTENTION_EDGES) * 2 + 2,
          f"attention: {launches} launches")
    for name, gap in gaps.items():
        check(gap <= TOL_ATTENTION, f"attention {name}: max abs gap {gap}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(torch, lambda: ac.attention(q, k, v), flush)
    plain_ms = time_ms(torch, lambda: ac.attention_plain(
        q[:1], k[:1], v[:1]), flush)
    library_ms = time_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v), flush)
    flops = 4 * n * h * length * length * dh
    moved = 4 * 4 * n * h * length * dh
    t_ops, t_bytes = flops / F32_OPS_PER_S, moved / HBM_BYTES_PER_S
    res = {"phase": "attention", "shape": list(ATTENTION_MAIN),
           "max_abs_gap": gaps, "launches": launches, "ms": ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "roofline_pct": 100.0 * max(t_ops, t_bytes) * 1e3 / ms,
           "tflops": flops / ms / 1e9, "plain_ms_n1": plain_ms,
           "library_ms": library_ms, "card": card}
    emit(res)
    return res


def phase_writer(torch, vc, work, card, device="cuda"):
    """Frames written by one background thread per sequence on the three
    eval paths, images on and off: every PNG present and decodable, the
    first windows against the CPU, rows equal with and without images,
    done.json, no writer thread left, one voxelizer launch per chunk;
    ms/frame, evaluate's whole wall and the peak writer threads."""
    from evreal_tpu_torch.convert.params import flatten, save_params
    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.models import flagship_e2vid_kwargs
    from evreal_tpu_torch.models.init import init_e2vid

    c = ECD
    hw = (c["h"], c["w"])
    t_phase = time.perf_counter()
    names = [f"seq{j:02d}" for j in range(N_LANES)]
    root = os.path.join(work, "data", "WRITE")
    for j, name in enumerate(names):
        make_sequence(os.path.join(root, name), c["h"], c["w"],
                      WRITER_WINDOWS, EVENTS_PER_WINDOW, seed=200 + j)
    kw = flagship_e2vid_kwargs()
    npz = os.path.join(work, "weights", "E2VID.npz")
    os.makedirs(os.path.dirname(npz))
    save_params(npz, flatten(init_e2vid(
        seed=0, num_bins=kw["num_bins"],
        base_num_channels=kw["base_num_channels"],
        kernel_size=kw["kernel_size"], num_encoders=kw["num_encoders"],
        num_residual_blocks=kw["num_residual_blocks"])),
        {"class": "E2VIDRecurrent", "kwargs": kw, "model_name": "E2VID"})
    write_config(work, "method", "E2VID",
                 {"model_name": "E2VID", "model_path": npz,
                  "event_tensor_normalization": True,
                  "post_process_norm": "robust"})
    write_eval_config(work, "std_noimg", save_images=False)
    for label, lanes, *_ in WRITER_RUNS:
        write_config(work, "dataset", f"W_{label}",
                     {"root_path": root,
                      "sequences": {n: {} for n in names[:lanes]}})
    setup_s = time.perf_counter() - t_phase
    os.chdir(work)
    seqs = [Sequence(os.path.join(root, n), num_bins=c["b"])
            for n in names]
    n_chunks = WRITER_WINDOWS // CHUNK_T
    cores = len(os.sched_getaffinity(0))

    runs, refs, sample = {}, {}, []
    for label, lanes, switches, prec, wire in WRITER_RUNS:
        dataset = f"W_{label}"
        run = runs[label] = {"lanes": lanes, "frames": lanes * WRITER_WINDOWS,
                             "host_cores": cores, "card": card}
        # the frames the PNGs are held to: in f32 the CPU's (phase 4's
        # check); in bf16 the card's own, recomputed by a runner of the
        # run's lanes (bf16 on the CPU rounds otherwise: its difference
        # is reported beside)
        if (wire, prec) not in refs:
            refs[wire, prec] = {"cpu": writer_frames(
                torch, seqs[:WRITER_CPU_LANES], wire, switches, "cpu")}
            if prec == "default":
                refs[wire, prec]["card"] = writer_frames(
                    torch, seqs[:lanes], wire, switches, device)
        ref = refs[wire, prec]
        for images, config in ((True, "std"), (False, "std_noimg")):
            key = "images_on" if images else "images_off"
            with writer_thread_peak() as peak:
                _, launches, ms, wall_s, _ = capture_evaluate(
                    vc, ["E2VID"], config, dataset, f"writer {label} {key}",
                    device, switches=switches)
            want = {"highest": 0, "default": 0}
            want[prec] = n_chunks
            check(launches == want, f"writer {label} {key}: voxelizer "
                  f"launches {launches}, want {want} (one per chunk)")
            left = writer_threads()
            check(not left, f"writer {label} {key}: {len(left)} writer "
                  f"threads alive after evaluate")
            check(peak["peak"] == (lanes if images else 0),
                  f"writer {label} {key}: {peak['peak']} writer threads at "
                  f"most, want {lanes if images else 0}")
            run[key] = {"ms_per_frame_steady": ms, "evaluate_wall_s": wall_s,
                        "peak_writer_threads": peak["peak"],
                        "voxelize_launches": launches[prec]}
        png_err, cpu_err = 0, 0
        for j, name in enumerate(names[:lanes]):
            on, off = (os.path.join("outputs", cfg, dataset, name, "E2VID")
                       for cfg in ("std", "std_noimg"))
            for out in (on, off):
                check(os.path.exists(os.path.join(out, "done.json")),
                      f"writer {label}: {out}/done.json missing")
            for text in WRITER_TEXT:
                check(read_bytes(os.path.join(on, text))
                      == read_bytes(os.path.join(off, text)),
                      f"writer {label} {name}: {text} differs between the "
                      f"images-on and images-off runs")
            check(not [f for f in os.listdir(off) if f.endswith(".png")],
                  f"writer {label}: {off} has PNGs with save_images off")
            # every window's PNG decoded (outputs.decode_png), its rows
            _, frames = check_tree(on, WRITER_WINDOWS, hw, may_skip={0}
                                   if prec == "default" else ())
            n_png = sum(f.endswith(".png") for f in os.listdir(on))
            check(n_png == WRITER_WINDOWS, f"writer {label} {name}: {n_png} "
                  f"PNGs for {WRITER_WINDOWS} windows")
            if label == "lockstep_f32":
                sample += frames[:WRITER_SCALING_FRAMES]
            if j < WRITER_CPU_LANES:
                # bf16: a lane's empty first window is a flat frame that
                # the robust post-norm turns to NaN (phase 5's window 0)
                first = 1 if prec == "default" else 0
                cpu_err = max(cpu_err, frames_diff(frames, ref["cpu"], j,
                                                   first))
                png_err = max(png_err, frames_diff(
                    frames, ref.get("card", ref["cpu"]), j, first))
        run["png_held_to"] = "card" if "card" in ref else "cpu"
        run["png_max_diff"] = png_err
        run["png_max_diff_vs_cpu"] = cpu_err
        run["windows_compared"] = min(lanes, WRITER_CPU_LANES) * \
            WRITER_CPU_WINDOWS
    result = {"phase": "writer", "method": "E2VID", "width": "full",
              "sensor": list(hw), "windows_per_lane": WRITER_WINDOWS,
              "chunk_t": CHUNK_T, "card": card, "host_cores": cores,
              "setup_s": setup_s, "runs": runs,
              "png_frames_per_s": encode_scaling(
                  sample, os.path.join(work, "encode")),
              "png_frames_timed": len(sample),
              "seconds": time.perf_counter() - t_phase}
    emit(result)
    for label, run in runs.items():  # after the line, which shows them all
        check(run["png_max_diff"] <= 1, f"writer {label}: PNGs vs the "
              f"{run['png_held_to']} frames {run['png_max_diff']} grey "
              f"levels")
    return result


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    from evreal_tpu_torch.kernels import voxelize_cuda as vc
    from evreal_tpu_torch.ops import voxelize as vox

    if sys.argv[1:] == ["--serve-voxelizer-times"]:  # phase 9's timings
        emit(time_serve_voxelizer(torch, vc, vox))
        return
    if sys.argv[1:] == ["--attention"]:  # phase 16 alone
        phase_attention(torch, subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        return

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
    # the native packer's build, timed here (the main path would build it
    # at its first pack); phase 12 reports it
    from evreal_tpu_torch import native
    native_build = native.build()

    # the phases before the mesh phase run on one card whatever the host
    # holds: the eval mesh is off until phase_mesh sets it
    from evreal_tpu_torch.harness import batched
    batched._EVAL_MESH = None

    kern = phase_kernel(torch, vc, vox)
    with tempfile.TemporaryDirectory() as work:
        cwd = os.getcwd()
        try:
            main_res = phase_main_path(torch, vc, work, smi)
            lock = phase_lockstep(torch, vc, vox, work, smi)
            methods = phase_methods(torch, vc, vox, work, smi)
            configs = phase_eval_configs(torch, vc, vox, work, smi)
            metrics = phase_metrics(torch, vc, vox, work, smi)
            served = phase_serve(torch, vc, vox, work, smi)
            trained = phase_train(torch, vc, vox, work, smi)
            meshed = phase_mesh(torch, vc, vox, work, smi)
            phase_native(torch, vc, work, smi, native_build)
        finally:
            os.chdir(cwd)
    phase_bench(smi)
    with tempfile.TemporaryDirectory() as work:
        cwd = os.getcwd()
        try:
            swept = phase_sweep(torch, vc, vox, work, smi)
        finally:
            os.chdir(cwd)
    with tempfile.TemporaryDirectory() as work:
        cwd = os.getcwd()
        try:
            phase_writer(torch, vc, work, smi)
        finally:
            os.chdir(cwd)
    attn = phase_attention(torch, smi)
    by_method = methods["launches"]
    at_launch = methods["kernel_at_launch"]
    color = configs["color"]
    heq = configs["histeq"]
    # the eval configs' paths, each read from its own run
    by_method["E2VID"]["color_f32"] = color["runs"]["E2VID"]["launches"]
    by_method.setdefault("FireNet+", {})["color_f32_odd_sensor"] = \
        color["runs"]["FireNet+"]["launches"]
    for mode, run in heq["runs"].items():
        by_method["E2VID"][f"histeq_{mode}_single_f32"] = run["launches"]
    for label, run in heq["lockstep"].items():
        by_method["E2VID"][f"histeq_global_{HEQ_LANES}_lanes_{label}_f32"] = \
            run["launches"]
    by_method["E2VID"]["resume_skip"] = configs["resume"][
        "skipped_launches"]
    for label, run in metrics["runs"].items():
        if not label.endswith("cpu"):
            by_method["E2VID"][f"metrics_{label}"] = run["launches"]
    color_launch = color["kernel_at_color_launch"]
    for arch in TRAIN_ARCHS:
        by_method[f"train_{arch}"] = {
            f"cli_{TRAIN_STEPS}_steps": trained["launches"][f"train_{arch}"]}
    train_launch = trained["train_launch"]
    for path, n in meshed["launches"].items():
        arch = re.match(r"mesh_train_(\w+?)_dp", path)
        by_method[f"train_{arch.group(1)}" if arch else "E2VID"][path] = n
    shard_launch = meshed["shard_launch"]

    def mesh_launch(prec):
        return {k: shard_launch[prec][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "windows",
            "wire", "max_abs_err", "shards")}

    def launch_errs(prec):
        return [v["max_abs_err"] for v in list(at_launch.values())
                + list(metrics["kernel_at_launch"].values())
                if v["precision"] == prec]

    def launch_times(prec):
        return {k: {kk: v[kk] for kk in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "windows")} for k, v in at_launch.items()
            if v["precision"] == prec}

    def serve_launches(prec, route):
        by_path = served["launches_by_path"]
        out = {m: {p: n[prec] for p, n in v.items()
                   if n[prec] and by_path[m][p][route]}
               for m, v in served["launches"].items()}
        return {m: v for m, v in out.items() if v}

    def serve_shapes(prec, route):
        return {k: {kk: v[kk] for kk in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "windows",
            "wire", "max_abs_err", "accumulate_blocks")}
            for k, v in served["voxelize_at_serve_shapes"][prec].items()
            if v["route"] == route}

    def sweep_launches(prec):
        return {c: {k: v[k] for k in (
            "launches", "capacity", "windows", "valid_windows", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "wire",
            "max_abs_err")}
            for c, v in swept["kernel_at_launch"][prec].items()}

    def direct_call(prec):
        """K1 at T = 1 on its stream wire: the routed (direct) call with
        its plain version, library call and bound; both paths in turns,
        their host enqueue and device time."""
        v = served["voxelize_at_serve_shapes"][prec]["T1_stream"]
        return {**{k: v[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "wire",
            "max_abs_err")}, "in_turns_ms": {
                p: v["paths"][p]["ms"] for p in vc.PATHS},
            "host_enqueue_us": {p: v["paths"][p]["host_enqueue_us"]
                                for p in vc.PATHS},
            "device_us": {p: v["paths"][p]["device_us"]["kernels_us"]
                          for p in vc.PATHS},
            "tiled_memset_us": v["paths"]["tiled"]["device_us"]["memset_us"]}

    def crossover(prec):
        return {k: {p: v["paths"][p]["ms"] for p in vc.PATHS}
                for k, v in served["voxelize_at_serve_shapes"][prec].items()
                if v["route"] == "tiled"}

    source = "evreal_tpu_torch/kernels/csrc/voxelize.cu"
    f32_times = kern["times_f32_wire"]["highest"]
    bf16_times = lock["kernel_at_lockstep_shape"]["default_compact4"]
    lock_f32 = lock["kernel_at_lockstep_shape"]["highest_f32"]
    k1 = direct_call("highest")
    emit({"kernels": [
        {"name": "voxelize_direct", "route": "cuda", "source": source,
         "path": "direct",
         "replaces": "evreal_tpu/kernels/voxelize_pallas.py:93",
         "precision": "highest",
         "launches": served["launches_by_path"]["E2VID"]["stream_f32"][
             "direct"],
         "max_abs_err": max(
             v["max_abs_err"] for prec in vc.PRECISIONS for v in
             served["voxelize_at_serve_shapes"][prec].values()
             if v["route"] == "direct"),
         **{k: k1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "wire")},
         "shape": [1, ECD["e"]],
         "in_turns_ms": k1["in_turns_ms"],
         "host_enqueue_us": k1["host_enqueue_us"],
         "device_us": k1["device_us"],
         "tiled_memset_us": k1["tiled_memset_us"],
         "launch_floor": served["launch_floor"],
         "compact4_default": direct_call("default"),
         "crossover_ms": {p: crossover(p) for p in vc.PRECISIONS},
         "serve_launches": {p: serve_launches(p, "direct")
                            for p in vc.PRECISIONS},
         "kernel_phase_windows_bit_equal": kern[
             "direct_path_bit_equal_windows"],
         "bit_equal_int64_plain": True, "card": smi},
        {"name": "voxelize_windows", "route": "cuda", "source": source,
         "path": "tiled",
         "replaces": "evreal_tpu/kernels/voxelize_pallas.py:249",
         "precision": "highest",
         "launches": main_res["voxelize_launches"],
         "launches_lockstep_f32": lock["runs"]["f32_f32wire"]["launches"][
             "highest"],
         "max_abs_err": max(
             list(kern["max_abs_err"]["highest"].values())
             + [lock["kernel_lockstep_max_abs_err"]["highest_f32"],
                color_launch["max_abs_err"]]
             + launch_errs("highest")
             + [v["max_abs_err"] for v in
                serve_shapes("highest", "tiled").values()]
             + [train_launch["max_abs_err"],
                shard_launch["highest"]["max_abs_err"]]
             + [v["max_abs_err"] for v in
                swept["kernel_at_launch"]["highest"].values()]),
         "ms": f32_times["ms"], "plain_ms": f32_times["plain_ms"],
         "bound_ms": f32_times["bound_ms"], "bound_by": f32_times["bound_by"],
         "library_ms": f32_times["library_ms"],
         "shape": [f32_times["windows"], ECD["e"]],
         "bit_equal_int64_plain": True,
         "launches_by_method": {m: {p: n["highest"] for p, n in v.items()
                                    if n["highest"] or p == "resume_skip"}
                                for m, v in by_method.items()},
         "lockstep_f32": {k: lock_f32[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "windows")},
         "methods_launches": launch_times("highest"),
         "color_launch": {k: color_launch[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "windows", "sensor", "capacity", "max_abs_err")},
         "serve_launches": serve_launches("highest", "tiled"),
         "serve_shapes": serve_shapes("highest", "tiled"),
         "train_launch": {k: train_launch[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "windows", "wire", "max_abs_err", "launches_per_step")},
         "mesh_shard_launch": mesh_launch("highest"),
         "sweep_launches": sweep_launches("highest"),
         "card": smi},
        {"name": "voxelize_windows_bf16_factors", "route": "cuda",
         "source": source, "path": "tiled",
         "replaces": "evreal_tpu/kernels/voxelize_pallas.py:249 "
                     "(bf16_factors=True, :165-169)",
         "precision": "default",
         "launches": lock["runs"]["bf16_compact4"]["launches"]["default"],
         "max_abs_err": max(list(kern["max_abs_err"]["default"].values())
                            + [lock["kernel_lockstep_max_abs_err"][
                                "default_compact4"]]
                            + launch_errs("default")
                            + [v["max_abs_err"] for v in
                               serve_shapes("default", "tiled").values()]
                            + [shard_launch["default"]["max_abs_err"]]
                            + [v["max_abs_err"] for v in swept[
                                "kernel_at_launch"]["default"].values()]),
         "ms": bf16_times["ms"], "plain_ms": bf16_times["plain_ms"],
         "bound_ms": bf16_times["bound_ms"],
         "bound_by": bf16_times["bound_by"],
         "library_ms": bf16_times["library_ms"],
         "shape": [bf16_times["windows"], ECD["e"]], "wire": "compact4",
         "bit_equal_int64_plain": True,
         "launches_by_method": {m: {p: n["default"] for p, n in v.items()
                                    if n["default"]}
                                for m, v in by_method.items()
                                if any(n["default"] for n in v.values())},
         "methods_launches": launch_times("default"),
         "serve_launches": serve_launches("default", "tiled"),
         "serve_shapes": serve_shapes("default", "tiled"),
         "mesh_shard_launch": mesh_launch("default"),
         "sweep_launches": sweep_launches("default"),
         "card": smi},
        {"name": "attention", "route": "cuda",
         "source": "evreal_tpu_torch/kernels/csrc/attention.cu",
         "replaces": None, "precision": "float32",
         "launches_by_method": {m: {p: a["kernel_calls"]
                                    for p, a in v.items()}
                                for m, v in methods["attention"].items()
                                if any(a["calls"] for a in v.values())},
         "phase_launches": attn["launches"],
         **{k: attn[k] for k in ("shape", "max_abs_gap", "ms",
                                 "bound_ms", "bound_by", "roofline_pct",
                                 "plain_ms_n1", "library_ms")},
         "card": smi}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})


if __name__ == "__main__":
    main()
