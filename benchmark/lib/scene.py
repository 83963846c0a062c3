"""Synthetic event sequences from a seed: the moving-blob scene of
``evreal_tpu_torch/data/synthetic.py`` (events fire where the brightness
changes between two frames, the frames show the scene), drawn on the
device in a few large calls, with several blobs a scene so that the
events spread over the sensor. Every seed gives the same sizes: the same
frames, intervals and events per interval; the seed moves the blobs.

``make_scene`` returns host arrays in the EVREAL npy-memmap layout that
the native packer reads: f64 timestamps from 0, int16 (N, 2)
coordinates, uint8 {0, 1} polarity, (M, H, W) uint8 frames, their times
and ``image_event_indices``; ``write_sequence`` writes them to a folder.
"""

import json
import os

import numpy as np
import torch


def sub_seed(seed, *keys):
    """A 63-bit seed for one stream of draws, from the run's seed and the
    keys (sequence index, purpose): independent streams, any seed size."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *keys])
    return int(state.generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(device, seed, *keys):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def frames(scene, times, height, width, device, gen):
    """(M, H, W) f32 brightness in [30, 230] of ``scene["blobs"]`` Gaussian
    blobs, each on its own ellipse through the sensor, at ``times``."""
    k = int(scene["blobs"])
    lo, hi = scene["sigma_px"]
    u = torch.rand((k, 5), generator=gen, device=device, dtype=torch.float64)
    sigma = lo + (hi - lo) * u[:, 0]
    phase = 2 * np.pi * u[:, 1]
    sign = torch.where(u[:, 2] < 0.5, -1.0, 1.0).to(torch.float64)
    amp = 0.5 + 0.5 * u[:, 3]
    period = float(scene["period_s"]) * (0.75 + 0.5 * u[:, 4])
    t = torch.as_tensor(times, dtype=torch.float64, device=device)[:, None]
    ang = phase + sign * 2 * np.pi * t / period
    cy = height / 2 + height / 3 * torch.sin(ang)        # (M, k)
    cx = width / 2 + width / 3 * torch.cos(ang)
    yy = torch.arange(height, device=device, dtype=torch.float64)
    xx = torch.arange(width, device=device, dtype=torch.float64)
    img = torch.zeros((len(times), height, width), dtype=torch.float64,
                      device=device)
    for b in range(k):
        gy = torch.exp(-(yy[None] - cy[:, b:b + 1]) ** 2
                       / (2 * sigma[b] ** 2))
        gx = torch.exp(-(xx[None] - cx[:, b:b + 1]) ** 2
                       / (2 * sigma[b] ** 2))
        img += amp[b] * gy[:, :, None] * gx[:, None, :]
    return (30 + 200 * img.clamp(max=1.0)).to(torch.float32)


def make_scene(scene, n_intervals, events_per_interval, fps, height, width,
               device, seed, key):
    """One sequence: ``n_intervals + 1`` frames at ``fps`` and
    ``events_per_interval`` events in each interval between two frames,
    sorted in time, from the seed and ``key`` (the sequence's index).
    Returns a dict of host arrays (module docstring)."""
    gen = generator(device, seed, key)
    n, r = int(n_intervals), int(events_per_interval)
    times = np.arange(n + 1, dtype=np.float64) / fps
    img = frames(scene, times, height, width, device, gen)
    diff = img[1:] - img[:-1]                                   # (n, H, W)
    prob = diff.abs().reshape(n, -1)
    # a still interval (no change anywhere) fires uniformly
    prob = torch.where(prob.sum(1, keepdim=True) > 0, prob,
                       torch.ones_like(prob))
    idx = torch.multinomial(prob, r, replacement=True, generator=gen)
    pol = torch.gather(diff.reshape(n, -1), 1, idx) > 0
    t0 = torch.as_tensor(times[:-1], device=device)[:, None]
    ts = t0 + torch.rand((n, r), generator=gen, device=device,
                         dtype=torch.float64) / fps
    ts, order = ts.sort(dim=1)
    idx = torch.gather(idx, 1, order)
    pol = torch.gather(pol, 1, order)
    xy = torch.stack([idx % width, idx // width], -1).to(torch.int16)
    events_ts = ts.reshape(-1).cpu().numpy()
    out = {
        "events_ts": events_ts,
        "events_xy": xy.reshape(-1, 2).cpu().numpy(),
        "events_p": pol.reshape(-1).to(torch.uint8).cpu().numpy(),
        "images": img.round().to(torch.uint8).cpu().numpy(),
        "images_ts": times.reshape(-1, 1),
    }
    iei = np.searchsorted(events_ts, times, "right") - 1
    out["image_event_indices"] = np.maximum(iei, 0).reshape(-1, 1).astype(
        np.int64)
    return out


def write_sequence(out_dir, seq):
    """The sequence's arrays as ``<name>.npy`` files and its
    ``metadata.json``; returns the bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    total = 0
    for name, arr in seq.items():
        path = os.path.join(out_dir, name + ".npy")
        np.save(path, arr)
        total += os.path.getsize(path)
    h, w = seq["images"].shape[1:3]
    with open(os.path.join(out_dir, "metadata.json"), "w",
              encoding="utf-8") as f:
        json.dump({"sensor_resolution": [int(h), int(w)]}, f)
    return total
