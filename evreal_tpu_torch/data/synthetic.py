"""Synthetic event sequences in the EVREAL npy-memmap layout (numpy only;
the port's own copy of ``tools/make_synthetic_sequence.py:make_sequence``,
with the same arguments, the same draws from ``np.random.default_rng(seed)``
and the same files, byte for byte):

  events_ts.npy (N,) f64 seconds, zero-origin
  events_xy.npy (N,2) int16 coordinates
  events_p.npy  (N,) int8 {0,1}
  images.npy    (M,H,W,3) uint8
  images_ts.npy (M,1) f64
  image_event_indices.npy (M,1) int64: searchsorted(events_ts, images_ts,'right')-1
  metadata.json {"sensor_resolution": [H, W]}

The scene is a moving Gaussian blob: events fire where brightness changes,
frames show the blob, so reconstruction metrics are meaningful. Each frame
interval holds ``events_per_frame`` events, spread uniformly in time.
"""

import json
import os

import numpy as np


def make_sequence(out_dir, height=64, width=96, duration_s=2.0, fps=25,
                  events_per_frame=3000, seed=0):
    rng = np.random.default_rng(seed)
    num_frames = int(duration_s * fps)
    frame_times = np.arange(num_frames) / fps

    def blob(t):
        cy = height / 2 + height / 4 * np.sin(2 * np.pi * t / duration_s)
        cx = width / 2 + width / 4 * np.cos(2 * np.pi * t / duration_s)
        yy, xx = np.mgrid[0:height, 0:width]
        return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 8.0 ** 2))

    images = np.stack([(blob(t) * 200 + 30).astype(np.uint8)
                       for t in frame_times])
    images = np.repeat(images[:, :, :, None], 3, axis=3)

    all_ts, all_xy, all_p = [], [], []
    for i in range(num_frames - 1):
        t0, t1 = frame_times[i], frame_times[i + 1]
        d = blob(t1) - blob(t0)
        prob = np.abs(d).ravel()
        prob = prob / prob.sum()
        idx = rng.choice(prob.size, size=events_per_frame, p=prob)
        ys, xs = np.unravel_index(idx, (height, width))
        ts = np.sort(rng.uniform(t0, t1, events_per_frame))
        ps = (d.ravel()[idx] > 0).astype(np.int8)
        all_ts.append(ts)
        all_xy.append(np.stack([xs, ys], 1).astype(np.int16))
        all_p.append(ps)

    events_ts = np.concatenate(all_ts)
    events_xy = np.concatenate(all_xy)
    events_p = np.concatenate(all_p)
    image_event_indices = (np.searchsorted(events_ts, frame_times, "right")
                           - 1).reshape(-1, 1).astype(np.int64)
    image_event_indices = np.maximum(image_event_indices, 0)

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "events_ts.npy"), events_ts)
    np.save(os.path.join(out_dir, "events_xy.npy"), events_xy)
    np.save(os.path.join(out_dir, "events_p.npy"), events_p)
    np.save(os.path.join(out_dir, "images.npy"), images)
    np.save(os.path.join(out_dir, "images_ts.npy"),
            frame_times.reshape(-1, 1))
    np.save(os.path.join(out_dir, "image_event_indices.npy"),
            image_event_indices)
    with open(os.path.join(out_dir, "metadata.json"), "w",
              encoding="utf-8") as f:
        json.dump({"sensor_resolution": [height, width]}, f)
    return out_dir
