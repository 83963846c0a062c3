"""Windows, voxel grids and the event norm, as EVREAL defines them.

* ``windows``: the (start, end) event index of every window of a
  sequence, its timestamp and its reference frame, for ``between_frames``
  (window i holds the events from ``image_event_indices[i - 1]`` to
  ``image_event_indices[i]``, window 0 none; EVREAL dataset.py) and
  ``k_events`` (k events a window, the frame nearest the window's last
  event);
* ``voxel_grid``: EVREAL's ``events_to_voxel_grid`` with temporal
  bilinear weights: timestamps normalized to [0, bins - 1] over the
  window, each event adding ``p * max(0, 1 - |t - b|)`` to bin ``b`` at its
  pixel, summed in float64 and rounded once to float32;
* ``event_norm``: zero mean and unit deviation over the nonzero entries
  (EVREAL eval.py).
"""

import bisect

import numpy as np
import torch


def windows(seq, voxel_method):
    """[(idx0, idx1, voxel_ts, frame_index)] of ``seq`` (a dict of host
    arrays in the memmap layout)."""
    ts = seq["events_ts"]
    frame_ts = [float(t) for t in seq["images_ts"].reshape(-1)]
    out = []
    if voxel_method["method"] == "between_frames":
        iei = seq["image_event_indices"].reshape(-1)
        for i in range(len(frame_ts) - 1):
            idx0 = int(iei[i - 1]) if i > 0 else int(iei[0])
            out.append((idx0, max(int(iei[i]), idx0), frame_ts[i], i))
    elif voxel_method["method"] == "k_events":
        k = int(voxel_method["k"])
        for i in range(len(ts) // k):
            tk = float(ts[(i + 1) * k - 1])
            pos = bisect.bisect_left(frame_ts, tk)
            if pos == len(frame_ts):
                f = pos - 1
            elif pos == 0:
                f = 0
            else:
                f = pos if frame_ts[pos] - tk < tk - frame_ts[pos - 1] \
                    else pos - 1
            out.append((i * k, (i + 1) * k, tk, f))
    else:
        raise ValueError(f"voxel method {voxel_method} is not referenced")
    return out


def device_events(seq, device):
    """A sequence's events on ``device``: (f64 seconds, f64 +-1
    polarity, int64 linear pixel index)."""
    xy = torch.as_tensor(seq["events_xy"].astype(np.int64), device=device)
    w = seq["images"].shape[2]
    return (torch.as_tensor(seq["events_ts"], device=device),
            torch.as_tensor(seq["events_p"], device=device).double() * 2 - 1,
            xy[:, 1] * w + xy[:, 0])


def voxel_grid(t, p, pix, bins, h, w):
    """(bins, H, W) float32 grid of one window's events (``device_events``
    sliced to the window)."""
    grid = torch.zeros(bins * h * w, dtype=torch.float64, device=t.device)
    if len(t):
        dt = float(t[-1] - t[0])
        tn = (t - t[0]) / (dt if dt > 0 else 1.0) * (bins - 1)
        for b in range(bins):
            weight = p * (1.0 - (tn - b).abs()).clamp(min=0.0)
            grid.index_add_(0, pix + b * h * w, weight)
    return grid.view(bins, h, w).float()


def event_norm(vox):
    """Each item of ``vox`` (N, ...) over its own nonzero entries; an
    all-zero item stays zero."""
    out = torch.zeros_like(vox)
    for i, v in enumerate(vox):
        nz = v != 0
        n = int(nz.sum())
        if n == 0:
            continue
        mean = v.sum() / n
        std = torch.sqrt((v * v).sum() / n - mean * mean)
        out[i] = nz.float() * (v - mean) / std
    return out
