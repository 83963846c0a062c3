"""Memmap-backed event sequence reader (numpy only; the port's own copy of
``evreal_tpu/data/memmap.py``, kept line for line so the two window tables
agree).

On-disk contract (reference dataset.py:230-281, README.md:43-59): a directory
with ``events_ts.npy``, ``events_xy.npy``, ``events_p.npy`` and optionally
``images.npy``, ``images_ts.npy``, ``image_event_indices.npy``,
``metadata.json`` (with ``sensor_resolution``).

Window semantics match MemMapDataset exactly (dataset.py:33-294) for the three
voxel methods (between_frames / t_seconds / k_events), including the
zero-event timestamp reconstruction and the nearest-frame match for
non-between_frames modes. One deliberate divergence: ``keep_ratio`` sampling
is seeded (the reference uses unseeded ``np.random.choice``,
dataset.py:132-140 — nondeterministic run to run).

Instead of producing torch tensors item by item, windows are described by
lightweight host metadata (event index ranges + timestamps); the voxel grids
are built on device from packed event buffers (see packing.py / ops/voxelize.py).
"""

import bisect
import json
import os

import numpy as np


class Sequence:
    def __init__(self, data_path, sensor_resolution=None, num_bins=5,
                 voxel_method=None, max_length=None, keep_ratio=1, seed=0):
        self.data_path = data_path
        self.num_bins = num_bins
        self.keep_ratio = keep_ratio
        self.sensor_resolution = sensor_resolution
        self.seed = seed
        self._load(data_path)
        self.voxel_method = voxel_method or {"method": "between_frames"}
        self._set_voxel_method()
        if max_length is not None:
            self.length = min(self.length, max_length + 1)

    # -- loading ------------------------------------------------------------

    def _load(self, path):
        assert os.path.isdir(path), f"{path} is not a valid data_path"
        j = lambda name: os.path.join(path, name)
        self.has_images = all(os.path.exists(j(n)) for n in
                              ("images.npy", "images_ts.npy",
                               "image_event_indices.npy"))
        if self.has_images:
            self.images = np.load(j("images.npy"), mmap_mode="r")
            # reshape(-1), not squeeze(): a single-frame (1,1) array must
            # stay iterable (squeeze would collapse it to a 0-d scalar)
            self.frame_ts = [float(t) for t in
                             np.load(j("images_ts.npy")).reshape(-1)]
            self.image_event_indices = np.load(j("image_event_indices.npy"))
            self.num_frames = len(self.images)
        else:
            self.images = None
            self.frame_ts = []
            self.num_frames = 0

        # reshape, not squeeze (reference dataset.py:248-250 squeezes, which
        # collapses a single-event (1,2)/(1,1) file into an unusable shape);
        # reshape of a C-contiguous memmap stays a lazy view
        self.t = np.load(j("events_ts.npy"), mmap_mode="r").reshape(-1)
        self.xy = np.load(j("events_xy.npy"), mmap_mode="r").reshape(-1, 2)
        self.p = np.load(j("events_p.npy"), mmap_mode="r").reshape(-1)
        assert len(self.p) == len(self.xy) == len(self.t), \
            "Number of events, timestamps and coordinates do not match"
        assert len(self.frame_ts) == self.num_frames, \
            "Number of frames and timestamps do not match"

        self.t0 = float(self.t[0])
        self.tk = float(self.t[-1])
        self.num_events = len(self.p)

        if self.sensor_resolution is None:
            meta_path = j("metadata.json")
            if os.path.exists(meta_path):
                with open(meta_path, encoding="utf-8") as f:
                    self.sensor_resolution = json.load(f)["sensor_resolution"]
            elif self.has_images and self.num_frames > 0:
                self.sensor_resolution = list(self.images[0].shape[:2])
            else:
                self.sensor_resolution = [int(self.xy[:, 1].max()) + 1,
                                          int(self.xy[:, 0].max()) + 1]
        self.sensor_resolution = tuple(int(v) for v in self.sensor_resolution)

    # -- windowing ----------------------------------------------------------

    def _set_voxel_method(self):
        m = self.voxel_method
        if m["method"] == "k_events":
            self.length = max(int(self.num_events /
                                  (m["k"] - m["sliding_window_w"])), 0)
            step = m["k"] - m["sliding_window_w"]
            self.event_indices = [(step * i, step * i + m["k"])
                                  for i in range(self.length)]
        elif m["method"] == "t_seconds":
            duration = self.tk - self.t0
            self.length = max(int(duration /
                                  (m["t"] - m["sliding_window_t"])), 0)
            self.event_indices = self._timeblock_indices()
        elif m["method"] == "between_frames":
            assert self.has_images, \
                "Cannot use between_frames voxel method without images"
            self.length = self.num_frames - 1
            self.event_indices = self._frame_indices()
            self._choose_frames_to_use()
        else:
            raise ValueError(f"Invalid voxel forming method chosen ({m})")

    def _timeblock_indices(self):
        """Same table as the reference's per-window searchsorted loop
        (dataset.py:104-117), built with one vectorized searchsorted."""
        m = self.voxel_method
        step = m["t"] - m["sliding_window_t"]
        end_times = step * np.arange(self.length) + self.t0 + m["t"]
        ends = np.searchsorted(self.t, end_times)
        starts = np.concatenate([[0], ends[:-1]])
        return [(int(a), int(b)) for a, b in zip(starts, ends)]

    def _frame_indices(self):
        out, start_idx = [], 0
        for ev_idx in self.image_event_indices:
            end_idx = int(np.asarray(ev_idx).reshape(-1)[0])
            out.append((start_idx, end_idx))
            start_idx = end_idx
        return out

    def _choose_frames_to_use(self):
        self.frames_to_use = list(range(self.num_frames))
        if self.keep_ratio != 1:
            assert self.voxel_method["method"] == "between_frames", \
                "keep_ratio can only specified for between_frames voxel method"
            assert self.keep_ratio < 1, "keep_ratio cannot be greater than 1"
            n_use = int(self.num_frames * self.keep_ratio)
            rng = np.random.default_rng(self.seed)
            self.frames_to_use = sorted(
                rng.choice(self.frames_to_use, size=n_use, replace=False))
            self.length = n_use - 1

    def __len__(self):
        return self.length

    def get_min_max_t(self):
        if self.has_images:
            return (min(self.frame_ts[0], self.t0),
                    max(self.frame_ts[-1], self.tk))
        return self.t0, self.tk

    def _closest_frame_index(self, ts):
        pos = bisect.bisect_left(self.frame_ts, ts)
        if pos == 0:
            return 0
        if pos == len(self.frame_ts):
            return pos - 1
        before, after = self.frame_ts[pos - 1], self.frame_ts[pos]
        return pos if after - ts < ts - before else pos - 1

    def _event_range(self, index):
        idx0, idx1 = self.event_indices[index]
        if not (idx0 >= 0 and idx1 <= self.num_events):
            raise ValueError(
                f"WARNING: Event indices {idx0},{idx1} out of bounds "
                f"0,{self.num_events}")
        return idx0, idx1

    def window(self, index):
        """Host metadata for one window. Keys mirror the reference item dict
        (dataset.py:96-102) minus the voxel itself."""
        m = self.voxel_method["method"]
        if m == "between_frames":
            assert 0 <= index < len(self)
            prev_index = self.frames_to_use[index - 1] if index > 0 else 0
            frame_index = self.frames_to_use[index]
            _, idx0 = self._event_range(prev_index)
            _, idx1 = self._event_range(frame_index)
        else:
            assert 0 <= index < len(self)
            idx0, idx1 = self._event_range(index)

        if idx1 < idx0:
            # non-monotonic image_event_indices (frame-ts repair in the
            # converters fixes only isolated errors) — the reference's
            # events_ts[idx0:idx1] is simply empty there (dataset.py:222-228);
            # emit an empty window rather than a negative count that would
            # blow up the fixed-capacity packer
            idx1 = idx0
        event_count = idx1 - idx0
        if event_count > 0:
            ts_0 = float(self.t[idx0])
            ts_k = float(self.t[idx1 - 1])
        elif idx0 > 0:
            ts_0 = float(self.t[idx0 - 1])
            if m == "t_seconds":
                ts_k = ts_0 + self.voxel_method["t"]
            else:
                ts_k = self.frame_ts[
                    self.frames_to_use[index] if m == "between_frames" else index]
        else:
            ts_0, ts_k = 0.0, 0.0

        dt = ts_k - ts_0
        if m == "t_seconds":
            dt = self.voxel_method["t"]

        frame_index = None
        frame_ts = 0.0
        if self.has_images:
            if m == "between_frames":
                frame_index = self.frames_to_use[index]
            else:
                frame_index = self._closest_frame_index(ts_k)
            frame_ts = self.frame_ts[frame_index]

        voxel_ts = frame_ts if m == "between_frames" else ts_k
        return {"idx0": idx0, "idx1": idx1, "event_count": event_count,
                "dt": dt, "frame_index": frame_index,
                "frame_timestamp": frame_ts, "voxel_timestamp": voxel_ts}

    def windows(self):
        """All window metadata dicts, memoized — the eval loops walk the
        full table once per (method, eval-config) otherwise."""
        if getattr(self, "_windows", None) is None:
            self._windows = [self.window(i) for i in range(len(self))]
        return self._windows

    def events(self, idx0, idx1):
        """Raw event slice: xs, ys f32; ts f64 zero-based-later; ps in ±1.

        Polarity maps through the same sign-aware rule as the production
        wires (packing.polarity_bit: LSB for unsigned on-disk {0,1}/{0,255},
        sign for already-±1 input) — a bare ``p*2-1`` would disagree with
        what the device pipeline voxelizes for signed or {0,255} data."""
        from evreal_tpu_torch.data.packing import polarity_bit

        xy = self.xy[idx0:idx1]
        xs = xy[:, 0].astype(np.float32)
        ys = xy[:, 1].astype(np.float32)
        ts = np.asarray(self.t[idx0:idx1])
        ps = polarity_bit(self.p[idx0:idx1]).astype(np.float32) * 2.0 - 1.0
        return xs, ys, ts, ps

    def frame(self, index):
        """GT frame as float32 in [0,1] (channel 0, /255: dataset.py:218-220, 84)."""
        arr = self.images[index]
        if arr.ndim == 3:
            arr = arr[:, :, 0]
        return arr.astype(np.float32) / 255.0

    def frame_u8(self, index):
        """GT frame as raw uint8 (channel 0), or None when the stored dtype
        is not uint8. Lets the eval loop upload 1 byte/pixel and defer
        frame()'s /255 to the device (bit-identical: u8->f32 is exact and
        the f32 divide rounds once either way)."""
        if self.images.dtype != np.uint8:
            return None
        arr = self.images[index]
        if arr.ndim == 3:
            arr = arr[:, :, 0]
        return arr
