// Fused event-window packer: the hot host loop of the data layer
// (data/packing.py pack_windows; reference MemMapDataset.__getitem__,
// dataset.py:33-102, which does this work in Python per frame). A copy of
// the JAX package's evreal_tpu/native/packer.cpp, built and loaded by
// native/__init__.py.
//
// One pass per window over the raw memmapped event arrays:
//   * deinterleave (N,2) int16 xy into xs/ys rows,
//   * map polarity bytes {0,1} -> {-1,+1} int8,
//   * zero-base timestamps and narrow f64 -> f32,
//   * zero the tail of each fixed-capacity row.
//
// Called through ctypes (GIL released for the duration), so the host packs
// chunk k+1 while the card runs chunk k.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// All out_* buffers are (t_rows, capacity), C-contiguous, caller-allocated
// (not pre-zeroed). idx0/idx1 index into the full event arrays.
// Returns 0 on success, -1 if any window exceeds capacity / has bad bounds.
int evreal_pack_i16(
    const double* ts, const int16_t* xy, const uint8_t* p,
    int64_t num_events,
    const int64_t* idx0, const int64_t* idx1, int64_t t_rows,
    int64_t capacity,
    float* out_ts, int16_t* out_xs, int16_t* out_ys, int8_t* out_ps,
    int32_t* out_count) {
  for (int64_t r = 0; r < t_rows; ++r) {
    const int64_t i0 = idx0[r];
    const int64_t i1 = idx1[r];
    const int64_t n = i1 - i0;
    if (i0 < 0 || i1 > num_events || n < 0 || n > capacity) return -1;
    out_count[r] = static_cast<int32_t>(n);

    float* row_ts = out_ts + r * capacity;
    int16_t* row_xs = out_xs + r * capacity;
    int16_t* row_ys = out_ys + r * capacity;
    int8_t* row_ps = out_ps + r * capacity;

    const double t0 = n > 0 ? ts[i0] : 0.0;
    const int16_t* exy = xy + 2 * i0;
    const double* ets = ts + i0;
    const uint8_t* ep = p + i0;
    for (int64_t i = 0; i < n; ++i) {
      row_xs[i] = exy[2 * i];
      row_ys[i] = exy[2 * i + 1];
      row_ts[i] = static_cast<float>(ets[i] - t0);
      row_ps[i] = static_cast<int8_t>(2 * static_cast<int>(ep[i] & 1) - 1);
    }
    const int64_t tail = capacity - n;
    if (tail > 0) {
      std::memset(row_ts + n, 0, tail * sizeof(float));
      std::memset(row_xs + n, 0, tail * sizeof(int16_t));
      std::memset(row_ys + n, 0, tail * sizeof(int16_t));
      std::memset(row_ps + n, 0, tail * sizeof(int8_t));
    }
  }
  return 0;
}

// Compact-wire variant (data/packing.py wire="compact"): timestamps as
// uint16 window-normalized fractions q = rint((t - t0) / dt * 65535) with
// the degenerate dt < 1e-9 linspace encoded here, and optionally uint8
// coordinates with out-of-range values parked at the 255 sentinel (the
// device's bounds guard drops them; only valid when h, w <= 255).
// out_xs/out_ys point at uint8 rows when u8_coords != 0, int16 otherwise.
// Bit-identical to the numpy fallback in pack_windows (same f64 op order:
// one division into `scale`, then per-event multiply + rint).
int evreal_pack_compact(
    const double* ts, const int16_t* xy, const uint8_t* p,
    int64_t num_events,
    const int64_t* idx0, const int64_t* idx1, int64_t t_rows,
    int64_t capacity, int u8_coords,
    uint16_t* out_ts, void* out_xs, void* out_ys, int8_t* out_ps,
    int32_t* out_count) {
  for (int64_t r = 0; r < t_rows; ++r) {
    const int64_t i0 = idx0[r];
    const int64_t i1 = idx1[r];
    const int64_t n = i1 - i0;
    if (i0 < 0 || i1 > num_events || n < 0 || n > capacity) return -1;
    out_count[r] = static_cast<int32_t>(n);

    uint16_t* row_ts = out_ts + r * capacity;
    int8_t* row_ps = out_ps + r * capacity;

    const int16_t* exy = xy + 2 * i0;
    const double* ets = ts + i0;
    const uint8_t* ep = p + i0;

    const double t0 = n > 0 ? ets[0] : 0.0;
    const double dt = n > 0 ? ets[n - 1] - t0 : 0.0;
    const bool degenerate = dt < 1e-9;
    const double scale =
        degenerate ? 65535.0 / static_cast<double>(n > 1 ? n - 1 : 1)
                   : 65535.0 / dt;

    if (u8_coords) {
      uint8_t* row_xs = static_cast<uint8_t*>(out_xs) + r * capacity;
      uint8_t* row_ys = static_cast<uint8_t*>(out_ys) + r * capacity;
      for (int64_t i = 0; i < n; ++i) {
        const int16_t x = exy[2 * i];
        const int16_t y = exy[2 * i + 1];
        row_xs[i] = (x >= 0 && x < 256) ? static_cast<uint8_t>(x) : 255;
        row_ys[i] = (y >= 0 && y < 256) ? static_cast<uint8_t>(y) : 255;
      }
      const int64_t tail = capacity - n;
      if (tail > 0) {
        std::memset(row_xs + n, 0, tail * sizeof(uint8_t));
        std::memset(row_ys + n, 0, tail * sizeof(uint8_t));
      }
    } else {
      int16_t* row_xs = static_cast<int16_t*>(out_xs) + r * capacity;
      int16_t* row_ys = static_cast<int16_t*>(out_ys) + r * capacity;
      for (int64_t i = 0; i < n; ++i) {
        row_xs[i] = exy[2 * i];
        row_ys[i] = exy[2 * i + 1];
      }
      const int64_t tail = capacity - n;
      if (tail > 0) {
        std::memset(row_xs + n, 0, tail * sizeof(int16_t));
        std::memset(row_ys + n, 0, tail * sizeof(int16_t));
      }
    }

    for (int64_t i = 0; i < n; ++i) {
      double v = degenerate ? std::rint(static_cast<double>(i) * scale)
                            : std::rint((ets[i] - t0) * scale);
      if (v < 0.0) v = 0.0;
      if (v > 65535.0) v = 65535.0;
      row_ts[i] = static_cast<uint16_t>(v);
      row_ps[i] = static_cast<int8_t>(2 * static_cast<int>(ep[i] & 1) - 1);
    }
    const int64_t tail = capacity - n;
    if (tail > 0) {
      std::memset(row_ts + n, 0, tail * sizeof(uint16_t));
      std::memset(row_ps + n, 0, tail * sizeof(int8_t));
    }
  }
  return 0;
}

// Packed-u32 wire (data/packing.py wire="compact4"): one uint32 per event —
// linear pixel index y*w+x in the low idx_bits (out-of-range events park at
// the h*w sentinel, which decodes to y >= h and is dropped by the device
// bounds guard), the window-normalized timestamp fraction
// q = rint((t - t0) / dt * (2^ts_bits - 1)) in the next ts_bits bits with
// the degenerate dt < 1e-9 linspace encoded here, polarity sign in bit 31.
// Bit-identical to packing.encode_compact4 (same f64 op order: one division
// into `scale`, then per-event multiply + rint).
int evreal_pack_compact4(
    const double* ts, const int16_t* xy, const uint8_t* p,
    int64_t num_events,
    const int64_t* idx0, const int64_t* idx1, int64_t t_rows,
    int64_t capacity, int64_t h, int64_t w, int idx_bits, int ts_bits,
    uint32_t* out_ev, int32_t* out_count) {
  const double qmax = static_cast<double>((1u << ts_bits) - 1u);
  const uint32_t sentinel = static_cast<uint32_t>(h * w);
  for (int64_t r = 0; r < t_rows; ++r) {
    const int64_t i0 = idx0[r];
    const int64_t i1 = idx1[r];
    const int64_t n = i1 - i0;
    if (i0 < 0 || i1 > num_events || n < 0 || n > capacity) return -1;
    out_count[r] = static_cast<int32_t>(n);

    uint32_t* row = out_ev + r * capacity;
    const int16_t* exy = xy + 2 * i0;
    const double* ets = ts + i0;
    const uint8_t* ep = p + i0;

    const double t0 = n > 0 ? ets[0] : 0.0;
    const double dt = n > 0 ? ets[n - 1] - t0 : 0.0;
    const bool degenerate = dt < 1e-9;
    const double scale =
        degenerate ? qmax / static_cast<double>(n > 1 ? n - 1 : 1)
                   : qmax / dt;

    for (int64_t i = 0; i < n; ++i) {
      const int64_t x = exy[2 * i];
      const int64_t y = exy[2 * i + 1];
      const uint32_t idx =
          (x >= 0 && x < w && y >= 0 && y < h)
              ? static_cast<uint32_t>(y * w + x)
              : sentinel;
      double v = degenerate ? std::rint(static_cast<double>(i) * scale)
                            : std::rint((ets[i] - t0) * scale);
      if (v < 0.0) v = 0.0;
      if (v > qmax) v = qmax;
      const uint32_t q = static_cast<uint32_t>(v);
      // LSB convention, matching the f32/compact wires' (p & 1) * 2 - 1
      // (packing.polarity_bit): every wire agrees on event sign for any
      // uint8 polarity encoding, not just {0,1}
      const uint32_t pbit = ep[i] & 1u;
      row[i] = idx | (q << idx_bits) | (pbit << 31);
    }
    const int64_t tail = capacity - n;
    if (tail > 0) std::memset(row + n, 0, tail * sizeof(uint32_t));
  }
  return 0;
}

}  // extern "C"
