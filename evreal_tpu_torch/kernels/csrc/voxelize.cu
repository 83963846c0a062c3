// Event voxelizer for Hopper (sm_90a): a chunk of T windows in one launch.
//
// Replaces the Pallas TPU kernels of evreal_tpu/kernels/voxelize_pallas.py:
//   K1 `_kernel` (pallas_call at :93), one window, reached through
//      `voxelize_pallas` / `voxelize` — here the T = 1 case;
//   K2 `_batched_kernel` (pallas_call at :249), a chunk of windows, reached
//      through `voxelize_pallas_windows`, in both of its precisions:
//      HIGHEST (f32 weights) and DEFAULT (`bf16_factors=True`: each
//      interpolation weight rounded to bf16, round to nearest even, before
//      the f32 accumulation). In K2's one-hot row factor at most one of the
//      two terms of a row is non-zero, so each of its deposits is exactly
//      f32(bf16_rne(w)); the BF16 template flag does the same rounding.
// The math is ops/voxelize.py's: each valid in-bounds event adds
// p * (1 - frac) to bin lo = floor(t_norm) and p * frac to bin lo + 1 at
// (y, x). The TPU kernels built one-hot factors for the matrix unit; that
// layout does not bind this port. Here one thread owns one event slot and
// does the per-event prep (ops/voxelize.py:t_norm and event_deposits) itself,
// reading its wire's bytes directly: split buffers xs/ys/ts/ps of any wire
// dtype, or the packed compact4 word, decoded in the thread exactly as
// ops/voxelize.py:decode_compact4 does.
//
// Deterministic accumulation. Float atomics add in an order that changes
// from run to run, so their sums would differ at the ulp level between runs
// and between groupings of windows. Instead each deposit is rounded to a
// fixed-point integer at a scale of 2^32 and added with a 64-bit integer
// atomicAdd (two's complement on unsigned long long) into a zero-filled
// int64 scratch; integer addition is associative, so the sum of every cell
// is the same whatever the order of the atomics. A second pass converts each
// cell to f32 with one rounding (int64 -> double is exact below 2^53, the
// 2^-32 scale is exact, then one double -> f32 rounding). A window's cells
// are its own, so its grid does not depend on which windows share a launch:
// one launch over 32 windows equals two over 16 + 16, bit for bit.
// Range: |p| = 1 on every wire the packer writes (the polarity convention of
// data/packing.py), so |w| <= 1 and a cell takes at most E deposits: its
// magnitude stays below E * 2^32 <= 2^63 for any E < 2^31. Rounding costs at
// most 2^-33 per deposit, so a cell of k deposits is within k * 2^-33 of the
// exact sum (3.8e-6 even at k = E = 32768), far inside the 2e-5 tolerance
// against the plain version.
//
// Bound on the card: bytes. At the single-sequence shape (T = 32,
// E = 32768, 5 x 180 x 240) the valid events are ~7 MB on the f32 wire and
// the f32 output is 27.6 MB, written once: ~10 us at 3.35 TB/s; the
// arithmetic is a few dozen operations per event. This simple design pays
// above that bound for the wrapper's zero-fill of the int64 scratch (twice
// the output's bytes), the atomics' read-modify-write of it in L2, and the
// conversion pass, which reads the scratch and writes the output. The reads
// of the event buffers are coalesced (neighbouring threads, neighbouring
// slots) and slots past `count` read nothing but `count`.
//
// Rounding: every multiply, add and divide is written with the _rn
// intrinsics (and the library is built with --fmad=false, no fast math), so
// nothing is contracted into an FMA and `/` stays IEEE division: t_norm,
// frac and the two weights are bit-identical to the JAX package's f32 ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kFixedScale = 4294967296.0f;     // 2^32
constexpr double kFixedInvScale = 1.0 / 4294967296.0;

// Coordinates truncate toward zero, as astype(int32) / Tensor.long() do
// (the float -> int conversion is cvt.rzi).
template <typename C>
__device__ __forceinline__ int to_coord(C v) {
  return static_cast<int>(v);
}

// One event as the deposit step needs it.
struct Event {
  int x, y;
  float tn, p;
};

// Split buffers: xs, ys (C), ts (f32 zero-based seconds, or uint16
// window-normalized fractions on the compact wire), ps (P).
template <typename C, typename TS, typename P>
struct SplitWire {
  const C* xs;
  const C* ys;
  const TS* ts;
  const P* ps;

  __device__ __forceinline__ Event load(long long row, int slot, int n, int E,
                                        int B, float u16_scale) const {
    Event ev;
    ev.x = to_coord(xs[row + slot]);
    ev.y = to_coord(ys[row + slot]);
    if constexpr (sizeof(TS) == 2) {
      // uint16 (compact) wire: window-normalized fraction, the scale
      // f32((B - 1) / 65535) computed in double on the host
      ev.tn = __fmul_rn(static_cast<float>(ts[row + slot]), u16_scale);
    } else {
      const float span = static_cast<float>(B - 1);
      const float ts0 = ts[row];
      int last = n - 1;
      last = last < 0 ? 0 : (last > E - 1 ? E - 1 : last);
      const float dt = __fsub_rn(ts[row + last], ts0);
      if (dt < 1e-9f) {
        // degenerate window: linspace(0, B - 1, n) over the first n slots
        const int denom = n - 1 > 1 ? n - 1 : 1;
        ev.tn = __fdiv_rn(__fmul_rn(static_cast<float>(slot), span),
                          static_cast<float>(denom));
      } else {
        ev.tn = __fmul_rn(__fdiv_rn(__fsub_rn(ts[row + slot], ts0),
                                    fmaxf(dt, 1e-38f)),
                          span);
      }
    }
    ev.p = static_cast<float>(ps[row + slot]);
    return ev;
  }
};

// Packed compact4 wire: one uint32 per event — linear pixel index in the
// low idx_bits, the timestamp fraction in the next ts_bits, polarity in
// bit 31 (data/packing.py:compact4_layout). The sentinel index h * w
// decodes to y >= H and is dropped by the bounds guard.
struct Compact4Wire {
  const uint32_t* ev;
  int idx_bits, ts_bits, width;

  __device__ __forceinline__ Event load(long long row, int slot, int, int,
                                        int, float u16_scale) const {
    const uint32_t e = ev[row + slot];
    const uint32_t idx = e & ((1u << idx_bits) - 1u);
    const uint32_t q = (e >> idx_bits) & ((1u << ts_bits) - 1u);
    // widen to the uint16 scale by bit replication (ts_bits in [12, 16])
    const uint32_t ts16 =
        ((q << (16 - ts_bits)) | (q >> (2 * ts_bits - 16))) & 0xFFFFu;
    Event out;
    out.x = static_cast<int>(idx % static_cast<uint32_t>(width));
    out.y = static_cast<int>(idx / static_cast<uint32_t>(width));
    out.tn = __fmul_rn(static_cast<float>(ts16), u16_scale);
    out.p = (e >> 31) ? 1.0f : -1.0f;
    return out;
  }
};

template <bool BF16>
__device__ __forceinline__ void deposit(unsigned long long* cell, float w) {
  if constexpr (BF16) {
    w = __bfloat162float(__float2bfloat16_rn(w));
  }
  // w * 2^32 is exact in f32 (a power-of-two scale); round to nearest
  const long long fixed = __float2ll_rn(__fmul_rn(w, kFixedScale));
  atomicAdd(cell, static_cast<unsigned long long>(fixed));
}

template <typename Wire, bool BF16>
__global__ void voxelize_deposit_kernel(Wire wire,
                                        const int* __restrict__ count,
                                        unsigned long long* __restrict__ acc,
                                        int E, int B, int H, int W,
                                        float u16_scale) {
  const int t = blockIdx.y;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= E) return;
  const int n = count[t];
  if (slot >= n) return;
  const long long row = static_cast<long long>(t) * E;
  const Event ev = wire.load(row, slot, n, E, B, u16_scale);
  if (ev.x < 0 || ev.x >= W || ev.y < 0 || ev.y >= H) return;

  const int lo = static_cast<int>(floorf(ev.tn));
  const float frac = __fsub_rn(ev.tn, static_cast<float>(lo));
  const long long plane = static_cast<long long>(H) * W;
  unsigned long long* cell = acc + static_cast<long long>(t) * B * plane +
                             static_cast<long long>(ev.y) * W + ev.x;
  if (lo >= 0 && lo < B) {
    deposit<BF16>(cell + lo * plane, __fmul_rn(ev.p, __fsub_rn(1.0f, frac)));
  }
  // lo + 1 >= 0: an unsorted timestamp with t_norm <= -1 deposits nothing
  if (lo + 1 >= 0 && lo + 1 < B) {
    deposit<BF16>(cell + (lo + 1) * plane, __fmul_rn(ev.p, frac));
  }
}

// Fixed point (two's complement int64 at 2^32) -> f32, one rounding.
__global__ void voxelize_fixed_to_f32_kernel(
    const long long* __restrict__ acc, float* __restrict__ out,
    long long size) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size) return;
  out[i] = __double2float_rn(__ll2double_rn(acc[i]) * kFixedInvScale);
}

constexpr int kThreads = 256;

template <typename Wire>
int launch(const Wire& wire, bool bf16, const int* count, void* acc,
           float* out, int T, int E, int B, int H, int W, float u16_scale,
           cudaStream_t stream) {
  const dim3 grid((E + kThreads - 1) / kThreads, T);
  auto* a = static_cast<unsigned long long*>(acc);
  if (bf16) {
    voxelize_deposit_kernel<Wire, true><<<grid, kThreads, 0, stream>>>(
        wire, count, a, E, B, H, W, u16_scale);
  } else {
    voxelize_deposit_kernel<Wire, false><<<grid, kThreads, 0, stream>>>(
        wire, count, a, E, B, H, W, u16_scale);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long size = static_cast<long long>(T) * B * H * W;
  const long long blocks = (size + kThreads - 1) / kThreads;
  voxelize_fixed_to_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(static_cast<const long long*>(acc),
                                           out, size);
  return static_cast<int>(cudaGetLastError());
}

template <typename C, typename TS>
int dispatch_pol(int pol_type, const void* xs, const void* ys, const void* ts,
                 const void* ps, bool bf16, const int* count, void* acc,
                 float* out, int T, int E, int B, int H, int W,
                 float u16_scale, cudaStream_t stream) {
  switch (pol_type) {
    case 0:
      return launch(SplitWire<C, TS, int8_t>{
                        static_cast<const C*>(xs), static_cast<const C*>(ys),
                        static_cast<const TS*>(ts),
                        static_cast<const int8_t*>(ps)},
                    bf16, count, acc, out, T, E, B, H, W, u16_scale, stream);
    case 1:
      return launch(SplitWire<C, TS, float>{
                        static_cast<const C*>(xs), static_cast<const C*>(ys),
                        static_cast<const TS*>(ts),
                        static_cast<const float*>(ps)},
                    bf16, count, acc, out, T, E, B, H, W, u16_scale, stream);
  }
  return -1;
}

template <typename C>
int dispatch_ts(int ts_type, int pol_type, const void* xs, const void* ys,
                const void* ts, const void* ps, bool bf16, const int* count,
                void* acc, float* out, int T, int E, int B, int H, int W,
                float u16_scale, cudaStream_t stream) {
  switch (ts_type) {
    case 0:
      return dispatch_pol<C, float>(pol_type, xs, ys, ts, ps, bf16, count,
                                    acc, out, T, E, B, H, W, u16_scale,
                                    stream);
    case 1:
      return dispatch_pol<C, uint16_t>(pol_type, xs, ys, ts, ps, bf16, count,
                                       acc, out, T, E, B, H, W, u16_scale,
                                       stream);
  }
  return -1;
}

}  // namespace

// Plain C interface, loaded with ctypes. `acc` is a zero-filled int64
// scratch of T * B * H * W cells, `out` the f32 output of the same size.
// `bf16` selects the bf16-factor (DEFAULT) variant. Type codes: coords
// 0 int16, 1 uint8, 2 int32, 3 float32; ts 0 float32, 1 uint16; ps 0 int8,
// 1 float32. Returns -1 for a type code it does not know, else the first
// non-zero cudaGetLastError() of its two launches (0 on success).
extern "C" int evreal_voxelize_windows(const void* xs, const void* ys,
                                       const void* ts, const void* ps,
                                       const void* count, void* acc,
                                       void* out, int T, int E, int B, int H,
                                       int W, int coord_type, int ts_type,
                                       int pol_type, int bf16,
                                       float u16_scale, void* stream) {
  const int* c = static_cast<const int*>(count);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b = bf16 != 0;
  switch (coord_type) {
    case 0:
      return dispatch_ts<int16_t>(ts_type, pol_type, xs, ys, ts, ps, b, c,
                                  acc, o, T, E, B, H, W, u16_scale, s);
    case 1:
      return dispatch_ts<uint8_t>(ts_type, pol_type, xs, ys, ts, ps, b, c,
                                  acc, o, T, E, B, H, W, u16_scale, s);
    case 2:
      return dispatch_ts<int32_t>(ts_type, pol_type, xs, ys, ts, ps, b, c,
                                  acc, o, T, E, B, H, W, u16_scale, s);
    case 3:
      return dispatch_ts<float>(ts_type, pol_type, xs, ys, ts, ps, b, c, acc,
                                o, T, E, B, H, W, u16_scale, s);
  }
  return -1;
}

// The packed compact4 wire: `ev` (T, E) uint32, the layout's idx_bits and
// ts_bits (12..16) from data/packing.py:compact4_layout.
extern "C" int evreal_voxelize_compact4(const void* ev, const void* count,
                                        void* acc, void* out, int T, int E,
                                        int B, int H, int W, int idx_bits,
                                        int ts_bits, int bf16,
                                        float u16_scale, void* stream) {
  if (ts_bits < 12 || ts_bits > 16 || idx_bits < 1 ||
      idx_bits + ts_bits > 31) {
    return -1;
  }
  const Compact4Wire wire{static_cast<const uint32_t*>(ev), idx_bits, ts_bits,
                          W};
  return launch(wire, bf16 != 0, static_cast<const int*>(count), acc,
                static_cast<float*>(out), T, E, B, H, W, u16_scale,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* evreal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
