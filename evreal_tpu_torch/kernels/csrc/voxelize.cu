// Event voxelizer for Hopper (sm_90a): a chunk of T windows in one launch.
//
// Replaces the two Pallas TPU kernels of evreal_tpu/kernels/voxelize_pallas.py:
//   K1 `_kernel` (pallas_call at :93), one window, reached through
//      `voxelize_pallas` / `voxelize` — here the T = 1 case;
//   K2 `_batched_kernel` (pallas_call at :249), a chunk of windows, reached
//      through `voxelize_pallas_windows` — its f32 (HIGHEST) variant.
// The math is ops/voxelize.py's: each valid in-bounds event adds
// p * (1 - frac) to bin lo = floor(t_norm) and p * frac to bin lo + 1 at
// (y, x). The TPU kernels built one-hot factors for the matrix unit; that
// layout does not bind this port. Here one thread owns one event slot and
// does the per-event prep (ops/voxelize.py:_t_norm and _event_rows_cols)
// itself, then deposits with two atomicAdds into the zero-filled output.
//
// Bound on the card: bytes. At the eval path's shape (T = 32, E = 32768,
// 5 x 180 x 240) the events are ~9.4 MB on the f32 wire and the output
// 27.6 MB, written once: ~11 us at 3.35 TB/s, while the arithmetic is a few
// dozen operations per event. This first design pays above that bound for
// the wrapper's zero-fill of the output and the atomics' read-modify-write
// in L2; the reads of xs/ys/ts/ps are coalesced (neighbouring threads,
// neighbouring slots) and slots past `count` read nothing but `count`.
//
// Rounding: every multiply, add and divide is written with the _rn
// intrinsics (and the library is built with --fmad=false, no fast math), so
// nothing is contracted into an FMA and `/` stays IEEE division: t_norm,
// frac and the two weights are bit-identical to the JAX package's f32 ops.
//
// Determinism: float atomics add in an order that changes from run to run,
// so the sums differ between runs at the ulp level (bounded by the
// tolerance atol 2e-5 against the plain version). A deterministic mode
// (deposits summed in event order) is required before the batched runner
// is ported, for batched == single and sharded == unsharded.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Coordinates truncate toward zero, as astype(int32) / Tensor.long() do
// (the float -> int conversion is cvt.rzi).
template <typename C>
__device__ __forceinline__ int to_coord(C v) {
  return static_cast<int>(v);
}

template <typename C, typename TS, typename P>
__global__ void voxelize_windows_kernel(
    const C* __restrict__ xs, const C* __restrict__ ys,
    const TS* __restrict__ ts, const P* __restrict__ ps,
    const int* __restrict__ count, float* __restrict__ out, int E, int B,
    int H, int W, float u16_scale) {
  const int t = blockIdx.y;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= E) return;
  const int n = count[t];
  if (slot >= n) return;
  const long long row = static_cast<long long>(t) * E;
  const int x = to_coord(xs[row + slot]);
  const int y = to_coord(ys[row + slot]);
  if (x < 0 || x >= W || y < 0 || y >= H) return;

  float tn;
  if constexpr (sizeof(TS) == 2) {
    // uint16 (compact) wire: window-normalized fraction, the scale
    // f32((B - 1) / 65535) computed in double on the host
    tn = __fmul_rn(static_cast<float>(ts[row + slot]), u16_scale);
  } else {
    const float span = static_cast<float>(B - 1);
    const float ts0 = ts[row];
    int last = n - 1;
    last = last < 0 ? 0 : (last > E - 1 ? E - 1 : last);
    const float dt = __fsub_rn(ts[row + last], ts0);
    if (dt < 1e-9f) {
      // degenerate window: linspace(0, B - 1, n) over the first n slots
      const int denom = n - 1 > 1 ? n - 1 : 1;
      tn = __fdiv_rn(__fmul_rn(static_cast<float>(slot), span),
                     static_cast<float>(denom));
    } else {
      tn = __fmul_rn(__fdiv_rn(__fsub_rn(ts[row + slot], ts0),
                               fmaxf(dt, 1e-38f)),
                     span);
    }
  }
  const int lo = static_cast<int>(floorf(tn));
  const float frac = __fsub_rn(tn, static_cast<float>(lo));
  const float p = static_cast<float>(ps[row + slot]);

  const long long plane = static_cast<long long>(H) * W;
  float* cell = out + static_cast<long long>(t) * B * plane +
                static_cast<long long>(y) * W + x;
  if (lo >= 0 && lo < B) {
    atomicAdd(cell + lo * plane, __fmul_rn(p, __fsub_rn(1.0f, frac)));
  }
  // lo + 1 >= 0: an unsorted timestamp with t_norm <= -1 deposits nothing
  if (lo + 1 >= 0 && lo + 1 < B) {
    atomicAdd(cell + (lo + 1) * plane, __fmul_rn(p, frac));
  }
}

constexpr int kThreads = 256;

template <typename C, typename TS, typename P>
void launch(const void* xs, const void* ys, const void* ts, const void* ps,
            const int* count, float* out, int T, int E, int B, int H, int W,
            float u16_scale, cudaStream_t stream) {
  const dim3 grid((E + kThreads - 1) / kThreads, T);
  voxelize_windows_kernel<C, TS, P><<<grid, kThreads, 0, stream>>>(
      static_cast<const C*>(xs), static_cast<const C*>(ys),
      static_cast<const TS*>(ts), static_cast<const P*>(ps), count, out, E,
      B, H, W, u16_scale);
}

template <typename C, typename TS>
int dispatch_pol(int pol_type, const void* xs, const void* ys, const void* ts,
                 const void* ps, const int* count, float* out, int T, int E,
                 int B, int H, int W, float u16_scale, cudaStream_t stream) {
  switch (pol_type) {
    case 0:
      launch<C, TS, int8_t>(xs, ys, ts, ps, count, out, T, E, B, H, W,
                            u16_scale, stream);
      return 0;
    case 1:
      launch<C, TS, float>(xs, ys, ts, ps, count, out, T, E, B, H, W,
                           u16_scale, stream);
      return 0;
  }
  return -1;
}

template <typename C>
int dispatch_ts(int ts_type, int pol_type, const void* xs, const void* ys,
                const void* ts, const void* ps, const int* count, float* out,
                int T, int E, int B, int H, int W, float u16_scale,
                cudaStream_t stream) {
  switch (ts_type) {
    case 0:
      return dispatch_pol<C, float>(pol_type, xs, ys, ts, ps, count, out, T,
                                    E, B, H, W, u16_scale, stream);
    case 1:
      return dispatch_pol<C, uint16_t>(pol_type, xs, ys, ts, ps, count, out,
                                       T, E, B, H, W, u16_scale, stream);
  }
  return -1;
}

}  // namespace

// Plain C interface, loaded with ctypes. Type codes: coords 0 int16,
// 1 uint8, 2 int32, 3 float32; ts 0 float32, 1 uint16; ps 0 int8,
// 1 float32. Returns -1 for a type code it does not know, else
// cudaGetLastError() after the launch (0 on success).
extern "C" int evreal_voxelize_windows(const void* xs, const void* ys,
                                       const void* ts, const void* ps,
                                       const void* count, void* out, int T,
                                       int E, int B, int H, int W,
                                       int coord_type, int ts_type,
                                       int pol_type, float u16_scale,
                                       void* stream) {
  const int* c = static_cast<const int*>(count);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  switch (coord_type) {
    case 0:
      rc = dispatch_ts<int16_t>(ts_type, pol_type, xs, ys, ts, ps, c, o, T,
                                E, B, H, W, u16_scale, s);
      break;
    case 1:
      rc = dispatch_ts<uint8_t>(ts_type, pol_type, xs, ys, ts, ps, c, o, T,
                                E, B, H, W, u16_scale, s);
      break;
    case 2:
      rc = dispatch_ts<int32_t>(ts_type, pol_type, xs, ys, ts, ps, c, o, T,
                                E, B, H, W, u16_scale, s);
      break;
    case 3:
      rc = dispatch_ts<float>(ts_type, pol_type, xs, ys, ts, ps, c, o, T, E,
                              B, H, W, u16_scale, s);
      break;
  }
  if (rc != 0) return -1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* evreal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
