// Event voxelizer for Hopper (sm_90a): a chunk of T windows per call, by
// one of two paths (kernels/voxelize_cuda.py:route picks it from the shape):
// the direct path for one window (T = 1), the tiled path for a chunk.
//
// Replaces the Pallas TPU kernels of evreal_tpu/kernels/voxelize_pallas.py:
//   K1 `_kernel` (pallas_call at :93), one window, reached through
//      `voxelize_pallas` / `voxelize` — the direct path below;
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
// layout does not bind this port. Here the threads that read an event do
// its per-event prep (ops/voxelize.py:t_norm and event_deposits) themselves,
// reading its wire's bytes directly: split buffers xs/ys/ts/ps of any wire
// dtype, or the packed compact4 word, decoded in the thread exactly as
// ops/voxelize.py:decode_compact4 does.
//
// The direct path (one window; evreal_voxelize_direct). One window's whole
// (B, H, W) grid is small: 216,000 int64 cells, 1.73 MB at 5 x 180 x 240,
// which stays in the 50 MB L2. On sm_90 a 64-bit integer atomicAdd to
// global memory is native (RED.E.ADD.64, done in L2), unlike the shared one
// (a compare-and-swap loop, below). So one window needs no tiles, no
// binning and no records. Two launches, no memset:
//   1. deposit (grid: E / 256 blocks x T, 128 at E = 32768): each thread
//      decodes two events with the wire's own load, computes t_norm, lo,
//      frac and the weights with the same _rn arithmetic as the tiled path,
//      rounds each deposit to fixed point (fixed_point below, the same
//      rounding as `deposit`) and adds it with one 64-bit atomicAdd into a
//      (T, B, H, W) int64 scratch that is zero when the launch starts;
//   2. finish (grid: one block per 1024 cells, 211 at one window): each
//      thread converts its cells with fixed_to_f32, writes the output and
//      writes 0 back, so the scratch is zero again when the call ends and
//      every output cell is written once.
// The wrapper keeps one scratch per (device, stream) and drops it when a
// launch reports an error (it may no longer be zero). The sums are integer
// sums, so they do not depend on the order of the atomics: the direct path
// equals the tiled path and the int64 plain version bit for bit.
// Bound at T = 1: the bytes bound (1.13 MB of a 30,000-event window, 0.34
// us) is below one launch, so the floor is the launch latency and the
// host's enqueue (hence the cached plan and the short C entry). On the
// device the deposits' L2 atomics bound it: the events of a moving blob hit
// few pixels, and atomics to one cell serialize in L2. The finish kernel
// reads, converts and clears the whole dense grid, so the path's device time
// grows with T * B * H * W, and the scratch leaves L2 as T grows: the tiled
// path keeps every T > 1.
//
// The tiled path (a chunk; evreal_voxelize_windows, evreal_voxelize_compact4)
// bins the events by tile, then sums each tile in shared memory. The
// wrapper cuts each window's (B, H, W) grid into tiles of rows x cols pixels
// (kernels/voxelize_cuda.py:tile_plan): bands of whole rows where a row
// fits, else pieces of a row, so that a tile's B * rows * cols int64 cells
// fit one block's shared memory with two blocks on an SM. Three launches:
//   1. count (grid: event blocks x T): a block decodes the coordinates of
//      its events, counts the valid in-bounds ones per tile in shared
//      memory and adds each non-zero count to the (T, tiles) int32 counts
//      with one global atomic. The last of a window's blocks to finish scans
//      the window's counts into segment starts, and sets the scatter's
//      cursors to them;
//   2. scatter (same shape of grid): a block reserves its run in each tile's
//      segment with one global atomic on the cursors and writes one record
//      per valid in-bounds event into the (T, E) records: its tile-local
//      pixel, its polarity and its t_norm, in 8 bytes, or in 4 on the wires
//      with a 16-bit timestamp (Record below). The order inside a segment
//      changes from run to run; the sums below do not depend on it;
//   3. accumulate (persistent blocks, as many as fit on the card): a block
//      claims (window, tile) pairs one after another from a global counter,
//      adds the deposits of the tile's records into its int64 cells in
//      dynamic shared memory, then converts every cell once and writes the
//      f32 tile, clearing each cell as it reads it. Empty cells write 0, so
//      each output cell is written exactly once and the output needs no
//      fill. A block loads the next tile's records while it writes this one.
// No scratch of the output's size exists: besides the output there are the
// (T, E) records and 3 * T * tiles + T + 1 int32 (counts, starts, cursors,
// finished blocks per window, the claim counter), the only memory zeroed.
// Each thread issues all of its loads before it uses any: the blocks are
// short, and a block that waited on one load at a time would be bound by
// the memory's latency, not by its bandwidth.
//
// Deterministic accumulation. Float atomics add in an order that changes
// from run to run, so their sums would differ at the ulp level between runs
// and between groupings of windows. Instead each deposit is rounded to a
// fixed-point integer at a scale of 2^32 and added into the tile's int64
// cell (two's complement), exactly; integer addition is associative, so the
// sum of every cell is the same whatever the order of the records and of
// the atomics. Each cell is then converted to f32 with one rounding (int64 ->
// double is exact below 2^53, the 2^-32 scale is exact, then one double ->
// f32 rounding). A window's cells are its own, and the tiles depend on
// (B, H, W) only, so a window's grid does not depend on which windows share
// a launch: one launch over 32 windows equals two over 16 + 16, bit for bit.
// The plain version ops/voxelize.py:voxelize_windows_plain(accum_dtype=
// torch.int64) does the same arithmetic and equals these kernels bit for bit.
// Range: |p| = 1 on every wire the packer writes (the polarity convention of
// data/packing.py), so the record keeps the sign of p only (p > 0), |w| <= 1
// and a cell takes at most E deposits: its magnitude stays below
// E * 2^32 <= 2^63 for any E < 2^31. Rounding costs at most 2^-33 per
// deposit, so a cell of k deposits is within k * 2^-33 of the exact sum
// (3.8e-6 even at k = E = 32768), far inside the 2e-5 tolerance against the
// float64 plain version.
//
// Bound on the card: bytes. The least traffic is each valid event read once
// and the f32 output written once (at the bf16 lockstep launch, 512 windows
// of 5 x 180 x 240 on compact4: 59.5 MB + 442 MB, 0.150 ms at 3.35 TB/s).
// This design reads the events twice (count, scatter), writes and reads a
// record per event (4 bytes there), and writes the output once: ~0.68 GB
// there, ~0.20 ms. The int64 cells live only in shared memory. A 64-bit shared
// atomic add compiles to a compare-and-swap loop on sm_90
// (ATOMS.CAST.SPIN.64), so a deposit is two native 32-bit atomics with the
// carry handled by the thread (deposit below).
//
// Rounding: every multiply, add and divide is written with the _rn
// intrinsics (and the library is built with --fmad=false, no fast math), so
// nothing is contracted into an FMA and `/` stays IEEE division: t_norm,
// frac and the two weights are bit-identical to the JAX package's f32 ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr float kFixedScale = 4294967296.0f;     // 2^32
constexpr double kFixedInvScale = 1.0 / 4294967296.0;
// Block shapes: threads, and event slots (records) a thread loads at once.
constexpr int kCountThreads = 128;
constexpr int kCountItems = 8;
constexpr int kScatterThreads = 256;
constexpr int kScatterItems = 2;
constexpr int kAccThreads = 512;
constexpr int kAccItems = 4;
// The scatter block keeps two int32 arrays of one entry per tile in its
// shared memory, within the 48 KB a launch may take without opting in
// (kernels/voxelize_cuda.py:MAX_TILES is the same number).
constexpr int kMaxTiles = 4096;
// The dynamic shared memory one block can take on sm_90: 227 KB.
constexpr long long kMaxTileBytes = 232448;
constexpr int kMaxDevices = 64;
constexpr unsigned kFullMask = 0xffffffffu;

// n / d and n % d for 0 <= n < 2^24 and d >= 1, without an integer
// division: the estimate trunc(n * f32(1 / d)) is exact for a power of two
// and off by at most one otherwise (relative error <= 2^-23, and
// n / d < 2^24 / 3 for d >= 3), which one correction step removes.
struct FastDiv {
  int d;
  float rcp;

  __device__ __forceinline__ int div(int n, int* rem) const {
    int q = __float2int_rz(__fmul_rn(__int2float_rn(n), rcp));
    int r = n - q * d;
    if (r < 0) {
      --q;
      r += d;
    } else if (r >= d) {
      ++q;
      r -= d;
    }
    *rem = r;
    return q;
  }
};

FastDiv fast_div(int d) { return FastDiv{d, 1.0f / static_cast<float>(d)}; }

// Coordinates truncate toward zero, as astype(int32) / Tensor.long() do
// (the float -> int conversion is cvt.rzi).
template <typename C>
__device__ __forceinline__ int to_coord(C v) {
  return static_cast<int>(v);
}

// One event as the deposit step needs it; ts16 is the 16-bit timestamp of
// the wires that carry one (tn = ts16 * u16_scale there).
struct Event {
  int x, y;
  float tn, p;
  uint32_t ts16;
};

// Split buffers: xs, ys (C), ts (f32 zero-based seconds, or uint16
// window-normalized fractions on the compact wire), ps (P).
template <typename C, typename TS, typename P>
struct SplitWire {
  // a 16-bit timestamp fits a 4-byte record (Record below)
  static constexpr bool kShortRecord = sizeof(TS) == 2;
  const C* xs;
  const C* ys;
  const TS* ts;
  const P* ps;

  __device__ __forceinline__ void coords(long long row, int slot, int* x,
                                         int* y) const {
    *x = to_coord(xs[row + slot]);
    *y = to_coord(ys[row + slot]);
  }

  __device__ __forceinline__ Event load(long long row, int slot, int n, int E,
                                        int B, float u16_scale) const {
    Event ev;
    coords(row, slot, &ev.x, &ev.y);
    if constexpr (sizeof(TS) == 2) {
      // uint16 (compact) wire: window-normalized fraction, the scale
      // f32((B - 1) / 65535) computed in double on the host
      ev.ts16 = ts[row + slot];
      ev.tn = __fmul_rn(static_cast<float>(ev.ts16), u16_scale);
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
  static constexpr bool kShortRecord = true;
  const uint32_t* ev;
  int idx_bits, ts_bits;
  FastDiv width;  // idx < 2^19 (idx_bits + ts_bits <= 31, ts_bits >= 12)

  __device__ __forceinline__ void coords(long long row, int slot, int* x,
                                         int* y) const {
    const int idx = static_cast<int>(ev[row + slot] & ((1u << idx_bits) - 1u));
    *y = width.div(idx, x);
  }

  __device__ __forceinline__ Event load(long long row, int slot, int, int,
                                        int, float u16_scale) const {
    const uint32_t e = ev[row + slot];
    const uint32_t idx = e & ((1u << idx_bits) - 1u);
    const uint32_t q = (e >> idx_bits) & ((1u << ts_bits) - 1u);
    // widen to the uint16 scale by bit replication (ts_bits in [12, 16])
    const uint32_t ts16 =
        ((q << (16 - ts_bits)) | (q >> (2 * ts_bits - 16))) & 0xFFFFu;
    Event out;
    out.y = width.div(static_cast<int>(idx), &out.x);
    out.ts16 = ts16;
    out.tn = __fmul_rn(static_cast<float>(ts16), u16_scale);
    out.p = (e >> 31) ? 1.0f : -1.0f;
    return out;
  }
};

// A record: an event as the accumulate kernel needs it, in its tile. The
// 8-byte record holds the tile-local pixel offset shifted left by one with
// the polarity in bit 0, then the f32 bits of t_norm. On the wires with a
// 16-bit timestamp the 4-byte record holds the offset in bits 17-31 (a
// tile has at most 232448 / 8 < 2^15 pixels), the polarity in bit 16 and
// the timestamp in bits 0-15, and t_norm is recomputed from it with the
// wire's own product, so both records give the same bits.
template <bool kShort>
struct Record {
  using Word = uint2;
  __device__ __forceinline__ static Word pack(int local, const Event& ev) {
    return make_uint2((static_cast<uint32_t>(local) << 1) |
                          (ev.p > 0.0f ? 1u : 0u),
                      __float_as_uint(ev.tn));
  }
  __device__ __forceinline__ static int pixel(Word r) { return r.x >> 1; }
  __device__ __forceinline__ static bool positive(Word r) { return r.x & 1u; }
  __device__ __forceinline__ static float tn(Word r, float) {
    return __uint_as_float(r.y);
  }
};

template <>
struct Record<true> {
  using Word = uint32_t;
  __device__ __forceinline__ static Word pack(int local, const Event& ev) {
    return (static_cast<uint32_t>(local) << 17) |
           (ev.p > 0.0f ? 1u << 16 : 0u) | ev.ts16;
  }
  __device__ __forceinline__ static int pixel(Word r) { return r >> 17; }
  __device__ __forceinline__ static bool positive(Word r) {
    return (r >> 16) & 1u;
  }
  __device__ __forceinline__ static float tn(Word r, float u16_scale) {
    return __fmul_rn(static_cast<float>(r & 0xFFFFu), u16_scale);
  }
};

// Tiles of rows x cols pixels, `across` of them side by side in a band of
// rows, `n` per window; tile (i, j) starts at pixel (i * rows, j * cols).
// A tile's cells are [bin][row][col], `cols` wide even where the tile is
// cut by the grid's edge.
struct Tiles {
  FastDiv rows, cols;  // H, W < 2^24
  int across, n;

  // The tile of in-bounds pixel (x, y), and the pixel's offset in it.
  __device__ __forceinline__ int of(int x, int y, int* local) const {
    int ry, rx;
    const int ty = rows.div(y, &ry);
    const int tx = cols.div(x, &rx);
    *local = ry * cols.d + rx;
    return ty * across + tx;
  }
};

__device__ __forceinline__ bool in_bounds(int x, int y, int H, int W) {
  return x >= 0 && x < W && y >= 0 && y < H;
}

// Exclusive prefix sum of in[0, n) (global memory, read through L2) into
// out[0, n) (shared memory) by a block of kCountThreads. The caller
// synchronizes before reading out.
__device__ void block_exclusive_scan(const int* in, int* out, int n) {
  __shared__ int warp_total[kCountThreads / 32];
  const int per = (n + kCountThreads - 1) / kCountThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += __ldcg(in + i);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inclusive = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFullMask, inclusive, d);
    if (lane >= d) inclusive += v;
  }
  if (lane == 31) warp_total[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kCountThreads / 32 ? warp_total[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFullMask, w, d);
      if (lane >= d) w += v;
    }
    if (lane < kCountThreads / 32) warp_total[lane] = w;
  }
  __syncthreads();
  int run = inclusive - sum + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run += __ldcg(in + i);
  }
}

// 1. Events per (window, tile), then segment starts.
template <typename Wire>
__global__ void __launch_bounds__(kCountThreads)
    voxelize_count_kernel(Wire wire, const int* __restrict__ count,
                          int* tile_counts, int* __restrict__ starts,
                          int* __restrict__ cursors, int* __restrict__ done,
                          int E, int H, int W, Tiles g) {
  constexpr int kSlots = kCountThreads * kCountItems;
  extern __shared__ int hist[];
  __shared__ bool last;
  const int t = blockIdx.y;
  const int n = min(count[t], E);
  const int first = blockIdx.x * kSlots;
  // the whole block lies past the window's count: nothing to count
  if (first >= n) return;
  for (int i = threadIdx.x; i < g.n; i += kCountThreads) hist[i] = 0;
  const long long row = static_cast<long long>(t) * E;
  int x[kCountItems], y[kCountItems];
#pragma unroll
  for (int k = 0; k < kCountItems; ++k) {
    const int slot = first + k * kCountThreads + threadIdx.x;
    x[k] = -1;
    y[k] = -1;
    if (slot < n) wire.coords(row, slot, &x[k], &y[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCountItems; ++k) {
    int local;
    if (in_bounds(x[k], y[k], H, W)) {
      atomicAdd(&hist[g.of(x[k], y[k], &local)], 1);
    }
  }
  __syncthreads();
  const long long tiles_row = static_cast<long long>(t) * g.n;
  for (int i = threadIdx.x; i < g.n; i += kCountThreads) {
    if (hist[i]) atomicAdd(tile_counts + tiles_row + i, hist[i]);
  }
  // each block's counts reach L2 before its ticket: the last ticket sees
  // them all (the threadfence reduction of the CUDA samples)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(done + t, 1) == (n + kSlots - 1) / kSlots - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  block_exclusive_scan(tile_counts + tiles_row, hist, g.n);
  __syncthreads();
  for (int i = threadIdx.x; i < g.n; i += kCountThreads) {
    starts[tiles_row + i] = hist[i];
    cursors[tiles_row + i] = hist[i];
  }
}

// 2. One record per valid in-bounds event, in its tile's segment of the
// window's row of records.
template <typename Wire>
__global__ void __launch_bounds__(kScatterThreads)
    voxelize_scatter_kernel(Wire wire, const int* __restrict__ count,
                            int* __restrict__ cursors, void* records, int E,
                            int B, int H, int W, float u16_scale, Tiles g) {
  using Rec = Record<Wire::kShortRecord>;
  extern __shared__ int smem[];
  int* hist = smem;        // per tile: this block's records
  int* base = smem + g.n;  // per tile: this block's first record
  const int t = blockIdx.y;
  const int n = count[t];
  const int valid = min(n, E);
  const int first = blockIdx.x * kScatterThreads * kScatterItems;
  if (first >= valid) return;
  for (int i = threadIdx.x; i < g.n; i += kScatterThreads) hist[i] = 0;
  const long long row = static_cast<long long>(t) * E;
  Event ev[kScatterItems];
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    const int slot = first + k * kScatterThreads + threadIdx.x;
    ev[k] = Event{-1, -1, 0.0f, 0.0f, 0u};
    if (slot < valid) ev[k] = wire.load(row, slot, n, E, B, u16_scale);
  }
  __syncthreads();
  int tile[kScatterItems], rank[kScatterItems], local[kScatterItems];
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    tile[k] = in_bounds(ev[k].x, ev[k].y, H, W)
                  ? g.of(ev[k].x, ev[k].y, &local[k])
                  : -1;
    if (tile[k] >= 0) rank[k] = atomicAdd(&hist[tile[k]], 1);
  }
  __syncthreads();
  int* cur = cursors + static_cast<long long>(t) * g.n;
  for (int i = threadIdx.x; i < g.n; i += kScatterThreads) {
    if (hist[i]) base[i] = atomicAdd(cur + i, hist[i]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    if (tile[k] < 0) continue;
    static_cast<typename Rec::Word*>(records)[row + base[tile[k]] + rank[k]] =
        Rec::pack(local[k], ev[k]);
  }
}

// A deposit w in two's complement fixed point at 2^32; BF16 rounds w to
// bf16 (round to nearest even) first.
template <bool BF16>
__device__ __forceinline__ unsigned long long fixed_point(float w) {
  if constexpr (BF16) {
    w = __bfloat162float(__float2bfloat16_rn(w));
  }
  // w * 2^32 is exact in f32 (a power-of-two scale); round to nearest
  return static_cast<unsigned long long>(
      __float2ll_rn(__fmul_rn(w, kFixedScale)));
}

// Adds w, rounded to fixed point at 2^32, to the int64 cell in shared
// memory. The add is two native 32-bit atomics: the low words add modulo
// 2^32, and the thread whose add wraps the low word carries one into the
// high word with its own high word. The low word only grows (as unsigned),
// so the carries counted are exactly the wraps of the low word's sum, and
// the final (high, low) pair is the exact two's complement sum, whatever
// the order of the adds.
template <bool BF16>
__device__ __forceinline__ void deposit(unsigned long long* cell, float w) {
  const unsigned long long fixed = fixed_point<BF16>(w);
  unsigned* word = reinterpret_cast<unsigned*>(cell);  // little endian
  const unsigned lo = static_cast<unsigned>(fixed);
  const unsigned old = atomicAdd(word, lo);
  const unsigned hi = static_cast<unsigned>(fixed >> 32) + (old + lo < old);
  if (hi) atomicAdd(word + 1, hi);
}

// Fixed point (two's complement int64 at 2^32) -> f32, one rounding.
__device__ __forceinline__ float fixed_to_f32(long long v) {
  return __double2float_rn(__ll2double_rn(v) * kFixedInvScale);
}

// A tile's records: its window and its run in the window's row.
struct Segment {
  int t, start, len;
};

// The segment of (window, tile) pair w = t * tiles + tile; none past total.
__device__ __forceinline__ Segment segment(const int* tile_counts,
                                           const int* starts, int w,
                                           int total, const Tiles& g) {
  if (w >= total) return Segment{0, 0, 0};
  return Segment{w / g.n, starts[w], tile_counts[w]};
}

// Loads the records [i0, i0 + kAccItems * kAccThreads) of a segment that
// exist, kAccThreads apart.
template <typename Word>
__device__ __forceinline__ void load_records(Word (&r)[kAccItems],
                                             const Word* records, int E,
                                             const Segment& s, int i0) {
  const Word* rec = records + static_cast<long long>(s.t) * E + s.start;
#pragma unroll
  for (int k = 0; k < kAccItems; ++k) {
    const int i = i0 + k * kAccThreads + threadIdx.x;
    if (i < s.len) r[k] = rec[i];
  }
}

template <bool BF16, typename Rec>
__device__ __forceinline__ void deposit_records(
    unsigned long long* acc, const typename Rec::Word (&r)[kAccItems], int i0,
    int len, int B, int plane, float u16_scale) {
#pragma unroll
  for (int k = 0; k < kAccItems; ++k) {
    if (i0 + k * kAccThreads + static_cast<int>(threadIdx.x) >= len) break;
    const float p = Rec::positive(r[k]) ? 1.0f : -1.0f;
    const float tn = Rec::tn(r[k], u16_scale);
    const int lo = static_cast<int>(floorf(tn));
    const float frac = __fsub_rn(tn, static_cast<float>(lo));
    unsigned long long* cell = acc + Rec::pixel(r[k]);
    if (lo >= 0 && lo < B) {
      deposit<BF16>(cell + lo * plane, __fmul_rn(p, __fsub_rn(1.0f, frac)));
    }
    // lo + 1 >= 0: an unsorted timestamp with t_norm <= -1 deposits nothing
    if (lo + 1 >= 0 && lo + 1 < B) {
      deposit<BF16>(cell + (lo + 1) * plane, __fmul_rn(p, frac));
    }
  }
}

// 3. Persistent blocks: block b takes pair b first, then claims the pairs
// gridDim.x, gridDim.x + 1, ... from the counter `claims` as it goes (a
// window's tiles hold very different numbers of records, so a fixed share
// per block would leave the card waiting on the slowest). Per pair: sum the
// tile in shared memory, then write it, reading each cell back and clearing
// it for the next pair. The next pair's first records are loaded, and the
// pair after it claimed, while this one is summed and written.
template <bool BF16, typename Rec>
__global__ void __launch_bounds__(kAccThreads)
    voxelize_accumulate_kernel(const typename Rec::Word* __restrict__ records,
                               const int* __restrict__ tile_counts,
                               const int* __restrict__ starts,
                               int* __restrict__ claims,
                               float* __restrict__ out, int T, int E, int B,
                               int H, int W, float u16_scale, Tiles g) {
  extern __shared__ unsigned long long acc[];
  __shared__ int claimed;
  const int total = T * g.n;
  const int plane = g.rows.d * g.cols.d;  // cells of one bin of the tile
  const int chunk = kAccItems * kAccThreads;
  const long long hw = static_cast<long long>(H) * W;
  if (threadIdx.x == 0) claimed = gridDim.x + atomicAdd(claims, 1);
  for (int i = threadIdx.x; i < B * plane; i += kAccThreads) acc[i] = 0ull;
  __syncthreads();
  int w = blockIdx.x;
  int w_next = claimed;
  Segment cur = segment(tile_counts, starts, w, total, g);
  Segment next = segment(tile_counts, starts, w_next, total, g);
  typename Rec::Word r[kAccItems];
  load_records(r, records, E, cur, 0);
  while (w < total) {
    int claim = 0;
    if (threadIdx.x == 0) claim = gridDim.x + atomicAdd(claims, 1);
    __syncthreads();  // the tile's cells are zero; `claimed` was read
    deposit_records<BF16, Rec>(acc, r, 0, cur.len, B, plane, u16_scale);
    for (int i0 = chunk; i0 < cur.len; i0 += chunk) {
      load_records(r, records, E, cur, i0);
      deposit_records<BF16, Rec>(acc, r, i0, cur.len, B, plane, u16_scale);
    }
    load_records(r, records, E, next, 0);  // summed in the next pass
    if (threadIdx.x == 0) claimed = claim;
    __syncthreads();  // every deposit is in
    const int w_after = claimed;
    const Segment after = segment(tile_counts, starts, w_after, total, g);
    const int tile = w - cur.t * g.n;
    const int ty = tile / g.across;
    const int tx = tile - ty * g.across;
    const int y0 = ty * g.rows.d;
    const int x0 = tx * g.cols.d;
    const int rh = min(g.rows.d, H - y0);
    const int cw = min(g.cols.d, W - x0);
    float* o = out + static_cast<long long>(cur.t) * B * hw +
               static_cast<long long>(y0) * W + x0;
    for (int b = 0; b < B; ++b) {
      unsigned long long* a = acc + b * plane;
      float* ob = o + b * hw;
      if (cw == W) {
        // a band of whole rows: contiguous in the tile and in the output
        for (int j = threadIdx.x; j < rh * W; j += kAccThreads) {
          ob[j] = fixed_to_f32(static_cast<long long>(a[j]));
          a[j] = 0ull;
        }
      } else {
        for (int j = threadIdx.x; j < rh * cw; j += kAccThreads) {
          const int r0 = j / cw;
          const int c = r0 * g.cols.d + j - r0 * cw;
          ob[static_cast<long long>(r0) * W + (j - r0 * cw)] =
              fixed_to_f32(static_cast<long long>(a[c]));
          a[c] = 0ull;
        }
      }
    }
    w = w_next;
    w_next = w_after;
    cur = next;
    next = after;
  }
}

// The dynamic shared memory granted to an accumulate kernel and its
// persistent grid, per device; set at the first launch of a tile size.
struct Residency {
  int bytes = -1;
  int blocks = 0;
};

// The grid of the process's last accumulate launch, for
// evreal_last_accumulate_grid.
std::atomic<int> last_accumulate_grid{0};

template <bool BF16, typename Rec>
cudaError_t accumulate(const void* records, const int* tile_counts,
                       const int* starts, int* claims, float* out, int T,
                       int E, int B, int H, int W, float u16_scale,
                       const Tiles& g, int bytes, cudaStream_t stream) {
  static Residency residency[kMaxDevices];
  auto* kernel = voxelize_accumulate_kernel<BF16, Rec>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  Residency& res = residency[device];
  if (res.bytes != bytes) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kAccThreads, bytes);
    if (err != cudaSuccess) return err;
    res.bytes = bytes;
    res.blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int total = T * g.n;
  const int grid = total < res.blocks ? total : res.blocks;
  last_accumulate_grid.store(grid, std::memory_order_relaxed);
  kernel<<<grid, kAccThreads, bytes, stream>>>(
      static_cast<const typename Rec::Word*>(records), tile_counts, starts,
      claims, out, T, E, B, H, W, u16_scale, g);
  return cudaGetLastError();
}

// `scratch` holds the (T, E) records, then the int32 counters that the
// launch zeroes.
template <typename Wire>
int launch(const Wire& wire, bool bf16, const int* count, void* scratch,
           float* out, int T, int E, int B, int H, int W, int rows, int cols,
           float u16_scale, cudaStream_t stream) {
  if (rows < 1 || cols < 1 || B < 1 || H >= (1 << 24) || W >= (1 << 24)) {
    return -1;
  }
  Tiles g;
  g.rows = fast_div(rows);
  g.cols = fast_div(cols);
  g.across = (W + cols - 1) / cols;
  const long long n = static_cast<long long>((H + rows - 1) / rows) * g.across;
  const long long bytes = 8LL * B * rows * cols;
  if (n > kMaxTiles || bytes > kMaxTileBytes ||
      static_cast<long long>(T) * n > 0x7fffffffLL) {
    return -1;
  }
  g.n = static_cast<int>(n);
  const long long pairs = static_cast<long long>(T) * g.n;
  // the records' room is 8 bytes a slot, whichever record the wire takes
  int* tile_counts = reinterpret_cast<int*>(static_cast<uint2*>(scratch) +
                                            static_cast<long long>(T) * E);
  int* starts = tile_counts + pairs;
  int* cursors = starts + pairs;
  int* done = cursors + pairs;
  int* claims = done + T;
  cudaError_t err = cudaMemsetAsync(
      tile_counts, 0, sizeof(int) * (3 * pairs + T + 1), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kCountSlots = kCountThreads * kCountItems;
  constexpr int kScatterSlots = kScatterThreads * kScatterItems;
  voxelize_count_kernel<Wire>
      <<<dim3((E + kCountSlots - 1) / kCountSlots, T), kCountThreads,
         g.n * sizeof(int), stream>>>(wire, count, tile_counts, starts,
                                      cursors, done, E, H, W, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  voxelize_scatter_kernel<Wire>
      <<<dim3((E + kScatterSlots - 1) / kScatterSlots, T), kScatterThreads,
         2 * g.n * sizeof(int), stream>>>(wire, count, cursors, scratch, E,
                                          B, H, W, u16_scale, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int b = static_cast<int>(bytes);
  using Rec = Record<Wire::kShortRecord>;
  err = bf16 ? accumulate<true, Rec>(scratch, tile_counts, starts, claims,
                                     out, T, E, B, H, W, u16_scale, g, b,
                                     stream)
             : accumulate<false, Rec>(scratch, tile_counts, starts, claims,
                                      out, T, E, B, H, W, u16_scale, g, b,
                                      stream);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// The direct path (header: "The direct path")
// ---------------------------------------------------------------------------

constexpr int kDirectThreads = 128;
constexpr int kDirectItems = 2;
constexpr int kFinishThreads = 256;
constexpr int kFinishItems = 4;

template <bool BF16>
__device__ __forceinline__ void deposit_global(unsigned long long* cell,
                                               float w) {
  const unsigned long long fixed = fixed_point<BF16>(w);
  if (fixed) atomicAdd(cell, fixed);  // native RED.E.ADD.64, in L2
}

// 1. Every valid in-bounds event's two deposits into the window's int64
// cells, cells[t][bin][y][x].
template <bool BF16, typename Wire>
__global__ void __launch_bounds__(kDirectThreads)
    voxelize_deposit_kernel(Wire wire, const int* __restrict__ count,
                            unsigned long long* __restrict__ cells, int E,
                            int B, int H, int W, float u16_scale) {
  constexpr int kSlots = kDirectThreads * kDirectItems;
  const int t = blockIdx.y;
  const int n = count[t];
  const int valid = min(n, E);
  const int first = blockIdx.x * kSlots;
  if (first >= valid) return;
  const long long row = static_cast<long long>(t) * E;
  Event ev[kDirectItems];
#pragma unroll
  for (int k = 0; k < kDirectItems; ++k) {
    const int slot = first + k * kDirectThreads + threadIdx.x;
    ev[k] = Event{-1, -1, 0.0f, 0.0f, 0u};
    if (slot < valid) ev[k] = wire.load(row, slot, n, E, B, u16_scale);
  }
  const long long plane = static_cast<long long>(H) * W;
  unsigned long long* grid = cells + static_cast<long long>(t) * B * plane;
#pragma unroll
  for (int k = 0; k < kDirectItems; ++k) {
    if (!in_bounds(ev[k].x, ev[k].y, H, W)) continue;
    // the sign of p only, as the tiled path's records keep it
    const float p = ev[k].p > 0.0f ? 1.0f : -1.0f;
    const int lo = static_cast<int>(floorf(ev[k].tn));
    const float frac = __fsub_rn(ev[k].tn, static_cast<float>(lo));
    unsigned long long* cell =
        grid + static_cast<long long>(ev[k].y) * W + ev[k].x;
    if (lo >= 0 && lo < B) {
      deposit_global<BF16>(cell + lo * plane,
                           __fmul_rn(p, __fsub_rn(1.0f, frac)));
    }
    // lo + 1 >= 0: an unsorted timestamp with t_norm <= -1 deposits nothing
    if (lo + 1 >= 0 && lo + 1 < B) {
      deposit_global<BF16>(cell + (lo + 1) * plane, __fmul_rn(p, frac));
    }
  }
}

// 2. Every cell to f32, and back to zero for the next call.
__global__ void __launch_bounds__(kFinishThreads)
    voxelize_finish_kernel(unsigned long long* __restrict__ cells,
                           float* __restrict__ out, long long n) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kFinishThreads * kFinishItems +
      threadIdx.x;
  long long v[kFinishItems];
#pragma unroll
  for (int k = 0; k < kFinishItems; ++k) {
    const long long i = first + k * kFinishThreads;
    v[k] = i < n ? static_cast<long long>(cells[i]) : 0;
  }
#pragma unroll
  for (int k = 0; k < kFinishItems; ++k) {
    const long long i = first + k * kFinishThreads;
    if (i < n) {
      out[i] = fixed_to_f32(v[k]);
      cells[i] = 0ull;
    }
  }
}

template <typename Wire>
int launch_direct(const Wire& wire, bool bf16, const int* count,
                  unsigned long long* cells, float* out, int T, int E, int B,
                  int H, int W, float u16_scale, cudaStream_t stream) {
  constexpr int kSlots = kDirectThreads * kDirectItems;
  constexpr int kCells = kFinishThreads * kFinishItems;
  const dim3 grid((E + kSlots - 1) / kSlots, T);
  if (bf16) {
    voxelize_deposit_kernel<true, Wire><<<grid, kDirectThreads, 0, stream>>>(
        wire, count, cells, E, B, H, W, u16_scale);
  } else {
    voxelize_deposit_kernel<false, Wire><<<grid, kDirectThreads, 0, stream>>>(
        wire, count, cells, E, B, H, W, u16_scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(T) * B * H * W;
  voxelize_finish_kernel<<<static_cast<unsigned>((n + kCells - 1) / kCells),
                           kFinishThreads, 0, stream>>>(cells, out, n);
  return static_cast<int>(cudaGetLastError());
}

__global__ void evreal_noop_kernel() {}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

// f(wire) for the split buffers of the given type codes: coords 0 int16,
// 1 uint8, 2 int32, 3 float32; ts 0 float32, 1 uint16; ps 0 int8, 1
// float32. -1 for a code it does not take.
template <typename C, typename TS, typename F>
int with_pol(int pol_type, const void* xs, const void* ys, const void* ts,
             const void* ps, F&& f) {
  const C* x = static_cast<const C*>(xs);
  const C* y = static_cast<const C*>(ys);
  const TS* t = static_cast<const TS*>(ts);
  switch (pol_type) {
    case 0:
      return f(SplitWire<C, TS, int8_t>{x, y, t,
                                        static_cast<const int8_t*>(ps)});
    case 1:
      return f(SplitWire<C, TS, float>{x, y, t,
                                       static_cast<const float*>(ps)});
  }
  return -1;
}

template <typename C, typename F>
int with_ts(int ts_type, int pol_type, const void* xs, const void* ys,
            const void* ts, const void* ps, F&& f) {
  switch (ts_type) {
    case 0:
      return with_pol<C, float>(pol_type, xs, ys, ts, ps, f);
    case 1:
      return with_pol<C, uint16_t>(pol_type, xs, ys, ts, ps, f);
  }
  return -1;
}

template <typename F>
int with_split_wire(int coord_type, int ts_type, int pol_type, const void* xs,
                    const void* ys, const void* ts, const void* ps, F&& f) {
  switch (coord_type) {
    case 0:
      return with_ts<int16_t>(ts_type, pol_type, xs, ys, ts, ps, f);
    case 1:
      return with_ts<uint8_t>(ts_type, pol_type, xs, ys, ts, ps, f);
    case 2:
      return with_ts<int32_t>(ts_type, pol_type, xs, ys, ts, ps, f);
    case 3:
      return with_ts<float>(ts_type, pol_type, xs, ys, ts, ps, f);
  }
  return -1;
}

// The compact4 wire of a layout (data/packing.py:compact4_layout), or
// false for one the decoder does not take.
bool compact4_wire(const void* ev, int idx_bits, int ts_bits, int W,
                   Compact4Wire* wire) {
  if (ts_bits < 12 || ts_bits > 16 || idx_bits < 1 ||
      idx_bits + ts_bits > 31) {
    return false;
  }
  *wire = Compact4Wire{static_cast<const uint32_t*>(ev), idx_bits, ts_bits,
                       fast_div(W)};
  return true;
}

// f() with `device` as the calling thread's current device, restored after:
// set only where it differs.
template <typename F>
int on_device(int device, F&& f) {
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (previous != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int ret = f();
  if (previous != device) {
    err = cudaSetDevice(previous);
    if (ret == 0) ret = static_cast<int>(err);
  }
  return ret;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each entry returns -1 for a type
// code, shape, tile plan or wire layout it does not take, else the first
// non-zero CUDA error of its launches (0 on success); it launches on
// `stream` of `device`, which it makes current for the call.

// The tiled path. `scratch` holds the (T, E) 8-byte records, then
// 3 * T * tiles + T + 1 int32 counters, which the call zeroes
// (kernels/voxelize_cuda.py:_buffers), for the tiles of rows x cols pixels
// of kernels/voxelize_cuda.py:tile_plan; `out` is the (T, B, H, W) f32
// output, written whole. `bf16` selects the bf16-factor (DEFAULT) variant.
// Type codes as with_split_wire's.
extern "C" int evreal_voxelize_windows(
    const void* xs, const void* ys, const void* ts, const void* ps,
    const void* count, void* scratch, void* out, int T, int E, int B, int H,
    int W, int rows, int cols, int coord_type, int ts_type, int pol_type,
    int bf16, float u16_scale, int device, void* stream) {
  const int* c = static_cast<const int*>(count);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return with_split_wire(
        coord_type, ts_type, pol_type, xs, ys, ts, ps, [&](const auto& wire) {
          return launch(wire, bf16 != 0, c, scratch, o, T, E, B, H, W, rows,
                        cols, u16_scale, s);
        });
  });
}

// The tiled path on the packed compact4 wire: `ev` (T, E) uint32, the
// layout's idx_bits and ts_bits (12..16) from data/packing.py:
// compact4_layout.
extern "C" int evreal_voxelize_compact4(const void* ev, const void* count,
                                        void* scratch, void* out, int T,
                                        int E, int B, int H, int W, int rows,
                                        int cols, int idx_bits, int ts_bits,
                                        int bf16, float u16_scale, int device,
                                        void* stream) {
  Compact4Wire wire;
  if (!compact4_wire(ev, idx_bits, ts_bits, W, &wire)) return -1;
  return on_device(device, [&] {
    return launch(wire, bf16 != 0, static_cast<const int*>(count), scratch,
                  static_cast<float*>(out), T, E, B, H, W, rows, cols,
                  u16_scale, static_cast<cudaStream_t>(stream));
  });
}

// What a direct call takes that does not change from call to call: the
// wrapper keeps one per (device, dtypes, shapes, precision) key
// (kernels/voxelize_cuda.py:_DirectPlan, field for field).
struct DirectPlan {
  int T, E, B, H, W;
  int compact4;                       // 0: split buffers, 1: compact4
  int coord_type, ts_type, pol_type;  // split buffers: with_split_wire's
  int idx_bits, ts_bits;              // compact4: its layout
  int bf16;
  int device;
  float u16_scale;
};

// The direct path: `a`..`d` are xs, ys, ts, ps, or `a` the compact4 words;
// `cells` the (T, B, H, W) int64 scratch, zero on entry and on return;
// `out` the (T, B, H, W) f32 output, written whole.
extern "C" int evreal_voxelize_direct(const DirectPlan* p, const void* a,
                                      const void* b, const void* c,
                                      const void* d, const void* count,
                                      void* cells, void* out, void* stream) {
  if (p->T < 1 || p->T > 65535 || p->E < 1 || p->B < 1 || p->H < 1 ||
      p->W < 1 || p->H >= (1 << 24) || p->W >= (1 << 24)) {
    return -1;
  }
  const int* n = static_cast<const int*>(count);
  unsigned long long* acc = static_cast<unsigned long long*>(cells);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](const auto& wire) {
    return launch_direct(wire, p->bf16 != 0, n, acc, o, p->T, p->E, p->B,
                         p->H, p->W, p->u16_scale, s);
  };
  if (p->compact4) {
    Compact4Wire wire;
    if (!compact4_wire(a, p->idx_bits, p->ts_bits, p->W, &wire)) return -1;
    return on_device(p->device, [&] { return run(wire); });
  }
  return on_device(p->device, [&] {
    return with_split_wire(p->coord_type, p->ts_type, p->pol_type, a, b, c, d,
                           run);
  });
}

// `launches` empty kernels through the same binding and device handling as
// evreal_voxelize_direct: the launch floor the smoke times beside it.
extern "C" int evreal_noop(int launches, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    for (int i = 0; i < launches; ++i) {
      evreal_noop_kernel<<<1, 32, 0, s>>>();
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  });
}

// Blocks of the last accumulate launch: min(T x tiles, the resident blocks
// that the card's occupancy allows at the tile's shared memory).
extern "C" int evreal_last_accumulate_grid() {
  return last_accumulate_grid.load(std::memory_order_relaxed);
}

extern "C" const char* evreal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
