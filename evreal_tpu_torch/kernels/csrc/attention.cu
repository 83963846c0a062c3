// Fused multi-head attention for Hopper (sm_90a), float32:
//   out[b] = softmax(q[b] k[b]^T * scale) v[b],  scale = 1 / sqrt(dh),
// for each b of the (BH, L, dh) contiguous float32 q (Lq rows), k and v (Lk
// rows), BH = lanes x heads, dh = 32 (ET-Net's 256 / 8 heads).
//
// Replaces no TPU kernel: the JAX package (evreal_tpu/nn/attention.py) left
// attention to XLA. It was added because the written-out product
// (kernels/attention_cuda.py:attention_plain: matmul, scale, softmax,
// matmul) stores every (N, heads, Lq, Lk) score tensor in device memory.
// At BS-ERGB's 970 x 625 frame, padded to 976 x 632, ET-Net's tokens are
// L = 79 x 122 = 9,638 a scale, one (N, 8, L, L) f32 tensor is 2.97 GB a
// lane, and a 10-lane lockstep group holds two or three of 30 GB at once:
// more than the card's 80 GB. Here no L x L tensor exists: a block keeps
// its queries' running max, sum and output while it walks over the keys
// once (online softmax).
//
// The work: a (lane, head) of L = 9,638 needs 4 * L^2 * dh = 1.19e10 flops
// (QK^T and PV, 2 * dh each a score) against 4 * L * dh * 4 B = 4.9 MB in
// and out; 177 us at the 67 TFLOP/s of the CUDA cores' FP32 FMA against
// 1.5 us at 3.35 TB/s. The products are float32 FMA on the CUDA cores
// (fmaf), with no TF32 or 3xTF32 tensor-core path: the configurations
// state float32, and the roofline is read against the FP32 peak. exp2f,
// not __expf or ex2.approx.ftz; built without --use_fast_math (IEEE
// division, denormals kept).
//
// Design. Two launches a call, both named attention_*:
// attention_transpose_kernel writes k as (BH, dh, Lkp), Lkp = Lk rounded
// up to the key tile, zero-padded, into a scratch buffer the wrapper
// allocates; attention_fwd_kernel does the rest. A block of 64 threads
// takes 64 query rows of one (lane, head) and walks over the keys in tiles
// of 64. q (transposed) and each tile's p sit in shared memory; a ring of
// two stages, filled with cp.async, brings the tiles of k (transposed) and
// v, so tile t + 1 is in flight while tile t is computed. Thread (g, h),
// g, h < 8, holds two register tiles:
//   QK: the scores of rows 8g..8g+7 against keys 4h..4h+3 and 32+4h..+3,
//     64 independent chains; a step d reads 8 q and 8 k values (four
//     float4) for 64 FMAs, and each chain runs over d in order from 0, as
//     cuBLAS's does for attention_plain's product, so both round the
//     scores alike;
//   PV: the output of rows 8g..8g+7 over dims 4h..4h+3; four keys at a
//     time read 8 float4 of p and 4 of v for 128 FMAs.
// The 8 threads of a row group sit in one warp. The softmax works in log2
// units: a row's reference is its max times c = scale * log2(e), and
// p = exp2f(fmaf(s, c, -ref)) scales and subtracts in one rounding. The
// reference is raised only when a tile's max tops it by more than 8 (then
// p <= 2^8, far from overflow): a warp votes, and if any of its rows needs
// it, all take the row max over their 8 threads by shuffles and rescale
// sums and outputs by alpha = exp2f(ref_old - ref_new); the first tile
// always does (ref = -inf). The sums stay per thread over its keys and
// are added over the 8 at the end. Keys past Lk get p = 0 (the last tile
// sets their scores to -inf; their k and v are zeros); rows past Lq
// compute on zeros and are not stored. The sums run in another order than
// softmax's, so the result differs from attention_plain by float32
// rounding.
//
// What bounds it now (-Xptxas -v: 226 registers, no spills; 56 KB of
// dynamic shared memory a block, so 4 blocks, 8 warps, an SM): the FMAs'
// issue. Of about 5,400 instructions a thread issues for a tile's 4,096
// FMAs, the rest are the softmax (exp2f's five instructions a score, the
// scaling FMA, the max and the sums: about 530), the shared-memory loads
// and stores (336) and the loops; with 8 warps an SM, the barriers (two a
// tile) and the loads' latency hold it near 62% of the FP32 peak. A
// thread that held whole rows of q and of the output would feed 8 FMAs
// a shared-memory load, and a warp-wide float4 load holds the SM's
// shared-memory pipe about as long as 8 FMAs of each scheduler take: that
// layout stops near 55%.
//
// Not done yet (later work): a tensor-core path (which would leave
// float32); a persistent grid over (lane, head, row block).

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kDh = 32;          // head width
constexpr int kThreads = 64;     // threads a block
constexpr int kBlockQ = 64;      // query rows a block
constexpr int kBlockK = 64;      // keys a tile
constexpr int kStages = 2;       // tiles in the ring
constexpr int kTileRows = 8;     // rows of a thread's register tiles
constexpr int kTileKeys = 8;     // keys of its QK tile
constexpr int kTileDims = 4;     // dims of its PV tile
constexpr float kSlack = 8.f;    // log2 headroom before the reference rises
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockQ == kThreads / 8 * kTileRows, "8 row groups a block");
static_assert(kBlockK == 8 * kTileKeys && kDh == 8 * kTileDims,
              "8 key groups a tile, 8 dim groups a row");

struct Shared {
  float q[kDh][kBlockQ];                // q, transposed: 8 KB
  float p[kBlockQ][kBlockK];            // the tile's p: 16 KB
  float k[kStages][kDh][kBlockK];       // k tiles, transposed: 16 KB
  float4 v[kStages][kBlockK][kDh / 4];  // v tiles: 16 KB
};

// 16 bytes global -> shared, asynchronous; zero-filled unless `full`
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// kt[b][d][j] = k[b][j][d] for j < Lk, 0 for Lk <= j < Lkp; blocks of
// 32 keys x 32 dims through shared memory, both sides coalesced
__global__ void __launch_bounds__(256)
attention_transpose_kernel(const float* __restrict__ k,
                           float* __restrict__ kt, int Lk, int Lkp) {
  __shared__ float tile[32][33];
  const long long bh = blockIdx.y;
  const int j0 = blockIdx.x * 32;
  k += bh * Lk * kDh;
  kt += bh * kDh * Lkp;
#pragma unroll
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int j = j0 + i;
    tile[i][threadIdx.x] =
        j < Lk ? k[static_cast<long long>(j) * kDh + threadIdx.x] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int d = threadIdx.y; d < 32; d += 8)
    kt[static_cast<long long>(d) * Lkp + j0 + threadIdx.x] =
        tile[threadIdx.x][d];
}

// (64, 1): the compiler may take the registers it wants (226); the
// shared memory allows 4 blocks an SM whatever it takes, and aiming at
// more blocks holds it to 188 registers and runs 4% slower
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel(const float4* __restrict__ q,
                     const float* __restrict__ kt,
                     const float4* __restrict__ v, float4* __restrict__ out,
                     int Lq, int Lk, int Lkp, float scale) {
  extern __shared__ __align__(16) unsigned char shared_bytes[];
  Shared& sh = *reinterpret_cast<Shared*>(shared_bytes);
  const long long bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ;
  q += bh * Lq * (kDh / 4);
  out += bh * Lq * (kDh / 4);
  kt += bh * kDh * Lkp;
  v += bh * Lk * (kDh / 4);

  const int g = threadIdx.x / 8;  // row group: rows 8g..8g+7
  const int h = threadIdx.x % 8;  // key group (QK) and dim group (PV)

  // q, transposed, rows past Lq zero
#pragma unroll
  for (int it = 0; it < kBlockQ * kDh / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i % kBlockQ, cc = i / kBlockQ;
    const float4 x =
        row0 + r < Lq ? q[static_cast<long long>(row0 + r) * (kDh / 4) + cc]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    sh.q[4 * cc][r] = x.x;
    sh.q[4 * cc + 1][r] = x.y;
    sh.q[4 * cc + 2][r] = x.z;
    sh.q[4 * cc + 3][r] = x.w;
  }

  // tile t's k (transposed, padded: always whole) and v rows (past Lk
  // zero-filled) into its stage; one copy group a tile
  const int ntiles = (Lk + kBlockK - 1) / kBlockK;
  auto load_tile = [&](int t) {
    const int s = t % kStages, k0 = t * kBlockK;
#pragma unroll
    for (int it = 0; it < kDh * kBlockK / 4 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int d = i / (kBlockK / 4), c4 = i % (kBlockK / 4);
      cp_async16(&sh.k[s][d][4 * c4],
                 kt + static_cast<long long>(d) * Lkp + k0 + 4 * c4, true);
      const int j = i / (kDh / 4), cv = i % (kDh / 4);
      const bool in = k0 + j < Lk;
      const long long at =
          in ? static_cast<long long>(k0 + j) * (kDh / 4) + cv : 0;
      cp_async16(&sh.v[s][j][cv], v + at, in);
    }
    cp_async_commit();
  };

  const float c = scale * kLog2e;
  float o[kTileRows][kTileDims];
  float ref[kTileRows], lsum[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
    for (int e = 0; e < kTileDims; ++e) o[r][e] = 0.f;
    ref[r] = -INFINITY;
    lsum[r] = 0.f;
  }

  load_tile(0);
  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed, q is in place, and every thread is past tile
    // t - 1's PV: its stage and p may be overwritten
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntiles) load_tile(t + 1);
    const int s = t % kStages;

    // QK: keys 4h..4h+3 and 32+4h..32+4h+3 of the tile
    float sc[kTileRows][kTileKeys];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
      for (int j = 0; j < kTileKeys; ++j) sc[r][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < kDh; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sh.q[d][8 * g]);
      const float4 qb =
          *reinterpret_cast<const float4*>(&sh.q[d][8 * g + 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&sh.k[s][d][4 * h]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&sh.k[s][d][32 + 4 * h]);
      const float qv[kTileRows] = {qa.x, qa.y, qa.z, qa.w,
                                   qb.x, qb.y, qb.z, qb.w};
      const float kv[kTileKeys] = {ka.x, ka.y, ka.z, ka.w,
                                   kb.x, kb.y, kb.z, kb.w};
      // alternate rows run the keys backwards, so each FMA shares an
      // operand with the one before (the register-reuse cache)
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
        for (int j2 = 0; j2 < kTileKeys; ++j2) {
          const int j = (r & 1) ? kTileKeys - 1 - j2 : j2;
          sc[r][j] = fmaf(qv[r], kv[j], sc[r][j]);
        }
      }
    }
    if (t == ntiles - 1) {  // the ragged end: missing keys get p = 0
#pragma unroll
      for (int j = 0; j < kTileKeys; ++j) {
        const int key = t * kBlockK + (j < 4 ? 4 * h + j : 28 + 4 * h + j);
        if (key >= Lk) {
#pragma unroll
          for (int r = 0; r < kTileRows; ++r) sc[r][j] = -INFINITY;
        }
      }
    }

    // raise a row's reference only where the tile's max tops it by more
    // than kSlack; a warp decides together
    float smax[kTileRows];
    bool raise = false;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      float m = sc[r][0];
#pragma unroll
      for (int j = 1; j < kTileKeys; ++j) m = fmaxf(m, sc[r][j]);
      smax[r] = m;
      raise |= fmaf(m, c, -ref[r]) > kSlack;
    }
    if (__any_sync(0xffffffffu, raise)) {
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        float m = smax[r];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        const float next = fmaxf(ref[r], m * c);
        const float alpha = exp2f(ref[r] - next);  // 0 at the first tile
        lsum[r] *= alpha;
#pragma unroll
        for (int e = 0; e < kTileDims; ++e) o[r][e] *= alpha;
        ref[r] = next;
      }
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
      for (int j = 0; j < kTileKeys; ++j) {
        sc[r][j] = exp2f(fmaf(sc[r][j], c, -ref[r]));
        lsum[r] += sc[r][j];
      }
      *reinterpret_cast<float4*>(&sh.p[8 * g + r][4 * h]) =
          make_float4(sc[r][0], sc[r][1], sc[r][2], sc[r][3]);
      *reinterpret_cast<float4*>(&sh.p[8 * g + r][32 + 4 * h]) =
          make_float4(sc[r][4], sc[r][5], sc[r][6], sc[r][7]);
    }
    __syncthreads();  // the tile's p is complete

    // PV: dims 4h..4h+3, keys four at a time (missing ones: p = 0, v = 0)
#pragma unroll 4
    for (int k4 = 0; k4 < kBlockK / 4; ++k4) {
      float pr[kTileRows][4];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float4 x =
            *reinterpret_cast<const float4*>(&sh.p[8 * g + r][4 * k4]);
        pr[r][0] = x.x;
        pr[r][1] = x.y;
        pr[r][2] = x.z;
        pr[r][3] = x.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 vx = sh.v[s][4 * k4 + kk][h];
        const float w[kTileDims] = {vx.x, vx.y, vx.z, vx.w};
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
          for (int e2 = 0; e2 < kTileDims; ++e2) {
            const int e = (r & 1) ? kTileDims - 1 - e2 : e2;
            o[r][e] = fmaf(pr[r][kk], w[e], o[r][e]);
          }
        }
      }
    }
  }

  // a row's sum: the 8 threads' partial sums over their keys
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    float l = lsum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = row0 + 8 * g + r;
    if (row < Lq)
      out[static_cast<long long>(row) * (kDh / 4) + h] =
          make_float4(o[r][0] / l, o[r][1] / l, o[r][2] / l, o[r][3] / l);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. q (BH, Lq, dh), k and v (BH, Lk,
// dh), out (BH, Lq, dh) and the scratch kt (BH, dh, Lk rounded up to a
// multiple of 64): contiguous float32 on `device`, 16-byte aligned.
// Returns -1 for a shape it does not take, else the launches' CUDA error
// (0 on success); it launches on `stream` of `device`, which it makes
// current for the call.
extern "C" int evreal_attention(const void* q, const void* k, const void* v,
                                void* out, void* kt, int BH, int Lq, int Lk,
                                int dh, float scale, int device,
                                void* stream) {
  if (dh != kDh || BH < 1 || BH > 65535 || Lq < 1 || Lk < 1) return -1;
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (previous != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // more than 48 KB of dynamic shared memory needs the kernel's consent
  const int bytes = sizeof(Shared);
  int ret = static_cast<int>(cudaFuncSetAttribute(
      attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes));
  if (ret == 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const int Lkp = (Lk + kBlockK - 1) / kBlockK * kBlockK;
    attention_transpose_kernel<<<dim3(Lkp / 32, BH), dim3(32, 8), 0, s>>>(
        static_cast<const float*>(k), static_cast<float*>(kt), Lk, Lkp);
    ret = static_cast<int>(cudaGetLastError());
    if (ret == 0) {
      const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, BH);
      attention_fwd_kernel<<<grid, kThreads, bytes, s>>>(
          static_cast<const float4*>(q), static_cast<const float*>(kt),
          static_cast<const float4*>(v), static_cast<float4*>(out), Lq, Lk,
          Lkp, scale);
      ret = static_cast<int>(cudaGetLastError());
    }
  }
  if (previous != device) {
    err = cudaSetDevice(previous);
    if (ret == 0) ret = static_cast<int>(err);
  }
  return ret;
}

extern "C" const char* evreal_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
