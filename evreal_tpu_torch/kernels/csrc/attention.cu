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
// its queries' running max, sum and output in registers while it walks
// over the keys once (online softmax).
//
// What bounds it: a (lane, head) of L = 9,638 needs 4 * L^2 * dh = 1.19e10
// flops (QK^T and PV, 2 * dh each a score) against 4 * L * dh * 4 B =
// 4.9 MB in and out; 177 us at the 67 TFLOP/s of the CUDA cores' FP32 FMA
// against 1.5 us at 3.35 TB/s. So it is bound by FP32 FMA issue, then by
// the shared-memory loads that feed it and by the softmax's expf, one a
// score. The products are float32 FMA on the CUDA cores (fmaf), with no
// TF32 or 3xTF32 tensor-core path: the configurations state float32, and
// the roofline is read against the FP32 peak. expf, not __expf; built
// without --use_fast_math (IEEE division, denormals kept).
//
// Design. A block of 128 threads takes 256 query rows of one (lane, head),
// two rows a thread, and holds each row's q (32 floats) and output
// accumulator (32 floats) in registers. It walks over the keys in tiles of
// 64: the block copies the tile's k and v rows (8 KB each, coalesced
// float4) into shared memory, then each thread takes the tile 16 keys at a
// time: 16 scores a row as 32-long FMA chains against k rows read as
// float4 broadcasts (every thread of a warp reads the same address), the
// online softmax of those 16 in the thread (a row lives in one thread, so
// no reduction crosses threads), and the 16 x 32 FMAs of p v against v rows
// read the same way. A float4 of k or v read from shared memory feeds 8
// FMAs, which keeps the loads under the FMA issue rate. The ragged last
// tile is zero-filled, and its missing keys get p = 0; rows past Lq compute
// on zeros and are not stored. Each row's output is its accumulator over
// its sum. The sums run in another order than cuBLAS's and softmax's, so
// the result differs from attention_plain by float32 rounding.
//
// Not done yet (later work): double-buffered tiles (cp.async), a tensor-core
// path (which would leave float32), larger register tiles.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kDh = 32;                    // head width
constexpr int kVec = kDh / 4;              // float4 a row
constexpr int kThreads = 128;              // threads a block
constexpr int kRows = 2;                   // query rows a thread
constexpr int kBlockQ = kThreads * kRows;  // query rows a block
constexpr int kBlockK = 64;                // keys a shared-memory tile
constexpr int kSub = 16;                   // keys a register tile of scores
static_assert(kBlockK % kSub == 0, "a tile holds whole register tiles");

__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_kernel(const float4* __restrict__ q,
                     const float4* __restrict__ k,
                     const float4* __restrict__ v, float4* __restrict__ out,
                     int Lq, int Lk, float scale) {
  __shared__ float4 ks[kBlockK][kVec];
  __shared__ float4 vs[kBlockK][kVec];
  const long long bh = blockIdx.y;
  q += bh * Lq * kVec;
  out += bh * Lq * kVec;
  k += bh * Lk * kVec;
  v += bh * Lk * kVec;

  // thread t holds rows base + t and base + 128 + t, so a warp's loads and
  // stores of one row index touch 32 neighbouring rows
  const int base = blockIdx.x * kBlockQ + threadIdx.x;
  float qr[kRows][kDh];
  float acc[kRows][kDh];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = base + r * kThreads;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const float4 x =
          row < Lq ? q[static_cast<long long>(row) * kVec + c]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[r][4 * c] = x.x;
      qr[r][4 * c + 1] = x.y;
      qr[r][4 * c + 2] = x.z;
      qr[r][4 * c + 3] = x.w;
    }
#pragma unroll
    for (int d = 0; d < kDh; ++d) acc[r][d] = 0.f;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += kBlockK) {
    const int nk = min(kBlockK, Lk - k0);
    __syncthreads();  // the previous tile has been read
    for (int i = threadIdx.x; i < kBlockK * kVec; i += kThreads) {
      const int j = i / kVec;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (j < nk) {
        const long long at = static_cast<long long>(k0) * kVec + i;
        kx = k[at];
        vx = v[at];
      }
      ks[j][i % kVec] = kx;
      vs[j][i % kVec] = vx;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += kSub) {
      const int valid = nk - j0;  // keys of this register tile, >= 1
      float s[kRows][kSub];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) s[r][jj] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const float4 kx = ks[j0 + jj][c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            s[r][jj] = fmaf(qr[r][4 * c], kx.x, s[r][jj]);
            s[r][jj] = fmaf(qr[r][4 * c + 1], kx.y, s[r][jj]);
            s[r][jj] = fmaf(qr[r][4 * c + 2], kx.z, s[r][jj]);
            s[r][jj] = fmaf(qr[r][4 * c + 3], kx.w, s[r][jj]);
          }
        }
      }
      // online softmax: the running max of the raw scores (scale > 0, so
      // it is the max of the scaled ones), the accumulator and the sum
      // rescaled to it, then p = exp((s - max) * scale)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float mx = m[r];
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          if (jj < valid) mx = fmaxf(mx, s[r][jj]);
        }
        const float alpha = expf((m[r] - mx) * scale);  // 0 at the start
        l[r] *= alpha;
#pragma unroll
        for (int d = 0; d < kDh; ++d) acc[r][d] *= alpha;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const float p = jj < valid ? expf((s[r][jj] - mx) * scale) : 0.f;
          s[r][jj] = p;
          l[r] += p;
        }
        m[r] = mx;
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float4 vx = vs[j0 + jj][c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][4 * c] = fmaf(s[r][jj], vx.x, acc[r][4 * c]);
            acc[r][4 * c + 1] = fmaf(s[r][jj], vx.y, acc[r][4 * c + 1]);
            acc[r][4 * c + 2] = fmaf(s[r][jj], vx.z, acc[r][4 * c + 2]);
            acc[r][4 * c + 3] = fmaf(s[r][jj], vx.w, acc[r][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = base + r * kThreads;
    if (row < Lq) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        out[static_cast<long long>(row) * kVec + c] =
            make_float4(acc[r][4 * c] / l[r], acc[r][4 * c + 1] / l[r],
                        acc[r][4 * c + 2] / l[r], acc[r][4 * c + 3] / l[r]);
      }
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. q (BH, Lq, dh), k and v (BH, Lk,
// dh), out (BH, Lq, dh): contiguous float32 on `device`, 16-byte aligned.
// Returns -1 for a shape it does not take, else the launch's CUDA error
// (0 on success); it launches on `stream` of `device`, which it makes
// current for the call.
extern "C" int evreal_attention(const void* q, const void* k, const void* v,
                                void* out, int BH, int Lq, int Lk, int dh,
                                float scale, int device, void* stream) {
  if (dh != kDh || BH < 1 || BH > 65535 || Lq < 1 || Lk < 1) return -1;
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (previous != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, BH);
  attention_fwd_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<const float4*>(v), static_cast<float4*>(out), Lq, Lk,
      scale);
  int ret = static_cast<int>(cudaGetLastError());
  if (previous != device) {
    err = cudaSetDevice(previous);
    if (ret == 0) ret = static_cast<int>(err);
  }
  return ret;
}

extern "C" const char* evreal_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
