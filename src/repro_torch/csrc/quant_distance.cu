// Asymmetric float32-query x int8-row distance scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `quant_distance_pallas` /
// `_quant_distance_kernel` in src/repro/kernels/quant_distance/kernel.py
// (:52). Semantics are the TPU kernel's: every row is dequantized as
// x = c * scale + zero (one multiply, then one add, each rounded, as the
// plain version `quant_scores_ref` computes it), and for q [B, d] against
// rows [n, d] the output [B, n] float32 holds
//   l2:      2 q.x - |q|^2 - |x|^2
//   ip:      q.x
//   angular: q.x / ((|q| + 1e-12) (|x| + 1e-12))
//
// What bounds it on the H100: the least work reads the codes (n d bytes)
// and the queries once and writes the [B, n] float32 output once, and
// does 2 B n d operations. At the main path's shape (B = 1,024, n =
// 50,000, d = 128) that is 0.21 GB (0.063 ms at 3.35 TB/s) against 13.1
// GFLOP (0.196 ms at 67 TFLOP/s float32): the operations bound it. The
// tensor cores are not used: TF32 and bf16 keep 10 and 7 bits of
// mantissa, far from the 1e-5 the family is held to, so every product is
// a float32 FMA on the CUDA cores.
//
// Design. The TPU kernel's grid of (query block, row block) tiles is
// fully parallel, so it maps onto blocks directly:
//   * one block of 256 threads owns a tile of 64 queries x 64 rows; the
//     grid covers any B and n, the ragged edges masked;
//   * d is walked in slices of 32: the block stages the query slice and
//     the int8 code slice in shared memory, transposed ([32][65]: a
//     warp's stores fall in distinct banks), and dequantizes the codes
//     there, once per tile, not once per product;
//   * each thread keeps a 4 x 4 tile of dot products in registers (rows
//     ty + 16 i, columns tx + 16 j), so a warp reads two query values
//     (broadcast) and 16 consecutive row values per step;
//   * the first 128 threads also sum |q|^2 and |x|^2 of the tile's
//     queries and rows over the same slices, so the norms cost one pass
//     over data already in shared memory.
// Products are summed in ascending order of d with FMAs; cuBLAS (the
// plain version's product) sums in another order, which is the only
// difference between the two.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // queries and rows of a block's tile
constexpr int kSlice = 32;       // columns of d staged at a time
constexpr int kLd = kTile + 1;   // row stride of the transposed slices
constexpr float kEps = 1e-12f;   // angular epsilon, as core/metrics.py

__global__ void __launch_bounds__(kThreads)
quant_distance_kernel(const float* __restrict__ q,
                      const int8_t* __restrict__ codes,
                      const float* __restrict__ scale,
                      const float* __restrict__ zero,
                      float* __restrict__ out, int B, int n, int d,
                      int metric) {
  __shared__ float qs[kSlice][kLd];
  __shared__ float xs[kSlice][kLd];
  __shared__ float qnorm[kTile];
  __shared__ float xnorm[kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * kTile;    // first database row
  const int q0 = blockIdx.y * kTile;      // first query

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float norm = 0.0f;   // threads 0..63: |q|^2, 64..127: |x|^2

  for (int k0 = 0; k0 < d; k0 += kSlice) {
    for (int e = tid; e < kTile * kSlice; e += kThreads) {
      const int r = e / kSlice;
      const int c = e % kSlice;
      const int k = k0 + c;
      float qv = 0.0f;
      if (q0 + r < B && k < d) qv = q[(size_t)(q0 + r) * d + k];
      qs[c][r] = qv;
      float xv = 0.0f;
      if (row0 + r < n && k < d) {
        const float cv = (float)codes[(size_t)(row0 + r) * d + k];
        xv = __fadd_rn(__fmul_rn(cv, scale[k]), zero[k]);
      }
      xs[c][r] = xv;
    }
    __syncthreads();
    if (tid < kTile) {
#pragma unroll 8
      for (int c = 0; c < kSlice; ++c)
        norm = fmaf(qs[c][tid], qs[c][tid], norm);
    } else if (tid < 2 * kTile) {
      const int r = tid - kTile;
#pragma unroll 8
      for (int c = 0; c < kSlice; ++c) norm = fmaf(xs[c][r], xs[c][r], norm);
    }
#pragma unroll 8
    for (int c = 0; c < kSlice; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kTile) qnorm[tid] = norm;
  else if (tid < 2 * kTile) xnorm[tid - kTile] = norm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = ty + 16 * i;
    if (q0 + qi >= B) continue;
    float* orow = out + (size_t)(q0 + qi) * n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int xj = tx + 16 * j;
      if (row0 + xj >= n) continue;
      const float dot = acc[i][j];
      float s;
      if (metric == 0) {          // l2: (2 q.x - |q|^2) - |x|^2
        s = (2.0f * dot - qnorm[qi]) - xnorm[xj];
      } else if (metric == 1) {   // ip
        s = dot;
      } else {                    // angular
        s = dot / ((sqrtf(qnorm[qi]) + kEps) * (sqrtf(xnorm[xj]) + kEps));
      }
      orow[row0 + xj] = s;
    }
  }
}

}  // namespace

extern "C" int quant_distance_launch(const void* q, const void* codes,
                                     const void* scale, const void* zero,
                                     void* out, int B, int n, int d,
                                     int metric, void* stream) {
  if (B < 1 || n < 1 || d < 1 || metric < 0 || metric > 2) return -1;
  const dim3 grid((n + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  if (grid.y > 65535) return -2;
  quant_distance_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<float*>(out), B, n, d, metric);
  return (int)cudaGetLastError();
}
