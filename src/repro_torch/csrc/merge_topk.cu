// Dedup-top-k merge for Hopper (sm_90a): the coordinator combine of
// Alg. 4 line 9, each query's m = w * k_search partial (score, id) pairs
// cut to the k best with duplicate external ids removed.
//
// Replaces the Pallas TPU kernel `merge_topk_pallas` / `_merge_kernel` in
// src/repro/kernels/merge_topk/kernel.py. Semantics are those of
// `merge_topk_ref` (src/repro_torch/kernels/merge_topk/ref.py) and of the
// Pallas kernel: an entry with id < 0 is empty; each of k rounds selects
// the best score, ties going to the lowest position (-0.0 equal to +0.0),
// outputs it, and retires that entry and every entry with the same id;
// the output is in descending order, padded with (-inf, -1).
//
// What bounds it on the H100: it reads 8 bytes and writes at most 8 bytes
// an entry, 1.6 MB for 1,024 rows of m = 160, a bound of 0.0004 ms, below
// the latency of one launch. What remains is latency: k dependent rounds,
// each a maximum over the row. The previous kernel (Triton) ran three
// block-wide reductions a round (maximum, lowest position of it, id),
// each through shared memory behind a barrier, over a row padded to a
// power of two, behind Triton's Python launcher.
//
// Design:
//   * one warp a row for m <= 1,280 (the path's m is 16 shards x k_search,
//     at most 1,280): lane i holds entries i, i + 32, ... in registers,
//     read with coalesced loads, 8 warps (8 rows) a block;
//   * one key an entry: an order-preserving map of the score (-0.0 folded
//     onto +0.0) in the high word, and the complement of the position in
//     the low word (shifted up one bit, with a bit that remembers a -0.0,
//     so the score is given back as it came). The largest key is the best
//     score at its lowest position, so one warp-wide maximum of each
//     lane's local best gives the winner's score and position
//     together (as two 32-bit `redux.sync` maxima: the high words, then
//     the low words of the lanes that hold the top high word); empty and
//     retired entries hold key 0, below the key of any score;
//   * the winner's id is broadcast by a shuffle from the lane that holds
//     it; every lane retires its entries of that id, and recomputes its
//     local best only when one of its own entries was retired;
//   * a round whose best is -inf (or empty) ends the row: the rest of the
//     output is padding;
//   * above 1,280 entries one block of 8 warps takes a row, which lives in
//     shared memory (12 bytes an entry); each round the warps' maxima meet
//     in shared memory behind one barrier.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWarpM = 1280;

typedef unsigned long long Key;

// order-preserving key of (score, position); -0.0 ranks as +0.0
__device__ __forceinline__ Key pack(float s, int j) {
  unsigned u = __float_as_uint(s);
  const unsigned neg_zero = u == 0x80000000u;
  if (neg_zero) u = 0u;
  const unsigned hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const unsigned lo = ((0x7fffffffu - (unsigned)j) << 1) | neg_zero;
  return ((Key)hi << 32) | lo;
}

__device__ __forceinline__ float score_of(Key key) {
  const unsigned hi = (unsigned)(key >> 32);
  const unsigned u = (hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi;
  return (key & 1ull) ? -0.0f : __uint_as_float(u);
}

__device__ __forceinline__ int position_of(Key key) {
  return (int)(0x7fffffffu - ((unsigned)key >> 1));
}

// a key above every -inf key holds a finite (or +inf) score
__device__ __forceinline__ bool alive(Key key) {
  return (unsigned)(key >> 32) > 0x007fffffu;   // the high word of -inf
}

// the largest key of the warp: the largest high word, then the largest
// low word among the lanes that hold it (two redux.sync reductions)
__device__ __forceinline__ Key warp_max(Key x) {
  const unsigned hi = (unsigned)(x >> 32), lo = (unsigned)x;
  const unsigned top_hi = __reduce_max_sync(kFull, hi);
  const unsigned top_lo = __reduce_max_sync(kFull, hi == top_hi ? lo : 0u);
  return ((Key)top_hi << 32) | top_lo;
}

// the rest of a row's output, from round r on, is padding
__device__ __forceinline__ void pad(float* os, int* oi, int r, int k,
                                    int first, int step) {
  for (int i = r + first; i < k; i += step) {
    os[i] = -INFINITY;
    oi[i] = -1;
  }
}

// one warp a row; N entries a lane (m <= 32 N)
template <int N>
__global__ void __launch_bounds__(kThreads)
merge_warp_kernel(const float* __restrict__ scores,
                  const int* __restrict__ ids, float* __restrict__ out_s,
                  int* __restrict__ out_i, int B, int m, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;               // the whole warp
  const float* s_row = scores + (size_t)row * m;
  const int* i_row = ids + (size_t)row * m;
  Key key[N];
  int id[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = i * 32 + lane;
    float s = -INFINITY;
    int d = -1;
    if (j < m) {
      s = __ldg(s_row + j);
      d = __ldg(i_row + j);
    }
    id[i] = d;
    key[i] = d >= 0 ? pack(s, j) : 0ull;
  }
  Key best = 0ull;
  int best_id = -1;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (key[i] > best) {
      best = key[i];
      best_id = id[i];
    }

  float* os = out_s + (size_t)row * k;
  int* oi = out_i + (size_t)row * k;
  int r = 0;
  for (; r < k; ++r) {
    const Key top = warp_max(best);   // the same in every lane
    if (!alive(top)) break;
    const int bid = __shfl_sync(kFull, best_id, position_of(top) & 31);
    if (lane == 0) {
      os[r] = score_of(top);
      oi[r] = bid;
    }
    bool hit = false;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (id[i] == bid && key[i] != 0ull) {
        key[i] = 0ull;
        hit = true;
      }
    if (hit) {
      best = 0ull;
      best_id = -1;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (key[i] > best) {
          best = key[i];
          best_id = id[i];
        }
    }
  }
  pad(os, oi, r, k, lane, 32);
}

// one block of kWarps warps a row, the row's keys and ids in shared memory
__global__ void __launch_bounds__(kThreads)
merge_block_kernel(const float* __restrict__ scores,
                   const int* __restrict__ ids, float* __restrict__ out_s,
                   int* __restrict__ out_i, int m, int k) {
  extern __shared__ Key s_key[];                        // [m]
  int* s_id = reinterpret_cast<int*>(s_key + m);        // [m]
  __shared__ Key s_wkey[2][kWarps];
  __shared__ int s_wid[2][kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t row = blockIdx.x;
  const float* s_row = scores + row * m;
  const int* i_row = ids + row * m;
  // thread t owns entries t, t + kThreads, ...; only it reads them
  Key best = 0ull;
  int best_id = -1;
  for (int j = t; j < m; j += kThreads) {
    const int d = __ldg(i_row + j);
    const Key kj = d >= 0 ? pack(__ldg(s_row + j), j) : 0ull;
    s_id[j] = d;
    s_key[j] = kj;
    if (kj > best) {
      best = kj;
      best_id = d;
    }
  }

  float* os = out_s + row * k;
  int* oi = out_i + row * k;
  int r = 0;
  for (; r < k; ++r) {
    const Key wtop = warp_max(best);
    const int wid = __shfl_sync(kFull, best_id, position_of(wtop) & 31);
    // rounds alternate two slots, so one barrier a round suffices
    if (lane == 0) {
      s_wkey[r & 1][warp] = wtop;
      s_wid[r & 1][warp] = wid;
    }
    __syncthreads();
    Key top = s_wkey[r & 1][0];
    int bid = s_wid[r & 1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      if (s_wkey[r & 1][w] > top) {
        top = s_wkey[r & 1][w];
        bid = s_wid[r & 1][w];
      }
    if (!alive(top)) break;           // the same in every thread
    if (t == 0) {
      os[r] = score_of(top);
      oi[r] = bid;
    }
    bool hit = false;
    for (int j = t; j < m; j += kThreads)
      if (s_id[j] == bid && s_key[j] != 0ull) {
        s_key[j] = 0ull;
        hit = true;
      }
    if (hit) {
      best = 0ull;
      best_id = -1;
      for (int j = t; j < m; j += kThreads)
        if (s_key[j] > best) {
          best = s_key[j];
          best_id = s_id[j];
        }
    }
  }
  pad(os, oi, r, k, t, kThreads);
}

template <int N>
int launch_warp(const float* scores, const int* ids, float* out_s,
                int* out_i, int B, int m, int k, cudaStream_t st) {
  merge_warp_kernel<N><<<(B + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      scores, ids, out_s, out_i, B, m, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success), or -1 for a shape the kernel
// does not take (it needs 0 < k <= m and, above 1,280 entries, the row in
// shared memory). Launches on `stream` and does not synchronise.
int merge_topk_launch(const float* scores, const int* ids, float* out_s,
                      int* out_i, int B, int m, int k, void* stream) {
  if (B < 0 || m < 1 || k < 1 || k > m) return -1;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 64) return launch_warp<2>(scores, ids, out_s, out_i, B, m, k, st);
  if (m <= 160) return launch_warp<5>(scores, ids, out_s, out_i, B, m, k, st);
  if (m <= 320)
    return launch_warp<10>(scores, ids, out_s, out_i, B, m, k, st);
  if (m <= 640)
    return launch_warp<20>(scores, ids, out_s, out_i, B, m, k, st);
  if (m <= kMaxWarpM)
    return launch_warp<40>(scores, ids, out_s, out_i, B, m, k, st);
  // the block path: the row's keys and ids in shared memory
  const long long smem = (long long)m * (sizeof(Key) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  merge_block_kernel<<<B, kThreads, (size_t)smem, st>>>(scores, ids, out_s,
                                                        out_i, m, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
