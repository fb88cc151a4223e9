// Brute-force top-k similarity scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `topk_similarity_pallas` in
// src/repro/kernels/topk_distance/kernel.py (:99). For each query row, the
// k database rows of highest similarity under l2 (2 q.x - |q|^2 - |x|^2),
// ip (q.x) or angular (q.x / ((|q| + 1e-12)(|x| + 1e-12)), the form of the
// plain version); float32 scores sorted descending, int32 ids, ties to the
// lowest database id. The main path calls it for the k-means assignments
// of the index builds (k = 1: B = 4,096 or 20,000 rows against 1,000
// centres at d = 128; B = 400 keys against 32 centres at d = 2,048 or
// 1,536 for the LM datastores) and for the MIPS replication (k = r over
// the whole dataset).
//
// What bounds it on the H100: 2 B n d float32 operations against (B + n) d
// 4 bytes, so at the build's shapes it is bound by operations at the
// 67 TFLOP/s of the CUDA cores (full float32: TF32 or bf16 would change
// which row is nearest, and ids must equal the plain version's).
//
// Design.
//   * topk_norms_kernel: one warp per row computes |x|^2 (l2) or |x|
//     (angular) of every query row and every database row, once, in one
//     launch.
//   * topk_scan_kernel: a CTA of 256 threads owns 128 query rows and one
//     split of the database, walked in tiles of 128 rows. The 128 x 128
//     score tile is a register-tiled float32 product (8 x 8 FMAs a thread,
//     float4 loads from shared memory) over slabs of 16 columns of d,
//     double-buffered with cp.async; the next tile's first slab loads while
//     the epilogue runs. At k = 1 (every call of the main path) the
//     epilogue is a running argmax in registers: each thread's best of its
//     8 columns a row, reduced over the row's 16 threads by shuffles, no
//     shared memory and no barrier. Otherwise it writes the tile's scores
//     to shared memory, and one warp per row keeps that row's running
//     top-k in the output (or partial) rows in device memory: a candidate
//     enters only if it beats the row's current k-th score (ties lose,
//     since a split walks ids in ascending order), so after the first
//     tiles most rows skip the merge. For k <= 32 a tile's candidates are
//     first cut to those not below the k-th best of the 32 lanes' maxima
//     (a bitonic sort across the warp), a lower bound of the tile's k-th
//     best; without it the first tile's rank merge of up to 128
//     candidates a row more than doubles the scan at k = 16. Candidates
//     that enter are compacted, and the new list is the k best of list
//     and candidates, each placed by its rank (count of better elements;
//     (score desc, id asc) is a strict order).
//   * topk_merge_kernel: with several splits, one warp per query merges
//     the splits' sorted partial lists [B, splits, k] in k rounds of a
//     warp argmax over the list heads, ties to the lowest id.
//   * One database tile (n <= 128, the LM datastores' 32 centres) gives
//     only one CTA per 128 queries, so there the scan cuts d instead: each
//     CTA writes the raw dot products of its slice of d ([slices, B, n],
//     the kDotSlice mode), and topk_dsum_kernel, one warp per query, adds
//     the slices in slice order, applies the metric and takes the k best
//     in k rounds of a warp argmax, ties to the lowest id.
// The wrapper (kernels/topk_distance/ops.py) chooses the cut. `split_plan`:
// the number of database splits that minimises (waves of CTAs) x (tiles
// per CTA) on the card's SMs, one CTA per SM, ties to fewer splits: one
// split when the query tiles alone fill whole waves, and at B = 4,096,
// n = 1,000 four splits of two tiles (128 CTAs); with one split the scan
// writes the output directly and the merge kernel is not launched.
// `slice_plan`: with n <= 128 and the query tiles on under half the SMs,
// slices of at least 64 columns of d, as many as fill the SMs (32 slices
// at B = 400, d = 2,048: 128 CTAs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;             // query rows and database rows a tile
constexpr int kSlab = 16;              // columns of d a pipeline stage
constexpr int kLdT = kSlab + 4;        // row stride of the staged slabs
constexpr int kLdS = kTile + 16;       // row stride of the score tile
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr int kMaxK = 256;
constexpr int kMaxHeads = 4;           // splits <= 128 in the merge
constexpr int kMergeSmem = 512;        // list entries of a row in smem
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Params {
  const float* q;      // [B, d], d % 4 == 0, 16-byte aligned
  const float* x;      // [n, d]
  const float* qn;     // [B] |q|^2 (l2) or |q| (angular); null for ip
  const float* xn;     // [n]
  float* ls;           // [B, splits, k] running lists (the output if 1
                       // split); kDotSlice: the dot products [slices, B, n]
  int* li;
  int B, n, d, k, metric, tiles_per_split;
  int d_cols;          // kDotSlice: columns of d a slice, a multiple of kSlab
};

// What a scan CTA keeps of its tiles: a running argmax (k = 1), running
// lists in device memory (k > 1), or, over one slice of d, the raw dot
// products for topk_dsum_kernel. (The kernel takes it as an int, so that
// profiles name it topk_scan_kernel<0> and so on.)
enum Mode { kArgmax, kLists, kDotSlice };

size_t scan_smem_bytes(int mode, int k) {
  size_t f = 2 * 2 * (size_t)kTile * kLdT;     // q and x slabs, two stages
  if (mode != kLists) return f * sizeof(float);  // the rest is registers
  f += (size_t)kTile * kLdS                    // score tile
       + kTile                                 // k-th score of each row
       + 2 * (size_t)kWarps * kTile            // compacted candidates
       + 2 * (size_t)kWarps * k;               // merged list of each warp
  return f * sizeof(float);
}

// |row|^2 (root = 0) or |row| (root = 1) of the B query rows, then of the
// n database rows, all of width d, a warp a row
__global__ void __launch_bounds__(kThreads) topk_norms_kernel(
    const float* __restrict__ q, const float* __restrict__ x, int B, int n,
    int d, int root, float* __restrict__ qn, float* __restrict__ xn) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B + n) return;
  const float* r = row < B ? q + (size_t)row * d : x + (size_t)(row - B) * d;
  float* out = row < B ? qn + row : xn + (row - B);
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(r[c], r[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) *out = root ? sqrtf(s) : s;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    topk_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int K = p.k;
  float* sQ = smem;                                  // [2][kTile][kLdT]
  float* sX = sQ + 2 * kTile * kLdT;                 // [2][kTile][kLdT]
  float* sS = sX + 2 * kTile * kLdT;                 // [kTile][kLdS]
  float* sThr = sS + kTile * kLdS;                   // [kTile]
  float* sCs = sThr + kTile;                         // [kWarps][kTile]
  int* sCi = reinterpret_cast<int*>(sCs + kWarps * kTile);
  float* sTs = reinterpret_cast<float*>(sCi + kWarps * kTile);  // [kWarps][K]
  int* sTi = reinterpret_cast<int*>(sTs + kWarps * K);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kTile;
  // a split of the database, or with kDotSlice a slice [d0, d1) of d
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (p.n + kTile - 1) / kTile;
  const int t_begin = kMode == kDotSlice ? 0 : split * p.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_split);
  const int n_end = min(p.n, t_end * kTile);
  const int d0 = kMode == kDotSlice ? split * p.d_cols : 0;
  const int d1 = kMode == kDotSlice ? min(p.d, d0 + p.d_cols) : p.d;
  const int ksteps = (d1 - d0 + kSlab - 1) / kSlab;
  const int steps = (t_end - t_begin) * ksteps;

  // the running list of row r of this CTA (r < kTile, m0 + r < B)
  auto list_s = [&](int r) -> float* {
    return p.ls + ((size_t)(m0 + r) * splits + split) * K;
  };
  auto list_i = [&](int r) -> int* {
    return p.li + ((size_t)(m0 + r) * splits + split) * K;
  };

  if (kMode == kLists) {
    if (tid < kTile) sThr[tid] = -INFINITY;
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (m0 + r >= p.B) break;
      float* ls = list_s(r);
      int* li = list_i(r);
      for (int e = lane; e < K; e += 32) {
        ls[e] = -INFINITY;
        li[e] = -1;
      }
    }
  }
  // kArgmax: the best (score, id) so far of rows ty + 16 i, the same in
  // each of a row's 16 threads
  float best_s[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_s[i] = -INFINITY;
    best_i[i] = -1;
  }
  float qnv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
    qnv[i] = (p.metric != 1 && r < p.B) ? p.qn[r] : 0.f;
  }

  auto load = [&](int step, int buf) {
    const int t = t_begin + step / ksteps;
    const int k0 = d0 + (step % ksteps) * kSlab;
    for (int c = tid; c < kTile * kSlab / 4; c += kThreads) {
      const int r = c >> 2, kq = (c & 3) * 4, gk = k0 + kq;
      const int gq = m0 + r, gx = t * kTile + r;
      const bool okq = gq < p.B && gk < d1;
      const bool okx = gx < n_end && gk < d1;
      cp_async16(&sQ[(buf * kTile + r) * kLdT + kq],
                 okq ? p.q + (size_t)gq * p.d + gk : p.q, okq);
      cp_async16(&sX[(buf * kTile + r) * kLdT + kq],
                 okx ? p.x + (size_t)gx * p.d + gk : p.x, okx);
    }
    cp_async_commit();
  };

  float acc[8][8];
  load(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1, ks = s % ksteps;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (s + 1 < steps) {
      load(s + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qa = sQ + buf * kTile * kLdT;
    const float* xa = sX + buf * kTile * kLdT;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 4) {
      float4 qv[8], xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &qa[(ty + 16 * i) * kLdT + kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xv[j] = *reinterpret_cast<const float4*>(
            &xa[(tx + 16 * j) * kLdT + kk]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(qv[i].x, xv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, xv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, xv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, xv[j].w, acc[i][j]);
        }
    }
    __syncthreads();   // the next iteration's prefetch overwrites `buf`
    if (ks != ksteps - 1) continue;

    // ---- epilogue of database tile t: the scores ----
    const int n0 = (t_begin + s / ksteps) * kTile;
    if (kMode == kDotSlice) {   // the slice's dot products, as they are
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = m0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + tx + 16 * j;
          if (r < p.B && c < p.n)
            p.ls[((size_t)split * p.B + r) * p.n + c] = acc[i][j];
        }
      }
      continue;
    }
    float xnv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tx + 16 * j;
      xnv[j] = (p.metric != 1 && c < p.n) ? p.xn[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float& v = acc[i][j];
        if (p.metric == 0)
          v = (2.f * v - qnv[i]) - xnv[j];
        else if (p.metric == 2)
          v = v / ((qnv[i] + 1e-12f) * (xnv[j] + 1e-12f));
      }
    if (kMode == kArgmax) {
      // a thread's columns ascend with j, so a strict > keeps the lowest
      // id; then the best of the row's 16 threads (lanes xor 8, 4, 2, 1)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float bs = -INFINITY;
        int bi = INT32_MAX;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + tx + 16 * j;
          if (c < n_end && acc[i][j] > bs) {
            bs = acc[i][j];
            bi = c;
          }
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float os = __shfl_xor_sync(kFull, bs, off);
          const int oi = __shfl_xor_sync(kFull, bi, off);
          if (better(os, oi, bs, bi)) {
            bs = os;
            bi = oi;
          }
        }
        if (better(bs, bi, best_s[i], best_i[i])) {
          best_s[i] = bs;
          best_i[i] = bi;
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sS[(ty + 16 * i) * kLdS + tx + 16 * j] = acc[i][j];
    __syncthreads();

    // ---- one warp per row: merge the tile's candidates into the list ----
    float* cs = sCs + warp * kTile;
    int* ci = sCi + warp * kTile;
    float* ts = sTs + warp * K;
    int* ti = sTi + warp * K;
    const unsigned below = (1u << lane) - 1u;
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (m0 + r >= p.B) break;
      const float thr = sThr[r];
      float sv[4];
      int id[4];
      bool in[4];
      unsigned bal[4];
      int m = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        id[u] = n0 + lane + 32 * u;
        sv[u] = sS[r * kLdS + lane + 32 * u];
        in[u] = id[u] < n_end && sv[u] > thr;
        bal[u] = __ballot_sync(kFull, in[u]);
        m += __popc(bal[u]);
      }
      if (m == 0) continue;
      if (K <= 32 && m > K) {
        // the K-th best of the lanes' maxima bounds the tile's K-th best
        float best = -INFINITY;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (in[u]) best = fmaxf(best, sv[u]);
        float lb = best;
        if (K == 1) {          // the row's maximum
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            lb = fmaxf(lb, __shfl_xor_sync(kFull, lb, off));
        } else {               // sort the maxima descending, take the K-th
#pragma unroll
          for (int w = 2; w <= 32; w <<= 1)
#pragma unroll
            for (int j = w >> 1; j > 0; j >>= 1) {
              const float o = __shfl_xor_sync(kFull, lb, j);
              lb = (((lane & j) == 0) == ((lane & w) == 0)) ? fmaxf(lb, o)
                                                           : fminf(lb, o);
            }
          lb = __shfl_sync(kFull, lb, K - 1);
        }
        m = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          in[u] = in[u] && sv[u] >= lb;
          bal[u] = __ballot_sync(kFull, in[u]);
          m += __popc(bal[u]);
        }
      }
      int base = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (in[u]) {
          const int pos = base + __popc(bal[u] & below);
          cs[pos] = sv[u];
          ci[pos] = id[u];
        }
        base += __popc(bal[u]);
      }
      float* ls = list_s(r);
      int* li = list_i(r);
      __syncwarp();
      for (int e = lane; e < K + m; e += 32) {
        float v;
        int vi, rank;
        if (e < K) {
          v = ls[e];
          vi = li[e];
          rank = e;
        } else {
          v = cs[e - K];
          vi = ci[e - K];
          int lo = 0, hi = K;          // list entries better than it
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (better(ls[mid], li[mid], v, vi)) lo = mid + 1;
            else hi = mid;
          }
          rank = lo;
        }
        for (int c = 0; c < m; ++c) rank += better(cs[c], ci[c], v, vi);
        if (rank < K) {
          ts[rank] = v;
          ti[rank] = vi;
        }
      }
      __syncwarp();
      for (int e = lane; e < K; e += 32) {
        ls[e] = ts[e];
        li[e] = ti[e];
      }
      if (lane == 0) sThr[r] = ts[K - 1];
      __syncwarp();
    }
    __syncthreads();   // before the next tile's scores overwrite sS
  }

  if (kMode == kArgmax && tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + ty + 16 * i;
      if (r < p.B) {
        p.ls[(size_t)r * splits + split] = best_s[i];
        p.li[(size_t)r * splits + split] = best_i[i];
      }
    }
  }
}

// one warp per query row: the k best of its splits' sorted lists, in k
// rounds of a warp argmax over the lists' heads; a row's lists are first
// copied to shared memory when they fit (splits x k <= kMergeSmem)
__global__ void __launch_bounds__(kThreads) topk_merge_kernel(
    const float* __restrict__ ls, const int* __restrict__ li,
    float* __restrict__ os, int* __restrict__ oi, int B, int splits, int K) {
  __shared__ float s_s[kWarps * kMergeSmem];
  __shared__ int s_i[kWarps * kMergeSmem];
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (row >= B) return;
  const int total = splits * K;
  const float* rs = ls + (size_t)row * total;
  const int* ri = li + (size_t)row * total;
  if (total <= kMergeSmem) {
    float* ws = s_s + warp * kMergeSmem;
    int* wi = s_i + warp * kMergeSmem;
    for (int e = lane; e < total; e += 32) {
      ws[e] = rs[e];
      wi[e] = ri[e];
    }
    __syncwarp();
    rs = ws;
    ri = wi;
  }
  int head[kMaxHeads];
  float hs[kMaxHeads];
  int hi[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    const int sp = lane + 32 * h;
    head[h] = 0;
    hs[h] = sp < splits ? rs[sp * K] : -INFINITY;
    hi[h] = sp < splits ? ri[sp * K] : INT32_MAX;
  }
  for (int r = 0; r < K; ++r) {
    float bs = hs[0];
    int bi = hi[0], bh = 0;
#pragma unroll
    for (int h = 1; h < kMaxHeads; ++h)
      if (better(hs[h], hi[h], bs, bi)) {
        bs = hs[h];
        bi = hi[h];
        bh = h;
      }
    float ws = bs;
    int wi = bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFull, ws, off);
      const int oid = __shfl_xor_sync(kFull, wi, off);
      if (better(o, oid, ws, wi)) {
        ws = o;
        wi = oid;
      }
    }
    if (lane == 0) {
      os[(size_t)row * K + r] = ws;
      oi[(size_t)row * K + r] = wi;
    }
    if (bs == ws && bi == wi) {        // this lane's head was taken
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h == bh) {
          const int sp = lane + 32 * h;
          const int nx = ++head[h];
          hs[h] = nx < K ? rs[sp * K + nx] : -INFINITY;
          hi[h] = nx < K ? ri[sp * K + nx] : INT32_MAX;
        }
    }
  }
}

// one warp per query row, n <= kTile: the row's dot products summed over
// the slices of d in slice order, the metric applied as in the scan, then
// the k best in k rounds of a warp argmax, ties to the lowest id
__global__ void __launch_bounds__(kThreads) topk_dsum_kernel(
    const float* __restrict__ part, const float* __restrict__ qn,
    const float* __restrict__ xn, float* __restrict__ os,
    int* __restrict__ oi, int B, int n, int slices, int K, int metric) {
  constexpr int kPer = kTile / 32;     // columns a lane
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const float qv = metric != 1 ? qn[row] : 0.f;
  float v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int c = lane + 32 * u;
    float dot = 0.f;
    if (c < n)
      for (int sl = 0; sl < slices; ++sl)
        dot += part[((size_t)sl * B + row) * n + c];
    v[u] = dot;
    if (c < n && metric == 0)
      v[u] = (2.f * dot - qv) - xn[c];
    else if (c < n && metric == 2)
      v[u] = dot / ((qv + 1e-12f) * (xn[c] + 1e-12f));
  }
  unsigned taken = 0;                  // bit u: column lane + 32 u is out
  for (int r = 0; r < K; ++r) {
    float bs = -INFINITY;
    int bi = INT32_MAX;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = lane + 32 * u;
      if (c < n && !((taken >> u) & 1u) && better(v[u], c, bs, bi)) {
        bs = v[u];
        bi = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFull, bs, off);
      const int oid = __shfl_xor_sync(kFull, bi, off);
      if (better(o, oid, bs, bi)) {
        bs = o;
        bi = oid;
      }
    }
    if (lane == 0) {
      os[(size_t)row * K + r] = bs;
      oi[(size_t)row * K + r] = bi;
    }
    if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
  }
}

template <int kMode>
int launch_scan(const Params& p, int splits, cudaStream_t st) {
  const size_t smem = scan_smem_bytes(kMode, p.k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_scan_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.B + kTile - 1) / kTile, splits);
  topk_scan_kernel<kMode><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success), or -1 for arguments the
// kernel is not built for. Launches on `stream` and does not synchronise.
// q [B, d] and x [n, d] float32, d % 4 == 0, both 16-byte aligned;
// qn [B] and xn [n] scratch (unused for ip); with splits > 1, ls / li
// [B, splits, k] scratch for the partial lists; with slices > 1 (n <=
// 128, one split), ls [slices, B, n] scratch for the dot products of
// slices of d_cols columns; out_s [B, k] float32 and out_i [B, k] int32.
int topk_launch(const float* q, const float* x, float* qn, float* xn,
                float* ls, int* li, float* out_s, int* out_i, int B, int n,
                int d, int k, int metric, int splits, int tiles_per_split,
                int slices, int d_cols, void* stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  if (B < 1 || n < 1 || d < 4 || d % 4 != 0 || k < 1 || k > kMaxK ||
      k > n || metric < 0 || metric > 2 || splits < 1 ||
      splits > 32 * kMaxHeads || tiles_per_split < 1 ||
      (splits - 1) * tiles_per_split >= n_tiles ||
      splits * tiles_per_split < n_tiles || slices < 1 ||
      (slices > 1 && (n > kTile || splits > 1 || d_cols < kSlab ||
                      d_cols % kSlab != 0 || (slices - 1) * d_cols >= d ||
                      slices * d_cols < d)))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_block = kThreads / 32;
  if (metric != 1) {
    topk_norms_kernel<<<(B + n + per_block - 1) / per_block, kThreads, 0,
                        st>>>(q, x, B, n, d, metric == 2, qn, xn);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int row_blocks = (B + per_block - 1) / per_block;
  if (slices > 1) {
    const Params p{q, x, qn, xn, ls, li, B, n, d, k, metric, 1, d_cols};
    const int err = launch_scan<kDotSlice>(p, slices, st);
    if (err != 0) return err;
    topk_dsum_kernel<<<row_blocks, kThreads, 0, st>>>(
        ls, qn, xn, out_s, out_i, B, n, slices, k, metric);
    return (int)cudaGetLastError();
  }
  const Params p{q, x, qn, xn, splits == 1 ? out_s : ls,
                 splits == 1 ? out_i : li, B, n, d, k, metric,
                 tiles_per_split, d};
  const int err = k == 1 ? launch_scan<kArgmax>(p, splits, st)
                         : launch_scan<kLists>(p, splits, st);
  if (err != 0 || splits == 1) return err;
  topk_merge_kernel<<<row_blocks, kThreads, 0, st>>>(ls, li, out_s, out_i, B,
                                                     splits, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
