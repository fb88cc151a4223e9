// Flash-decode for Hopper (sm_90a): single-token GQA attention over a
// KV cache, with an online softmax, in one launch.
//
// Replaces the Pallas TPU kernel `flash_decode_pallas` /
// `_flash_decode_kernel` in src/repro/kernels/decode_attention/kernel.py.
// Semantics are those of `decode_attention_ref`
// (src/repro/kernels/decode_attention/ref.py): for every batch row b and
// query head h = kv * G + g, softmax(q . k_s * hd^-0.5) over the cache rows
// s = 0..pos[b], times v_s, summed in float32; the output is float32.
//
// What bounds it on the H100: each valid K and V row is read once and
// used by the G query heads of its kv head, about 2 G operations per
// byte of bf16 cache, far below the ~295 the card needs to be bound by
// arithmetic. So the kernel is bound by the bytes of the valid cache rows
// (rows past pos[b] are never read), and at the short caches of a
// serving step by the latency of a round trip to device memory, of the
// merge of partial states, and of its launch. Tensor cores are not used:
// a kv head has G query rows (2 in qwen3-1.7b), so an `mma` of 16 rows
// would waste 8 of every 16, and q is float32 in the reference; the G
// rows stay in registers and the scores and the weighted sum of V are
// float32 FMAs.
//
// What the previous design lost: it cut each (b, kv head)'s valid rows
// into a count of splits chosen from the allocated cache length and the
// SM count, each block streaming its split from device memory into
// registers a few rows a warp at a time; a second kernel combined the
// splits, with its scratch allocated on every call.
//
// Design:
//   * the grid is (B * KV, spans): a span is `span_rows` cache rows of
//     one (b, kv head), a whole number of tiles. A block whose span
//     starts past pos[b] exits at once, so the work is cut by the valid
//     rows, read on the device (no host sync). The wrapper gives each
//     block one tile while every tile's block fits on the card at once
//     (the CUDA occupancy API); otherwise one wave of spans of several
//     tiles;
//   * a whole tile is in flight before its first score: a tile is one
//     pass of the block, 8 warps x R rows x U loads (64 bf16 rows of hd =
//     128 at G <= 4, 32 KB of K and V), and every lane group issues the
//     16-byte loads of its U rows into registers before it scores any;
//     a span of several tiles streams them pass after pass;
//   * a cache row is read by L = hd * sizeof(T) / 16 neighbouring lanes,
//     each holding E = 16 / sizeof(T) elements of the G query rows in
//     registers; the dot product is finished by xor-shuffles inside the
//     lane group, and each lane group keeps its own running (max, sum,
//     acc[G][E]), so a block needs no barrier until its rows are done; the
//     lane groups then merge by shuffles, the warps through shared memory
//     with one weight exp(m_w - max) for each warp and query row;
//   * one launch: a (b, kv head) with one valid span writes its output
//     directly. Otherwise each span writes its partial (max, sum,
//     acc[G][hd]) to a workspace, and the last span to finish, found by a
//     per-(b, kv head) counter behind __threadfence(), merges the partials
//     in span order (so the output is the same bit for bit from run to
//     run), writes the output and resets the counter to 0 for the next
//     call. The workspace and the counters are kept by the wrapper from
//     call to call; the counters are zeroed once, when allocated.
//   * tiles staged in shared memory (16-byte cp.async, two to six stages;
//     and, separately, TMA bulk copies of one row each) measured slower
//     at every shape of chip_smoke.py's phase 2: the copies add a
//     round trip through shared memory and a barrier a tile, and a block
//     holding 32 KB of tiles per stage leaves fewer loads in flight on an
//     SM than warps that stream into registers.
// bf16 rows are widened exactly (bits << 16); all arithmetic is float32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// a (b, kv head)'s spans: at most this many, their weights in shared
// memory during the merge
constexpr int kMaxSpans = 256;

#ifdef DECODE_PROFILE
// profiling builds: for each of the first kProfBlocks blocks, the global
// timer (ns) and the SM clock at its start, after its rows, after its
// output or partial is written, after the counter, and after the merge
// (0 where not reached)
constexpr int kProfBlocks = 1 << 16;
constexpr int kStamps = 5;
__device__ unsigned long long g_prof[kProfBlocks][2 * kStamps];
#define STAMP(i)                                                          \
  if (threadIdx.x == 0 && prof_slot < kProfBlocks) {                      \
    unsigned long long ns;                                                \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                \
    g_prof[prof_slot][2 * (i)] = ns;                                      \
    g_prof[prof_slot][2 * (i) + 1] = clock64();                           \
  }
#else
#define STAMP(i)
#endif

struct Params {
  const float* q;     // [B, H, hd] float32
  const void* k;      // [B, S, KV, hd] float32 or bfloat16, contiguous
  const void* v;      // [B, S, KV, hd]
  const int* pos;     // [B]: rows 0..pos[b] are valid
  float* out;         // [B, H, hd]
  float* part;        // acc [B * KV, spans, G, hd], then (m, l) [.., G, 2]
  int* counters;      // [B * KV], 0 between calls
  int B, S, H, KV;
  int span_rows, spans;  // blocks over one (b, kv head), rows each
  float scale;
};

template <typename T> struct Row16;
template <> struct Row16<float> { static constexpr int kElems = 4; };
template <> struct Row16<uint16_t> { static constexpr int kElems = 8; };

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// exp(m - mx) for a running max m that may still be -inf (no row yet)
__device__ __forceinline__ float rescale(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Params p) {
  constexpr int E = Row16<T>::kElems;   // elements of a 16-byte piece
  constexpr int L = HD / E;             // lanes (pieces) of a cache row
  constexpr int R = 32 / L;             // rows a warp reads at once
  constexpr int U = G <= 4 ? 4 : 2;     // row loads of a lane in flight
  static_assert(HD % E == 0 && L >= 2 && L <= 32 && 32 % L == 0,
                "unsupported head_dim");

  // the warps' states (acc [kWarps][G][HD], then max and sum
  // [kWarps][G][2]); in the merge, the spans' weights [spans][G][2]
  constexpr int kArea = kWarps * G * (HD + 2) > kMaxSpans * G * 2
                            ? kWarps * G * (HD + 2)
                            : kMaxSpans * G * 2;
  __shared__ float s_area[kArea];
  __shared__ float s_mx[G], s_den[G];
  __shared__ int s_last;

  const int bk = blockIdx.x, span = blockIdx.y;
  const int b = bk / p.KV, kv = bk - b * p.KV;
#ifdef DECODE_PROFILE
  const size_t prof_slot = (size_t)span * gridDim.x + bk;
#endif
  STAMP(0);

  // this block's rows: span `span` of the valid rows 0..pos[b]; span 0
  // always runs, so that a row with no valid cache row still gets its
  // (zero) output
  const int n_valid = min(max(p.pos[b] + 1, 0), p.S);
  const int span_rows = p.span_rows;
  const int start = span * span_rows;
  if (span > 0 && start >= n_valid) return;
  const int end = min(start + span_rows, n_valid);
  const int n_spans = max(1, (n_valid + span_rows - 1) / span_rows);

  const size_t row = (size_t)p.KV * HD;   // elements from row s to s + 1
  const size_t base = ((size_t)b * p.S * p.KV + kv) * HD;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;

  // the G query rows of this kv head, E elements a lane, in registers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % L, grp = lane / L;
  float q[G][E];
  const float* qb = p.q + ((size_t)b * p.H + (size_t)kv * G) * HD + sub * E;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) q[g][e] = qb[g * HD + e];

  // each lane group's running (max, sum, acc)
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // a pass of the block reads kWarps * R * U rows (a tile: 32 KB of K
  // and V at G <= 4): each lane group issues its U rows of the pass
  // before it scores the first. The loop bound depends on the warp only,
  // so every lane of a warp takes part in the shuffles.
  for (int r0 = start + warp * R; r0 < end; r0 += kWarps * R * U) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * kWarps * R + grp;
      ok[u] = r < end;
      if (ok[u]) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)r * row +
                                                     sub * E));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)r * row +
                                                     sub * E));
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
      }
    }
    float sc[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(q[g][e], kf[e], d);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(kFull, d, off);
        sc[u][g] = ok[u] ? d * p.scale : -INFINITY;
      }
    }
    float vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) unpack(vr[u], vf[u]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
      if (mx == -INFINITY) continue;     // no valid row for this group yet
      const float c = rescale(m[g], mx);
      l[g] *= c;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= c;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pr = expf(sc[u][g] - mx);   // 0 for an invalid row
        l[g] += pr;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = fmaf(pr, vf[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }
  STAMP(1);

  // merge the R lane groups of the warp (they hold the same elements)
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float ca = rescale(m[g], mx), cb = rescale(mo, mx);
      l[g] = l[g] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[g][e], off);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
      m[g] = mx;
    }
  }
  // the warps' states into shared memory
  float* s_acc = s_area;                              // [kWarps][G][HD]
  float* s_ml = s_acc + kWarps * G * HD;              // [kWarps][G][2]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        s_acc[(warp * G + g) * HD + sub * E + e] = acc[g][e];
      if (sub == 0) {
        s_ml[2 * (warp * G + g)] = m[g];
        s_ml[2 * (warp * G + g) + 1] = l[g];
      }
    }
  }
  __syncthreads();
  // each warp's weight exp(m_w - max) for each query row, and the block's
  // max and sum, in place of the warps' (max, sum)
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = -INFINITY, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_ml[2 * (w * G + g)]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(s_ml[2 * (w * G + g)], mx);
      den += c * s_ml[2 * (w * G + g) + 1];
      s_ml[2 * (w * G + g)] = c;
    }
    s_mx[g] = mx;
    s_den[g] = den;
  }
  __syncthreads();

  // merge the warps; write the output, or this span's partial state
  const size_t groups = (size_t)p.B * p.KV;
  float* part_acc = p.part;
  float* part_ml = p.part + groups * p.spans * G * HD;
  const size_t slot = (size_t)bk * p.spans + span;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i - g * HD;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      num += s_ml[2 * (w * G + g)] * s_acc[(w * G + g) * HD + d];
    const float mx = s_mx[g], den = s_den[g];
    if (n_spans == 1) {
      p.out[((size_t)b * p.H + (size_t)kv * G + g) * HD + d] =
          num / fmaxf(den, 1e-30f);
    } else {
      const size_t o = slot * G + g;
      part_acc[o * HD + d] = num;
      if (d == 0) {
        part_ml[2 * o] = mx;
        part_ml[2 * o + 1] = den;
      }
    }
  }
  STAMP(2);
  if (n_spans == 1) return;

  // the last span of this (b, kv head) to finish merges all of them
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(p.counters + bk, 1) == n_spans - 1;
  __syncthreads();
  STAMP(3);
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) p.counters[bk] = 0;
  const size_t first = (size_t)bk * p.spans;
  // the spans' (max, sum) into shared memory at once, while each thread
  // loads its first kPre partial sums; then each query row's weights
  // exp(m_j - max) in place and its total sum; the partials are summed
  // in span order
  constexpr int kPre = 8;
  constexpr int kPer = (G * HD + kThreads - 1) / kThreads;
  float pre[kPer][kPre];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
#pragma unroll
    for (int j = 0; j < kPre; ++j)
      pre[u][j] = i < G * HD && j < n_spans
                      ? __ldcg(part_acc + (first + j) * G * HD + i)
                      : 0.f;
  }
  float* s_w = s_area;                                // [n_spans][G][2]
  for (int i = threadIdx.x; i < 2 * n_spans * G; i += kThreads)
    s_w[i] = __ldcg(part_ml + 2 * first * G + i);
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int j = lane; j < n_spans; j += 32)
      mx = fmaxf(mx, s_w[2 * (j * G + g)]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int j = lane; j < n_spans; j += 32) {
      const float c = rescale(s_w[2 * (j * G + g)], mx);
      s_w[2 * (j * G + g)] = c;
      den += c * s_w[2 * (j * G + g) + 1];
    }
    den = warp_sum(den);
    if (lane == 0) s_den[g] = den;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i >= G * HD) break;
    const int g = i / HD, d = i - g * HD;
    const float* pa = part_acc + first * G * HD + i;
    float num = 0.f;
#pragma unroll
    for (int j = 0; j < kPre; ++j)
      if (j < n_spans) num += s_w[2 * (j * G + g)] * pre[u][j];
    int j = kPre;
    for (; j + 4 <= n_spans; j += 4) {
      const float a0 = __ldcg(pa + (size_t)j * G * HD);
      const float a1 = __ldcg(pa + (size_t)(j + 1) * G * HD);
      const float a2 = __ldcg(pa + (size_t)(j + 2) * G * HD);
      const float a3 = __ldcg(pa + (size_t)(j + 3) * G * HD);
      num += s_w[2 * (j * G + g)] * a0;
      num += s_w[2 * ((j + 1) * G + g)] * a1;
      num += s_w[2 * ((j + 2) * G + g)] * a2;
      num += s_w[2 * ((j + 3) * G + g)] * a3;
    }
    for (; j < n_spans; ++j)
      num += s_w[2 * (j * G + g)] * __ldcg(pa + (size_t)j * G * HD);
    p.out[((size_t)b * p.H + (size_t)kv * G + g) * HD + d] =
        num / fmaxf(s_den[g], 1e-30f);
  }
  STAMP(4);
}

// blocks an SM holds at once
template <typename T, int HD, int G>
long long run(const Params& p, bool occupancy, cudaStream_t st) {
  if (occupancy) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_decode_kernel<T, HD, G>, kThreads, 0);
    return err != cudaSuccess ? -(long long)err : blocks;
  }
  const dim3 grid(p.B * p.KV, p.spans);
  flash_decode_kernel<T, HD, G><<<grid, kThreads, 0, st>>>(p);
  return (long long)cudaGetLastError();
}

template <typename T, int HD>
long long by_groups(const Params& p, int G, bool occ, cudaStream_t st) {
  switch (G) {
    case 1: return run<T, HD, 1>(p, occ, st);
    case 2: return run<T, HD, 2>(p, occ, st);
    case 3: return run<T, HD, 3>(p, occ, st);
    case 4: return run<T, HD, 4>(p, occ, st);
    case 5: return run<T, HD, 5>(p, occ, st);
    case 6: return run<T, HD, 6>(p, occ, st);
    case 7: return run<T, HD, 7>(p, occ, st);
    case 8: return run<T, HD, 8>(p, occ, st);
  }
  return -1;
}

template <typename T>
long long by_head_dim(const Params& p, int hd, int G, bool occ,
                      cudaStream_t st) {
  switch (hd) {
    case 16: return by_groups<T, 16>(p, G, occ, st);
    case 32: return by_groups<T, 32>(p, G, occ, st);
    case 64: return by_groups<T, 64>(p, G, occ, st);
    case 128: return by_groups<T, 128>(p, G, occ, st);
  }
  return -1;
}

long long dispatch(const Params& p, int hd, int bf16, bool occ,
                   cudaStream_t st) {
  if (p.KV <= 0 || p.H % p.KV != 0) return -1;
  const int G = p.H / p.KV;
  return bf16 ? by_head_dim<uint16_t>(p, hd, G, occ, st)
              : by_head_dim<float>(p, hd, G, occ, st);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success), or -1 for a head_dim, group
// count or plan the kernel is not built for. Launches on `stream` and
// does not synchronise. `part` holds at least B * KV * spans * G *
// (hd + 2) floats (unused when spans == 1) and `counters` B * KV ints
// that are 0 (the kernel leaves them 0). `spans` blocks of `span_rows`
// rows each cover the cache (spans * span_rows >= S), spans <= 256.
int flash_decode_launch(const float* q, const void* k, const void* v,
                        const int* pos, float* out, float* part,
                        int* counters, int B, int S, int H, int KV, int hd,
                        int bf16, int span_rows, int spans, void* stream) {
  if (spans < 1 || spans > kMaxSpans || span_rows < 1 ||
      (long long)spans * span_rows < S)
    return -1;
  const Params p{q, k, v, pos, out, part, counters, B, S, H, KV,
                 span_rows, spans, 1.0f / sqrtf((float)hd)};
  const long long r = dispatch(p, hd, bf16, false,
                               static_cast<cudaStream_t>(stream));
  return (int)r;
}

// The blocks an SM holds at once (the CUDA occupancy API), negative for
// what the kernel does not take.
int flash_decode_blocks_per_sm(int H, int KV, int hd, int bf16) {
  const Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, 0, 0, H, KV, 1, 1, 1.f};
  return (int)dispatch(p, hd, bf16, true, nullptr);
}

#ifdef DECODE_PROFILE
// Copies the stamps of the first `blocks` blocks (2 * kStamps a block,
// see g_prof) to `out` and zeroes them (profiling builds).
int flash_decode_profile(unsigned long long* out, int blocks) {
  const size_t n = sizeof(unsigned long long) * 2 * kStamps *
                   (size_t)(blocks < kProfBlocks ? blocks : kProfBlocks);
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, n);
  if (err != cudaSuccess) return (int)err;
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, g_prof);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(dev, 0, sizeof(g_prof));
}
#endif

}  // extern "C"
