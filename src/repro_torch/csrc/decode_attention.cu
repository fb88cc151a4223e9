// Flash-decode for Hopper (sm_90a): single-token GQA attention over a
// KV cache, with an online softmax, in one launch.
//
// Replaces the Pallas TPU kernel `flash_decode_pallas` /
// `_flash_decode_kernel` in src/repro/kernels/decode_attention/kernel.py.
// Semantics are those of `decode_attention_ref`
// (src/repro/kernels/decode_attention/ref.py): for every batch row b and
// query head h = kv * G + g, softmax(q . k_s * hd^-0.5) over the cache rows
// s = lo..pos[b], times v_s, summed in float32; the output is float32.
// lo is 0, or with a window w > 0, max(0, pos[b] - w + 1): the rows a
// full-size cache on a sliding layer holds for its token
// (src/repro/models/attention.py, decode_attention_block). A ring cache of
// R slots needs no window: its valid slots are 0..min(pos, R - 1), which
// the caller passes as pos.
//
// What bounds it on the H100: each valid K and V row is read once and
// used by the G query heads of its kv head, about 2 G operations per
// byte of bf16 cache, far below the ~295 the card needs to be bound by
// arithmetic. So the kernel is bound by the bytes of the valid cache rows
// (rows outside lo..pos[b] are never read), and at the short caches of a
// serving step by the latency of a round trip to device memory, of the
// merge of partial states, and of its launch. Tensor cores are not used:
// a kv head has G query rows (2 in qwen3-1.7b and gemma3-12b), so an
// `mma` of 16 rows would waste most of them, and q is float32 in the
// reference; the G rows stay in registers and the scores and the
// weighted sum of V are float32 FMAs.
//
// Design:
//   * the grid is (B * KV * slices, spans): a span is `span_rows` cache
//     rows of one (b, kv head), a whole number of tiles. A block whose
//     span lies outside lo..pos[b] exits at once, so the work is cut by
//     the valid rows, read on the device (no host sync). The wrapper
//     gives each block one tile while every tile's block fits on the card
//     at once (the CUDA occupancy API); otherwise one wave of spans of
//     several tiles;
//   * a kv head's G query heads are cut into `slices` blocks of a power
//     of two of heads, at most 8 (4 at hd = 240), so that a lane's query
//     and accumulator registers (2 x 8 x 8 floats at most) stay the same
//     at G = 16 (chatglm3-6b) as at G = 8 and nothing spills; the slices
//     of one (b, kv head) are neighbouring blocks, so the second reads
//     the rows from L2. A block whose slice has fewer heads than its
//     power of two (G = 3, 5 to 7, 9 to 15) carries zero query rows for
//     the rest and writes none of them: one build of 1, 2, 4 and 8 heads
//     serves every G from 1 to 16;
//   * a whole tile is in flight before its first score: a tile is one
//     pass of the block, 8 warps x R rows x U loads (64 bf16 rows of hd =
//     128 at G <= 4, 32 KB of K and V), and every lane group issues the
//     16-byte loads of its U rows into registers before it scores any;
//     a span of several tiles streams them pass after pass;
//   * a cache row is hd * sizeof(T) / 16 pieces of 16 bytes (E = 16 /
//     sizeof(T) elements each), read by L neighbouring lanes, a power of
//     two: at hd = 16 to 128 one piece a lane, as many lanes as pieces; at
//     hd = 80 and 240 the lanes round up to the next power of two (10
//     bf16 pieces on 16 lanes, 30 on 32, 20 float32 pieces on 32) and the
//     idle lanes hold zeros; at hd = 240 in float32 (60 pieces) a lane
//     holds two, pieces sub and sub + 32, so that each load instruction
//     still reads neighbouring addresses. Each lane keeps E (or 2E)
//     elements of the G query rows; the dot product is finished by
//     xor-shuffles inside the lane group, and each lane group keeps its
//     own running (max, sum, acc[G][.]), so a block needs no barrier
//     until its rows are done; the lane groups then merge by shuffles,
//     the warps through shared memory with one weight exp(m_w - max) for
//     each warp and query row;
//   * one launch: a (b, kv head, slice) with one valid span writes its
//     output directly. Otherwise each span writes its partial (max, sum,
//     acc[G][hd]) to a workspace, and the last span to finish, found by a
//     per-(b, kv head, slice) counter behind __threadfence(), merges the
//     partials in span order (so the output is the same bit for bit from
//     run to run), writes the output and resets the counter to 0 for the
//     next call. The workspace and the counters are kept by the wrapper
//     from call to call; the counters are zeroed once, when allocated.
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
// query heads a block takes: the lane's registers hold G x E (or 2E)
// query elements and as many accumulators; at hd = 240 the warps' states
// (kWarps x G x (hd + 2) floats) must also fit the 48 KB of static shared
// memory
__host__ __device__ constexpr int max_groups(int hd) {
  return hd > 128 ? 4 : 8;
}

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
  const int* pos;     // [B]: rows lo..pos[b] are valid
  float* out;         // [B, H, hd]
  float* part;        // acc [B * KV * slices, spans, G, hd], then (m, l)
  int* counters;      // [B * KV * slices], 0 between calls
  int B, S, H, KV;
  int span_rows, spans;  // blocks over one (b, kv head), rows each
  int slices;            // blocks over one kv head's query heads
  int window;            // 0: none; else rows > pos - window only
  float scale;
};

template <typename T> struct Row16;
template <> struct Row16<float> { static constexpr int kElems = 4; };
template <> struct Row16<uint16_t> { static constexpr int kElems = 8; };

// a row's lanes: `pieces` 16-byte pieces a lane, `lanes` a power of two
// (at least 2) with lanes * pieces >= the row's pieces
template <typename T, int HD> struct Lanes {
  static constexpr int kElems = Row16<T>::kElems;
  static constexpr int kRowPieces = HD / kElems;
  static constexpr int kPieces = (kRowPieces + 31) / 32;
  static constexpr int kNeeded = (kRowPieces + kPieces - 1) / kPieces;
  static constexpr int kLanes = kNeeded <= 2    ? 2
                                : kNeeded <= 4  ? 4
                                : kNeeded <= 8  ? 8
                                : kNeeded <= 16 ? 16
                                                : 32;
};

__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float* f, uint16_t) {
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
  using Lay = Lanes<T, HD>;
  constexpr int E = Lay::kElems;        // elements of a 16-byte piece
  constexpr int NP = Lay::kRowPieces;   // pieces of a cache row
  constexpr int P = Lay::kPieces;       // pieces a lane holds
  constexpr int L = Lay::kLanes;        // lanes of a cache row
  constexpr int R = 32 / L;             // rows a warp reads at once
  constexpr int PE = P * E;             // elements a lane holds
  constexpr int U = (G <= 4 ? 4 : 2) / P;  // row loads of a lane in flight
  static_assert(HD % E == 0 && L * P >= NP && P <= 2 && U >= 1,
                "unsupported head_dim");
  static_assert(G <= max_groups(HD), "too many query heads for a block");

  // the warps' states (acc [kWarps][G][HD], then max and sum
  // [kWarps][G][2]); in the merge, the spans' weights [spans][G][2]
  constexpr int kArea = kWarps * G * (HD + 2) > kMaxSpans * G * 2
                            ? kWarps * G * (HD + 2)
                            : kMaxSpans * G * 2;
  __shared__ float s_area[kArea];
  __shared__ float s_mx[G], s_den[G];
  __shared__ int s_last;

  // unit: one (b, kv head, slice of its query heads)
  const int unit = blockIdx.x, span = blockIdx.y;
  const int bk = unit / p.slices, slice = unit - bk * p.slices;
  const int b = bk / p.KV, kv = bk - b * p.KV;
  const int heads = p.H / p.KV;                   // G of the model
  const int g0 = slice * G;                       // first head of the slice
  const int gn = min(G, heads - g0);              // heads of the slice
#ifdef DECODE_PROFILE
  const size_t prof_slot = (size_t)span * gridDim.x + unit;
#endif
  STAMP(0);

  // the valid rows lo..hi-1, the spans they touch, and this block's rows;
  // with no valid row, span 0 alone runs, so that the row still gets its
  // (zero) output
  const int pb = p.pos[b];
  const int hi = min(max(pb + 1, 0), p.S);
  const int lo = p.window > 0 ? max(pb - p.window + 1, 0) : 0;
  const int span_rows = p.span_rows;
  int first = 0, n_spans = 1, start = 0, end = 0;
  if (hi > lo) {
    first = lo / span_rows;
    n_spans = (hi - 1) / span_rows - first + 1;
    if (span < first || span >= first + n_spans) return;
    start = max(span * span_rows, lo);
    end = min(span * span_rows + span_rows, hi);
  } else if (span > 0) {
    return;
  }

  const size_t row = (size_t)p.KV * HD;   // elements from row s to s + 1
  const size_t base = ((size_t)b * p.S * p.KV + kv) * HD;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;

  // the slice's query rows of this kv head, pieces sub and sub + L of
  // each in a lane's registers (zeros for idle lanes and missing heads)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % L, grp = lane / L;
  float q[G][PE];
  const float* qb = p.q + ((size_t)b * p.H + (size_t)kv * heads + g0) * HD;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int piece = sub + j * L;
#pragma unroll
      for (int e = 0; e < E; ++e)
        q[g][j * E + e] = g < gn && piece < NP
                              ? qb[(size_t)g * HD + piece * E + e]
                              : 0.f;
    }

  // each lane group's running (max, sum, acc)
  float m[G], l[G], acc[G][PE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PE; ++e) acc[g][e] = 0.f;
  }

  // a pass of the block reads kWarps * R * U rows (a tile: 32 KB of K
  // and V at G <= 4 and hd <= 128): each lane group issues its U rows of
  // the pass before it scores the first. The loop bound depends on the
  // warp only, so every lane of a warp takes part in the shuffles.
  for (int r0 = start + warp * R; r0 < end; r0 += kWarps * R * U) {
    uint4 kr[U][P], vr[U][P];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * kWarps * R + grp;
      ok[u] = r < end;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int piece = sub + j * L;
        if (ok[u] && piece < NP) {
          const size_t o = (size_t)r * row + piece * E;
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(kb + o));
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(vb + o));
        } else {
          kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][j] = kr[u][j];
        }
      }
    }
    float sc[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[PE];
#pragma unroll
      for (int j = 0; j < P; ++j) unpack(kr[u][j], kf + j * E, T());
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < PE; ++e) d = fmaf(q[g][e], kf[e], d);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(kFull, d, off);
        sc[u][g] = ok[u] ? d * p.scale : -INFINITY;
      }
    }
    float vf[U][PE];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < P; ++j) unpack(vr[u][j], vf[u] + j * E, T());
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
      if (mx == -INFINITY) continue;     // no valid row for this group yet
      const float c = rescale(m[g], mx);
      l[g] *= c;
#pragma unroll
      for (int e = 0; e < PE; ++e) acc[g][e] *= c;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pr = expf(sc[u][g] - mx);   // 0 for an invalid row
        l[g] += pr;
#pragma unroll
        for (int e = 0; e < PE; ++e)
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
      const float lo_ = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float ca = rescale(m[g], mx), cb = rescale(mo, mx);
      l[g] = l[g] * ca + lo_ * cb;
#pragma unroll
      for (int e = 0; e < PE; ++e) {
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
      for (int j = 0; j < P; ++j) {
        const int piece = sub + j * L;
        if (piece < NP) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            s_acc[(warp * G + g) * HD + piece * E + e] = acc[g][j * E + e];
        }
      }
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
  const size_t units = (size_t)p.B * p.KV * p.slices;
  float* part_acc = p.part;
  float* part_ml = p.part + units * p.spans * G * HD;
  const size_t slot = (size_t)unit * p.spans + span;
  float* outb = p.out + ((size_t)b * p.H + (size_t)kv * heads + g0) * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i - g * HD;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      num += s_ml[2 * (w * G + g)] * s_acc[(w * G + g) * HD + d];
    const float mx = s_mx[g], den = s_den[g];
    if (n_spans == 1) {
      if (g < gn) outb[i] = num / fmaxf(den, 1e-30f);
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

  // the last span of this unit to finish merges all of them
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(p.counters + unit, 1) == n_spans - 1;
  __syncthreads();
  STAMP(3);
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) p.counters[unit] = 0;
  const size_t first_slot = (size_t)unit * p.spans + first;
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
                      ? __ldcg(part_acc + (first_slot + j) * G * HD + i)
                      : 0.f;
  }
  float* s_w = s_area;                                // [n_spans][G][2]
  for (int i = threadIdx.x; i < 2 * n_spans * G; i += kThreads)
    s_w[i] = __ldcg(part_ml + 2 * first_slot * G + i);
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
    const int g = i / HD;
    const float* pa = part_acc + first_slot * G * HD + i;
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
    if (g < gn) outb[i] = num / fmaxf(s_den[g], 1e-30f);
  }
  STAMP(4);
}

// what a call of the templates below does: launch the kernel, ask the
// occupancy API for the blocks an SM holds, or report the layout
enum class Op { kLaunch, kOccupancy, kLayout };

// a launch: the CUDA error (0 on success); occupancy: the blocks an SM
// holds at once; layout: writes the row's lanes and the pieces a lane
// holds to out[0], out[1]
template <typename T, int HD, int G>
long long run(const Params& p, Op op, cudaStream_t st, int* out) {
  if (op == Op::kLayout) {
    out[0] = Lanes<T, HD>::kLanes;
    out[1] = Lanes<T, HD>::kPieces;
    return 0;
  }
  if (op == Op::kOccupancy) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_decode_kernel<T, HD, G>, kThreads, 0);
    return err != cudaSuccess ? -(long long)err : blocks;
  }
  const dim3 grid(p.B * p.KV * p.slices, p.spans);
  flash_decode_kernel<T, HD, G><<<grid, kThreads, 0, st>>>(p);
  return (long long)cudaGetLastError();
}

// G: the heads of one block, a power of two
template <typename T, int HD>
long long by_groups(const Params& p, int G, Op op, cudaStream_t st,
                    int* out) {
  if (G > max_groups(HD)) return -1;
  switch (G) {
    case 1: return run<T, HD, 1>(p, op, st, out);
    case 2: return run<T, HD, 2>(p, op, st, out);
    case 4: return run<T, HD, 4>(p, op, st, out);
  }
  if constexpr (max_groups(HD) > 4) {
    if (G == 8) return run<T, HD, 8>(p, op, st, out);
  }
  return -1;
}

template <typename T>
long long by_head_dim(const Params& p, int hd, int G, Op op,
                      cudaStream_t st, int* out) {
  switch (hd) {
    case 16: return by_groups<T, 16>(p, G, op, st, out);
    case 32: return by_groups<T, 32>(p, G, op, st, out);
    case 64: return by_groups<T, 64>(p, G, op, st, out);
    case 80: return by_groups<T, 80>(p, G, op, st, out);
    case 128: return by_groups<T, 128>(p, G, op, st, out);
    case 240: return by_groups<T, 240>(p, G, op, st, out);
  }
  return -1;
}

// The kv head's H / KV query heads cut into p.slices blocks of G heads:
// as few blocks as max_groups(hd) allows, G the least power of two that
// covers the heads in them. Fills p.slices (and, for the layout, out[2]
// and out[3]), then calls the instantiation for (T, hd, G); -1 for a
// shape it is not built for.
long long dispatch(Params& p, int hd, int bf16, Op op, cudaStream_t st,
                   int* out) {
  if (p.KV <= 0 || p.H <= 0 || p.H % p.KV != 0 || hd <= 0) return -1;
  const int heads = p.H / p.KV;
  const int cap = max_groups(hd);
  p.slices = (heads + cap - 1) / cap;
  int G = 1;
  while (G * p.slices < heads) G *= 2;
  if (op == Op::kLayout) {
    out[2] = p.slices;
    out[3] = G;
  }
  return bf16 ? by_head_dim<uint16_t>(p, hd, G, op, st, out)
              : by_head_dim<float>(p, hd, G, op, st, out);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success), or -1 for a head_dim, group
// count or plan the kernel is not built for. Launches on `stream` and
// does not synchronise. `part` holds at least B * KV * slices * spans *
// G * (hd + 2) floats (unused when spans == 1) and `counters` B * KV *
// slices ints that are 0 (the kernel leaves them 0), slices and G as
// flash_decode_layout gives them. `spans` blocks of `span_rows` rows each
// cover the cache (spans * span_rows >= S), spans <= 256. `window` > 0
// keeps only the rows > pos - window.
int flash_decode_launch(const float* q, const void* k, const void* v,
                        const int* pos, float* out, float* part,
                        int* counters, int B, int S, int H, int KV, int hd,
                        int bf16, int span_rows, int spans, int window,
                        void* stream) {
  if (spans < 1 || spans > kMaxSpans || span_rows < 1 || window < 0 ||
      (long long)spans * span_rows < S)
    return -1;
  Params p{q, k, v, pos, out, part, counters, B, S, H, KV,
           span_rows, spans, 0, window, 1.0f / sqrtf((float)hd)};
  return (int)dispatch(p, hd, bf16, Op::kLaunch,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// The blocks an SM holds at once (the CUDA occupancy API), negative for
// what the kernel does not take.
int flash_decode_blocks_per_sm(int H, int KV, int hd, int bf16) {
  Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, 0, 0, H, KV, 1, 1, 0, 0, 1.f};
  return (int)dispatch(p, hd, bf16, Op::kOccupancy, nullptr, nullptr);
}

// The kernel's layout at (H, KV, hd, bf16): writes the lanes that read a
// cache row, the 16-byte pieces a lane holds, the blocks over a kv head's
// query heads (slices) and the heads a block holds (G) to out[0..3];
// returns -1 for a shape the kernel is not built for.
int flash_decode_layout(int H, int KV, int hd, int bf16, int* out) {
  Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, 0, 0, H, KV, 1, 1, 0, 0, 1.f};
  return (int)dispatch(p, hd, bf16, Op::kLayout, nullptr, out);
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
