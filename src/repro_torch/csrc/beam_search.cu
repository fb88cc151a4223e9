// Fused bottom-layer HNSW beam walk for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `beam_search_pallas` / `_beam_kernel`
// in src/repro/kernels/beam_search/kernel.py. Semantics are those of
// `beam_search_np` (src/repro/kernels/beam_search/ref.py): per (graph,
// slot) row, expand the best unexpanded beam entry (ties to the lowest
// beam position), skip -1 padding and visited neighbours, score them
// (l2 / ip / angular; int8 rows dequantized as c*scale+zero), and keep
// the top `ef` of beam U neighbours with the old beam first on ties. A row
// stops when nothing is unexpanded or after `max_iters` expansions. A row
// whose entry is -1 (an empty slot of a shard's queue) returns (-inf, -1)
// without walking.
//
// What bounds it on the H100. An expansion reads one adjacency row, then
// up to M0 data rows at addresses that depend on it, then ranks the new
// candidates into the beam before the next expansion can start: a walk
// is a chain of dependent memory round trips and short serial steps, and
// the card runs as many chains at once as its SMs hold walks. With
// thousands of walks a launch the row gathers' latency under load bounds
// it (from L2 where a graph's rows fit there, from device memory where
// they do not: 16 graphs of 65,536 float32 rows are 537 MB); with a few
// walks (an engine batch of 16) the latency of one expansion does.
//
// Design. One block walks one (graph, slot) row.
//   * Every surviving row of an expansion is in flight at once: cp.async
//     16-byte copies (4-byte for other widths) of all of them into a
//     shared staging buffer, one wait per expansion. The kNN-LM
//     datastores' rows (d = 1,536 and 2,048) are staged whole where the
//     launch leaves at most one walk an SM (the lookups' 32 walks: a block
//     then has the SM's shared memory to itself), and otherwise in slices
//     of d, double-buffered, the next slice in flight while the current
//     one is scored. A walk with a large beam (ef >= 512) spends
//     most of an expansion ranking, so it stages a quarter of the rows a
//     pass and the smaller block lets more walks share an SM.
//   * The next expansion's adjacency row is fetched before it is needed:
//     that of the best unexpanded entry after the current one, with the
//     rows; and when the best new candidate lands before that entry, its
//     own, while the beam is merged.
//   * Eight lanes score a row, up to eight rows a group at once: a lane
//     reads its share of the query (and of the int8 grid) once for all of
//     them, the rows' loads and 3-step shuffle reductions interleave. A
//     lane sums 4 products at a time and adds those partials pairwise, the
//     same depth of sums as one lane a float4 and a warp-wide tree. From
//     a lane's sum of a pass on, everything is float64: the 3-step shuffle
//     reduction, the slices' sums, |q|^2 and the metric, rounded to
//     float32 once. At the kNN-LM widths |q|^2 and |x|^2 reach d ~ 4,096,
//     where float32 sums of the lanes and slices part from the exact score
//     by up to an ulp of it and reorder rows that float64 parts by less.
//   * The new candidates are first cut at the beam's ef-th score (only a
//     strictly better one can enter: the beam wins ties), then the
//     survivors are sorted by a warp-wide bitonic sort on (score desc,
//     slot asc), one a lane, over the next power of two above their count.
//   * The beam (8-byte entries, the expanded flag in the id's top bit) is
//     updated in place. A survivor lands at its rank plus the number of
//     beam entries >= its score (a binary search); only the entries
//     behind the first insertion point move, merged 32 outputs at a time
//     from the back. A pointer below which every entry is
//     expanded replaces the scan of the whole beam, so an expansion's work
//     follows what entered the beam, not ef.
//   * At small S * C (an engine batch, the kNN-LM lookups, the routing
//     walk) a block has two or four warps, which split the copies and the
//     scoring; the ranking and the beam update stay on warp 0. The wrapper
//     chooses the warps and the staging (`walk_plan` in
//     kernels/beam_search/ops.py): as many warps as keep the walks that
//     fit an SM resident.
//   * The visited set is a packed bitmask, in shared memory when it fits
//     and otherwise in a zeroed global scratch tensor from the wrapper.
// Duplicate neighbour slots: the visited test reads the mask for all M0
// slots before any of this step's bits are set, so a node that appears
// twice in one adjacency row is a candidate twice, as in the reference.
// Float comparisons treat -0.0 == +0.0, as numpy and the Pallas kernel do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 8;         // lanes that score one row
constexpr int kMaxM0 = 64;        // adjacency slots: two per lane

struct Params {
  const void* data;        // [S, n, d] float32 or int8
  const float* scale;      // [d] (int8 only)
  const float* zero;       // [d] (int8 only)
  const int* bottom;       // [S, n, M0], -1 padded
  const float* queries;    // [S, C, d]
  const int* entries;      // [S, C], -1 for a slot not to walk
  float* out_s;            // [S, C, efp]
  int* out_i;              // [S, C, efp]
  unsigned* vis_global;    // [S*C, words] zeroed, or nullptr (shared)
  int S, n, d, M0, C, efp, max_iters, metric, words;
  int stage_rows;          // rows a staging pass holds
  int slice;               // columns of d a staging pass holds
  int stage_buffers;       // 1, or 2 to copy a pass while one is scored
  int row_unit;            // bytes a row copy moves: 16, 4 or 1
  int adj_unit;            // bytes an adjacency copy moves: 16 or 4
};

// A beam entry: score, and node id with the expanded flag in bit 31.
struct alignas(8) Entry {
  float s;
  int id;
};
constexpr int kExpanded = int(0x80000000u);

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of one block's shared-memory regions (mirrored by
// `layout_bytes` in kernels/beam_search/ops.py).
struct Layout {
  size_t q, sc, zr, beam, vnode, vdot, vnrm, adj, cand, ctrl, vis, stage0,
      stage1, bytes;
  __host__ __device__ Layout(int d, int efp, int M0, int words, bool vis_shared,
                             bool quant, int stage_rows, int slice, int buffers) {
    const size_t elem = quant ? 1 : 4;
    size_t o = 0;
    q = o;      o = align16(o + 4 * (size_t)d);
    sc = o;     o = align16(o + (quant ? 4 * (size_t)d : 0));
    zr = o;     o = align16(o + (quant ? 4 * (size_t)d : 0));
    beam = o;   o = align16(o + sizeof(Entry) * (size_t)efp);
    vnode = o;  o = align16(o + 4 * (size_t)M0);
    vdot = o;   o = align16(o + 8 * (size_t)M0);
    vnrm = o;   o = align16(o + 8 * (size_t)M0);
    adj = o;    o = align16(o + 4 * (size_t)M0);
    cand = o;   o = align16(o + sizeof(Entry) * 32);
    ctrl = o;   o = align16(o + 16);
    vis = o;    o = align16(o + (vis_shared ? 4 * (size_t)words : 0));
    stage0 = o; o = align16(o + elem * stage_rows * slice);
    stage1 = o; o = align16(o + (buffers == 2 ? elem * stage_rows * slice : 0));
    bytes = o;
  }
};

#ifdef BEAM_PROFILE
// clock cycles of warp 0's phases, summed over blocks (profiling builds)
__device__ unsigned long long g_prof[8];
#define PROF_MARK(t) long long t = clock64()
#define PROF_ADD(i, a, b) \
  if (lane == 0) acc[i] += (unsigned long long)((b) - (a))
#else
#define PROF_MARK(t)
#define PROF_ADD(i, a, b)
#endif

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the metric from float64 sums, rounded to float32 once
__device__ __forceinline__ float finish_score(int metric, double dot, double xn,
                                              double qn) {
  if (metric == 0) return (float)(2.0 * dot - qn - xn);                 // l2
  if (metric == 1) return (float)dot;                                    // ip
  return (float)(dot / ((sqrt(qn) + 1e-12) * (sqrt(xn) + 1e-12)));       // angular
}

// Copies columns [c0, c0 + nc) of rows vnode[r0 .. r0 + nr) of the graph
// starting at row `gbase` into `stage` (row stride `slice` elements), all
// threads of the block together. Does not commit.
template <bool kInt8>
__device__ void issue_rows(const Params& p, long long gbase, const int* vnode,
                           int r0, int nr, int c0, int nc, unsigned char* stage,
                           int tid, int nthreads) {
  constexpr int elem = kInt8 ? 1 : 4;
  const char* data = static_cast<const char*>(p.data);
  const size_t row_bytes = (size_t)p.d * elem;
  const int stride = p.slice * elem;
  const int unit = p.row_unit;
  const int per_row = nc * elem / unit;          // copies a row
  const int total = nr * per_row;
  // (r, c) of copy f = tid + k * nthreads, advanced without a division
  const int dr = nthreads / per_row, dc = nthreads - dr * per_row;
  int r = tid / per_row, c = tid - r * per_row;
  for (int f = tid; f < total; f += nthreads) {
    const char* src = data + (gbase + vnode[r0 + r]) * row_bytes +
                      (size_t)c0 * elem + (size_t)c * unit;
    unsigned char* dst = stage + r * stride + c * unit;
    if (unit == 16) {
      cp16(dst, src);
    } else if (unit == 4) {
      cp4(dst, src);
    } else {
      *dst = *reinterpret_cast<const unsigned char*>(src);
    }
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// One lane's partial dot product and squared norm of one staged row over
// columns [c0, c0 + nc) when d % 4 != 0 (int8: d % 16 != 0): columns
// l + 8t of each 128, four partials of four columns, added pairwise.
template <bool kInt8>
__device__ __forceinline__ void row_partial_scalar(const unsigned char* row, int c0,
                                                   int nc, const float* q,
                                                   const float* sc, const float* zr,
                                                   int l, float& dot, float& nrm) {
  for (int b = 0; b < nc; b += 16 * kGroup) {
    float pd[4] = {0.f, 0.f, 0.f, 0.f}, pn[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int e = b + l + t * kGroup;
      if (e < nc) {
        float x;
        if (kInt8) {
          x = fmaf((float)reinterpret_cast<const int8_t*>(row)[e], sc[c0 + e],
                   zr[c0 + e]);
        } else {
          x = reinterpret_cast<const float*>(row)[e];
        }
        pd[t >> 2] = fmaf(q[c0 + e], x, pd[t >> 2]);
        pn[t >> 2] = fmaf(x, x, pn[t >> 2]);
      }
    }
    dot += (pd[0] + pd[1]) + (pd[2] + pd[3]);
    nrm += (pn[0] + pn[1]) + (pn[2] + pn[3]);
  }
}

// Scores the staged rows r0 .. r0 + nr over columns [c0, c0 + nc): eight
// lanes a row, kRows rows a group at once (their loads and reductions
// interleave, and a lane reads its share of the query, and of the int8
// grid, once for all of them); adds the dot products and squared norms
// into vdot / vnrm (stores them for the first slice). A lane sums four
// products at a time and adds those partials pairwise: its float4 chunks
// l, l+8, l+16, l+24 of each 128 columns, or its chunk l of 16 codes; the
// lanes' sums meet in float64. All threads take part.
template <bool kInt8, bool kVec, int kRows>
__device__ void score_pass(const Params& p, const unsigned char* stage, int r0,
                           int nr, int c0, int nc, const float* q,
                           const float* sc, const float* zr, double* vdot,
                           double* vnrm, bool first, int tid, int nthreads) {
  constexpr int elem = kInt8 ? 1 : 4;
  const int l = tid & (kGroup - 1);
  const int gid = tid / kGroup, ngroups = nthreads / kGroup;
  const size_t stride = (size_t)p.slice * elem;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // the same trip count in every lane: the reductions shuffle across the warp
  for (int rb = 0; rb < nr; rb += kRows * ngroups) {
    const unsigned char* rows[kRows];
    float dot[kRows], nrm[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int r = rb + gid + t * ngroups;
      // rows past nr score row 0 again and are not stored
      rows[t] = stage + (r < nr ? r : 0) * stride;
      dot[t] = 0.f;
      nrm[t] = 0.f;
    }
    if (kVec && !kInt8) {
      const float4* q4 = reinterpret_cast<const float4*>(q + c0);
      const int nch = nc >> 2;
      for (int b = 0; b < nch; b += 4 * kGroup) {
        float4 qq[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = b + l + u * kGroup;
          qq[u] = c < nch ? q4[c] : zero4;
        }
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const float4* x4 = reinterpret_cast<const float4*>(rows[t]);
          float pd[4], pn[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = b + l + u * kGroup;
            const float4 x = c < nch ? x4[c] : zero4;
            pd[u] = qq[u].x * x.x + qq[u].y * x.y + qq[u].z * x.z + qq[u].w * x.w;
            pn[u] = x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
          }
          dot[t] += (pd[0] + pd[1]) + (pd[2] + pd[3]);
          nrm[t] += (pn[0] + pn[1]) + (pn[2] + pn[3]);
        }
      }
    } else if (kVec) {
      const int nch = nc >> 4;
      for (int b = 0; b < nch; b += kGroup) {
        const int c = b + l;
        const bool in = c < nch;
        float4 qq[4], s4[4], z4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = c0 + 16 * (in ? c : 0) + 4 * u;
          qq[u] = *reinterpret_cast<const float4*>(q + e);
          s4[u] = *reinterpret_cast<const float4*>(sc + e);
          z4[u] = *reinterpret_cast<const float4*>(zr + e);
        }
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int4 raw = in ? reinterpret_cast<const int4*>(rows[t])[c]
                              : make_int4(0, 0, 0, 0);
          const int w[4] = {raw.x, raw.y, raw.z, raw.w};
          float pd[4], pn[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int v = w[u];
            const float x0 = fmaf((float)static_cast<int8_t>(v), s4[u].x, z4[u].x);
            const float x1 = fmaf((float)static_cast<int8_t>(v >> 8), s4[u].y, z4[u].y);
            const float x2 = fmaf((float)static_cast<int8_t>(v >> 16), s4[u].z, z4[u].z);
            const float x3 = fmaf((float)static_cast<int8_t>(v >> 24), s4[u].w, z4[u].w);
            pd[u] = in ? qq[u].x * x0 + qq[u].y * x1 + qq[u].z * x2 + qq[u].w * x3 : 0.f;
            pn[u] = in ? x0 * x0 + x1 * x1 + x2 * x2 + x3 * x3 : 0.f;
          }
          dot[t] += (pd[0] + pd[1]) + (pd[2] + pd[3]);
          nrm[t] += (pn[0] + pn[1]) + (pn[2] + pn[3]);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < kRows; ++t)
        row_partial_scalar<kInt8>(rows[t], c0, nc, q, sc, zr, l, dot[t], nrm[t]);
    }
    double dd[kRows], dn[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      dd[t] = dot[t];
      dn[t] = nrm[t];
    }
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        dd[t] += __shfl_xor_sync(kFull, dd[t], o);
        dn[t] += __shfl_xor_sync(kFull, dn[t], o);
      }
    }
    if (l == 0) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        const int r = r0 + rb + gid + t * ngroups;
        if (rb + gid + t * ngroups < nr) {
          vdot[r] = first ? dd[t] : vdot[r] + dd[t];
          vnrm[r] = first ? dn[t] : vnrm[r] + dn[t];
        }
      }
    }
  }
}

// Gathers and scores rows vnode[0 .. nv): passes of stage_rows rows x
// `slice` columns; with two staging buffers each pass's copies are in
// flight while the previous pass is scored. Every thread of the block
// calls it; it ends on a barrier.
template <bool kInt8, bool kVec>
__device__ void gather_score(const Params& p, long long gbase, const int* vnode,
                             int nv, unsigned char* stage0, unsigned char* stage1,
                             const float* q, const float* sc, const float* zr,
                             double* vdot, double* vnrm, int tid, int nthreads) {
  const int nslices = (p.d + p.slice - 1) / p.slice;
  const int passes = nslices * ((nv + p.stage_rows - 1) / p.stage_rows);
  const bool two = p.stage_buffers == 2;
  // rows a group scores in a pass
  const int per_group = (min(p.stage_rows, nv) + nthreads / kGroup - 1) /
                        (nthreads / kGroup);
  auto issue = [&](int ps) {
    const int rb = ps / nslices, sl = ps - rb * nslices;
    const int r0 = rb * p.stage_rows, c0 = sl * p.slice;
    issue_rows<kInt8>(p, gbase, vnode, r0, min(p.stage_rows, nv - r0), c0,
                      min(p.slice, p.d - c0), (two && (ps & 1)) ? stage1 : stage0,
                      tid, nthreads);
    cp_commit();
  };
  issue(0);
  for (int ps = 0; ps < passes; ++ps) {
    if (two && ps + 1 < passes) {
      issue(ps + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int rb = ps / nslices, sl = ps - rb * nslices;
    const int r0 = rb * p.stage_rows, c0 = sl * p.slice;
    const int nr = min(p.stage_rows, nv - r0), nc = min(p.slice, p.d - c0);
    const unsigned char* st = (two && (ps & 1)) ? stage1 : stage0;
    if (per_group <= 1) {
      score_pass<kInt8, kVec, 1>(p, st, r0, nr, c0, nc, q, sc, zr, vdot, vnrm,
                                 sl == 0, tid, nthreads);
    } else if (per_group <= 2) {
      score_pass<kInt8, kVec, 2>(p, st, r0, nr, c0, nc, q, sc, zr, vdot, vnrm,
                                 sl == 0, tid, nthreads);
    } else if (per_group <= 4 || kInt8) {   // int8: the grid takes registers
      score_pass<kInt8, kVec, 4>(p, st, r0, nr, c0, nc, q, sc, zr, vdot, vnrm,
                                 sl == 0, tid, nthreads);
    } else {
      score_pass<kInt8, kVec, 8>(p, st, r0, nr, c0, nc, q, sc, zr, vdot, vnrm,
                                 sl == 0, tid, nthreads);
    }
    __syncthreads();
    if (!two && ps + 1 < passes) issue(ps + 1);
  }
}

// First position >= from, below cnt, whose entry is unexpanded; -1 if none.
// Warp-uniform result.
__device__ __forceinline__ int first_unexpanded(const Entry* beam, int cnt, int from,
                                                int lane) {
  for (int b = from; b < cnt; b += 32) {
    const int pos = b + lane;
    const unsigned bal =
        __ballot_sync(kFull, pos < cnt && !(beam[pos].id & kExpanded));
    if (bal) return b + __ffs(bal) - 1;
  }
  return -1;
}

// Copies the adjacency row at `src` (M0 ids) into `dst` in shared memory,
// the lanes of one warp together, and commits the copies.
__device__ __forceinline__ void fetch_adjacency(int* dst, const int* src, int M0,
                                                int unit, int lane) {
  if (unit == 16) {
    if (4 * lane < M0) cp16(dst + 4 * lane, src + 4 * lane);
  } else {
    if (lane < M0) cp4(dst + lane, src + lane);
    if (lane + 32 < M0) cp4(dst + lane + 32, src + lane + 32);
  }
  cp_commit();
}

// Bitonic sort of one (score, slot) a lane over lanes [0, width), best
// first: higher score, then lower slot. `width` is a power of two; lanes
// past it keep their values.
__device__ __forceinline__ void bitonic_sort(float& s, int& idx, int lane, int width) {
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float os = __shfl_xor_sync(kFull, s, j);
      const int oi = __shfl_xor_sync(kFull, idx, j);
      const bool other_better = os > s || (os == s && oi < idx);
      const bool keep_better = ((lane & j) == 0) == ((lane & k) == 0);
      if (lane < width && other_better == keep_better) {
        s = os;
        idx = oi;
      }
    }
  }
}

// At most 128 registers a thread (four blocks of four warps an SM), which
// `walk_plan` counts on when it chooses the warps of a walk.
template <bool kInt8, bool kVec>
__global__ void __launch_bounds__(128, 4) beam_walk_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int row = blockIdx.x;
  const int efp = p.efp;
  float* out_s = p.out_s + (size_t)row * efp;
  int* out_i = p.out_i + (size_t)row * efp;
  const int entry = p.entries[row];
  if (entry < 0) {   // an empty slot: nothing to walk
    for (int i = tid; i < efp; i += nthreads) {
      out_s[i] = -INFINITY;
      out_i[i] = -1;
    }
    return;
  }
  const int g = row / p.C;
  const bool vis_shared = p.vis_global == nullptr;
  const Layout L(p.d, efp, p.M0, p.words, vis_shared, kInt8, p.stage_rows, p.slice,
                 p.stage_buffers);
  float* q = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* zr = reinterpret_cast<float*>(smem + L.zr);
  Entry* beam = reinterpret_cast<Entry*>(smem + L.beam);
  int* vnode = reinterpret_cast<int*>(smem + L.vnode);
  double* vdot = reinterpret_cast<double*>(smem + L.vdot);
  double* vnrm = reinterpret_cast<double*>(smem + L.vnrm);
  int* adjbuf = reinterpret_cast<int*>(smem + L.adj);
  Entry* cand = reinterpret_cast<Entry*>(smem + L.cand);
  volatile int* ctrl = reinterpret_cast<volatile int*>(smem + L.ctrl);
  unsigned* vis = vis_shared ? reinterpret_cast<unsigned*>(smem + L.vis)
                             : p.vis_global + (size_t)row * p.words;
  unsigned char* stage0 = smem + L.stage0;
  unsigned char* stage1 = smem + L.stage1;
#ifdef BEAM_PROFILE
  unsigned long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#endif

  for (int e = tid; e < p.d; e += nthreads) {
    q[e] = p.queries[(size_t)row * p.d + e];
    if (kInt8) {
      sc[e] = p.scale[e];
      zr[e] = p.zero[e];
    }
  }
  for (int i = tid; i < efp; i += nthreads) beam[i] = Entry{-INFINITY, -1};
  if (vis_shared) {
    for (int i = tid; i < p.words; i += nthreads) vis[i] = 0u;
  }
  __syncthreads();
  double qn = 0.0;
  if (warp == 0) {
    double part = 0.0;
    for (int e = lane; e < p.d; e += 32) part += (double)q[e] * q[e];
    qn = warp_sum(part);
    if (lane == 0) {
      atomicOr(&vis[entry >> 5], 1u << (entry & 31));
      vnode[0] = entry;
    }
  }
  __syncthreads();
  const long long gbase = (long long)g * p.n;
  gather_score<kInt8, kVec>(p, gbase, vnode, 1, stage0, stage1, q, sc, zr, vdot,
                            vnrm, tid, nthreads);
  if (tid == 0) beam[0] = Entry{finish_score(p.metric, vdot[0], vnrm[0], qn), entry};
  __syncwarp();

  // warp 0's walk state (uniform across its lanes): live entries, the
  // position below which all are expanded, the node whose adjacency row
  // was prefetched, and the position of the best unexpanded entry after
  // the one being expanded
  int cnt = 1, ptr = 0, pf_node = -1, gpos = -1;
  const int* adj_base = p.bottom + (size_t)g * p.n * p.M0;
  const unsigned lt = (1u << lane) - 1u;
  for (int it = 0;; ++it) {
    PROF_MARK(t0);
    if (warp == 0) {
      int nv = -1;
      const int sel = it < p.max_iters ? first_unexpanded(beam, cnt, ptr, lane) : -1;
      if (sel >= 0) {
        const int node = beam[sel].id;
        const bool pre = node == pf_node;
#ifdef BEAM_PROFILE
        if (lane == 0 && pre) acc[6] += 1;
#endif
        const int* adj = adj_base + (size_t)node * p.M0;
        if (pre) {   // fetched during the previous expansion's merge
          cp_wait<0>();
          __syncwarp();
        }
        int nb0 = -1, nb1 = -1;
        if (lane < p.M0) nb0 = pre ? adjbuf[lane] : __ldg(adj + lane);
        if (lane + 32 < p.M0) nb1 = pre ? adjbuf[lane + 32] : __ldg(adj + lane + 32);
        // the visited test of every slot precedes this step's marks
        const bool v0 = nb0 >= 0 && !((vis[nb0 >> 5] >> (nb0 & 31)) & 1u);
        const bool v1 = nb1 >= 0 && !((vis[nb1 >> 5] >> (nb1 & 31)) & 1u);
        __syncwarp();
        if (lane == 0) beam[sel].id = node | kExpanded;
        if (nb0 >= 0) atomicOr(&vis[nb0 >> 5], 1u << (nb0 & 31));
        if (nb1 >= 0) atomicOr(&vis[nb1 >> 5], 1u << (nb1 & 31));
        const unsigned b0 = __ballot_sync(kFull, v0), b1 = __ballot_sync(kFull, v1);
        const int n0 = __popc(b0);
        if (v0) vnode[__popc(b0 & lt)] = nb0;
        if (v1) vnode[n0 + __popc(b1 & lt)] = nb1;
        nv = n0 + __popc(b1);
        ptr = sel + 1;
        pf_node = -1;
        gpos = -1;
        __syncwarp();
        if (nv > 0) {
          // prefetch the adjacency of the next best unexpanded entry: it is
          // expanded next unless a new candidate overtakes it
          gpos = first_unexpanded(beam, cnt, sel + 1, lane);
          if (gpos >= 0) {
            pf_node = beam[gpos].id;
            fetch_adjacency(adjbuf, adj_base + (size_t)pf_node * p.M0, p.M0,
                            p.adj_unit, lane);
          }
        }
      }
      if (lane == 0) ctrl[it & 1] = nv;
    }
    PROF_MARK(t1);
    __syncthreads();
    const int nv = ctrl[it & 1];
    if (nv < 0) break;
    if (nv == 0) continue;
    PROF_MARK(t2);
    gather_score<kInt8, kVec>(p, gbase, vnode, nv, stage0, stage1, q, sc, zr, vdot,
                              vnrm, tid, nthreads);
    PROF_MARK(t3);
    PROF_ADD(0, t0, t1);
    PROF_ADD(1, t1, t2);
    PROF_ADD(2, t2, t3);
    if (warp != 0) continue;
#ifdef BEAM_PROFILE
    if (lane == 0) acc[7] += 1;
#endif

    // rank the new candidates into the beam, 32 at a time in slot order
    // (a later batch loses ties to an earlier one, as in a stable sort)
    for (int base = 0; base < nv; base += 32) {
      PROF_MARK(r0);
      const int j = base + lane;
      const float s = j < nv ? finish_score(p.metric, vdot[j], vnrm[j], qn) : -INFINITY;
      const bool full = cnt == efp;
      const float thr = full ? beam[efp - 1].s : -INFINITY;
      const bool surv = j < nv && (!full || s > thr);
      const unsigned bal = __ballot_sync(kFull, surv);
      if (bal == 0) continue;
      // the survivors, in slot order, to lanes 0 .. k-1; sorted there
      const int k = __popc(bal);
      if (surv) cand[__popc(bal & lt)] = Entry{s, j};
      __syncwarp();
      const Entry c = lane < k ? cand[lane] : Entry{-INFINITY, 0x40000000 + lane};
      float cs = c.s;
      int ci = c.id;
      int width = 1;
      while (width < k) width <<= 1;
      bitonic_sort(cs, ci, lane, width);
      PROF_MARK(r1);
      // survivor `lane` lands at lane + #(beam entries >= its score)
      int pos = efp;
      if (lane < k) {
        int lo = 0, hi = cnt;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (beam[mid].s >= cs) lo = mid + 1; else hi = mid;
        }
        pos = lane + lo;
      }
      const int p0 = __shfl_sync(kFull, pos, 0);
      const int ncnt = min(efp, cnt + k);
      if (nv <= 32 && (gpos < 0 || p0 <= gpos)) {
        // the best survivor lands before the prefetched entry, so it is
        // expanded next: fetch its adjacency row while the beam is merged
        pf_node = vnode[__shfl_sync(kFull, ci, 0)];
        fetch_adjacency(adjbuf, adj_base + (size_t)pf_node * p.M0, p.M0, p.adj_unit,
                        lane);
      }
      PROF_MARK(r2);
      // merge in place over [p0, ncnt), 32 outputs at a time from the back:
      // an output holds a survivor where one lands, else the beam entry as
      // many places back as survivors land before it
      for (int ob = p0 + ((ncnt - 1 - p0) >> 5) * 32; ob >= p0; ob -= 32) {
        const int o = ob + lane;
        const bool here = lane < k && pos >= ob && pos < ob + 32;
        const unsigned m = __reduce_or_sync(kFull, here ? 1u << (pos - ob) : 0u);
        const int before = __popc(__ballot_sync(kFull, lane < k && pos < ob));
        const int t = before + __popc(m & lt);
        const float ts = __shfl_sync(kFull, cs, t & 31);
        const int ti = __shfl_sync(kFull, ci, t & 31);
        Entry v{0.f, 0};
        if (o < ncnt) v = ((m >> lane) & 1u) ? Entry{ts, vnode[ti]} : beam[o - t];
        __syncwarp();
        if (o < ncnt) beam[o] = v;
        __syncwarp();
      }
      cnt = ncnt;
      ptr = min(ptr, p0);
      PROF_MARK(r3);
      PROF_ADD(3, r0, r1);
      PROF_ADD(4, r1, r2);
      PROF_ADD(5, r2, r3);
    }
  }

  if (tid == 0) ctrl[2] = cnt;
  cp_wait<0>();
  __syncthreads();
  const int live = ctrl[2];
  for (int i = tid; i < efp; i += nthreads) {
    const Entry v = beam[i];
    out_s[i] = v.s;
    out_i[i] = i < live ? (v.id & ~kExpanded) : -1;
  }
#ifdef BEAM_PROFILE
  if (tid == 0) {
    for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], acc[i]);
  }
#endif
}

template <bool kInt8, bool kVec>
int launch(const Params& p, int warps, size_t smem, cudaStream_t stream) {
  auto kern = beam_walk_kernel<kInt8, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.S * p.C, warps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block (one walk).
long long beam_search_smem_bytes(int d, int efp, int M0, int words, int vis_shared,
                                 int quantized, int stage_rows, int slice,
                                 int stage_buffers) {
  return (long long)Layout(d, efp, M0, words, vis_shared != 0, quantized != 0,
                           stage_rows, slice, stage_buffers).bytes;
}

// Returns a cudaError_t code (0 on success), or -1 for arguments the
// kernel does not take. Launches on `stream` and does not synchronise.
int beam_search_launch(const void* data, int quantized, const float* scale,
                       const float* zero, const int* bottom,
                       const float* queries, const int* entries,
                       float* out_s, int* out_i, unsigned* vis_global,
                       int S, int n, int d, int M0, int C, int efp,
                       int max_iters, int metric, int warps, int stage_rows,
                       int slice, int stage_buffers, int row_unit, int adj_unit,
                       void* stream) {
  const int elem = quantized ? 1 : 4;
  if (M0 < 1 || M0 > kMaxM0 || warps < 1 || warps > 4 || stage_rows < 1 ||
      slice < 1 || slice > d || (slice * elem) % row_unit != 0 ||
      (d * elem) % row_unit != 0 || (adj_unit == 16 && M0 % 4 != 0) ||
      stage_buffers < 1 || stage_buffers > 2)
    return -1;
  Params p{data, scale, zero, bottom, queries, entries, out_s, out_i,
           vis_global, S, n, d, M0, C, efp, max_iters, metric,
           (n + 31) / 32, stage_rows, slice, stage_buffers, row_unit, adj_unit};
  const size_t smem = (size_t)beam_search_smem_bytes(
      d, efp, M0, p.words, vis_global == nullptr, quantized, stage_rows, slice,
      stage_buffers);
  // 16-byte chunks of every staged row: float4 or 16 codes
  const bool vec = (d * elem) % 16 == 0 && (slice * elem) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return vec ? launch<true, true>(p, warps, smem, st)
               : launch<true, false>(p, warps, smem, st);
  }
  return vec ? launch<false, true>(p, warps, smem, st)
             : launch<false, false>(p, warps, smem, st);
}

#ifdef BEAM_PROFILE
// Reads (and zeroes) the phase cycle sums of profiling builds: select and
// visited test, the barrier after it, gather and score, candidate cut and
// sort, insertion search, in-place merge, adjacency prefetch hits,
// expansions.
int beam_search_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(unsigned long long) * 8);
  if (err != cudaSuccess) return (int)err;
  unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
}
#endif

}  // extern "C"
