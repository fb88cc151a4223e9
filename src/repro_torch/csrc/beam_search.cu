// Fused bottom-layer HNSW beam walk for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `beam_search_pallas` / `_beam_kernel`
// in src/repro/kernels/beam_search/kernel.py. Semantics are those of
// `beam_search_np` (src/repro/kernels/beam_search/ref.py): per (graph,
// slot) row, expand the best unexpanded beam entry (ties to the lowest
// beam position), skip -1 padding and visited neighbours, score them
// (l2 / ip / angular; int8 rows dequantized as c*scale+zero), and keep
// the top `ef` of beam U neighbours with the old beam first on ties. A row
// stops when nothing is unexpanded or after `max_iters` expansions.
//
// What bounds it on the H100: every expansion gathers M0 adjacency ids
// and up to M0 rows of d values from device memory at addresses that
// depend on the previous step, so the walk is bound by the latency and
// bytes of scattered row gathers (M0 * d * 4 bytes an expansion for
// float32, a quarter of that for int8), not by arithmetic.
//
// Design. The Pallas version keeps the whole shard tile in VMEM and
// gathers rows by one-hot matmul; nothing of that carries over. Here one
// warp owns one (graph, slot) row:
//   * neighbour rows are gathered straight from device memory, the warp
//     spread over d with 16-byte loads (float4, or char4 for int8 codes),
//     up to kUnroll rows in flight at once so that their latencies overlap;
//   * the beam (scores, ids, expanded flags, double-buffered), the query
//     and the sorted new candidates live in shared memory;
//   * the visited set is a packed bitmask, in shared memory when it fits
//     and otherwise in a zeroed global scratch tensor from the wrapper;
//   * the M0 new candidates are ranked stably by (score desc, slot asc)
//     and merged into the sorted beam by a merge-path binary search, the
//     beam winning ties, which reproduces a stable sort of beam U new.
// Duplicate neighbour slots: the visited test reads the mask for all M0
// slots before any of this step's bits are set, so a node that appears
// twice in one adjacency row is a candidate twice, as in the reference.
// Float comparisons treat -0.0 == +0.0, as numpy and the Pallas kernel do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 8;

struct Params {
  const void* data;        // [S, n, d] float32 or int8
  const float* scale;      // [d] (int8 only)
  const float* zero;       // [d] (int8 only)
  const int* bottom;       // [S, n, M0], -1 padded
  const float* queries;    // [S, C, d]
  const int* entries;      // [S, C]
  float* out_s;            // [S, C, efp]
  int* out_i;              // [S, C, efp]
  unsigned* vis_global;    // [S*C, words] zeroed, or nullptr (shared)
  int S, n, d, M0, C, efp, max_iters, metric, words;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of one warp's shared-memory regions.
struct Layout {
  size_t q, bs0, bs1, bi0, bi1, be0, be1, ci, cs, ss, si, vis, warp_bytes;
  __host__ __device__ Layout(int d, int efp, int M0, int words, bool vis_shared) {
    size_t o = 0;
    q = o;   o = align16(o + sizeof(float) * d);
    bs0 = o; o = align16(o + sizeof(float) * efp);
    bs1 = o; o = align16(o + sizeof(float) * efp);
    bi0 = o; o = align16(o + sizeof(int) * efp);
    bi1 = o; o = align16(o + sizeof(int) * efp);
    be0 = o; o = align16(o + efp);
    be1 = o; o = align16(o + efp);
    ci = o;  o = align16(o + sizeof(int) * M0);
    cs = o;  o = align16(o + sizeof(float) * M0);
    ss = o;  o = align16(o + sizeof(float) * M0);
    si = o;  o = align16(o + sizeof(int) * M0);
    vis = o; o = align16(o + (vis_shared ? sizeof(unsigned) * words : 0));
    warp_bytes = o;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float finish_score(int metric, float dot, float xn, float qn) {
  if (metric == 0) return 2.0f * dot - qn - xn;                     // l2
  if (metric == 1) return dot;                                       // ip
  return dot / ((sqrtf(qn) + 1e-12f) * (sqrtf(xn) + 1e-12f));        // angular
}

// Scores rows `ids[0..cnt)` (graph-local) of graph `g` against the warp's
// query; writes out[0..cnt). All lanes take part; out is written by lane 0.
template <bool kInt8, bool kVec>
__device__ void score_rows(const Params& p, int g, const int* ids, int cnt,
                           const float* q, const float* sc, const float* zr,
                           float qn, float* out, int lane) {
  const long long gbase = (long long)g * p.n;
  for (int base = 0; base < cnt; base += kUnroll) {
    const int m = min(kUnroll, cnt - base);
    float dot[kUnroll], xn[kUnroll];
    long long row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dot[u] = 0.f;
      xn[u] = 0.f;
      row[u] = (gbase + (u < m ? ids[base + u] : 0)) * p.d;
    }
    if (kVec) {
      const int nv = p.d >> 2;
      const float4* q4 = reinterpret_cast<const float4*>(q);
      for (int c = lane; c < nv; c += 32) {
        const float4 qq = q4[c];
        float4 s4 = make_float4(1.f, 1.f, 1.f, 1.f), z4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kInt8) {
          s4 = reinterpret_cast<const float4*>(sc)[c];
          z4 = reinterpret_cast<const float4*>(zr)[c];
        }
        float4 x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u < m) {
            if (kInt8) {
              const char4 cv = reinterpret_cast<const char4*>(
                  static_cast<const int8_t*>(p.data) + row[u])[c];
              x[u] = make_float4(fmaf((float)cv.x, s4.x, z4.x), fmaf((float)cv.y, s4.y, z4.y),
                                 fmaf((float)cv.z, s4.z, z4.z), fmaf((float)cv.w, s4.w, z4.w));
            } else {
              x[u] = reinterpret_cast<const float4*>(
                  static_cast<const float*>(p.data) + row[u])[c];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u < m) {
            dot[u] += qq.x * x[u].x + qq.y * x[u].y + qq.z * x[u].z + qq.w * x[u].w;
            xn[u] += x[u].x * x[u].x + x[u].y * x[u].y + x[u].z * x[u].z + x[u].w * x[u].w;
          }
        }
      }
    } else {
      for (int e = lane; e < p.d; e += 32) {
        const float qe = q[e];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u < m) {
            float xv;
            if (kInt8) {
              xv = fmaf((float)static_cast<const int8_t*>(p.data)[row[u] + e], sc[e], zr[e]);
            } else {
              xv = static_cast<const float*>(p.data)[row[u] + e];
            }
            dot[u] += qe * xv;
            xn[u] += xv * xv;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < m) {
        const float dt = warp_sum(dot[u]);
        const float nx = warp_sum(xn[u]);
        if (lane == 0) out[base + u] = finish_score(p.metric, dt, nx, qn);
      }
    }
  }
  __syncwarp();
}

template <bool kInt8, bool kVec>
__global__ void beam_search_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool vis_shared = p.vis_global == nullptr;
  const Layout L(p.d, p.efp, p.M0, p.words, vis_shared);

  // block-shared dequantization grid
  float* sc = reinterpret_cast<float*>(smem);
  float* zr = sc + p.d;
  const size_t head = kInt8 ? align16(sizeof(float) * 2 * p.d) : 0;
  if (kInt8) {
    for (int e = threadIdx.x; e < p.d; e += blockDim.x) {
      sc[e] = p.scale[e];
      zr[e] = p.zero[e];
    }
  }
  __syncthreads();

  const int row = blockIdx.x * warps + warp;
  if (row >= p.S * p.C) return;
  const int g = row / p.C;

  unsigned char* w = smem + head + (size_t)warp * L.warp_bytes;
  float* q = reinterpret_cast<float*>(w + L.q);
  float* bs = reinterpret_cast<float*>(w + L.bs0);
  float* bs_n = reinterpret_cast<float*>(w + L.bs1);
  int* bi = reinterpret_cast<int*>(w + L.bi0);
  int* bi_n = reinterpret_cast<int*>(w + L.bi1);
  unsigned char* be = w + L.be0;
  unsigned char* be_n = w + L.be1;
  int* ci = reinterpret_cast<int*>(w + L.ci);
  float* cs = reinterpret_cast<float*>(w + L.cs);
  float* ss = reinterpret_cast<float*>(w + L.ss);
  int* si = reinterpret_cast<int*>(w + L.si);
  unsigned* vis = vis_shared ? reinterpret_cast<unsigned*>(w + L.vis)
                             : p.vis_global + (size_t)row * p.words;

  // query into shared memory, |q|^2 by warp reduction
  float qpart = 0.f;
  for (int e = lane; e < p.d; e += 32) {
    const float v = p.queries[(size_t)row * p.d + e];
    q[e] = v;
    qpart += v * v;
  }
  const float qn = warp_sum(qpart);
  if (vis_shared) {
    for (int i = lane; i < p.words; i += 32) vis[i] = 0u;
  }
  const float ninf = -INFINITY;
  for (int i = lane; i < p.efp; i += 32) {
    bs[i] = ninf;
    bi[i] = -1;
    be[i] = 0;
  }
  const int entry = p.entries[row];
  __syncwarp();
  if (lane == 0) {
    atomicOr(&vis[entry >> 5], 1u << (entry & 31));
    ci[0] = entry;
  }
  __syncwarp();
  score_rows<kInt8, kVec>(p, g, ci, 1, q, sc, zr, qn, cs, lane);
  if (lane == 0) {
    bs[0] = cs[0];
    bi[0] = entry;
  }
  __syncwarp();

  const int* adj_base = p.bottom + (size_t)g * p.n * p.M0;
  for (int it = 0; it < p.max_iters; ++it) {
    // best unexpanded entry: the beam is sorted best-first, so it is the
    // first live position (ties already ordered by position)
    int sel = -1;
    for (int base = 0; base < p.efp; base += 32) {
      const int pos = base + lane;
      const bool live = pos < p.efp && !be[pos] && bi[pos] >= 0;
      const unsigned b = __ballot_sync(kFull, live);
      if (b) {
        sel = base + __ffs(b) - 1;
        break;
      }
    }
    if (sel < 0) break;
    const int node = bi[sel];
    __syncwarp();
    if (lane == 0) be[sel] = 1;

    // gather the adjacency row; test visited for every slot BEFORE marking
    const int* adj = adj_base + (size_t)node * p.M0;
    int nvalid = 0;
    for (int mb = 0; mb < p.M0; mb += 32) {
      const int m = mb + lane;
      const int nb = m < p.M0 ? adj[m] : -1;
      const bool valid = nb >= 0 && !((vis[nb >> 5] >> (nb & 31)) & 1u);
      const unsigned b = __ballot_sync(kFull, valid);
      if (valid) ci[nvalid + __popc(b & ((1u << lane) - 1u))] = nb;
      nvalid += __popc(b);
    }
    __syncwarp();
    for (int m = lane; m < p.M0; m += 32) {
      const int nb = adj[m];
      if (nb >= 0) atomicOr(&vis[nb >> 5], 1u << (nb & 31));
    }
    __syncwarp();
    if (nvalid == 0) continue;

    score_rows<kInt8, kVec>(p, g, ci, nvalid, q, sc, zr, qn, cs, lane);

    // stable rank of the new candidates by (score desc, slot asc)
    for (int j = lane; j < nvalid; j += 32) {
      const float s = cs[j];
      int rank = 0;
      for (int t = 0; t < nvalid; ++t) {
        const float st = cs[t];
        rank += (st > s) || (st == s && t < j);
      }
      ss[rank] = s;
      si[rank] = ci[j];
    }
    __syncwarp();

    // merge path: beam entry i lands at i + #(new > s_i); new entry j at
    // j + #(beam >= s_j) -- the beam wins ties
    for (int i = lane; i < p.efp; i += 32) {
      const float s = bs[i];
      int lo = 0, hi = nvalid;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ss[mid] > s) lo = mid + 1; else hi = mid;
      }
      const int pos = i + lo;
      if (pos < p.efp) {
        bs_n[pos] = s;
        bi_n[pos] = bi[i];
        be_n[pos] = be[i];
      }
    }
    for (int j = lane; j < nvalid; j += 32) {
      const float s = ss[j];
      int lo = 0, hi = p.efp;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (bs[mid] >= s) lo = mid + 1; else hi = mid;
      }
      const int pos = j + lo;
      if (pos < p.efp) {
        bs_n[pos] = s;
        bi_n[pos] = si[j];
        be_n[pos] = 0;
      }
    }
    __syncwarp();
    float* tf = bs; bs = bs_n; bs_n = tf;
    int* ti = bi; bi = bi_n; bi_n = ti;
    unsigned char* te = be; be = be_n; be_n = te;
  }

  for (int i = lane; i < p.efp; i += 32) {
    p.out_s[(size_t)row * p.efp + i] = bs[i];
    p.out_i[(size_t)row * p.efp + i] = bi[i];
  }
}

template <bool kInt8, bool kVec>
int launch(const Params& p, int warps, size_t smem, cudaStream_t stream) {
  auto kern = beam_search_kernel<kInt8, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = p.S * p.C;
  const int blocks = (rows + warps - 1) / warps;
  kern<<<blocks, warps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of `warps` warps needs (0 if it cannot fit).
long long beam_search_smem_bytes(int d, int efp, int M0, int words,
                                 int vis_shared, int quantized, int warps) {
  const Layout L(d, efp, M0, words, vis_shared != 0);
  const size_t head = quantized ? align16(sizeof(float) * 2 * d) : 0;
  return (long long)(head + (size_t)warps * L.warp_bytes);
}

// Returns a cudaError_t code (0 on success). Launches on `stream` and
// does not synchronise.
int beam_search_launch(const void* data, int quantized, const float* scale,
                       const float* zero, const int* bottom,
                       const float* queries, const int* entries,
                       float* out_s, int* out_i, unsigned* vis_global,
                       int S, int n, int d, int M0, int C, int efp,
                       int max_iters, int metric, int warps, void* stream) {
  Params p{data, scale, zero, bottom, queries, entries, out_s, out_i,
           vis_global, S, n, d, M0, C, efp, max_iters, metric,
           (n + 31) / 32};
  const size_t smem = (size_t)beam_search_smem_bytes(
      d, efp, M0, p.words, vis_global == nullptr, quantized, warps);
  const bool vec = (d % 4) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return vec ? launch<true, true>(p, warps, smem, st)
               : launch<true, false>(p, warps, smem, st);
  }
  return vec ? launch<false, true>(p, warps, smem, st)
             : launch<false, false>(p, warps, smem, st);
}

}  // extern "C"
