// Flash-decode for Hopper (sm_90a): single-token GQA attention over a
// KV cache, with an online softmax.
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
// serving step by its launch.
//
// Design. The TPU kernel streams [block_s, hd] tiles of a transposed
// [B*KV, S, hd] cache through VMEM on a sequential grid. Here the cache
// is read in place in the model's layout [B, S, KV, hd] (a layer's slice
// of the stacked cache, no transpose or copy):
//   * one block of 4 warps per (b, kv head, split of the valid rows);
//     the wrapper picks the split count from the card's SM count, and a
//     second small kernel combines the splits' partial states;
//   * a cache row is 16-byte loads from L = hd * sizeof(T) / 16
//     neighbouring lanes, so one warp reads 32 / L rows at once and keeps
//     U such row tiles in flight before it uses them;
//   * each lane holds its E = 16 / sizeof(T) elements of the G query
//     rows in registers, the dot product is finished by xor-shuffles
//     inside the lane group, and each lane group keeps its own running
//     (max, sum, acc[G][E]);
//   * the lane groups of a warp merge by shuffles, the warps through
//     shared memory.
// bf16 rows are widened exactly (bits << 16); all arithmetic is float32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* q;     // [B, H, hd] float32
  const void* k;      // [B, S, KV, hd] float32 or bfloat16, contiguous
  const void* v;      // [B, S, KV, hd]
  const int* pos;     // [B]: rows 0..pos[b] are valid
  float* out;         // [B, H, hd]
  float* part_m;      // [B * KV, splits, G]      (splits > 1)
  float* part_l;      // [B * KV, splits, G]      (splits > 1)
  float* part_acc;    // [B * KV, splits, G, hd]  (splits > 1)
  int B, S, H, KV, splits;
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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Params p) {
  constexpr int E = Row16<T>::kElems;   // elements of a row per lane
  constexpr int L = HD / E;             // lanes per cache row
  constexpr int R = 32 / L;             // rows a warp reads at once
  constexpr int U = G <= 4 ? 4 : 2;     // row tiles in flight per warp
  static_assert(HD % E == 0 && L >= 1 && L <= 32 && 32 % L == 0,
                "unsupported head_dim");

  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][HD];

  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / p.KV, kv = bk - b * p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % L, grp = lane / L;

  // this block's share of the valid rows 0..pos[b]
  const int n_valid = min(max(p.pos[b] + 1, 0), p.S);
  const int chunk = (n_valid + p.splits - 1) / p.splits;
  const int start = min(split * chunk, n_valid);
  const int end = min(start + chunk, n_valid);

  float q[G][E];
  const float* qb = p.q + ((size_t)b * p.H + (size_t)kv * G) * HD + sub * E;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) q[g][e] = qb[g * HD + e];

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t row = (size_t)p.KV * HD;   // elements from row s to s + 1
  const size_t base = ((size_t)b * p.S * p.KV + kv) * HD + sub * E;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;

  // the loop bound depends on the warp only, so every lane of a warp
  // takes part in the shuffles
  for (int t = warp * R; start + t < end; t += kWarps * R * U) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = start + t + u * kWarps * R + grp;
      ok[u] = s < end;
      if (ok[u]) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)s * row));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)s * row));
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
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pr, vf[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

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
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) s_acc[warp][g][sub * E + e] = acc[g][e];
      if (sub == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; write the output, or this split's partial state
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i - g * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = rescale(s_m[w][g], mx);
        num += c * s_acc[w][g][d];
        den += c * s_l[w][g];
      }
    }
    if (p.splits == 1) {
      p.out[((size_t)b * p.H + (size_t)kv * G + g) * HD + d] =
          num / fmaxf(den, 1e-30f);
    } else {
      const size_t o = ((size_t)bk * p.splits + split) * G + g;
      p.part_acc[o * HD + d] = num;
      if (d == 0) {
        p.part_m[o] = mx;
        p.part_l[o] = den;
      }
    }
  }
}

// One block per (b, h), one thread per output element: combine the
// splits' partial (max, sum, acc) states.
__global__ void flash_decode_combine(const Params p, int G, int HD) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kv = h / G, g = h - kv * G;
  const size_t first = ((size_t)(b * p.KV + kv) * p.splits) * G + g;
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s)
    mx = fmaxf(mx, p.part_m[first + (size_t)s * G]);
  float num = 0.f, den = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < p.splits; ++s) {
      const size_t o = first + (size_t)s * G;
      const float c = rescale(p.part_m[o], mx);
      num += c * p.part_acc[o * HD + d];
      den += c * p.part_l[o];
    }
  }
  p.out[(size_t)bh * HD + d] = num / fmaxf(den, 1e-30f);
}

template <typename T, int HD, int G>
int launch(const Params& p, cudaStream_t st) {
  const dim3 grid(p.B * p.KV, p.splits);
  flash_decode_kernel<T, HD, G><<<grid, kThreads, 0, st>>>(p);
  if (p.splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_decode_combine<<<p.B * p.H, HD, 0, st>>>(p, G, HD);
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int by_groups(const Params& p, int G, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, HD, 1>(p, st);
    case 2: return launch<T, HD, 2>(p, st);
    case 3: return launch<T, HD, 3>(p, st);
    case 4: return launch<T, HD, 4>(p, st);
    case 5: return launch<T, HD, 5>(p, st);
    case 6: return launch<T, HD, 6>(p, st);
    case 7: return launch<T, HD, 7>(p, st);
    case 8: return launch<T, HD, 8>(p, st);
  }
  return -1;
}

template <typename T>
int by_head_dim(const Params& p, int hd, int G, cudaStream_t st) {
  switch (hd) {
    case 16: return by_groups<T, 16>(p, G, st);
    case 32: return by_groups<T, 32>(p, G, st);
    case 64: return by_groups<T, 64>(p, G, st);
    case 128: return by_groups<T, 128>(p, G, st);
  }
  return -1;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success), or -1 for a head_dim or
// group count the kernel is not built for. Launches on `stream` and does
// not synchronise. `part_*` are scratch of [B * KV, splits, G (, hd)]
// floats when splits > 1, else unused.
int flash_decode_launch(const float* q, const void* k, const void* v,
                        const int* pos, float* out, float* part_m,
                        float* part_l, float* part_acc, int B, int S, int H,
                        int KV, int hd, int bf16, int splits, void* stream) {
  if (KV <= 0 || H % KV != 0 || splits < 1) return -1;
  const Params p{q, k, v, pos, out, part_m, part_l, part_acc,
                 B, S, H, KV, splits, 1.0f / sqrtf((float)hd)};
  const int G = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? by_head_dim<uint16_t>(p, hd, G, st)
              : by_head_dim<float>(p, hd, G, st);
}

}  // extern "C"
