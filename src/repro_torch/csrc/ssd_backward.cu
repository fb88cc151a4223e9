// Backward of the Mamba2 SSD chunk scan for Hopper (sm_90a): the
// gradients of y and of the final state with respect to x, dt, a, B, C
// and the initial state.
//
// Replaces no Pallas TPU kernel: the JAX package trains through autodiff
// of the plain `ssd_chunked` (src/repro/models/ssm.py:73) and its SSD
// kernel (src/repro/kernels/ssd/kernel.py:85) has no backward. The port's
// forward runs in `csrc/ssd.cu`, whose outputs carry no gradient, so the
// train step needs this kernel to reach dt, a, B, C and x through the
// scan. It computes what autodiff of `ssd_chunked` computes: with, per
// (b, h, chunk), cum_i the inclusive prefix sum of dt * a over the chunk,
// L_ij = exp(cum_i - cum_j) (j <= i), w_j = dt_j exp(cum_end - cum_j),
// S_c the state entering the chunk and Sb the gradient of the state
// leaving it (the next chunk's, or d_final),
//   Sb_c    = exp(cum_end) Sb + sum_i exp(cum_i) C_i (x) dy_i
//   dx_j    = w_j B_j Sb + dt_j sum_{i>=j} (C_i.B_j) L_ij dy_i
//   s_ij    = dy_i . x_j,  G_ij = sum_h s_ij L_ij dt_j  (B, C are shared)
//   dB_j    = sum_h w_j Sb x_j + sum_{i>=j} G_ij C_i
//   dC_i    = sum_h exp(cum_i) S_c dy_i + sum_{j<=i} G_ij B_j
//   dcum_i  = sum_j M_ij - sum_j M_ji + exp(cum_i) dy_i . (C_i S_c)
//             - w_i (B_i . Sb x_i),  M_ij = s_ij (C_i.B_j) L_ij dt_j,
//   dcum_end += sum_j w_j (B_j . Sb x_j) + exp(cum_end) <Sb, S_c>
//   ddt_t   = sum_i s_it (C_i.B_t) L_it + exp(cum_end - cum_t) (B_t.Sb x_t)
//             + a sum_{i>=t} dcum_i,   da = sum_{b,t} dt_t sum_{i>=t} dcum_i
// and d_initial_state is the last Sb of the reverse recurrence. Rows past
// S act as dt = 0 and their gradients are dropped.
//
// Numbers: every exponential is of a difference <= 0 (cum falls within a
// chunk), as in the forward; the prefix sums, their differences and every
// sum over the chunk's rows of the decay gradient are taken in float64,
// since |cum| reaches ~10^3 in a chunk and float32 differences of such
// sums lose 2^-24 of |cum| each. Products and their sums are float32.
// Sums across thread blocks (over heads for dB, dC and G; over batch and
// chunks for da) are per-block partials summed by a later kernel in a
// fixed order: no atomics, so a call repeats bit for bit.
//
// What bounds it on the H100: about 20 GFLOP of products at mamba2-780m's
// layer shape (B = 4, S = 640, H = 48, P = 64, N = 128, Q = 256) against
// 80 to 110 MB of inputs and outputs: the float32 FMA rate, about 0.3 ms.
// Design, simple first: eight kernels, one call (the wrapper counts one
// launch), each a loop over 64 x 64 output tiles of float32 FMA products
// staged through shared memory in steps of 32 (`mm` below), the chunk's
// decays and weights recomputed from the prefix sums:
//   1. ssdb_kernel_cum    per (b, chunk, 8 heads): cum in float64;
//   2. ssdb_kernel_cb     per (b, chunk, tile i >= tile j): C B^T;
//   3. ssdb_kernel_outer  per (b, chunk, h): each chunk's state term
//      sum_j B_j (x) w_j x_j and its gradient term sum_i exp(cum_i) C_i (x)
//      dy_i, [N, P] each;
//   4. ssdb_kernel_pass   per (b, h, element of [N, P]): the forward
//      recurrence (chunk-entry states S_c), then the reverse one (Sb of
//      every chunk, d_initial_state);
//   5. ssdb_kernel_head   per (b, chunk, h): dx, the decay gradient,
//      ddt and the head's part of da;
//   6. ssdb_kernel_g      per (b, chunk, tile i >= tile j): G, a sum over
//      heads;
//   7. ssdb_kernel_bc     per (b, chunk, tile of rows, tile of N, B or C):
//      dB and dC, sums over heads and rows;
//   8. ssdb_kernel_da     da, the per-(b, chunk, h) parts summed in order.
// Tensor cores, fused stages and the chunk-entry states kept from the
// forward are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 256;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kT = 64;            // output tile rows and columns
constexpr int kK = 32;            // depth of one staged step
constexpr int kLd = kT + 4;       // staged operand row ([k][r]), float4 reads
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* x;      // [B, S, H, P], contiguous
  const float* dt;    // [B, S, H]
  const float* a;     // [H]
  const void* bm;     // B: [B, S, N], unit stride over N
  const void* cm;     // C: [B, S, N], unit stride over N
  const float* init;  // [B, H, N, P] or null (zero)
  const float* dy;    // [B, S, H, P]
  const float* dfin;  // [B, H, N, P] or null (zero)
  void* dx;           // [B, S, H, P], x's dtype
  float* ddt;         // [B, S, H]
  float* da;          // [H]
  void* db;           // [B, S, N], x's dtype, contiguous
  void* dc;           // [B, S, N]
  float* dinit;       // [B, H, N, P]
  double* cum;        // scratch [B, nc, H, Q]
  double* dapart;     // scratch [B, nc, H]
  float* cb;          // scratch [B, nc, Q, Q]: C_i . B_j
  float* g;           // scratch [B, nc, Q, Q]: G_ij
  float* st;          // scratch [B, nc, H, N, P]: state terms, then S_c
  float* sb;          // scratch [B, nc, H, N, P]: gradient terms, then Sb
  int B, S, H, P, N, Q, nc;
  long long b_sb, b_ss, c_sb, c_ss;   // batch and row strides of B and C
};

__device__ __forceinline__ float val(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float val(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void put(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int chunk_rows(const Params& p, int c) {
  return min(p.Q, p.S - c * p.Q);
}
__device__ __forceinline__ size_t bch(const Params& p, int b, int c, int h) {
  return ((size_t)b * p.nc + c) * p.H + h;
}
__device__ __forceinline__ size_t xi(const Params& p, int b, int t, int h) {
  return (((size_t)b * p.S + t) * p.H + h) * p.P;     // + p
}
__device__ __forceinline__ size_t dti(const Params& p, int b, int t, int h) {
  return ((size_t)b * p.S + t) * p.H + h;
}
template <typename T>
__device__ __forceinline__ float bval(const Params& p, int b, int t, int n) {
  return val(static_cast<const T*>(p.bm), b * p.b_sb + t * p.b_ss + n);
}
template <typename T>
__device__ __forceinline__ float cval(const Params& p, int b, int t, int n) {
  return val(static_cast<const T*>(p.cm), b * p.c_sb + t * p.c_ss + n);
}

// acc[u][v] += sum_{k0 <= k < k1} fa(4 ty + u, k) fb(4 tx + v, k), ty =
// thread / 16, tx = thread % 16, over one 64 x 64 tile. fa(r, k) and
// fb(r, k) give the operands (0 outside them). kAR / kBR choose the
// staging order: true where consecutive threads should take consecutive r
// (the operand is contiguous over r), false where they take consecutive k.
template <bool kAR, bool kBR, class FA, class FB>
__device__ __forceinline__ void mm(float (&acc)[4][4], int k0, int k1, FA fa,
                                   FB fb, float* sa, float* sb) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int kb = k0; kb < k1; kb += kK) {
    for (int e = tid; e < kT * kK; e += kThreads) {
      const int r = kAR ? e % kT : e / kK, k = kAR ? e / kT : e % kK;
      sa[k * kLd + r] = kb + k < k1 ? fa(r, kb + k) : 0.f;
    }
    for (int e = tid; e < kT * kK; e += kThreads) {
      const int r = kBR ? e % kT : e / kK, k = kBR ? e / kT : e % kK;
      sb[k * kLd + r] = kb + k < k1 ? fb(r, kb + k) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(sa + k * kLd + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(sb + k * kLd + 4 * tx);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(ar[u], br[v], acc[u][v]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
}

// the sum over the 16 threads of a tile row (lanes that differ in their
// low four bits), the same in every one of them
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// (it, jt) with jt <= it of the lower-triangle tile pair number x
__device__ __forceinline__ void tri(int x, int& it, int& jt) {
  it = 0;
  while ((it + 1) * (it + 2) / 2 <= x) ++it;
  jt = x - it * (it + 1) / 2;
}

// ---- 1. prefix sums of dt * a in float64, a warp a (b, chunk, head) ----
__global__ void __launch_bounds__(kThreads) ssdb_kernel_cum(const Params p) {
  constexpr int kPer = kMaxQ / 32;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y * (kThreads / 32) + (threadIdx.x >> 5);
  if (h >= p.H) return;
  const int lane = threadIdx.x & 31, rows = chunk_rows(p, c);
  const double a = p.a[h];
  double pre[kPer], run = 0.0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = lane * kPer + e;
    run += i < rows ? (double)p.dt[dti(p, b, c * p.Q + i, h)] * a : 0.0;
    pre[e] = run;
  }
  double inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += o;
  }
  const double base = inc - run;
  double* out = p.cum + bch(p, b, c, h) * p.Q;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = lane * kPer + e;
    if (i < p.Q) out[i] = base + pre[e];
  }
}

// ---- 2. C B^T over the causal tiles, per (b, chunk, tile pair) ---------
template <typename T>
__global__ void __launch_bounds__(kThreads) ssdb_kernel_cb(const Params p) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  int it, jt;
  tri(blockIdx.x, it, jt);
  const int c = blockIdx.y, b = blockIdx.z, rows = chunk_rows(p, c);
  const int i0 = it * kT, j0 = jt * kT, t0 = c * p.Q;
  if (i0 >= rows) return;
  float acc[4][4];
  zero(acc);
  mm<false, false>(
      acc, 0, p.N,
      [&](int r, int k) {
        return i0 + r < rows ? cval<T>(p, b, t0 + i0 + r, k) : 0.f;
      },
      [&](int r, int k) {
        return j0 + r < rows ? bval<T>(p, b, t0 + j0 + r, k) : 0.f;
      },
      sa, sb);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* out = p.cb + ((size_t)b * p.nc + c) * p.Q * p.Q;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + 4 * ty + u, j = j0 + 4 * tx + v;
      if (i < p.Q && j < p.Q) out[(size_t)i * p.Q + j] = acc[u][v];
    }
}

// ---- 3. per-chunk state and state-gradient terms, per (b, chunk, h) ----
template <typename T>
__global__ void __launch_bounds__(kThreads) ssdb_kernel_outer(const Params p) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  __shared__ float w[kMaxQ], e[kMaxQ];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int rows = chunk_rows(p, c), t0 = c * p.Q;
  const double* cum = p.cum + bch(p, b, c, h) * p.Q;
  const double cend = cum[p.Q - 1];
  for (int i = threadIdx.x; i < p.Q; i += kThreads) {
    const float dt = i < rows ? p.dt[dti(p, b, t0 + i, h)] : 0.f;
    w[i] = dt * expf((float)(cend - cum[i]));
    e[i] = expf((float)cum[i]);
  }
  __syncthreads();
  const T* x = static_cast<const T*>(p.x);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t o = bch(p, b, c, h) * p.N * p.P;
  for (int which = 0; which < 2; ++which) {
    float* out = (which == 0 ? p.st : p.sb) + o;
    for (int n0 = 0; n0 < p.N; n0 += kT) {
      float acc[4][4];
      zero(acc);
      if (which == 0)
        mm<true, true>(
            acc, 0, rows,
            [&](int r, int k) {
              return n0 + r < p.N ? bval<T>(p, b, t0 + k, n0 + r) : 0.f;
            },
            [&](int r, int k) {
              return r < p.P ? w[k] * val(x, xi(p, b, t0 + k, h) + r) : 0.f;
            },
            sa, sb);
      else
        mm<true, true>(
            acc, 0, rows,
            [&](int r, int k) {
              return n0 + r < p.N ? cval<T>(p, b, t0 + k, n0 + r) : 0.f;
            },
            [&](int r, int k) {
              return r < p.P ? e[k] * p.dy[xi(p, b, t0 + k, h) + r] : 0.f;
            },
            sa, sb);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int n = n0 + 4 * ty + u, q = 4 * tx + v;
          if (n < p.N && q < p.P) out[(size_t)n * p.P + q] = acc[u][v];
        }
    }
  }
}

// ---- 4. the two recurrences over chunks, per (b, h, element) -----------
__global__ void __launch_bounds__(kThreads) ssdb_kernel_pass(const Params p) {
  const int pn = p.P * p.N;
  const int el = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (el >= pn) return;
  const size_t fin = ((size_t)b * p.H + h) * pn + el;
  // forward: st[c] holds chunk c's state term, then the state entering c
  float s = p.init != nullptr ? p.init[fin] : 0.f;
  for (int c = 0; c < p.nc; ++c) {
    const size_t o = bch(p, b, c, h);
    const float g = expf((float)p.cum[o * p.Q + p.Q - 1]);
    const float term = p.st[o * pn + el];
    p.st[o * pn + el] = s;
    s = s * g + term;
  }
  // reverse: sb[c] holds chunk c's gradient term, then the gradient of the
  // state leaving c
  float sbar = p.dfin != nullptr ? p.dfin[fin] : 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    const size_t o = bch(p, b, c, h);
    const float g = expf((float)p.cum[o * p.Q + p.Q - 1]);
    const float term = p.sb[o * pn + el];
    p.sb[o * pn + el] = sbar;
    sbar = sbar * g + term;
  }
  p.dinit[fin] = sbar;
}

// ---- 5. dx, the decay gradient, ddt and da's part, per (b, chunk, h) ---
template <typename T>
__global__ void __launch_bounds__(kThreads) ssdb_kernel_head(const Params p) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  __shared__ double cum[kMaxQ], dcum[kMaxQ], ddt[kMaxQ], endv[kMaxQ];
  __shared__ float dt[kMaxQ], w[kMaxQ], e[kMaxQ], dend[kMaxQ];
  __shared__ float red1[16][kT], red2[16][kT];
  __shared__ double wred[kThreads / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int rows = chunk_rows(p, c), t0 = c * p.Q, Q = p.Q;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t o = bch(p, b, c, h);
  for (int i = tid; i < Q; i += kThreads) cum[i] = p.cum[o * Q + i];
  __syncthreads();
  const double cend = cum[Q - 1];
  for (int i = tid; i < Q; i += kThreads) {
    dt[i] = i < rows ? p.dt[dti(p, b, t0 + i, h)] : 0.f;
    dend[i] = expf((float)(cend - cum[i]));
    w[i] = dt[i] * dend[i];
    e[i] = expf((float)cum[i]);
    dcum[i] = ddt[i] = endv[i] = 0.0;
  }
  __syncthreads();
  const T* x = static_cast<const T*>(p.x);
  const float* sbar = p.sb + o * p.N * p.P;   // gradient of the leaving state
  const float* s_in = p.st + o * p.N * p.P;    // state entering the chunk
  const float* cbm = p.cb + ((size_t)b * p.nc + c) * Q * Q;
  auto L = [&](int i, int j) { return expf((float)(cum[i] - cum[j])); };

  // A. dx, and u_j = B_j . (Sb x_j), per tile of j
  for (int j0 = 0; j0 < rows; j0 += kT) {
    float bs[4][4], in[4][4];
    zero(bs);
    mm<false, true>(
        bs, 0, p.N,
        [&](int r, int k) {
          return j0 + r < rows ? bval<T>(p, b, t0 + j0 + r, k) : 0.f;
        },
        [&](int r, int k) { return r < p.P ? sbar[(size_t)k * p.P + r] : 0.f; },
        sa, sb);
    zero(in);
    mm<true, true>(
        in, j0, rows,
        [&](int r, int i) {
          const int j = j0 + r;
          return j <= i && j < rows ? cbm[(size_t)i * Q + j] * L(i, j) : 0.f;
        },
        [&](int r, int i) {
          return r < p.P ? p.dy[xi(p, b, t0 + i, h) + r] : 0.f;
        },
        sa, sb);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 4 * ty + u;
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int q = 4 * tx + v;
        if (j < rows && q < p.P) {
          const size_t at = xi(p, b, t0 + j, h) + q;
          part = fmaf(bs[u][v], val(x, at), part);
          put(static_cast<T*>(p.dx), at, w[j] * bs[u][v] + dt[j] * in[u][v]);
        }
      }
      const float uj = row_sum(part);
      if (tx == 0 && j < rows) {
        dcum[j] -= (double)w[j] * uj;
        endv[j] = (double)w[j] * uj;
        ddt[j] += (double)dend[j] * uj;
      }
    }
  }
  __syncthreads();

  // B. s_ij = dy_i . x_j over the causal tiles: the row and column sums of
  // M into dcum, the column sums of s (C.B) L into ddt
  for (int i0 = 0; i0 < rows; i0 += kT) {
    for (int j0 = 0; j0 <= i0; j0 += kT) {
      float s[4][4];
      zero(s);
      mm<false, false>(
          s, 0, p.P,
          [&](int r, int k) {
            return i0 + r < rows ? p.dy[xi(p, b, t0 + i0 + r, h) + k] : 0.f;
          },
          [&](int r, int k) {
            return j0 + r < rows ? val(x, xi(p, b, t0 + j0 + r, h) + k) : 0.f;
          },
          sa, sb);
      float colm[4] = {0.f, 0.f, 0.f, 0.f}, colt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 4 * ty + u;
        float rowm = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = j0 + 4 * tx + v;
          if (j <= i && i < rows) {
            const float t = s[u][v] * cbm[(size_t)i * Q + j] * L(i, j);
            const float m = t * dt[j];
            rowm += m;
            colm[v] += m;
            colt[v] += t;
          }
        }
        rowm = row_sum(rowm);
        if (tx == 0 && i < rows) dcum[i] += rowm;
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        red1[ty][4 * tx + v] = colm[v];
        red2[ty][4 * tx + v] = colt[v];
      }
      __syncthreads();
      if (tid < kT && j0 + tid < rows) {
        float sm = 0.f, st = 0.f;
        for (int r = 0; r < 16; ++r) {
          sm += red1[r][tid];
          st += red2[r][tid];
        }
        dcum[j0 + tid] -= sm;
        ddt[j0 + tid] += st;
      }
      __syncthreads();
    }
  }

  // C. the inter-chunk output term: exp(cum_i) dy_i . (C_i S_c)
  for (int i0 = 0; i0 < rows; i0 += kT) {
    float cs[4][4];
    zero(cs);
    mm<false, true>(
        cs, 0, p.N,
        [&](int r, int k) {
          return i0 + r < rows ? cval<T>(p, b, t0 + i0 + r, k) : 0.f;
        },
        [&](int r, int k) { return r < p.P ? s_in[(size_t)k * p.P + r] : 0.f; },
        sa, sb);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 4 * ty + u;
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int q = 4 * tx + v;
        if (i < rows && q < p.P)
          part = fmaf(cs[u][v], p.dy[xi(p, b, t0 + i, h) + q], part);
      }
      part = row_sum(part);
      if (tx == 0 && i < rows) dcum[i] += (double)e[i] * part;
    }
  }

  // D. the chunk's decay: exp(cum_end) <Sb, S_c> and sum_j w_j u_j
  double dot = 0.0;
  for (int el = tid; el < p.N * p.P; el += kThreads)
    dot += (double)sbar[el] * s_in[el];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(kFull, dot, off);
  if (lane == 0) wred[warp] = dot;
  __syncthreads();
  if (tid == 0) {
    double end = 0.0;
    for (int r = 0; r < kThreads / 32; ++r) end += wred[r];
    end *= (double)expf((float)cend);
    for (int j = 0; j < rows; ++j) end += endv[j];
    dcum[Q - 1] += end;
  }
  __syncthreads();

  // E. the reverse prefix sum of dcum (a warp, eight rows a lane), ddt and
  // da's part
  if (warp == 0) {
    constexpr int kPer = kMaxQ / 32;
    double loc[kPer], run = 0.0;
#pragma unroll
    for (int k = kPer - 1; k >= 0; --k) {
      const int i = lane * kPer + k;
      run += i < Q ? dcum[i] : 0.0;
      loc[k] = run;
    }
    double inc = run;       // suffix sum over lanes >= this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o2 = __shfl_down_sync(kFull, inc, off);
      if (lane + off < 32) inc += o2;
    }
    const double after = inc - run;
    const double a = p.a[h];
    double part = 0.0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = lane * kPer + k;
      if (i < rows) {
        const double dda = loc[k] + after;
        p.ddt[dti(p, b, t0 + i, h)] = (float)(ddt[i] + a * dda);
        part += dda * dt[i];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (lane == 0) p.dapart[o] = part;
  }
}

// ---- 6. G_ij = sum_h s_ij L_ij dt_j, per (b, chunk, tile pair) ---------
template <typename T>
__global__ void __launch_bounds__(kThreads) ssdb_kernel_g(const Params p) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  __shared__ double ci[kT], cj[kT];
  __shared__ float dj[kT];
  int it, jt;
  tri(blockIdx.x, it, jt);
  const int c = blockIdx.y, b = blockIdx.z, rows = chunk_rows(p, c);
  const int i0 = it * kT, j0 = jt * kT, t0 = c * p.Q;
  if (i0 >= rows) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* x = static_cast<const T*>(p.x);
  float tot[4][4];
  zero(tot);
  for (int h = 0; h < p.H; ++h) {
    const double* cum = p.cum + bch(p, b, c, h) * p.Q;
    if (tid < kT) {
      ci[tid] = i0 + tid < p.Q ? cum[i0 + tid] : 0.0;
      cj[tid] = j0 + tid < p.Q ? cum[j0 + tid] : 0.0;
      dj[tid] = j0 + tid < rows ? p.dt[dti(p, b, t0 + j0 + tid, h)] : 0.f;
    }
    float s[4][4];
    zero(s);
    mm<false, false>(       // its first barrier orders the loads above
        s, 0, p.P,
        [&](int r, int k) {
          return i0 + r < rows ? p.dy[xi(p, b, t0 + i0 + r, h) + k] : 0.f;
        },
        [&](int r, int k) {
          return j0 + r < rows ? val(x, xi(p, b, t0 + j0 + r, h) + k) : 0.f;
        },
        sa, sb);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = i0 + 4 * ty + u, j = j0 + 4 * tx + v;
        if (j <= i && i < rows)
          tot[u][v] = fmaf(s[u][v],
                           expf((float)(ci[4 * ty + u] - cj[4 * tx + v])) *
                               dj[4 * tx + v],
                           tot[u][v]);
      }
    __syncthreads();
  }
  float* out = p.g + ((size_t)b * p.nc + c) * p.Q * p.Q;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + 4 * ty + u, j = j0 + 4 * tx + v;
      if (i < p.Q && j < p.Q) out[(size_t)i * p.Q + j] = tot[u][v];
    }
}

// ---- 7. dB (which 0) and dC (which 1), per (b, chunk, row tile, N tile) -
template <typename T>
__global__ void __launch_bounds__(kThreads) ssdb_kernel_bc(const Params p) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  __shared__ float scale[kT];
  const int nt_count = (p.N + kT - 1) / kT;
  const int r0 = (blockIdx.x / nt_count) * kT;
  const int n0 = (blockIdx.x % nt_count) * kT;
  const int c = blockIdx.y, b = blockIdx.z >> 1, which = blockIdx.z & 1;
  const int rows = chunk_rows(p, c), t0 = c * p.Q, Q = p.Q;
  if (r0 >= rows) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* x = static_cast<const T*>(p.x);
  float acc[4][4];
  zero(acc);
  // sum over heads of (w_j x_j) Sb^T (dB) or (exp(cum_i) dy_i) S_c^T (dC)
  for (int h = 0; h < p.H; ++h) {
    const size_t o = bch(p, b, c, h);
    const double* cum = p.cum + o * Q;
    if (tid < kT) {
      const int r = r0 + tid;
      float sc = 0.f;
      if (r < rows)
        sc = which == 0 ? p.dt[dti(p, b, t0 + r, h)] *
                              expf((float)(cum[Q - 1] - cum[r]))
                        : expf((float)cum[r]);
      scale[tid] = sc;
    }
    __syncthreads();
    const float* m = (which == 0 ? p.sb : p.st) + o * p.N * p.P;
    if (which == 0)
      mm<false, false>(
          acc, 0, p.P,
          [&](int r, int k) {
            return r0 + r < rows
                       ? scale[r] * val(x, xi(p, b, t0 + r0 + r, h) + k)
                       : 0.f;
          },
          [&](int r, int k) {
            return n0 + r < p.N ? m[(size_t)(n0 + r) * p.P + k] : 0.f;
          },
          sa, sb);
    else
      mm<false, false>(
          acc, 0, p.P,
          [&](int r, int k) {
            return r0 + r < rows
                       ? scale[r] * p.dy[xi(p, b, t0 + r0 + r, h) + k]
                       : 0.f;
          },
          [&](int r, int k) {
            return n0 + r < p.N ? m[(size_t)(n0 + r) * p.P + k] : 0.f;
          },
          sa, sb);
  }
  // the intra-chunk term: G^T C (dB) or G B (dC)
  const float* g = p.g + ((size_t)b * p.nc + c) * Q * Q;
  if (which == 0)
    mm<true, true>(
        acc, r0, rows,
        [&](int r, int i) {
          const int j = r0 + r;
          return j <= i && j < rows ? g[(size_t)i * Q + j] : 0.f;
        },
        [&](int r, int i) {
          return n0 + r < p.N ? cval<T>(p, b, t0 + i, n0 + r) : 0.f;
        },
        sa, sb);
  else
    mm<false, true>(
        acc, 0, min(r0 + kT, rows),
        [&](int r, int j) {
          const int i = r0 + r;
          return j <= i && i < rows ? g[(size_t)i * Q + j] : 0.f;
        },
        [&](int r, int j) {
          return n0 + r < p.N ? bval<T>(p, b, t0 + j, n0 + r) : 0.f;
        },
        sa, sb);
  T* out = static_cast<T*>(which == 0 ? p.db : p.dc);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = r0 + 4 * ty + u, n = n0 + 4 * tx + v;
      if (r < rows && n < p.N)
        put(out, ((size_t)b * p.S + t0 + r) * p.N + n, acc[u][v]);
    }
}

// ---- 8. da: the per-(b, chunk, h) parts, summed in order ---------------
__global__ void __launch_bounds__(kThreads) ssdb_kernel_da(const Params p) {
  for (int h = threadIdx.x; h < p.H; h += kThreads) {
    double s = 0.0;
    for (int b = 0; b < p.B; ++b)
      for (int c = 0; c < p.nc; ++c) s += p.dapart[bch(p, b, c, h)];
    p.da[h] = (float)s;
  }
}

template <typename T>
int launch_all(const Params& p, cudaStream_t st) {
  const int qt = (p.Q + kT - 1) / kT, nt = (p.N + kT - 1) / kT;
  const int tri_tiles = qt * (qt + 1) / 2;
  cudaError_t err;
#define SSDB_CHECK()                                    \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  ssdb_kernel_cum<<<dim3(p.nc, (p.H + 7) / 8, p.B), kThreads, 0, st>>>(p);
  SSDB_CHECK();
  ssdb_kernel_cb<T><<<dim3(tri_tiles, p.nc, p.B), kThreads, 0, st>>>(p);
  SSDB_CHECK();
  ssdb_kernel_outer<T><<<dim3(p.nc, p.H, p.B), kThreads, 0, st>>>(p);
  SSDB_CHECK();
  ssdb_kernel_pass<<<dim3((p.N * p.P + kThreads - 1) / kThreads, p.H, p.B),
                     kThreads, 0, st>>>(p);
  SSDB_CHECK();
  ssdb_kernel_head<T><<<dim3(p.nc, p.H, p.B), kThreads, 0, st>>>(p);
  SSDB_CHECK();
  ssdb_kernel_g<T><<<dim3(tri_tiles, p.nc, p.B), kThreads, 0, st>>>(p);
  SSDB_CHECK();
  ssdb_kernel_bc<T><<<dim3(qt * nt, p.nc, 2 * p.B), kThreads, 0, st>>>(p);
  SSDB_CHECK();
  ssdb_kernel_da<<<1, kThreads, 0, st>>>(p);
  SSDB_CHECK();
#undef SSDB_CHECK
  return 0;
}

// byte offsets of the scratch: cum, dapart (float64), cb, g, st, sb
// (float32), each rounded up to 256 bytes
size_t scratch_layout(int B, int S, int H, int P, int N, int Q,
                      size_t (&off)[6]) {
  const size_t nc = (S + Q - 1) / Q;
  const size_t sizes[6] = {B * nc * H * Q * 8, B * nc * H * 8,
                           B * nc * Q * Q * 4, B * nc * Q * Q * 4,
                           B * nc * H * (size_t)N * P * 4,
                           B * nc * H * (size_t)N * P * 4};
  size_t total = 0;
  for (int i = 0; i < 6; ++i) {
    off[i] = total;
    total += (sizes[i] + 255) & ~(size_t)255;
  }
  return total;
}

}  // namespace

extern "C" {

// Bytes of scratch that ssd_backward_launch needs for these shapes.
long long ssd_backward_scratch_bytes(int B, int S, int H, int P, int N,
                                     int Q) {
  size_t off[6];
  return (long long)scratch_layout(B, S, H, P, N, Q, off);
}

// Returns a cudaError_t code (0 on success), or -1 for shapes the kernels
// are not built for (P > 64, N > 128, Q > 256). Launches on `stream` and
// does not synchronise. `init` and `dfin` may be null (zero). `scratch`:
// ssd_backward_scratch_bytes(...) bytes from the caller, 256-byte aligned.
int ssd_backward_launch(const void* x, const float* dt, const float* a,
                        const void* bm, const void* cm, const float* init,
                        const float* dy, const float* dfin, void* dx,
                        float* ddt, float* da, void* db, void* dc,
                        float* dinit, void* scratch, int B, int S, int H,
                        int P, int N, int Q, long long b_sb, long long b_ss,
                        long long c_sb, long long c_ss, int bf16,
                        void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ)
    return -1;
  size_t off[6];
  scratch_layout(B, S, H, P, N, Q, off);
  char* s8 = static_cast<char*>(scratch);
  const Params p{x, dt, a, bm, cm, init, dy, dfin, dx, ddt, da, db, dc,
                 dinit,
                 reinterpret_cast<double*>(s8 + off[0]),
                 reinterpret_cast<double*>(s8 + off[1]),
                 reinterpret_cast<float*>(s8 + off[2]),
                 reinterpret_cast<float*>(s8 + off[3]),
                 reinterpret_cast<float*>(s8 + off[4]),
                 reinterpret_cast<float*>(s8 + off[5]),
                 B, S, H, P, N, Q, (S + Q - 1) / Q, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_all<__nv_bfloat16>(p, s) : launch_all<float>(p, s);
}

}  // extern "C"
