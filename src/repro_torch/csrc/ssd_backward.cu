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
// What bounds it on the H100: at mamba2-780m's layer shape (B = 4,
// S = 640, H = 48, P = 64, N = 128, Q = 256, bf16) it must read x, dt,
// B, C and dy and write dx, ddt, dB and dC: 73 MB, 0.022 ms at 3.35 TB/s.
// Its least products, C B^T and the two with G over the causal triangle
// once per (b, chunk) and per head dy x^T, dx's triangle and six
// [rows, N] x [N, P] state products, are 16 GFLOP, 0.016 ms on the bf16
// tensor cores: the bytes bound it.
//
// Design: eleven kernels (ten on the bf16 path), one call (the wrapper
// counts one launch). The grid comes from the caller (`backward_plan` in
// kernels/ssd/ops.py): heads a group of the s stage (hpg) and heads a
// part of the dB/dC stage (hpp); the head stage takes ceil(Q / 128)
// blocks a (b, chunk, head) (hsplit).
//   1. ssdb_kernel_cum    per (b, chunk, 8 heads), a warp a head: cum in
//      float64 (rows past the chunk keep its last); dt, w = dt exp(cum_end
//      - cum), exp(cum) and exp(cum_end - cum) as float32 rows.
//   2. ssdb_kernel_amax, ssdb_kernel_scale: sigma, the power of two that
//      brings max |dy|, |d_final| into [1/2, 1) (a grid-stride max, then
//      one block; on the float32 path only, 1 on the bf16 path, whose
//      pieces have float32's range). Every gradient is linear in (dy,
//      d_final), so the stages below take sigma dy and sigma d_final and
//      the outputs are scaled back by 1 / sigma: exact, and it keeps the
//      float32 path's fp16 pieces out of fp16's subnormals, where a train
//      step's gradients (1e-5 and less) lie.
//   3. ssdb_kernel_outer  per (b, chunk, h, state or gradient): each
//      chunk's state term B^T (w x) and gradient term C^T (exp(cum) dy),
//      [N, P] each; a warp 16 rows of N.
//   4. ssdb_kernel_pass   per (b, h, 4 elements of [N, P]): the forward
//      recurrence (chunk-entry states S_c), then the reverse one (Sb of
//      every chunk, d_initial_state), each warp leaving its part of
//      <Sb, S_c> a chunk in float64.
//   5. ssdb_kernel_sg     per (b, chunk, causal 64 x 64 tile pair, group
//      of hpg heads): C B^T of the tile once (group 0 writes it for stage
//      6), then per head s = dy x^T once and, from it and L (made from
//      cum: below the diagonal tile as exp(cum_i - ref) exp(ref - cum_j),
//      ref the j tile's last row, both factors <= 1), the tile's M and
//      s (C.B) L into shared memory, their row and column sums (float64,
//      a fixed order) into scratch, and the group's part of G in
//      registers, summed over its heads in order.
//   6. ssdb_kernel_head   per (b, chunk, h, 1 / hsplit of the rows), four
//      warps, each a pair of 16-row tiles (t and the mirror of t, so the
//      triangle's work is even): dx = dt (exp(cum_end - cum) B Sb +
//      (C B^T o L)^T dy) in one accumulator (dt left out of the score
//      fragments, which are made in registers from stage 5's C B^T with
//      the next step's loads in flight), u_j = B_j . (Sb x_j) from the same
//      product, then exp(cum_i) dy_i . (C_i S_c): the rows' parts of the
//      decay gradient.
//   7. ssdb_kernel_decay  per (b, chunk, 8 heads), a warp a head: stage
//      5's, 6's and 4's parts summed in a fixed order in float64, the
//      reverse prefix sum of dcum, ddt and da's part.
//   8. ssdb_kernel_bc     per (b, chunk, 64 rows, dB or dC, part): a part
//      of hpp heads sums (w x) Sb^T or (exp(cum) dy) S_c^T over its heads
//      (the heads are the product's depth); the last part is G^T C or
//      G B, G summed over the groups in order as it is staged.
//   9. ssdb_kernel_bcsum  dB and dC: the parts summed in order.
//  10. ssdb_kernel_da     da: the per-(b, chunk, h) parts summed in order.
// At the layer above that is 1,152 blocks for stages 3 and 6 and 736 and
// 720 for stages 5 and 8 (groups and parts of six heads): three waves or
// more of two blocks a SM. Tiles are staged with 16-byte loads where rows
// allow it, into row-major shared memory whose rows are padded to be
// conflict-free for ldmatrix; `ldmatrix(.trans)` turns them into
// fragments of `mma.sync` m16n8k16, float32 sums.
//
// Numbers: the forward's precision scheme (csrc/ssd.cu). bf16 inputs
// (x, B, C) go in as their own bits; a float32 operand of the bf16 path
// (sigma dy, w x, exp(cum) dy, the states, the score tiles, G) as hi + lo
// bf16 pieces, a product of two such in three passes (lo x lo dropped).
// On the float32 path every operand is split into fp16 pieces and
// multiplied in three passes, the lo x lo term dropped. G, whose size
// follows dt and the cotangent, goes in times a power of two that brings
// its largest |value| in the block into [2^13, 2^14), and dt is left out
// of dx's score fragments, so that fp16's range does not cost them bits
// (G at 2^-8 of its size cost dB and dC 30 times their error, 6.6e-6 of
// their largest, enough to part phase 11c's float32 train step from the
// CPU's by 4.4e-4). Every exponential is of a difference <= 0 (cum falls
// within a chunk); the prefix sums, their differences and every sum over
// the chunk's rows of the decay gradient are float64, since |cum| reaches
// ~10^3 in a chunk and float32 differences of such sums lose 2^-24 of
// |cum| each; that takes in the tile pairs' row and column sums of M,
// which the reverse prefix sum of dcum cancels against each other
// (float32 tile sums left da 2.6e-4 of its largest off float64, float64
// ones 8e-7, in the split-piece mirror of
// tests/test_torch_kernel_stages.py). Sums across thread blocks (over
// heads for dB, dC and G; over tiles for the decay gradient; over batch
// and chunks for da) are per-block partials summed by a later kernel in
// a fixed order: no atomics, so a call repeats bit for bit.
//
// The chunk-entry states S_c are recomputed (stages 3 and 4) and not taken
// from the forward's scratch: the forward keeps cum in float32, so its
// states carry float32 decays, and keeping them would hold 19 MB a layer
// between the forward and the backward under remat.
//
// What still holds it back: staging. Tiles go from device memory through
// registers (split into pieces) to shared memory between barriers, and at
// the shape above that staging is most of stages 3, 5 and 8's time (0.07
// of stage 3's 0.11 ms); a one-deep cp.async pipeline of the raw rows did
// not shorten them, so it is not the loads' latency but the per-item
// rounds of staging and barriers with few blocks a SM (registers hold
// stages 3, 5 and 8 at two). The states also cross device memory several
// times: written by stage 3, read and written by stage 4, read twice by
// stage 6 and once per 64-row tile by stage 8.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeadThreads = 128;   // the head stage: four warps
constexpr int kMaxQ = 256;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kT = 64;              // tile rows and columns
constexpr int kLdP = kMaxP + 8;     // plane rows of 64 columns (ldmatrix)
constexpr int kLdN = kMaxN + 8;     // plane rows of N
constexpr int kLdM = kT + 1;       // rows of the M and T tiles (floats)
constexpr int kAmaxBlocks = 1024;
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
  // scratch; (b, c, h) rows are [B, nc, H, Qt], rows past the chunk hold
  // its last row's cum and dt = 0
  double* cum;        // [B, nc, H, Qt]
  float* rv;          // [4][B, nc, H, Qt]: dt, w, exp(cum), exp(cend - cum)
  float* amax;        // [kAmaxBlocks]: max |dy|, |d_final| of a block
  float* sigma;       // [2]: sigma, 1 / sigma
  float* xcb;         // [B, nc, Qt, Qt]: X[j][i] = B_j . C_i, tiles j <= i
  float* gpart;       // [B, nc, ng, Qt, Qt]: sigma G over a group of heads
  float* st;          // [B, nc, H, N, P]: state terms, then S_c
  float* sb;          // [B, nc, H, N, P]: gradient terms, then sigma Sb
  double* rowm;       // [B, nc, H, nt, Qt]: row sums of M, by column tile
  double* colm;       // [B, nc, H, nt, Qt]: column sums of M, by row tile
  double* colt;       // [B, nc, H, nt, Qt]: column sums of s (C.B) L
  double* hrow;       // [3][B, nc, H, Qt]: e v - w u, exp(cend - cum) u, w u
  double* dotw;       // [B, H, nc, dw]: <Sb, S_c> over a warp's elements
  double* dapart;     // [B, nc, H]
  float* bcpart;      // [parts + 1][2][B, nc, Qt, N]
  int B, S, H, P, N, Q, nc, Qt, nt;
  long long b_sb, b_ss, c_sb, c_ss;   // batch and row strides of B and C
  int vec_x, vec_b, vec_c, vec_dy;    // rows take 16-byte loads
  int hpg, ng, hpp, parts, hsplit;    // the plan
  int amax_blocks, dw;                // blocks of stage 1, warps of stage 4
};

// ---- pieces, loads and tensor-core products (as in csrc/ssd.cu) --------

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(uint16_t h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}
__device__ __forceinline__ uint16_t f16_bits(float v) {
  return __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ float f16_value(uint16_t h) {
  return __half2float(__ushort_as_half(h));
}
// v = hi + lo + O(2^-18 v) with bf16 pieces, O(2^-22 v) with fp16 pieces
template <bool kF16>
__device__ __forceinline__ void split(float v, uint16_t& hi, uint16_t& lo) {
  if constexpr (kF16) {
    hi = f16_bits(v);
    lo = f16_bits(v - f16_value(hi));
  } else {
    hi = bf16_bits(v);
    lo = bf16_bits(v - bf16_value(hi));
  }
}
// the same for two values, packed (v0 in the low half)
template <bool kF16>
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  if constexpr (kF16) {
    const __half2 h = __floats2half2_rn(v0, v1);
    const float2 f = __half22float2(h);
    const __half2 l = __floats2half2_rn(v0 - f.x, v1 - f.y);
    hi = reinterpret_cast<const uint32_t&>(h);
    lo = reinterpret_cast<const uint32_t&>(l);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - f.x, v1 - f.y);
    hi = reinterpret_cast<const uint32_t&>(h);
    lo = reinterpret_cast<const uint32_t&>(l);
  }
}
__device__ __forceinline__ uint32_t pack(uint16_t k0, uint16_t k1) {
  return static_cast<uint32_t>(k0) | (static_cast<uint32_t>(k1) << 16);
}

struct Bits8 {
  uint16_t hi[8], lo[8];
};
struct Floats8 {
  float v[8];
};
// eight elements of a row from c0, zero at and past ncols; with `vec` the
// row is 16-byte aligned and ncols % 8 == 0
__device__ __forceinline__ void load8(const float* row, int c0, int ncols,
                                      bool vec, Floats8& f) {
  if (vec && c0 < ncols) {
    const float4 a = *reinterpret_cast<const float4*>(row + c0);
    const float4 b = *reinterpret_cast<const float4*>(row + c0 + 4);
    f.v[0] = a.x; f.v[1] = a.y; f.v[2] = a.z; f.v[3] = a.w;
    f.v[4] = b.x; f.v[5] = b.y; f.v[6] = b.z; f.v[7] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) f.v[u] = c0 + u < ncols ? row[c0 + u] : 0.f;
  }
}
__device__ __forceinline__ void load8(const uint16_t* row, int c0, int ncols,
                                      bool vec, Floats8& f) {
  if (vec && c0 < ncols) {
    const uint4 r = *reinterpret_cast<const uint4*>(row + c0);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      f.v[2 * u] = __uint_as_float(w[u] << 16);
      f.v[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      f.v[u] = c0 + u < ncols ? bf16_value(row[c0 + u]) : 0.f;
  }
}
__device__ __forceinline__ void load8_bits(const uint16_t* row, int c0,
                                           int ncols, bool vec, Bits8& b) {
  if (vec && c0 < ncols) {
    const uint4 r = *reinterpret_cast<const uint4*>(row + c0);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      b.hi[2 * u] = static_cast<uint16_t>(w[u] & 0xffffu);
      b.hi[2 * u + 1] = static_cast<uint16_t>(w[u] >> 16);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      b.hi[u] = c0 + u < ncols ? row[c0 + u] : static_cast<uint16_t>(0);
  }
}
// eight hi pieces at hi[0 .. 7], and lo pieces at lo[0 .. 7] unless lo is
// null (both 16-byte aligned)
__device__ __forceinline__ void store8(uint16_t* hi, uint16_t* lo,
                                       const Bits8& b) {
  *reinterpret_cast<uint4*>(hi) =
      make_uint4(pack(b.hi[0], b.hi[1]), pack(b.hi[2], b.hi[3]),
                 pack(b.hi[4], b.hi[5]), pack(b.hi[6], b.hi[7]));
  if (lo != nullptr)
    *reinterpret_cast<uint4*>(lo) =
        make_uint4(pack(b.lo[0], b.lo[1]), pack(b.lo[2], b.lo[3]),
                   pack(b.lo[4], b.lo[5]), pack(b.lo[6], b.lo[7]));
}
// elements c, c + 1 of a row as packed hi and lo pieces (bf16 inputs: their
// own bits, lo zero), zero at and past ncols
template <bool kF16>
__device__ __forceinline__ void load_pair_bits(const uint16_t* row, int c,
                                               int ncols, bool vec,
                                               uint32_t& hi, uint32_t& lo) {
  static_assert(!kF16, "bf16 inputs go in as bf16 pieces");
  lo = 0;
  if (vec && c < ncols)
    hi = *reinterpret_cast<const uint32_t*>(row + c);
  else
    hi = pack(c < ncols ? row[c] : static_cast<uint16_t>(0),
              c + 1 < ncols ? row[c + 1] : static_cast<uint16_t>(0));
}
template <bool kF16>
__device__ __forceinline__ void load_pair_bits(const float* row, int c,
                                               int ncols, bool vec,
                                               uint32_t& hi, uint32_t& lo) {
  float v0, v1;
  if (vec && c < ncols) {
    const float2 f = *reinterpret_cast<const float2*>(row + c);
    v0 = f.x;
    v1 = f.y;
  } else {
    v0 = c < ncols ? row[c] : 0.f;
    v1 = c + 1 < ncols ? row[c + 1] : 0.f;
  }
  split2<kF16>(v0, v1, hi, lo);
}
// elements c, c + 1 of a row as floats, zero at and past ncols
__device__ __forceinline__ float2 pair_f(const float* row, int c, int ncols,
                                         bool vec) {
  if (vec && c < ncols) return *reinterpret_cast<const float2*>(row + c);
  return make_float2(c < ncols ? row[c] : 0.f,
                     c + 1 < ncols ? row[c + 1] : 0.f);
}
__device__ __forceinline__ float2 pair_f(const uint16_t* row, int c,
                                         int ncols, bool vec) {
  if (vec && c < ncols) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
  return make_float2(c < ncols ? bf16_value(row[c]) : 0.f,
                     c + 1 < ncols ? bf16_value(row[c + 1]) : 0.f);
}
__device__ __forceinline__ void put(float* q, float v) { *q = v; }
__device__ __forceinline__ void put(uint16_t* q, float v) {
  *q = bf16_bits(v);
}
// a lane's two columns of an output row: c + 1 < ncols with an even row
// length takes one store
__device__ __forceinline__ void put2(float* row, int c, int ncols, float v0,
                                     float v1) {
  if (c + 1 < ncols && ncols % 2 == 0) {
    *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
  } else {
    if (c < ncols) row[c] = v0;
    if (c + 1 < ncols) row[c + 1] = v1;
  }
}
__device__ __forceinline__ void put2(uint16_t* row, int c, int ncols,
                                     float v0, float v1) {
  if (c + 1 < ncols && ncols % 2 == 0) {
    *reinterpret_cast<uint32_t*>(row + c) = pack(bf16_bits(v0),
                                                 bf16_bits(v1));
  } else {
    if (c < ncols) row[c] = bf16_bits(v0);
    if (c + 1 < ncols) row[c + 1] = bf16_bits(v1);
  }
}

// Stage `rows` rows of `groups` groups of eight columns into the planes
// hi and lo ([rows][ld], 16-bit): element (r, col) = f(r, v) of v =
// src(r)[col], zero where src(r) is null or col >= ncols, split into
// pieces. The loads of kU groups are in flight in each thread before their
// stores.
template <bool kF16, int kNT, typename T, class Src, class F>
__device__ __forceinline__ void stage_split(uint16_t* hi, uint16_t* lo,
                                            int ld, int rows, int groups,
                                            int ncols, bool vec, Src src,
                                            F f) {
  constexpr int kU = 4;
  const int total = rows * groups;
  for (int g0 = threadIdx.x; g0 < total; g0 += kNT * kU) {
    Floats8 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int gi = g0 + u * kNT;
      if (gi < total) {
        const T* row = src(gi / groups);
        load8(row, (gi % groups) * 8, row != nullptr ? ncols : 0, vec, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int gi = g0 + u * kNT;
      if (gi < total) {
        const int r = gi / groups, off = r * ld + (gi % groups) * 8;
        Bits8 s8;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          split<kF16>(f(r, v[u].v[e]), s8.hi[e], s8.lo[e]);
        store8(hi + off, lo + off, s8);
      }
    }
  }
}
// Stage input rows (x, B or C) as they are: bf16 bits into hi (no lo
// piece), float32 values split into fp16 hi and lo.
template <typename T, int kNT, class Src>
__device__ __forceinline__ void stage_input(uint16_t* hi, uint16_t* lo,
                                            int ld, int rows, int groups,
                                            int ncols, bool vec, Src src) {
  if constexpr (sizeof(T) == 4) {
    stage_split<true, kNT, float>(hi, lo, ld, rows, groups, ncols, vec, src,
                                  [](int, float v) { return v; });
  } else {
    constexpr int kU = 4;
    const int total = rows * groups;
    for (int g0 = threadIdx.x; g0 < total; g0 += kNT * kU) {
      Bits8 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int gi = g0 + u * kNT;
        if (gi < total) {
          const uint16_t* row = src(gi / groups);
          load8_bits(row, (gi % groups) * 8, row != nullptr ? ncols : 0, vec,
                     v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int gi = g0 + u * kNT;
        if (gi < total)
          store8(hi + (gi / groups) * ld + (gi % groups) * 8, nullptr, v[u]);
      }
    }
  }
}

// d += a b: A 16 x 16 (row), B 16 x 8 (col), bf16 or fp16 in, float32
// sums. Fragments (g = lane / 4, t = lane % 4): a0 (g, 2t..), a1 (g + 8,
// 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); b0 (k 2t.., n g), b1 (k
// 2t + 8.., n g); d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, 2t, 2t + 1).
template <bool kF16>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (kF16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 16-bit matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8 (16 bytes) and receives in r[i] elements
// (g, 2t), (g, 2t + 1) of matrix i, or with kTrans elements (2t, g),
// (2t + 1, g).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(const uint16_t* row,
                                        uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
}
// B fragments (k 16, n 16: two n tiles of 8) at (k, n) of a plane stored
// [k][n] (kTrans) or [n][k]; r[0], r[1] the first tile's b0, b1
template <bool kTrans>
__device__ __forceinline__ int b_offset(int k, int n, int ld) {
  const int lane = threadIdx.x & 31, lm = lane >> 3, lr = lane & 7;
  return kTrans ? (k + (lm & 1) * 8 + lr) * ld + n + (lm >> 1) * 8
                : (n + (lm >> 1) * 8 + lr) * ld + k + (lm & 1) * 8;
}

// A warp's acc[kNT] (16 x 8 tiles at rows m0, columns n0 + 8 nt) += A B
// over k in [k0, k1) (multiples of 16): A from planes stored [m][k], or
// [k][m] with kAT; B from planes stored [n][k], or [k][n] with kBT; the lo
// planes (kALo, kBLo) add a pass each, lo x lo is dropped. Only the first
// `npairs` pairs of n tiles are computed.
template <bool kF16, bool kAT, bool kBT, bool kALo, bool kBLo, int kNT>
__device__ __forceinline__ void warp_mma(float (&acc)[kNT][4],
                                         const uint16_t* ah,
                                         const uint16_t* al, int lda,
                                         const uint16_t* bh,
                                         const uint16_t* bl, int ldb, int m0,
                                         int n0, int k0, int k1,
                                         int npairs) {
  const int lane = threadIdx.x & 31, lm = lane >> 3, lr = lane & 7;
  for (int k = k0; k < k1; k += 16) {
    const int a_off = kAT ? (k + (lm >> 1) * 8 + lr) * lda + m0 + (lm & 1) * 8
                          : (m0 + (lm & 1) * 8 + lr) * lda + k + (lm >> 1) * 8;
    uint32_t fa[4], fal[4];
    ldsm_x4<kAT>(ah + a_off, fa);
    if (kALo) ldsm_x4<kAT>(al + a_off, fal);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      if (np >= npairs) break;
      const int b_off = b_offset<kBT>(k, n0 + 16 * np, ldb);
      uint32_t fb[4], fbl[4];
      ldsm_x4<kBT>(bh + b_off, fb);
      if (kBLo) ldsm_x4<kBT>(bl + b_off, fbl);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float (&d)[4] = acc[2 * np + u];
        mma<kF16>(d, fa, fb[2 * u], fb[2 * u + 1]);
        if (kALo) mma<kF16>(d, fal, fb[2 * u], fb[2 * u + 1]);
        if (kBLo) mma<kF16>(d, fa, fbl[2 * u], fbl[2 * u + 1]);
      }
    }
  }
}

template <int kNT>
__device__ __forceinline__ void zero(float (&acc)[kNT][4]) {
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }
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
// the rows of one (b, chunk, h): [B, nc, H, Qt]
__device__ __forceinline__ size_t plane(const Params& p) {
  return (size_t)p.B * p.nc * p.H * p.Qt;
}
// (it, jt) with jt <= it of the lower-triangle tile pair number x
__device__ __forceinline__ void tri(int x, int& it, int& jt) {
  it = 0;
  while ((it + 1) * (it + 2) / 2 <= x) ++it;
  jt = x - it * (it + 1) / 2;
}

// ---- 1. prefix sums in float64, the rows' weights ----------------------
__global__ void __launch_bounds__(kThreads) ssdb_kernel_cum(const Params p) {
  constexpr int kPer = kMaxQ / 32;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y * (kThreads / 32) + (threadIdx.x >> 5);
  if (h >= p.H) return;
  const int lane = threadIdx.x & 31, rows = chunk_rows(p, c), t0 = c * p.Q;
  const double a = p.a[h];
  double pre[kPer], run = 0.0;
  float dtv[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = lane * kPer + e;
    dtv[e] = i < rows ? p.dt[dti(p, b, t0 + i, h)] : 0.f;
    run += (double)dtv[e] * a;
    pre[e] = run;
  }
  double inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += o;
  }
  const double base = inc - run, cend = __shfl_sync(kFull, inc, 31);
  const size_t o = bch(p, b, c, h), pl = plane(p);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = lane * kPer + e;
    if (i < p.Qt) {
      const double cum = base + pre[e];
      const float dend = expf((float)(cend - cum));
      p.cum[o * p.Qt + i] = cum;
      p.rv[o * p.Qt + i] = dtv[e];
      p.rv[pl + o * p.Qt + i] = dtv[e] * dend;
      p.rv[2 * pl + o * p.Qt + i] = expf((float)cum);
      p.rv[3 * pl + o * p.Qt + i] = dend;
    }
  }
}

// ---- 1b. max |dy|, |d_final| over a grid-stride share of each ---------
__global__ void __launch_bounds__(kThreads) ssdb_kernel_amax(const Params p) {
  __shared__ float red[kThreads / 32];
  const size_t ny = (size_t)p.B * p.S * p.H * p.P;
  const size_t nf = p.dfin != nullptr ? (size_t)p.B * p.H * p.N * p.P : 0;
  const size_t i0 = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t step = (size_t)gridDim.x * kThreads;
  float m = 0.f;
  if (p.vec_dy) {          // P % 8 == 0: whole float4s
    const float4* v = reinterpret_cast<const float4*>(p.dy);
    for (size_t i = i0; i < ny / 4; i += step) {
      const float4 f = v[i];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(f.x), fabsf(f.y)),
                         fmaxf(fabsf(f.z), fabsf(f.w))));
    }
  } else {
    for (size_t i = i0; i < ny; i += step) m = fmaxf(m, fabsf(p.dy[i]));
  }
  for (size_t i = i0; i < nf; i += step) m = fmaxf(m, fabsf(p.dfin[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
    p.amax[blockIdx.x] = m;
  }
}

// ---- 2. sigma: max |dy|, |d_final| times sigma in [1/2, 1) -------------
__global__ void __launch_bounds__(kThreads) ssdb_kernel_scale(const Params p) {
  __shared__ float red[kThreads / 32];
  float m = 0.f;
  for (int i = threadIdx.x; i < p.amax_blocks; i += kThreads)
    m = fmaxf(m, p.amax[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
    int e = 0;
    if (m > 0.f && isfinite(m)) {
      frexpf(m, &e);                 // m = f 2^e, f in [1/2, 1)
      e = max(-120, min(120, e));
    }
    p.sigma[0] = ldexpf(1.f, -e);
    p.sigma[1] = ldexpf(1.f, e);
  }
}

// ---- 3. per-chunk state and gradient terms, per (b, chunk, h, which) ---
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssdb_kernel_outer(
    const Params p) {
  constexpr bool kF16 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sR = reinterpret_cast<float*>(smem);                // [kMaxQ]
  uint16_t* sAh = reinterpret_cast<uint16_t*>(sR + kMaxQ);   // B or C [j][n]
  uint16_t* sAl = sAh + kT * kLdN;                           // (float32)
  uint16_t* sXh = sAl + (kF16 ? kT * kLdN : 0);              // [j][p]
  uint16_t* sXl = sXh + kT * kLdP;
  const int h = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z >> 1, which = blockIdx.z & 1;
  const int rows = chunk_rows(p, c), t0 = c * p.Q, tid = threadIdx.x;
  const size_t o = bch(p, b, c, h);
  const float sig = p.sigma[0];
  // w_j (state terms) or exp(cum_i) (gradient terms)
  const float* wr = p.rv + (which == 0 ? 1 : 2) * plane(p) + o * p.Qt;
  for (int j = tid; j < kMaxQ; j += kThreads) sR[j] = j < rows ? wr[j] : 0.f;
  const T* mat = static_cast<const T*>(which == 0 ? p.bm : p.cm) +
                 b * (which == 0 ? p.b_sb : p.c_sb);
  const long long mrow = which == 0 ? p.b_ss : p.c_ss;
  const bool mvec = which == 0 ? p.vec_b : p.vec_c;
  const T* xg = static_cast<const T*>(p.x) + xi(p, b, t0, h);
  const float* dyg = p.dy + xi(p, b, t0, h);
  const size_t xrow = (size_t)p.H * p.P;
  const int Np = round16(p.N), Pp = round16(p.P);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = warp * 16;      // the warp's 16 rows of N, all of P
  float acc[8][4];
  zero(acc);
  for (int jb = 0; jb < rows; jb += kT) {
    const int jr = min(kT, rows - jb), jr16 = round16(jr);
    __syncthreads();     // sR is ready; the previous block's tiles are used
    stage_input<T, kThreads>(
        sAh, sAl, kLdN, jr16, Np / 8, p.N, mvec, [&](int r) -> const T* {
          return r < jr ? mat + (t0 + jb + r) * mrow : nullptr;
        });
    if (which == 0)
      stage_split<kF16, kThreads, T>(
          sXh, sXl, kLdP, jr16, Pp / 8, p.P, p.vec_x,
          [&](int r) -> const T* {
            return r < jr ? xg + (size_t)(jb + r) * xrow : nullptr;
          },
          [&](int r, float v) { return v * sR[jb + r]; });
    else
      stage_split<kF16, kThreads, float>(
          sXh, sXl, kLdP, jr16, Pp / 8, p.P, p.vec_dy,
          [&](int r) -> const float* {
            return r < jr ? dyg + (size_t)(jb + r) * xrow : nullptr;
          },
          [&](int r, float v) { return (v * sig) * sR[jb + r]; });
    __syncthreads();
    if (n0 < Np)
      warp_mma<kF16, true, true, kF16, true, 8>(acc, sAh, sAl, kLdN, sXh, sXl,
                                                kLdP, n0, 0, 0, jr16,
                                                Pp / 16);
  }
  if (n0 >= Np) return;
  float* out = (which == 0 ? p.st : p.sb) + o * p.N * p.P;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {   // rows g and g + 8
      const int n = n0 + g + half * 8;
      if (n < p.N)
        put2(out + (size_t)n * p.P, nt * 8 + 2 * t, p.P, acc[nt][2 * half],
             acc[nt][2 * half + 1]);
    }
  }
}

// ---- 4. the two recurrences over chunks, per (b, h, V elements) --------
// Every warp also leaves its part of <Sb, S_c> a chunk (lanes past the
// elements add zero), for the chunk's decay gradient.
template <int V>
__global__ void __launch_bounds__(kThreads) ssdb_kernel_pass(const Params p) {
  const int pn = p.P * p.N;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * V;
  const int h = blockIdx.y, b = blockIdx.z;
  const int wg = (blockIdx.x * kThreads + threadIdx.x) >> 5;  // warp of (b, h)
  const bool on = e < pn;
  const size_t fin = ((size_t)b * p.H + h) * pn + e;   // [B, H, N, P]
  const size_t chunk = (size_t)p.H * pn;               // st, sb: a chunk on
  const double* cend = p.cum + bch(p, b, 0, h) * p.Qt + p.Q - 1;
  const size_t cchunk = (size_t)p.H * p.Qt;            // cum: a chunk on
  const float sig = p.sigma[0], inv = p.sigma[1];
  auto load = [&](const float* q, float (&v)[V]) {
    if (!on) {
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = 0.f;
    } else if constexpr (V == 4) {
      const float4 f = *reinterpret_cast<const float4*>(q);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
      v[0] = q[0];
    }
  };
  auto store = [&](float* q, const float (&v)[V]) {
    if (!on) return;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    else
      q[0] = v[0];
  };
  // forward: st[c] holds chunk c's state term, then the state entering c
  float s[V], cur[V], nxt[V];
#pragma unroll
  for (int u = 0; u < V; ++u)
    s[u] = on && p.init != nullptr ? p.init[fin + u] : 0.f;
  float* slot = p.st + bch(p, b, 0, h) * pn + e;
  load(slot, nxt);
  for (int c = 0; c < p.nc; ++c) {   // the next chunk's loads go first
#pragma unroll
    for (int u = 0; u < V; ++u) cur[u] = nxt[u];
    const float g = expf((float)cend[c * cchunk]);
    if (c + 1 < p.nc) load(slot + (c + 1) * chunk, nxt);
    store(slot + c * chunk, s);
#pragma unroll
    for (int u = 0; u < V; ++u) s[u] = s[u] * g + cur[u];
  }
  // reverse: sb[c] holds chunk c's gradient term, then the gradient of the
  // state leaving c
#pragma unroll
  for (int u = 0; u < V; ++u)
    s[u] = on && p.dfin != nullptr ? p.dfin[fin + u] * sig : 0.f;
  const float* s_in = slot;
  slot = p.sb + bch(p, b, 0, h) * pn + e;
  double* dotw = p.dotw + ((size_t)b * p.H + h) * p.nc * p.dw;
  load(slot + (p.nc - 1) * chunk, nxt);
  for (int c = p.nc - 1; c >= 0; --c) {
#pragma unroll
    for (int u = 0; u < V; ++u) cur[u] = nxt[u];
    const float g = expf((float)cend[c * cchunk]);
    if (c > 0) load(slot + (c - 1) * chunk, nxt);
    store(slot + c * chunk, s);
    float sc[V];
    load(s_in + c * chunk, sc);
    double dot = 0.0;
#pragma unroll
    for (int u = 0; u < V; ++u) dot += (double)s[u] * sc[u];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(kFull, dot, off);
    if ((threadIdx.x & 31) == 0) dotw[(size_t)c * p.dw + wg] = dot;
#pragma unroll
    for (int u = 0; u < V; ++u) s[u] = s[u] * g + cur[u];
  }
  if (on)
#pragma unroll
    for (int u = 0; u < V; ++u) p.dinit[fin + u] = s[u] * inv;
}

// ---- 5. C B^T, s = dy x^T and G, per (b, chunk, tile pair, group) ------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssdb_kernel_sg(const Params p) {
  constexpr bool kF16 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  double* sCi = reinterpret_cast<double*>(smem);   // [kT] cum of rows i
  double* sCj = sCi + kT;                          // [kT] of columns j
  float* sDt = reinterpret_cast<float*>(sCj + kT); // [kT] dt_j
  float* sLi = sDt + kT;         // [kT] exp(cum_i - ref) (off the diagonal)
  float* sLj = sLi + kT;         // [kT] exp(ref - cum_j)
  float* sM = sLj + kT;          // [kT][kLdM]: M of the tile
  float* sT = sM + kT * kLdM;    // [kT][kLdM]: s (C.B) L of the tile
  uint16_t* base = reinterpret_cast<uint16_t*>(sT + kT * kLdM);
  // C [i][n] and B [j][n] for C B^T, then dy [i][p] and x [j][p] per head
  uint16_t* sCh = base;
  uint16_t* sCl = sCh + kT * kLdN;
  uint16_t* sBh = sCl + (kF16 ? kT * kLdN : 0);
  uint16_t* sBl = sBh + kT * kLdN;
  uint16_t* sYh = base;
  uint16_t* sYl = sYh + kT * kLdP;
  uint16_t* sXh = sYl + kT * kLdP;
  uint16_t* sXl = sXh + kT * kLdP;
  int it, jt;
  tri(blockIdx.x, it, jt);
  const int c = blockIdx.y, b = blockIdx.z / p.ng, grp = blockIdx.z % p.ng;
  const int rows = chunk_rows(p, c), t0 = c * p.Q, i0 = it * kT, j0 = jt * kT;
  if (i0 >= rows) return;
  const int ir = min(kT, rows - i0), jr = min(kT, rows - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;  // rows, columns
  const int Np = round16(p.N), Pp = round16(p.P);
  const size_t Qt = p.Qt;

  // C B^T of the tile: cb[nt][e] at (i0 + wm + g + 8 (e / 2),
  // j0 + wn + 8 nt + 2t + e % 2)
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + t0 * p.c_ss;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + t0 * p.b_ss;
  stage_input<T, kThreads>(sCh, sCl, kLdN, kT, Np / 8, p.N, p.vec_c,
                           [&](int r) -> const T* {
                             return r < ir ? cg + (i0 + r) * p.c_ss : nullptr;
                           });
  stage_input<T, kThreads>(sBh, sBl, kLdN, kT, Np / 8, p.N, p.vec_b,
                           [&](int r) -> const T* {
                             return r < jr ? bg + (j0 + r) * p.b_ss : nullptr;
                           });
  __syncthreads();
  float cb[4][4];
  zero(cb);
  warp_mma<kF16, false, false, kF16, kF16, 4>(cb, sCh, sCl, kLdN, sBh, sBl,
                                              kLdN, wm, wn, 0, Np, 2);
  if (grp == 0) {
    float* xo = p.xcb + ((size_t)b * p.nc + c) * Qt * Qt;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wm + g + 8 * (e >> 1);
        const int j = j0 + wn + 8 * nt + 2 * t + (e & 1);
        xo[(size_t)j * Qt + i] = cb[nt][e];
      }
  }
  __syncthreads();       // the planes are staged anew below

  const T* xg = static_cast<const T*>(p.x) + xi(p, b, t0, 0);
  const float* dyg = p.dy + xi(p, b, t0, 0);
  const size_t xrow = (size_t)p.H * p.P;
  const float sig = p.sigma[0];
  const bool diag = it == jt;
  float gacc[4][4];
  zero(gacc);
  const int h_end = min(p.H, (grp + 1) * p.hpg);
  for (int h = grp * p.hpg; h < h_end; ++h) {
    const size_t o = bch(p, b, c, h);
    if (tid < kT) {
      const double ci = p.cum[o * Qt + i0 + tid];
      const double cj = p.cum[o * Qt + j0 + tid];
      sCi[tid] = ci;
      sCj[tid] = cj;
      sDt[tid] = p.rv[o * Qt + j0 + tid];
      // below the diagonal tile every i follows every j: with ref the cum
      // of the j tile's last row, L_ij = exp(cum_i - ref) exp(ref - cum_j),
      // both factors of differences <= 0
      const double ref = p.cum[o * Qt + j0 + kT - 1];
      sLi[tid] = expf((float)(ci - ref));
      sLj[tid] = expf((float)(ref - cj));
    }
    stage_split<kF16, kThreads, float>(
        sYh, sYl, kLdP, kT, Pp / 8, p.P, p.vec_dy,
        [&](int r) -> const float* {
          return r < ir ? dyg + (i0 + r) * xrow + h * p.P : nullptr;
        },
        [&](int, float v) { return v * sig; });
    stage_input<T, kThreads>(sXh, sXl, kLdP, kT, Pp / 8, p.P, p.vec_x,
                             [&](int r) -> const T* {
                               return r < jr ? xg + (j0 + r) * xrow + h * p.P
                                             : nullptr;
                             });
    __syncthreads();
    float s[4][4];
    zero(s);
    warp_mma<kF16, false, false, true, kF16, 4>(s, sYh, sYl, kLdP, sXh, sXl,
                                                kLdP, wm, wn, 0, Pp, 2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = wm + g + 8 * (e >> 1);
        const int jj = wn + 8 * nt + 2 * t + (e & 1);
        // L_ij (on the diagonal tile the exponent may overflow above the
        // diagonal)
        const float l = !diag ? sLi[ii] * sLj[jj]
                        : jj <= ii ? expf((float)(sCi[ii] - sCj[jj])) : 0.f;
        const float sl = s[nt][e] * l, dtj = sDt[jj];
        const float tt = sl * cb[nt][e];
        sM[ii * kLdM + jj] = tt * dtj;
        sT[ii * kLdM + jj] = tt;
        gacc[nt][e] = fmaf(sl, dtj, gacc[nt][e]);
      }
    }
    __syncthreads();     // also: every warp is done with this head's tiles
    // the tile's row sums of M and column sums of M and of T, in float64
    // in a fixed order: the reverse prefix sum of dcum cancels the row and
    // column sums of a pair of rows both past it, so their rounding must
    // not be float32's
    if (tid < 3 * kT) {
      const int which = tid / kT, k = tid % kT;
      const float* m = which == 2 ? sT : sM;
      const int step = which == 0 ? 1 : kLdM;
      const float* q = m + (which == 0 ? k * kLdM : k);
      double v4[4] = {0.0, 0.0, 0.0, 0.0};    // four chains, then in order
#pragma unroll 4
      for (int r = 0; r < kT; r += 4)
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) v4[k4] += q[(r + k4) * step];
      const double v = (v4[0] + v4[1]) + (v4[2] + v4[3]);
      if (which == 0)
        p.rowm[(o * p.nt + jt) * Qt + i0 + k] = v;
      else
        (which == 1 ? p.colm : p.colt)[(o * p.nt + it) * Qt + j0 + k] = v;
    }
  }
  float* go = p.gpart + (((size_t)b * p.nc + c) * p.ng + grp) * Qt * Qt;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + wm + g + 8 * half, j = j0 + wn + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(go + (size_t)i * Qt + j) =
          make_float2(gacc[nt][2 * half], gacc[nt][2 * half + 1]);
    }
}

// ---- 6. dx and the rows' decay gradient, per (b, chunk, h, split) ------
template <typename T>
__global__ void __launch_bounds__(kHeadThreads, 3) ssdb_kernel_head(
    const Params p) {
  constexpr bool kF16 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  double* sCum = reinterpret_cast<double*>(smem);    // [kMaxQ]
  uint16_t* sSh = reinterpret_cast<uint16_t*>(sCum + kMaxQ);   // [n][p]
  uint16_t* sSl = sSh + kMaxN * kLdP;
  uint16_t* sYh = sSl + kMaxN * kLdP;                // dy [i][p], 64 rows
  uint16_t* sYl = sYh + kT * kLdP;
  const int h = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / p.hsplit, split = blockIdx.z % p.hsplit;
  const int rows = chunk_rows(p, c), t0 = c * p.Q;
  const int nmt = (rows + 15) / 16, npair = (nmt + 1) / 2;
  if (split >= npair) return;   // no warp of this block has a pair
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t o = bch(p, b, c, h), pl = plane(p), Qt = p.Qt;
  const float sig = p.sigma[0], inv = p.sigma[1];
  const int Np = round16(p.N), Pp = round16(p.P), ppairs = Pp / 16;
  for (int i = tid; i < p.Qt; i += kHeadThreads) sCum[i] = p.cum[o * Qt + i];
  const float* sbar = p.sb + o * p.N * p.P;     // sigma Sb
  const float* s_in = p.st + o * p.N * p.P;     // S_c
  const bool svec = p.P % 8 == 0;
  auto stage_state = [&](const float* m) {
    stage_split<kF16, kHeadThreads, float>(
        sSh, sSl, kLdP, Np, Pp / 8, p.P, svec,
        [&](int r) -> const float* {
          return r < p.N ? m + (size_t)r * p.P : nullptr;
        },
        [](int, float v) { return v; });
  };
  stage_state(sbar);
  __syncthreads();

  // this warp's pair of 16-row tiles: q and its mirror nmt - 1 - q
  const int q = warp * p.hsplit + split;
  const bool has = q < npair;
  const int mts[2] = {q, nmt - 1 - q};
  const int ntile = has ? (mts[1] != mts[0] ? 2 : 1) : 0;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + t0 * p.b_ss;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + t0 * p.c_ss;
  const T* xg = static_cast<const T*>(p.x) + xi(p, b, t0, h);
  const float* dyg = p.dy + xi(p, b, t0, h);
  const size_t xrow = (size_t)p.H * p.P;
  const float* dtr = p.rv + o * Qt;
  const float* wr = p.rv + pl + o * Qt;
  const float* er = p.rv + 2 * pl + o * Qt;
  const float* dr = p.rv + 3 * pl + o * Qt;
  float uw[2][2] = {{0.f, 0.f}, {0.f, 0.f}};    // u of rows g, g + 8
  float acc[2][8][4];
  zero(acc[0]);
  zero(acc[1]);

  // A. B_j Sb (A from B's rows, B from the staged Sb), u_j = its product
  // with x_j, and exp(cend - cum_j) B_j Sb as the start of dx / dt_j
  uint32_t nh[2][4], nl[2][4];   // the next k step's A fragments
  auto load_b = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u >= ntile) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 16 * mts[u] + g + 8 * (r & 1);
        load_pair_bits<kF16>(bg + j * p.b_ss, k0 + 2 * t + 8 * (r >> 1),
                             j < rows ? p.N : 0, p.vec_b, nh[u][r], nl[u][r]);
      }
    }
  };
  load_b(0);
  for (int k0 = 0; k0 < Np; k0 += 16) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ah[u][r] = nh[u][r];
        al[u][r] = nl[u][r];
      }
    if (k0 + 16 < Np) load_b(k0 + 16);
#pragma unroll
    for (int np = 0; np < kMaxP / 16; ++np) {
      if (np >= ppairs) break;
      const int off = b_offset<true>(k0, 16 * np, kLdP);
      uint32_t bh[4], bl[4];
      ldsm_x4<true>(sSh + off, bh);
      ldsm_x4<true>(sSl + off, bl);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u >= ntile) break;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float (&d)[4] = acc[u][2 * np + v];
          mma<kF16>(d, ah[u], bh[2 * v], bh[2 * v + 1]);
          if (kF16) mma<kF16>(d, al[u], bh[2 * v], bh[2 * v + 1]);
          mma<kF16>(d, ah[u], bl[2 * v], bl[2 * v + 1]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u >= ntile) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 16 * mts[u] + g + 8 * half;
      const T* xr = xg + (size_t)j * xrow;
      float part = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 xv = pair_f(xr, 8 * nt + 2 * t, j < rows ? p.P : 0,
                                 p.vec_x);
        part = fmaf(acc[u][nt][2 * half], xv.x, part);
        part = fmaf(acc[u][nt][2 * half + 1], xv.y, part);
      }
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      uw[u][half] = part;
      const float de = j < rows ? dr[j] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[u][nt][2 * half] *= de;
        acc[u][nt][2 * half + 1] *= de;
      }
    }
  }

  // B. dx / dt_j += ((C B^T)_ij L_ij)^T sigma dy_i over i >= j, dy staged
  // a 64-row tile at a time, the score fragments made in registers (dt_j
  // left out, so that they are of the size of C B^T whatever dt is)
  const float* xo = p.xcb + ((size_t)b * p.nc + c) * Qt * Qt;
  for (int kt = 0; kt * kT < rows; ++kt) {
    const int kr = min(kT, rows - kt * kT);
    __syncthreads();     // the previous tile is used
    stage_split<kF16, kHeadThreads, float>(
        sYh, sYl, kLdP, kT, Pp / 8, p.P, p.vec_dy,
        [&](int r) -> const float* {
          return r < kr ? dyg + (size_t)(kt * kT + r) * xrow : nullptr;
        },
        [&](int, float v) { return v * sig; });
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u >= ntile) break;
      const int j0 = 16 * mts[u];
      const int ja = j0 + g, jb = ja + 8;
      const double ca = sCum[ja], cbv = sCum[jb];
      // k steps of this tile with i >= j0, below the chunk's rows
      const int k_lo = max(kt * kT, j0);
      const int k_hi = min(kt * kT + kT, (rows + 15) & ~15);
      const float* xa = xo + (size_t)ja * Qt + 2 * t;
      const float* xb = xo + (size_t)jb * Qt + 2 * t;
      float2 nx[4];     // fragment register r: row (r & 1 ? jb : ja),
                        // columns k0 + 2t + 8 (r >> 1) (+1)
      auto load_x = [&](int k0) {
        nx[0] = *reinterpret_cast<const float2*>(xa + k0);
        nx[1] = *reinterpret_cast<const float2*>(xb + k0);
        nx[2] = *reinterpret_cast<const float2*>(xa + k0 + 8);
        nx[3] = *reinterpret_cast<const float2*>(xb + k0 + 8);
      };
      if (k_lo < k_hi) load_x(k_lo);
      for (int k0 = k_lo; k0 < k_hi; k0 += 16) {
        const float2 cx[4] = {nx[0], nx[1], nx[2], nx[3]};
        if (k0 + 16 < k_hi) load_x(k0 + 16);   // the next step's loads
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = (r & 1) ? jb : ja;
          const double cj = (r & 1) ? cbv : ca;
          const int i = k0 + 2 * t + 8 * (r >> 1);
          float v0 = cx[r].x * expf((float)(sCum[i] - cj));
          float v1 = cx[r].y * expf((float)(sCum[i + 1] - cj));
          if (k0 == j0) {   // L: i >= j (the exponent may overflow below)
            v0 = i >= j ? v0 : 0.f;
            v1 = i + 1 >= j ? v1 : 0.f;
          }
          split2<kF16>(v0, v1, ah[r], al[r]);
        }
#pragma unroll
        for (int np = 0; np < kMaxP / 16; ++np) {
          if (np >= ppairs) break;
          const int off = b_offset<true>(k0 - kt * kT, 16 * np, kLdP);
          uint32_t bh[4], bl[4];
          ldsm_x4<true>(sYh + off, bh);
          ldsm_x4<true>(sYl + off, bl);
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            float (&d)[4] = acc[u][2 * np + v];
            mma<kF16>(d, ah, bh[2 * v], bh[2 * v + 1]);
            mma<kF16>(d, al, bh[2 * v], bh[2 * v + 1]);
            mma<kF16>(d, ah, bl[2 * v], bl[2 * v + 1]);
          }
        }
      }
    }
  }
  // dx = dt_j acc / sigma
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u >= ntile) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 16 * mts[u] + g + 8 * half;
      if (j >= rows) continue;
      T* out = static_cast<T*>(p.dx) + xi(p, b, t0 + j, h);
      const float f = dtr[j] * inv;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        put2(out, 8 * nt + 2 * t, p.P, acc[u][nt][2 * half] * f,
             acc[u][nt][2 * half + 1] * f);
    }
  }

  // C. v_i = sigma dy_i . (C_i S_c), a tile at a time
  float vv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if (c > 0 || p.init != nullptr) {
    __syncthreads();     // every warp is done with Sb
    stage_state(s_in);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u >= ntile) break;
      float cs[8][4];
      zero(cs);
      uint32_t nh[4], nl[4];       // the next k step's A fragments
      auto load_c = [&](int k0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 16 * mts[u] + g + 8 * (r & 1);
          load_pair_bits<kF16>(cg + i * p.c_ss, k0 + 2 * t + 8 * (r >> 1),
                               i < rows ? p.N : 0, p.vec_c, nh[r], nl[r]);
        }
      };
      load_c(0);
      for (int k0 = 0; k0 < Np; k0 += 16) {
        const uint32_t ah[4] = {nh[0], nh[1], nh[2], nh[3]};
        const uint32_t al[4] = {nl[0], nl[1], nl[2], nl[3]};
        if (k0 + 16 < Np) load_c(k0 + 16);
#pragma unroll
        for (int np = 0; np < kMaxP / 16; ++np) {
          if (np >= ppairs) break;
          const int off = b_offset<true>(k0, 16 * np, kLdP);
          uint32_t bh[4], bl[4];
          ldsm_x4<true>(sSh + off, bh);
          ldsm_x4<true>(sSl + off, bl);
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            float (&d)[4] = cs[2 * np + v];
            mma<kF16>(d, ah, bh[2 * v], bh[2 * v + 1]);
            if (kF16) mma<kF16>(d, al, bh[2 * v], bh[2 * v + 1]);
            mma<kF16>(d, ah, bl[2 * v], bl[2 * v + 1]);
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 16 * mts[u] + g + 8 * half;
        const float* yr = dyg + (size_t)i * xrow;
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 yv = pair_f(yr, 8 * nt + 2 * t, i < rows ? p.P : 0,
                                   p.vec_dy);
          part = fmaf(cs[nt][2 * half], yv.x * sig, part);
          part = fmaf(cs[nt][2 * half + 1], yv.y * sig, part);
        }
        part += __shfl_xor_sync(kFull, part, 1);
        part += __shfl_xor_sync(kFull, part, 2);
        vv[u][half] = part;
      }
    }
  }
  // the rows' parts of the decay gradient: e v - w u, exp(cend - cum) u,
  // w u (for the chunk's last row)
  if (t == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u >= ntile) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 16 * mts[u] + g + 8 * half;
        if (i >= rows) continue;
        const double wu = (double)wr[i] * uw[u][half];
        p.hrow[o * Qt + i] = (double)er[i] * vv[u][half] - wu;
        p.hrow[pl + o * Qt + i] = (double)dr[i] * uw[u][half];
        p.hrow[2 * pl + o * Qt + i] = wu;
      }
    }
  }

}

// ---- 7. dcum, its reverse prefix sum, ddt and da's part ----------------
__global__ void __launch_bounds__(kThreads) ssdb_kernel_decay(const Params p) {
  constexpr int kPer = kMaxQ / 32;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y * (kThreads / 32) + (threadIdx.x >> 5);
  if (h >= p.H) return;
  const int lane = threadIdx.x & 31, rows = chunk_rows(p, c), t0 = c * p.Q;
  const int ntr = (rows + kT - 1) / kT;
  const size_t o = bch(p, b, c, h), pl = plane(p), Qt = p.Qt;
  const double* hr = p.hrow + o * Qt;
  double dc[kPer], dd[kPer], endp = 0.0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = lane * kPer + e;
    dc[e] = dd[e] = 0.0;
    if (i < rows) {
      const int ti = i / kT;
      double v = hr[i], cm = 0.0, ct = 0.0;
      for (int jt = 0; jt <= ti; ++jt) v += p.rowm[(o * p.nt + jt) * Qt + i];
      for (int it = ti; it < ntr; ++it) {
        cm += p.colm[(o * p.nt + it) * Qt + i];
        ct += p.colt[(o * p.nt + it) * Qt + i];
      }
      dc[e] = v - cm;
      dd[e] = hr[pl + i] + ct;
      endp += hr[2 * pl + i];
    }
  }
  // exp(cum_end) <Sb, S_c>: the pass's warps' parts, in order
  const double* dotw = p.dotw + (((size_t)b * p.H + h) * p.nc + c) * p.dw;
  double dot = 0.0;
  for (int w = lane; w < p.dw; w += 32) dot += dotw[w];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    endp += __shfl_xor_sync(kFull, endp, off);
    dot += __shfl_xor_sync(kFull, dot, off);
  }
  endp += dot * (double)expf((float)p.cum[o * Qt + p.Q - 1]);
  // the chunk's decay enters at its last row, Q - 1
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (lane * kPer + e == p.Q - 1) dc[e] += endp;
  // the reverse prefix sum of dcum, eight rows a lane
  double loc[kPer], run = 0.0;
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k) {
    run += dc[k];
    loc[k] = run;
  }
  double inc = run;       // the sum over lanes >= this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o2 = __shfl_down_sync(kFull, inc, off);
    if (lane + off < 32) inc += o2;
  }
  const double after = inc - run, a = p.a[h], inv = p.sigma[1];
  const float* dtr = p.rv + o * Qt;
  double part = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = lane * kPer + k;
    if (i < rows) {
      const double dda = loc[k] + after;
      p.ddt[dti(p, b, t0 + i, h)] = (float)((dd[k] + a * dda) * inv);
      part += dda * dtr[i];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  if (lane == 0) p.dapart[o] = part;
}

// ---- 8. dB (which 0) and dC (which 1), per (b, chunk, rows, part) ------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssdb_kernel_bc(const Params p) {
  constexpr bool kF16 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sR = reinterpret_cast<float*>(smem);                // [kT]
  uint16_t* sAh = reinterpret_cast<uint16_t*>(sR + kT);      // [kT][kLdP]
  uint16_t* sAl = sAh + kT * kLdP;
  uint16_t* sBh = sAl + kT * kLdP;    // [n][p] (heads) or [k][n] (G)
  uint16_t* sBl = sBh + kMaxN * kLdP;
  uint16_t* sGl = sBh + kT * kLdN;    // the G part's lo plane of C or B
  const int rt = blockIdx.x >> 1, which = blockIdx.x & 1, c = blockIdx.y;
  const int b = blockIdx.z / (p.parts + 1), part = blockIdx.z % (p.parts + 1);
  const int rows = chunk_rows(p, c), t0 = c * p.Q, r0 = rt * kT;
  if (r0 >= rows) return;
  const int rr = min(kT, rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 64;
  const int Np = round16(p.N), Pp = round16(p.P);
  const int npairs = max(0, min(4, (Np - wn) / 16));
  const size_t Qt = p.Qt;
  float acc[8][4];
  zero(acc);
  if (part < p.parts) {
    // sum over the part's heads of (w x) Sb^T (dB) or (exp(cum) dy) S_c^T
    const T* xg = static_cast<const T*>(p.x) + xi(p, b, t0 + r0, 0);
    const float* dyg = p.dy + xi(p, b, t0 + r0, 0);
    const size_t xrow = (size_t)p.H * p.P;
    const float sig = p.sigma[0];
    const bool svec = p.P % 8 == 0;
    const int h_end = min(p.H, (part + 1) * p.hpp);
    for (int h = part * p.hpp; h < h_end; ++h) {
      const size_t o = bch(p, b, c, h);
      __syncthreads();       // the previous head's tiles are used
      if (tid < kT)
        sR[tid] = tid < rr ? p.rv[(which == 0 ? 1 : 2) * plane(p) + o * Qt +
                                  r0 + tid]
                           : 0.f;
      __syncthreads();
      if (which == 0)
        stage_split<kF16, kThreads, T>(
            sAh, sAl, kLdP, kT, Pp / 8, p.P, p.vec_x,
            [&](int r) -> const T* {
              return r < rr ? xg + r * xrow + h * p.P : nullptr;
            },
            [&](int r, float v) { return v * sR[r]; });
      else
        stage_split<kF16, kThreads, float>(
            sAh, sAl, kLdP, kT, Pp / 8, p.P, p.vec_dy,
            [&](int r) -> const float* {
              return r < rr ? dyg + r * xrow + h * p.P : nullptr;
            },
            [&](int r, float v) { return (v * sig) * sR[r]; });
      const float* m = (which == 0 ? p.sb : p.st) + o * p.N * p.P;
      stage_split<kF16, kThreads, float>(
          sBh, sBl, kLdP, Np, Pp / 8, p.P, svec,
          [&](int r) -> const float* {
            return r < p.N ? m + (size_t)r * p.P : nullptr;
          },
          [](int, float v) { return v; });
      __syncthreads();
      warp_mma<kF16, false, false, true, true, 8>(acc, sAh, sAl, kLdP, sBh,
                                                  sBl, kLdP, wm, wn, 0, Pp,
                                                  npairs);
    }
  } else {
    // G^T C (dB: k = i >= the rows) or G B (dC: k = j <= the rows), G
    // summed over the groups in order as it is staged. G carries dt and
    // the cotangent's size, so it goes in times a power of two that
    // brings its largest |value| here into [2^13, 2^14): fp16 pieces keep
    // 22 bits of it whatever its size.
    const int ntr = (rows + kT - 1) / kT;
    const int kt0 = which == 0 ? rt : 0, kt1 = which == 0 ? ntr - 1 : rt;
    const float* gp = p.gpart + ((size_t)b * p.nc + c) * p.ng * Qt * Qt;
    const size_t gstride = Qt * Qt;
    const T* mat = static_cast<const T*>(which == 0 ? p.cm : p.bm) +
                   b * (which == 0 ? p.c_sb : p.b_sb) +
                   t0 * (which == 0 ? p.c_ss : p.b_ss);
    const long long mrow = which == 0 ? p.c_ss : p.b_ss;
    const bool mvec = which == 0 ? p.vec_c : p.vec_b;
    // eight values of G (summed over the groups in order) at row i, from
    // column j, of the k tile kt: rows i of the k tile (dB) or of the row
    // tile (dC), 64 columns j of the row tile (dB) or of the k tile (dC)
    auto load_g = [&](int kt, int gi, Floats8& v) {
      const int grow = which == 0 ? kt * kT : r0;
      const int gcol = which == 0 ? r0 : kt * kT;
      const float* src = gp + (size_t)(grow + gi / 8) * Qt + gcol +
                         (gi % 8) * 8;
      load8(src, 0, 8, true, v);
      for (int gr = 1; gr < p.ng; ++gr) {
        Floats8 w;
        load8(src + gr * gstride, 0, 8, true, w);
#pragma unroll
        for (int e = 0; e < 8; ++e) v.v[e] += w.v[e];
      }
    };
    float gmax = 0.f;
    for (int kt = kt0; kt <= kt1; ++kt)
      for (int gi = tid; gi < kT * 8; gi += kThreads) {
        Floats8 v;
        load_g(kt, gi, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) gmax = fmaxf(gmax, fabsf(v.v[e]));
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      gmax = fmaxf(gmax, __shfl_xor_sync(kFull, gmax, off));
    if (lane == 0) sR[warp] = gmax;
    __syncthreads();
    for (int w = 0; w < kThreads / 32; ++w) gmax = fmaxf(gmax, sR[w]);
    int ge = 0;
    if (gmax > 0.f && isfinite(gmax)) frexpf(gmax, &ge);
    ge = max(-100, min(100, ge));
    const float gscale = ldexpf(1.f, 14 - ge);
    const float gunscale = ldexpf(1.f, ge - 14);
    for (int kt = kt0; kt <= kt1; ++kt) {
      const int k0 = kt * kT, kr = min(kT, rows - k0);
      __syncthreads();
      constexpr int kU = 4;
      for (int g0 = tid; g0 < kT * 8; g0 += kThreads * kU) {
        Floats8 v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int gi = g0 + u * kThreads;
          if (gi < kT * 8) load_g(kt, gi, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int gi = g0 + u * kThreads;
          if (gi >= kT * 8) continue;
          const int off = (gi / 8) * kLdP + (gi % 8) * 8;
          Bits8 s8;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            split<kF16>(v[u].v[e] * gscale, s8.hi[e], s8.lo[e]);
          store8(sAh + off, sAl + off, s8);
        }
      }
      stage_input<T, kThreads>(sBh, sGl, kLdN, kT, Np / 8, p.N, mvec,
                               [&](int r) -> const T* {
                                 return r < kr ? mat + (k0 + r) * mrow
                                               : nullptr;
                               });
      __syncthreads();
      if (which == 0)    // A = G^T, stored [k = i][m = j]
        warp_mma<kF16, true, true, true, kF16, 8>(acc, sAh, sAl, kLdP, sBh,
                                                  sGl, kLdN, wm, wn, 0, kT,
                                                  npairs);
      else               // A = G, stored [m = i][k = j]
        warp_mma<kF16, false, true, true, kF16, 8>(acc, sAh, sAl, kLdP, sBh,
                                                   sGl, kLdN, wm, wn, 0, kT,
                                                   npairs);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= gunscale;
  }
  float* out = p.bcpart +
               ((((size_t)part * 2 + which) * p.B + b) * p.nc + c) * Qt *
                   p.N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + g + 8 * half;
      if (r < rr)
        put2(out + (size_t)(r0 + r) * p.N, wn + 8 * nt + 2 * t, p.N,
             acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
}

// ---- 9. dB and dC: the parts summed in order ---------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) ssdb_kernel_bcsum(const Params p) {
  const size_t per = (size_t)p.B * p.S * p.N, total = 2 * per;
  const size_t stride = 2 * (size_t)p.B * p.nc * p.Qt * p.N;   // a part on
  const float inv = p.sigma[1];
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int which = (int)(e / per);
    const size_t rest = e % per;
    const int n = (int)(rest % p.N);
    const size_t bt = rest / p.N;
    const int tt = (int)(bt % p.S), b = (int)(bt / p.S);
    const int c = tt / p.Q, r = tt % p.Q;
    const float* src = p.bcpart +
                       ((((size_t)which * p.B + b) * p.nc + c) * p.Qt + r) *
                           p.N + n;
    float v = 0.f;
    for (int part = 0; part <= p.parts; ++part) v += src[part * stride];
    put(static_cast<T*>(which == 0 ? p.db : p.dc) + rest, v * inv);
  }
}

// ---- 10. da: the per-(b, chunk, h) parts, summed in order --------------
__global__ void __launch_bounds__(kThreads) ssdb_kernel_da(const Params p) {
  for (int h = threadIdx.x; h < p.H; h += kThreads) {
    double s = 0.0;
    for (int b = 0; b < p.B; ++b)
      for (int c = 0; c < p.nc; ++c) s += p.dapart[bch(p, b, c, h)];
    p.da[h] = (float)(s * p.sigma[1]);
  }
}

// dynamic shared memory of each staged kernel (ssd_backward_smem_bytes
// reports them)
size_t outer_smem(bool f32) {
  return kMaxQ * 4 + ((f32 ? 2 : 1) * kT * kLdN + 2 * kT * kLdP) * 2;
}
size_t sg_smem(bool f32) {
  const size_t tiles = (size_t)(f32 ? 4 : 2) * kT * kLdN * 2;
  const size_t heads = (size_t)(f32 ? 4 : 3) * kT * kLdP * 2;
  return 2 * kT * 8 + 3 * kT * 4 + 2 * kT * kLdM * 4 +
         (tiles > heads ? tiles : heads);
}
size_t head_smem() {
  return kMaxQ * 8 + (2 * (size_t)kMaxN * kLdP + 2 * (size_t)kT * kLdP) * 2;
}
size_t bc_smem(bool f32) {
  const size_t heads = 2 * (size_t)kMaxN * kLdP * 2;
  const size_t gterm = (size_t)(f32 ? 2 : 1) * kT * kLdN * 2;
  return kT * 4 + 2 * (size_t)kT * kLdP * 2 + (heads > gterm ? heads : gterm);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch_all(const Params& p, cudaStream_t st) {
  constexpr bool kF16 = sizeof(T) == 4;
  cudaError_t err;
#define SSDB_CHECK(call) \
  if ((err = (call)) != cudaSuccess) return (int)err
  const size_t so = outer_smem(kF16), ss = sg_smem(kF16), sh = head_smem(),
               sc = bc_smem(kF16);
  SSDB_CHECK(allow_smem(ssdb_kernel_outer<T>, so));
  SSDB_CHECK(allow_smem(ssdb_kernel_sg<T>, ss));
  SSDB_CHECK(allow_smem(ssdb_kernel_head<T>, sh));
  SSDB_CHECK(allow_smem(ssdb_kernel_bc<T>, sc));
  const dim3 warps(p.nc, (p.H + 7) / 8, p.B);
  ssdb_kernel_cum<<<warps, kThreads, 0, st>>>(p);
  SSDB_CHECK(cudaGetLastError());
  if (p.amax_blocks > 0) {      // the float32 path only (see stage 2)
    ssdb_kernel_amax<<<p.amax_blocks, kThreads, 0, st>>>(p);
    SSDB_CHECK(cudaGetLastError());
  }
  ssdb_kernel_scale<<<1, kThreads, 0, st>>>(p);
  SSDB_CHECK(cudaGetLastError());
  ssdb_kernel_outer<T><<<dim3(p.H, p.nc, 2 * p.B), kThreads, so, st>>>(p);
  SSDB_CHECK(cudaGetLastError());
  if ((p.P * p.N) % 4 == 0)
    ssdb_kernel_pass<4><<<dim3((p.P * p.N / 4 + kThreads - 1) / kThreads,
                               p.H, p.B), kThreads, 0, st>>>(p);
  else
    ssdb_kernel_pass<1><<<dim3((p.P * p.N + kThreads - 1) / kThreads, p.H,
                               p.B), kThreads, 0, st>>>(p);
  SSDB_CHECK(cudaGetLastError());
  ssdb_kernel_sg<T><<<dim3(p.nt * (p.nt + 1) / 2, p.nc, p.B * p.ng),
                      kThreads, ss, st>>>(p);
  SSDB_CHECK(cudaGetLastError());
  ssdb_kernel_head<T><<<dim3(p.H, p.nc, p.B * p.hsplit), kHeadThreads, sh,
                        st>>>(p);
  SSDB_CHECK(cudaGetLastError());
  ssdb_kernel_decay<<<warps, kThreads, 0, st>>>(p);
  SSDB_CHECK(cudaGetLastError());
  ssdb_kernel_bc<T><<<dim3(2 * p.nt, p.nc, p.B * (p.parts + 1)), kThreads,
                      sc, st>>>(p);
  SSDB_CHECK(cudaGetLastError());
  const size_t total = 2 * (size_t)p.B * p.S * p.N;
  const int blocks = (int)((total + kThreads - 1) / kThreads < 8192
                               ? (total + kThreads - 1) / kThreads
                               : 8192);
  ssdb_kernel_bcsum<T><<<blocks, kThreads, 0, st>>>(p);
  SSDB_CHECK(cudaGetLastError());
  ssdb_kernel_da<<<1, kThreads, 0, st>>>(p);
  SSDB_CHECK(cudaGetLastError());
#undef SSDB_CHECK
  return 0;
}

// the plan's derived counts: Qt (Q rounded up to the 64-row tile), tiles,
// groups of the s stage, parts of the dB/dC stage, blocks a (b, chunk,
// head) of the head stage (four warps, a pair of 16-row tiles a warp)
struct Layout {
  int nc, Qt, nt, ng, parts, hsplit;
};
Layout layout(int S, int H, int Q, int hpg, int hpp) {
  Layout l;
  l.nc = (S + Q - 1) / Q;
  l.Qt = (Q + kT - 1) / kT * kT;
  l.nt = l.Qt / kT;
  l.ng = (H + hpg - 1) / hpg;
  l.parts = (H + hpp - 1) / hpp;
  l.hsplit = (Q + 4 * 2 * 16 - 1) / (4 * 2 * 16);
  return l;
}

// warps a (b, h) of the pass kernel: each writes its part of <Sb, S_c>
int dot_warps(int P, int N) {
  const int v = (P * N) % 4 == 0 ? 4 : 1;
  return ((P * N / v + kThreads - 1) / kThreads) * (kThreads / 32);
}

// byte offsets of the scratch, in Params' order, each rounded up to 256
// bytes
constexpr int kScratch = 15;
size_t scratch_layout(int B, int S, int H, int P, int N, int Q, int hpg,
                      int hpp, size_t (&off)[kScratch]) {
  const Layout l = layout(S, H, Q, hpg, hpp);
  const size_t bch = (size_t)B * l.nc * H, rows = bch * l.Qt;
  const size_t bc = (size_t)B * l.nc, qq = (size_t)l.Qt * l.Qt;
  const size_t np = bch * (size_t)N * P;
  const size_t sizes[kScratch] = {
      rows * 8,                 // cum
      4 * rows * 4,             // rv
      kAmaxBlocks * 4,          // amax
      2 * 4,                    // sigma
      bc * qq * 4,              // xcb
      bc * l.ng * qq * 4,       // gpart
      np * 4,                   // st
      np * 4,                   // sb
      rows * l.nt * 8,          // rowm
      rows * l.nt * 8,          // colm
      rows * l.nt * 8,          // colt
      3 * rows * 8,             // hrow
      bch * (size_t)dot_warps(P, N) * 8,   // dotw
      bch * 8,                  // dapart
      (size_t)(l.parts + 1) * 2 * bc * l.Qt * N * 4};  // bcpart
  size_t total = 0;
  for (int i = 0; i < kScratch; ++i) {
    off[i] = total;
    total += (sizes[i] + 255) & ~(size_t)255;
  }
  return total;
}

}  // namespace

extern "C" {

// Bytes of scratch that ssd_backward_launch needs for these shapes and
// plan (hpg heads a group of the s stage, hpp heads a part of dB/dC).
long long ssd_backward_scratch_bytes(int B, int S, int H, int P, int N, int Q,
                                     int hpg, int hpp) {
  if (hpg < 1 || hpp < 1 || Q < 1 || S < 1) return -1;
  size_t off[kScratch];
  return (long long)scratch_layout(B, S, H, P, N, Q, hpg, hpp, off);
}

// Dynamic shared memory of a block of the staged kernel `stage` (0 outer,
// 1 sg, 2 head, 3 bc) on the bf16 (`bf16` = 1) or float32 path, bytes;
// -1 for another stage.
long long ssd_backward_smem_bytes(int stage, int bf16) {
  const bool f32 = !bf16;
  switch (stage) {
    case 0: return (long long)outer_smem(f32);
    case 1: return (long long)sg_smem(f32);
    case 2: return (long long)head_smem();
    case 3: return (long long)bc_smem(f32);
    default: return -1;
  }
}

// Returns a cudaError_t code (0 on success), or -1 for shapes the kernels
// are not built for (P > 64, N > 128, Q > 256) or an empty plan. Launches
// on `stream` and does not synchronise. `init` and `dfin` may be null
// (zero). `scratch`: ssd_backward_scratch_bytes(...) bytes from the
// caller, 256-byte aligned. The plan: hpg heads a group of the s stage,
// hpp heads a part of the dB/dC stage.
int ssd_backward_launch(const void* x, const float* dt, const float* a,
                        const void* bm, const void* cm, const float* init,
                        const float* dy, const float* dfin, void* dx,
                        float* ddt, float* da, void* db, void* dc,
                        float* dinit, void* scratch, int B, int S, int H,
                        int P, int N, int Q, long long b_sb, long long b_ss,
                        long long c_sb, long long c_ss, int bf16, int hpg,
                        int hpp, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ || hpg < 1 || hpp < 1)
    return -1;
  const Layout l = layout(S, H, Q, hpg, hpp);
  size_t off[kScratch];
  scratch_layout(B, S, H, P, N, Q, hpg, hpp, off);
  char* s8 = static_cast<char*>(scratch);
  // 16-byte loads of rows: aligned starts and strides, widths % 8 == 0
  const size_t es = bf16 ? 2 : 4;
  auto a16 = [](const void* q) { return (uintptr_t)q % 16 == 0; };
  const int vec_x = P % 8 == 0 && a16(x);
  const int vec_b = N % 8 == 0 && a16(bm) && (b_sb * es) % 16 == 0 &&
                    (b_ss * es) % 16 == 0;
  const int vec_c = N % 8 == 0 && a16(cm) && (c_sb * es) % 16 == 0 &&
                    (c_ss * es) % 16 == 0;
  const int vec_dy = P % 8 == 0 && a16(dy);
  Params p{};
  p.x = x; p.dt = dt; p.a = a; p.bm = bm; p.cm = cm; p.init = init;
  p.dy = dy; p.dfin = dfin; p.dx = dx; p.ddt = ddt; p.da = da; p.db = db;
  p.dc = dc; p.dinit = dinit;
  p.cum = reinterpret_cast<double*>(s8 + off[0]);
  p.rv = reinterpret_cast<float*>(s8 + off[1]);
  p.amax = reinterpret_cast<float*>(s8 + off[2]);
  p.sigma = reinterpret_cast<float*>(s8 + off[3]);
  p.xcb = reinterpret_cast<float*>(s8 + off[4]);
  p.gpart = reinterpret_cast<float*>(s8 + off[5]);
  p.st = reinterpret_cast<float*>(s8 + off[6]);
  p.sb = reinterpret_cast<float*>(s8 + off[7]);
  p.rowm = reinterpret_cast<double*>(s8 + off[8]);
  p.colm = reinterpret_cast<double*>(s8 + off[9]);
  p.colt = reinterpret_cast<double*>(s8 + off[10]);
  p.hrow = reinterpret_cast<double*>(s8 + off[11]);
  p.dotw = reinterpret_cast<double*>(s8 + off[12]);
  p.dapart = reinterpret_cast<double*>(s8 + off[13]);
  p.bcpart = reinterpret_cast<float*>(s8 + off[14]);
  p.B = B; p.S = S; p.H = H; p.P = P; p.N = N; p.Q = Q;
  p.nc = l.nc; p.Qt = l.Qt; p.nt = l.nt;
  p.b_sb = b_sb; p.b_ss = b_ss; p.c_sb = c_sb; p.c_ss = c_ss;
  p.vec_x = vec_x; p.vec_b = vec_b; p.vec_c = vec_c; p.vec_dy = vec_dy;
  p.hpg = hpg; p.ng = l.ng; p.hpp = hpp; p.parts = l.parts;
  p.hsplit = l.hsplit;
  const size_t ny4 = ((size_t)B * S * H * P + 4 * kThreads - 1) /
                     (4 * kThreads);
  p.amax_blocks = bf16 ? 0 : (int)(ny4 < (size_t)kAmaxBlocks ? ny4
                                                            : kAmaxBlocks);
  p.dw = dot_warps(P, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_all<uint16_t>(p, s) : launch_all<float>(p, s);
}

}  // extern "C"
