// Mamba2 SSD chunk scan for Hopper (sm_90a), state-space duality
// (arXiv:2405.21060, Alg. 1 'chunked' form), in stages.
//
// Replaces the Pallas TPU kernel `ssd_pallas` / `_ssd_kernel` in
// src/repro/kernels/ssd/kernel.py (:85). Semantics are those of `ssd_ref`
// (src/repro/kernels/ssd/ref.py, the model's `ssd_chunked`): for each
// batch row b and head h, S is cut into chunks of Q = min(chunk, S) rows
// (the last one ragged; rows past S act as dt = 0), and for each chunk,
// with cum the inclusive prefix sum of dt * a over the chunk,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . S_prev
//   S_new = S_prev exp(cum_end) + sum_j B_j (x_j dt_j exp(cum_end - cum_j))
// from S = initial_state (or zero). Outputs y [B, S, H, P] and the final
// state [B, H, N, P], both float32.
//
// What bounds it on the H100: the least work reads x, dt, B and C once
// and writes y and the state once; C B^T is shared by all heads (one
// group), so the least arithmetic is the lower triangle of C B^T once per
// (b, chunk), then per head its product with x and the two state terms.
// At full width (P = 64, N = 128, Q = 256) and bf16 inputs that is under
// 130 operations per byte, below the ~295 where the bf16 tensor cores
// would bound it: the bound is the bytes, about 0.1 ms at B = 4,
// S = 4,096.
//
// Design: five kernels, one call (the wrapper counts one launch), all
// parallel over chunks but the state passing; every kernel's name holds
// `ssd_kernel`.
//   1. ssd_kernel_cumsum, per (b, chunk, 8 heads), a warp a head: the
//      inclusive prefix sum of dt * a, and dt itself, zero past the
//      chunk's rows, into scratch [B, nc, H, Q].
//   2. ssd_kernel_cb, per (b, chunk, 64 rows of i): C B^T for j <= i,
//      written once to device memory as float32 [B, nc, Qs, Qs] (Qs = Q
//      rounded up to 16; 256 KB a chunk, 16 MB at B = 4, S = 4,096, which
//      stays in the 50 MB L2), read by every head's output stage.
//   3. ssd_kernel_states, per (b, chunk, h): the chunk's contribution to
//      the state, sum_j B_j^T (x_j dt_j exp(cum_end - cum_j)), [N, P], in
//      scratch [B, nc, H, N, P]; each warp owns 16 rows of N.
//   4. ssd_kernel_pass, per (b, h, 4 elements), float4: sequential over
//      chunks, S_c = S_{c-1} exp(cum_end) + contribution_c, overwriting
//      each contribution with the state that enters its chunk (the next
//      chunk's loads issued first); the last S is the final state.
//   5. ssd_kernel_out, per (b, chunk, h): y = exp(cum_i) C_i S_prev +
//      (C B^T o L o dt) x. Each warp owns two 16-row tiles of i (t and
//      15 - t, so the causal triangle's work is even across warps) and all
//      of P; the score fragments are made in registers from C B^T (float2
//      loads, prefetched a step ahead), cum and dt, so no CTA recomputes
//      C B^T; masks apply only on the diagonal tile.
// Tiles are staged with 16-byte loads, several in flight a thread, into
// row-major shared memory ([k][n], rows padded to 16-byte multiples that
// are conflict-free for ldmatrix); `ldmatrix.trans` turns them into mma
// fragments, so nothing is transposed on the way in.
// Products run on the tensor cores, `mma.sync` m16n8k16 -> float32.
// bf16 inputs (x, B, C) go in as their own bits: products of bf16 values
// are exact in float32; a float32 operand of the bf16 path (the scores,
// the weighted x of the states, the carried state) is split into hi + lo
// bf16 parts, hi = bf16(v), lo = bf16(v - hi), and multiplied in two
// passes: about 2^-18 of each product. On the float32 path every operand
// is split, into fp16 parts (hi = fp16(v), lo = fp16(v - hi), 2^-22 of v
// left over), and multiplied on the fp16 tensor cores in three passes,
// the lo x lo term dropped: about 2^-20 of each product. bf16 parts there
// left 2^-18 of each operand and 2^-18 in the dropped term, and a train
// step's gradients, which amplify the output's error many times over,
// parted from float32 autograd by more than 1e-4 of their largest. The
// operands stay far inside fp16's range (|scores| ~ 10^2, states
// ~ 10^1); values under 2^-14 lose relative precision but no more than
// 2^-24 in absolute terms. All sums are float32.
//
// What still bounds it: at B = 4, S = 4,096 the output and state stages
// take most of the time, on mma.sync's issue rate and the per-element
// work of the score fragments (an exponential and a split each), and the
// scratch round trip of the chunk states (about 100 MB written, read
// twice) is what keeps it far from the bytes bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 256;          // chunk length
constexpr int kMaxN = 128;          // state dim
constexpr int kMaxP = 64;           // head dim
constexpr int kCbRows = 64;         // rows of i per C B^T CTA
constexpr int kJBlock = 64;         // rows of j per step of the state stage
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* x;        // [B, S, H, P], contiguous
  const float* dt;      // [B, S, H], contiguous
  const float* a;       // [H]
  const void* bm;       // B: [B, S, N], unit stride over N
  const void* cm;       // C: [B, S, N], unit stride over N
  const float* init;    // [B, H, N, P] or null (zero)
  float* y;             // [B, S, H, P]
  float* state;         // [B, H, N, P]
  float* cum;           // scratch [B, nc, H, Q]
  float* dtc;           // scratch [B, nc, H, Q]
  float* cb;            // scratch [B, nc, Qs, Qs]
  float* st;            // scratch [B, nc, H, N, P]
  int B, S, H, P, N, Q, nc, Qs;
  long long b_sb, b_ss, c_sb, c_ss;   // batch and row strides of B and C
  int vec_x, vec_b, vec_c;   // rows of x, B, C take 16-byte loads
};

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(uint16_t h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}
// v = hi + lo + O(2^-18 v) with bf16 pieces, O(2^-22 v) with fp16 pieces
// (kF16: the float32 path, where every operand is split and the
// products run on fp16 tensor cores; bf16 inputs are exact bf16 and their
// path splits its float32 intermediates into bf16 pieces)
__device__ __forceinline__ uint16_t f16_bits(float v) {
  return __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ float f16_value(uint16_t h) {
  return __half2float(__ushort_as_half(h));
}
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
// the same for two values, packed (v0 in the low half): two conversions
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
// two bf16 of a row of a [rows][ld] bf16 tile, k even
__device__ __forceinline__ uint32_t pair(const uint16_t* s, int row, int ld,
                                         int k) {
  return *reinterpret_cast<const uint32_t*>(s + row * ld + k);
}

// Loads of input rows, zero at and past `ncols`; with `vec` the row is
// 16-byte aligned and ncols % 8 == 0, so a group of 8 (or a pair) inside
// it is one vector load. bf16 inputs stay bf16 bits (their lo part is
// zero: they are exact); float32 ones are split into hi and lo.
struct Bits8 {
  uint16_t hi[8], lo[8];
};
struct Floats8 {
  float v[8];
};
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
template <bool kF16>
__device__ __forceinline__ void load8_bits(const uint16_t* row, int c0,
                                           int ncols, bool vec, Bits8& b) {
  static_assert(!kF16, "bf16 inputs go in as bf16 pieces");
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
#pragma unroll
  for (int u = 0; u < 8; ++u) b.lo[u] = 0;
}
template <bool kF16>
__device__ __forceinline__ void load8_bits(const float* row, int c0,
                                           int ncols, bool vec, Bits8& b) {
  Floats8 f;
  load8(row, c0, ncols, vec, f);
#pragma unroll
  for (int u = 0; u < 8; ++u) split<kF16>(f.v[u], b.hi[u], b.lo[u]);
}
// elements c, c + 1 as a packed pair of bf16 hi parts and of lo parts
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

// Stage `groups` groups of eight elements into shared memory, with the
// loads of kU groups in flight in each thread before their stores. Where a
// tile is stored transposed, consecutive groups are consecutive rows, so a
// warp's 2-byte stores fall in consecutive words.
template <int kNT, typename Buf, typename Load, typename Store>
__device__ __forceinline__ void stage(int groups, Load load, Store store) {
  constexpr int kU = 4;
  for (int g0 = threadIdx.x; g0 < groups; g0 += kNT * kU) {
    Buf v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (g0 + u * kNT < groups) load(g0 + u * kNT, v[u]);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (g0 + u * kNT < groups) store(g0 + u * kNT, v[u]);
  }
}

// eight bf16 hi parts at hi[0 .. 7], and lo parts at lo[0 .. 7] unless lo
// is null (both 16-byte aligned)
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

// d += a b: A 16 x 16 (row), B 16 x 8 (col), bf16 in, float32 sums.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, 2t..), a1 (g + 8, 2t..),
// a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); b0 (k 2t.., n g), b1 (k 2t + 8..,
// n g); d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, 2t, 2t + 1).
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

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes), and receives in
// r[i] elements (2t, g), (2t + 1, g) of matrix i. From a row-major [k][n]
// tile this yields the B fragments (k 16, n 8) of mma, and from a [k][m]
// tile the A fragments of its transpose.
__device__ __forceinline__ void ldsm_x4_trans(const uint16_t* row,
                                              uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ int chunk_rows(const Params& p, int c) {
  return min(p.Q, p.S - c * p.Q);
}
__device__ __forceinline__ size_t bch(const Params& p, int b, int c, int h) {
  return ((size_t)b * p.nc + c) * p.H + h;
}

// ---- 1. prefix sums of dt * a, per (b, chunk, 8 heads), a warp a head --
__global__ void __launch_bounds__(kThreads) ssd_kernel_cumsum(
    const Params p) {
  constexpr int kPer = kMaxQ / 32;    // rows a lane
  const int c = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y * (kThreads / 32) + (threadIdx.x >> 5);
  if (h >= p.H) return;
  const int t0 = c * p.Q, rows = chunk_rows(p, c);
  const int lane = threadIdx.x & 31;
  const float a = p.a[h];
  float v[kPer], pre[kPer];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = lane * kPer + e;
    v[e] = i < rows ? p.dt[((size_t)b * p.S + t0 + i) * p.H + h] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    run += v[e] * a;
    pre[e] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += o;
  }
  const float base = inc - run;
  const size_t o = bch(p, b, c, h) * p.Q;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = lane * kPer + e;
    if (i < p.Q) {
      p.cum[o + i] = base + pre[e];
      p.dtc[o + i] = v[e];
    }
  }
}

// ---- 2. C B^T, per (b, chunk, 64 rows of i), lower triangle ------------
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel_cb(const Params p) {
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int kLd = kMaxN + 8;      // conflict-free fragment loads
  constexpr int kG = kMaxN / 8;       // groups of eight in a row
  extern __shared__ __align__(16) uint16_t smem16[];
  const int i0 = blockIdx.x * kCbRows, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, rows = chunk_rows(p, c);
  if (i0 >= rows) return;
  const int Np = (p.N + 15) & ~15;
  const int j_rows = min(i0 + kCbRows, (rows + 15) & ~15);  // B rows used
  uint16_t* sCh = smem16;                     // [kCbRows][kLd]
  uint16_t* sCl = sCh + kCbRows * kLd;
  uint16_t* sBh = sCl + (kSplit ? kCbRows * kLd : 0);   // [kMaxQ][kLd]
  uint16_t* sBl = sBh + kMaxQ * kLd;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + t0 * p.c_ss;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + t0 * p.b_ss;
  stage<kThreads, Bits8>(
      kCbRows * kG,
      [&](int gi, Bits8& v) {
        const int i = i0 + gi / kG;
        load8_bits<kSplit>(cg + (size_t)i * p.c_ss, (gi % kG) * 8,
                           i < rows ? p.N : 0, p.vec_c, v);
      },
      [&](int gi, const Bits8& v) {
        const int o = (gi / kG) * kLd + (gi % kG) * 8;
        store8(sCh + o, kSplit ? sCl + o : nullptr, v);
      });
  stage<kThreads, Bits8>(
      j_rows * kG,
      [&](int gi, Bits8& v) {
        const int j = gi / kG;
        load8_bits<kSplit>(bg + (size_t)j * p.b_ss, (gi % kG) * 8,
                           j < rows ? p.N : 0, p.vec_b, v);
      },
      [&](int gi, const Bits8& v) {
        const int o = (gi / kG) * kLd + (gi % kG) * 8;
        store8(sBh + o, kSplit ? sBl + o : nullptr, v);
      });
  __syncthreads();

  // warp w: rows 16 (w % 4) .. + 16 of the CTA, key tiles of 8 of parity
  // w / 4
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;
  if (i0 + r0 >= rows) return;
  const int ksteps = Np / 16;
  uint32_t ah[kMaxN / 16][4], al[kMaxN / 16][4];
#pragma unroll
  for (int ks = 0; ks < kMaxN / 16; ++ks) {
    if (ks >= ksteps) break;
    const int k = ks * 16 + 2 * t;
    ah[ks][0] = pair(sCh, r0 + g, kLd, k);
    ah[ks][1] = pair(sCh, r0 + g + 8, kLd, k);
    ah[ks][2] = pair(sCh, r0 + g, kLd, k + 8);
    ah[ks][3] = pair(sCh, r0 + g + 8, kLd, k + 8);
    if (kSplit) {
      al[ks][0] = pair(sCl, r0 + g, kLd, k);
      al[ks][1] = pair(sCl, r0 + g + 8, kLd, k);
      al[ks][2] = pair(sCl, r0 + g, kLd, k + 8);
      al[ks][3] = pair(sCl, r0 + g + 8, kLd, k + 8);
    }
  }
  float* out = p.cb + ((size_t)b * p.nc + c) * p.Qs * p.Qs;
  const int i_last = min(i0 + r0 + 15, rows - 1);
  for (int j0 = 8 * (warp >> 2); j0 <= i_last; j0 += 16) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (ks >= ksteps) break;
      const int k = ks * 16 + 2 * t;
      const uint32_t bh0 = pair(sBh, j0 + g, kLd, k);
      const uint32_t bh1 = pair(sBh, j0 + g, kLd, k + 8);
      mma<kSplit>(d, ah[ks], bh0, bh1);
      if (kSplit) {
        mma<kSplit>(d, al[ks], bh0, bh1);
        mma<kSplit>(d, ah[ks], pair(sBl, j0 + g, kLd, k),
                    pair(sBl, j0 + g, kLd, k + 8));
      }
    }
    const int i = i0 + r0 + g, j = j0 + 2 * t;
    *reinterpret_cast<float2*>(&out[(size_t)i * p.Qs + j]) =
        make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(&out[(size_t)(i + 8) * p.Qs + j]) =
        make_float2(d[2], d[3]);
  }
}

// ---- 3. chunk states, per (b, chunk, h): [N, P] = B^T (x w) ------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_kernel_states(
    const Params p) {
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int kLdX = kMaxP + 8, kLdB = kMaxN + 8;   // ldmatrix rows
  constexpr int kGP = kMaxP / 8, kGN = kMaxN / 8;
  extern __shared__ __align__(16) float smemw[];
  float* sW = smemw;                                       // [kMaxQ]
  uint16_t* sXh = reinterpret_cast<uint16_t*>(sW + kMaxQ);  // x w [j][p]
  uint16_t* sXl = sXh + kJBlock * kLdX;
  uint16_t* sBh = sXl + kJBlock * kLdX;                    // B [j][n]
  uint16_t* sBl = sBh + kJBlock * kLdB;                    // (float32 only)
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, rows = chunk_rows(p, c);
  const int tid = threadIdx.x;
  const size_t o = bch(p, b, c, h);
  {
    const float* cum = p.cum + o * p.Q;
    const float cum_end = cum[p.Q - 1];
    for (int j = tid; j < kMaxQ; j += kThreads)
      sW[j] = j < rows ? p.dtc[o * p.Q + j] * expf(cum_end - cum[j]) : 0.f;
  }
  const T* xg = static_cast<const T*>(p.x) +
                ((size_t)b * p.S + t0) * p.H * p.P + (size_t)h * p.P;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + t0 * p.b_ss;
  const size_t x_row = (size_t)p.H * p.P;

  // warp w: rows n0 .. n0 + 15 of the state, all of P
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, row
  const int n0 = warp * 16;
  const int p_pairs = (p.P + 15) / 16;       // pairs of 8-column tiles
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int jb = 0; jb < rows; jb += kJBlock) {
    __syncthreads();   // sW is ready; the previous block's tiles are used
    stage<kThreads, Floats8>(
        kJBlock * kGP,
        [&](int gi, Floats8& v) {
          const int j = jb + gi / kGP;
          load8(xg + (size_t)j * x_row, (gi % kGP) * 8, j < rows ? p.P : 0,
                p.vec_x, v);
        },
        [&](int gi, const Floats8& v) {
          const int jj = gi / kGP, off = jj * kLdX + (gi % kGP) * 8;
          const float w = sW[jb + jj];
          Bits8 s8;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            split<kSplit>(v.v[u] * w, s8.hi[u], s8.lo[u]);
          store8(sXh + off, sXl + off, s8);
        });
    stage<kThreads, Bits8>(
        kJBlock * kGN,
        [&](int gi, Bits8& v) {
          const int j = jb + gi / kGN;
          load8_bits<kSplit>(bg + (size_t)j * p.b_ss, (gi % kGN) * 8,
                     j < rows ? p.N : 0, p.vec_b, v);
        },
        [&](int gi, const Bits8& v) {
          const int off = (gi / kGN) * kLdB + (gi % kGN) * 8;
          store8(sBh + off, kSplit ? sBl + off : nullptr, v);
        });
    __syncthreads();
    if (n0 >= p.N) continue;
#pragma unroll
    for (int kj = 0; kj < kJBlock; kj += 16) {
      // A = B^T (rows n, k = j) from B [j][n]
      const int a_off = (kj + (lm >> 1) * 8 + lr) * kLdB + n0 + (lm & 1) * 8;
      uint32_t ah[4], al[4];
      ldsm_x4_trans(sBh + a_off, ah);
      if (kSplit) ldsm_x4_trans(sBl + a_off, al);
#pragma unroll
      for (int pp = 0; pp < kMaxP / 16; ++pp) {
        if (pp >= p_pairs) break;
        // B = x w (k = j, n = p) for column tiles 2 pp and 2 pp + 1
        const int b_off = (kj + (lm & 1) * 8 + lr) * kLdX + pp * 16 +
                          (lm >> 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4_trans(sXh + b_off, bh);
        ldsm_x4_trans(sXl + b_off, bl);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float (&d)[4] = acc[2 * pp + u];
          mma<kSplit>(d, ah, bh[2 * u], bh[2 * u + 1]);
          mma<kSplit>(d, ah, bl[2 * u], bl[2 * u + 1]);
          if (kSplit) mma<kSplit>(d, al, bh[2 * u], bh[2 * u + 1]);
        }
      }
    }
  }
  if (n0 >= p.N) return;
  float* out = p.st + o * p.P * p.N;   // [N, P]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int pp = nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {   // rows g and g + 8
      const int n = n0 + g + half * 8;
      const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
      float* dst = out + (size_t)n * p.P + pp;
      if (n >= p.N || pp >= p.P) continue;
      if (pp + 1 < p.P && p.P % 2 == 0) {      // a lane's two columns at once
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (pp + 1 < p.P) dst[1] = v1;
      }
    }
  }
}

// ---- 4. state passing, per (b, h, V elements of [N, P]) ----------------
template <int V>
__global__ void __launch_bounds__(kThreads) ssd_kernel_pass(const Params p) {
  const int pn = p.P * p.N;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * V;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= pn) return;
  const size_t fin = ((size_t)b * p.H + h) * pn + e;   // [B, H, N, P]
  float s[V], nxt[V];
#pragma unroll
  for (int u = 0; u < V; ++u) s[u] = p.init != nullptr ? p.init[fin + u] : 0.f;
  float* slot = p.st + bch(p, b, 0, h) * pn + e;
  const size_t chunk = (size_t)p.H * pn;            // st: one chunk on
  const float* cend = p.cum + bch(p, b, 0, h) * p.Q + p.Q - 1;
  const size_t cchunk = (size_t)p.H * p.Q;          // cum: one chunk on
  auto load = [&](const float* q, float (&v)[V]) {
    if constexpr (V == 4) {
      const float4 f = *reinterpret_cast<const float4*>(q);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
      v[0] = q[0];
    }
  };
  auto store = [&](float* q, const float (&v)[V]) {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    else
      q[0] = v[0];
  };
  load(slot, nxt);
  float gn = cend[0];
  for (int c = 0; c < p.nc; ++c) {   // the next chunk's loads go first
    float cur[V];
#pragma unroll
    for (int u = 0; u < V; ++u) cur[u] = nxt[u];
    const float g = expf(gn);
    if (c + 1 < p.nc) {
      load(slot + (c + 1) * chunk, nxt);
      gn = cend[(c + 1) * cchunk];
    }
    store(slot + c * chunk, s);
#pragma unroll
    for (int u = 0; u < V; ++u) s[u] = s[u] * g + cur[u];
  }
  store(p.state + fin, s);
}

// ---- 5. outputs, per (b, chunk, h) --------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 3) ssd_kernel_out(const Params p) {
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int kLdX = kMaxP + 8;               // ldmatrix rows, [k][p]
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) float smemf[];
  float* sCD = smemf;                           // [kMaxQ][2]: cum_j, dt_j
  uint16_t* sSh = reinterpret_cast<uint16_t*>(sCD + 2 * kMaxQ);
  uint16_t* sSl = sSh + kMaxN * kLdX;           // S_prev [n][p]
  uint16_t* sXh = sSl + kMaxN * kLdX;           // x [j][p]
  uint16_t* sXl = sXh + kMaxQ * kLdX;           // (float32 only)

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, rows = chunk_rows(p, c);
  const int tid = threadIdx.x;
  const size_t o = bch(p, b, c, h);
  const bool has_prev = c > 0 || p.init != nullptr;
  const int Np = (p.N + 15) & ~15, Pp = (p.P + 7) & ~7;
  const int rows16 = (rows + 15) & ~15;
  for (int i = tid; i < kMaxQ; i += kThreads) {
    sCD[2 * i] = i < p.Q ? p.cum[o * p.Q + i] : 0.f;
    sCD[2 * i + 1] = i < p.Q ? p.dtc[o * p.Q + i] : 0.f;
  }
  const T* xg = static_cast<const T*>(p.x) +
                ((size_t)b * p.S + t0) * p.H * p.P + (size_t)h * p.P;
  const size_t x_row = (size_t)p.H * p.P;
  constexpr int kGP = kMaxP / 8;
  stage<kThreads, Bits8>(
      rows16 * kGP,
      [&](int gi, Bits8& v) {
        const int j = gi / kGP;
        load8_bits<kSplit>(xg + (size_t)j * x_row, (gi % kGP) * 8,
                           j < rows ? p.P : 0, p.vec_x, v);
      },
      [&](int gi, const Bits8& v) {
        const int off = (gi / kGP) * kLdX + (gi % kGP) * 8;
        store8(sXh + off, kSplit ? sXl + off : nullptr, v);
      });
  if (has_prev) {
    const float* sp = p.st + o * p.P * p.N;   // the state entering chunk c
    stage<kThreads, Bits8>(
        Np * kGP,
        [&](int gi, Bits8& v) {
          const int n = gi / kGP;
          load8_bits<kSplit>(sp + (size_t)n * p.P, (gi % kGP) * 8,
                             n < p.N ? p.P : 0, p.P % 8 == 0, v);
        },
        [&](int gi, const Bits8& v) {
          const int off = (gi / kGP) * kLdX + (gi % kGP) * 8;
          store8(sSh + off, sSl + off, v);
        });
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, row
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + t0 * p.c_ss;
  const float* cb = p.cb + ((size_t)b * p.nc + c) * p.Qs * p.Qs;
  float* yg = p.y + ((size_t)b * p.S + t0) * x_row + (size_t)h * p.P;
  const int n_tiles = Pp / 8, p_pairs = (Pp + 15) / 16;
  for (int half = 0; half < 2; ++half) {
    const int mt = half == 0 ? warp : 15 - warp;
    const int i0 = mt * 16;
    if (i0 >= rows) continue;
    const int ra = i0 + g, rb = i0 + g + 8;    // this thread's two rows
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

    // A fragment register q of a k step holds the column pair
    // k0 + 2t + 8 (q >> 1) (+1) of row (q & 1 ? rb : ra)
    if (has_prev) {   // acc = C S_prev, then times exp(cum_i)
      uint32_t nh[4], nl[4];
      auto load_c = [&](int k0, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = (q & 1) ? rb : ra;
          load_pair_bits<kSplit>(cg + (size_t)r * p.c_ss,
                                 k0 + 2 * t + 8 * (q >> 1),
                                 r < rows ? p.N : 0, p.vec_c, hi[q], lo[q]);
        }
      };
      load_c(0, nh, nl);
      for (int k0 = 0; k0 < Np; k0 += 16) {
        const uint32_t ah[4] = {nh[0], nh[1], nh[2], nh[3]};
        const uint32_t al[4] = {nl[0], nl[1], nl[2], nl[3]};
        if (k0 + 16 < Np) load_c(k0 + 16, nh, nl);   // the next step's loads
#pragma unroll
        for (int pp = 0; pp < kMaxP / 16; ++pp) {
          if (pp >= p_pairs) break;
          // B = S_prev (k = n, n = p), column tiles 2 pp and 2 pp + 1
          const int b_off = (k0 + (lm & 1) * 8 + lr) * kLdX + pp * 16 +
                            (lm >> 1) * 8;
          uint32_t bh[4], bl[4];
          ldsm_x4_trans(sSh + b_off, bh);
          ldsm_x4_trans(sSl + b_off, bl);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float (&d)[4] = acc[2 * pp + u];
            mma<kSplit>(d, ah, bh[2 * u], bh[2 * u + 1]);
            mma<kSplit>(d, ah, bl[2 * u], bl[2 * u + 1]);
            if (kSplit) mma<kSplit>(d, al, bh[2 * u], bh[2 * u + 1]);
          }
        }
      }
      const float ea = expf(sCD[2 * ra]), eb = expf(sCD[2 * rb]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= ea;
        acc[nt][1] *= ea;
        acc[nt][2] *= eb;
        acc[nt][3] *= eb;
      }
    }

    // acc += (C B^T o L o dt) x over the key tiles j0 <= i0. C B^T rows
    // are 16-byte aligned (Qs % 16 == 0), so a column pair is one float2;
    // below the diagonal tile every (i, j) is causal and cum_i <= cum_j.
    const float cum_a = sCD[2 * ra], cum_b = sCD[2 * rb];
    float2 nq[4];
    auto load_cb = [&](int j0, float2 (&v)[4]) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = (q & 1) ? rb : ra;
        const int j = j0 + 2 * t + 8 * (q >> 1);
        v[q] = j <= r && r < rows
                   ? *reinterpret_cast<const float2*>(&cb[(size_t)r * p.Qs + j])
                   : make_float2(0.f, 0.f);
      }
    };
    load_cb(0, nq);
    for (int j0 = 0; j0 <= i0; j0 += 16) {
      float2 cq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) cq[q] = nq[q];
      if (j0 + 16 <= i0) load_cb(j0 + 16, nq);   // the next step's loads
      const bool diag = j0 == i0;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = (q & 1) ? rb : ra;
        const float ci = (q & 1) ? cum_b : cum_a;
        const int j = j0 + 2 * t + 8 * (q >> 1);
        // (cum_j, dt_j, cum_j+1, dt_j+1)
        const float4 cd = *reinterpret_cast<const float4*>(&sCD[2 * j]);
        float v0 = cq[q].x * exp2f((ci - cd.x) * kLog2e) * cd.y;
        float v1 = cq[q].y * exp2f((ci - cd.z) * kLog2e) * cd.w;
        if (diag) {   // L: j <= i (the exponent may overflow above it)
          v0 = j <= r ? v0 : 0.f;
          v1 = j + 1 <= r ? v1 : 0.f;
        }
        split2<kSplit>(v0, v1, ah[q], al[q]);
      }
#pragma unroll
      for (int pp = 0; pp < kMaxP / 16; ++pp) {
        if (pp >= p_pairs) break;
        // B = x (k = j, n = p), column tiles 2 pp and 2 pp + 1
        const int b_off = (j0 + (lm & 1) * 8 + lr) * kLdX + pp * 16 +
                          (lm >> 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4_trans(sXh + b_off, bh);
        if (kSplit) ldsm_x4_trans(sXl + b_off, bl);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float (&d)[4] = acc[2 * pp + u];
          mma<kSplit>(d, ah, bh[2 * u], bh[2 * u + 1]);
          mma<kSplit>(d, al, bh[2 * u], bh[2 * u + 1]);
          if (kSplit) mma<kSplit>(d, ah, bl[2 * u], bl[2 * u + 1]);
        }
      }
    }

#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= n_tiles) break;
      const int pp = nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {   // rows ra and rb
        const int r = half ? rb : ra;
        const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
        float* dst = yg + (size_t)r * x_row + pp;
        if (r >= rows || pp >= p.P) continue;
        if (pp + 1 < p.P && p.P % 2 == 0) {    // a lane's two columns at once
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (pp + 1 < p.P) dst[1] = v1;
        }
      }
    }
  }
}

size_t cb_smem_bytes(bool split_in) {
  const size_t plane = (size_t)(kCbRows + kMaxQ) * (kMaxN + 8);
  return (split_in ? 2 : 1) * plane * sizeof(uint16_t);
}

size_t states_smem_bytes(bool split_in) {
  return kMaxQ * sizeof(float) +
         (2 * (size_t)kJBlock * (kMaxP + 8) +
          (split_in ? 2 : 1) * (size_t)kJBlock * (kMaxN + 8)) *
             sizeof(uint16_t);
}

size_t out_smem_bytes(bool split_in) {
  return 2 * kMaxQ * sizeof(float) +
         (2 * (size_t)kMaxN + (split_in ? 2 : 1) * (size_t)kMaxQ) *
             (kMaxP + 8) * sizeof(uint16_t);
}

template <typename T>
int launch_all(const Params& p, cudaStream_t st) {
  constexpr bool kSplit = sizeof(T) == 4;
  ssd_kernel_cumsum<<<dim3(p.nc, (p.H + 7) / 8, p.B), kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t cb_smem = cb_smem_bytes(kSplit);
  err = cudaFuncSetAttribute(ssd_kernel_cb<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cb_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel_cb<T><<<dim3((p.Q + kCbRows - 1) / kCbRows, p.nc, p.B),
                     kThreads, cb_smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t states_smem = states_smem_bytes(kSplit);
  err = cudaFuncSetAttribute(ssd_kernel_states<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)states_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel_states<T><<<dim3(p.H, p.nc, p.B), kThreads, states_smem, st>>>(
      p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((p.P * p.N) % 4 == 0)
    ssd_kernel_pass<4><<<dim3((p.P * p.N / 4 + kThreads - 1) / kThreads, p.H,
                              p.B), kThreads, 0, st>>>(p);
  else
    ssd_kernel_pass<1><<<dim3((p.P * p.N + kThreads - 1) / kThreads, p.H,
                              p.B), kThreads, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t out_smem = out_smem_bytes(kSplit);
  err = cudaFuncSetAttribute(ssd_kernel_out<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)out_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel_out<T><<<dim3(p.H, p.nc, p.B), kThreads, out_smem, st>>>(p);
  return (int)cudaGetLastError();
}

// float32 scratch of one call, in the order cum, dtc, cb, st, each rounded
// up to 64 floats (256 bytes): nc = ceil(S / Q), Qs = Q rounded up to 16
size_t scratch_layout(int B, int S, int H, int P, int N, int Q,
                      size_t (&off)[4]) {
  const size_t nc = (S + Q - 1) / Q, qs = (Q + 15) & ~15;
  const size_t sizes[4] = {B * nc * H * Q, B * nc * H * Q, B * nc * qs * qs,
                           B * nc * H * P * N};
  size_t total = 0;
  for (int i = 0; i < 4; ++i) {
    off[i] = total;
    total += (sizes[i] + 63) & ~(size_t)63;
  }
  return total;
}

}  // namespace

extern "C" {

// Floats of scratch that ssd_launch needs for these shapes.
long long ssd_scratch_floats(int B, int S, int H, int P, int N, int Q) {
  size_t off[4];
  return (long long)scratch_layout(B, S, H, P, N, Q, off);
}

// Returns a cudaError_t code (0 on success), or -1 for shapes the kernels
// are not built for (P > 64, N > 128, Q > 256). Launches on `stream` and
// does not synchronise. `init` may be null (zero initial state).
// `scratch`: ssd_scratch_floats(...) float32 values from the caller.
int ssd_launch(const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, const float* init, float* y, float* state,
               float* scratch, int B, int S, int H, int P, int N, int Q,
               long long b_sb, long long b_ss, long long c_sb,
               long long c_ss, int bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ)
    return -1;
  const int nc = (S + Q - 1) / Q, Qs = (Q + 15) & ~15;
  size_t off[4];
  scratch_layout(B, S, H, P, N, Q, off);
  // 16-byte loads of rows: aligned starts and strides, widths % 8 == 0
  const size_t es = bf16 ? 2 : 4;
  auto a16 = [](const void* q) { return (uintptr_t)q % 16 == 0; };
  const int vec_x = P % 8 == 0 && a16(x);
  const int vec_b = N % 8 == 0 && a16(bm) && (b_sb * es) % 16 == 0 &&
                    (b_ss * es) % 16 == 0;
  const int vec_c = N % 8 == 0 && a16(cm) && (c_sb * es) % 16 == 0 &&
                    (c_ss * es) % 16 == 0;
  const Params p{x,    dt,   a,    bm,   cm,    init,  y,
                 state, scratch + off[0], scratch + off[1],
                 scratch + off[2], scratch + off[3],
                 B,    S,    H,    P,    N,     Q,     nc,
                 Qs,   b_sb, b_ss, c_sb, c_ss,  vec_x, vec_b,
                 vec_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_all<uint16_t>(p, s) : launch_all<float>(p, s);
}

}  // extern "C"
