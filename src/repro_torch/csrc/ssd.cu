// Mamba2 SSD chunk scan for Hopper (sm_90a), state-space duality
// (arXiv:2405.21060, Alg. 1 'chunked' form).
//
// Replaces the Pallas TPU kernel `ssd_pallas` / `_ssd_kernel` in
// src/repro/kernels/ssd/kernel.py (:85). Semantics are those of `ssd_ref`
// (src/repro/kernels/ssd/ref.py, the model's `ssd_chunked`), with every
// sum in float32: for each batch row b and head h, S is cut into chunks
// of q = min(chunk, S) rows (the last one ragged; rows past S act as
// dt = 0, which leaves the scan unchanged), and for each chunk, with
// cum the inclusive prefix sum of dt * a over the chunk,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . S_prev
//   S_new = S_prev exp(cum_end) + sum_j B_j (x_j dt_j exp(cum_end - cum_j))
// from S = initial_state (or zero). Outputs y [B, S, H, P] and the final
// state [B, H, N, P], both float32.
//
// What bounds it on the H100: the least work reads x, dt, B and C once
// and writes y and the state once; C B^T is shared by all heads (one
// group), so the least arithmetic is about 2 q N per row and head for
// the two state terms plus q P for the intra-chunk product. At full
// width (P = 64, N = 128, q = 256) and bf16 inputs that is under 130
// operations per byte, below the ~295 where the tensor cores would bound
// it: the bound is the bytes, about 0.1 ms for B = 4, S = 4,096. This
// kernel does not reach it: it recomputes C B^T for every head and slice
// of P, with plain float32 FMAs on the CUDA cores, so it is bound by
// those FMAs and by their shared-memory operand loads.
//
// Design. The TPU kernel keeps the state in VMEM across a sequential
// chunk grid axis. Hopper's blocks run in no order, so here:
//   * one block of 256 threads owns (b, h, a slice of PS columns of P)
//     and walks the chunks itself, with the [N, PS] state in shared
//     memory; the columns of P are independent given C B^T, dt and the
//     decays, so the wrapper cuts P into slices (64, 32 or 16 columns)
//     until the blocks fill the card (48 heads at batch 1 -> 192 blocks);
//   * a chunk is walked in tiles of 64 query rows against 64 key rows,
//     lower triangle only: C and B tiles are held transposed ([N][65],
//     conflict-free) in shared memory, each thread computes a 4 x 4 tile
//     of C B^T, scales it by the decay and dt into a [64][65] score
//     tile, and the y tile accumulates score x X in registers;
//   * every y row tile takes the carried-state term from the old state,
//     then one more pass over the chunk's key tiles updates the state.
// bf16 inputs are widened exactly (bits << 16); all arithmetic is
// float32. Tensor cores (mma/wgmma on bf16 tiles) and one C B^T shared
// across the heads are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows of a query or key tile
constexpr int kLd = kTile + 1;     // row stride of [N][64] and [64][64] tiles
constexpr int kMaxQ = 256;         // chunk length (one row per thread)
constexpr int kMaxN = 128;         // state dim
constexpr int kMaxP = 64;          // head dim
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxQ == kThreads, "the prefix sum gives one row per thread");

struct Params {
  const void* x;        // [B, S, H, P], contiguous
  const float* dt;      // [B, S, H], contiguous
  const float* a;       // [H]
  const void* bm;       // B: [B, S, N], unit stride over N
  const void* cm;       // C: [B, S, N], unit stride over N
  const float* init;    // [B, H, N, P] or null (zero)
  float* y;             // [B, S, H, P]
  float* state;         // [B, H, N, P]
  int B, S, H, P, N, Q;
  long long b_sb, b_ss, c_sb, c_ss;   // batch and row strides of B and C
};

__device__ __forceinline__ float widen(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float widen(const uint16_t* p, size_t i) {
  return __uint_as_float(static_cast<unsigned>(p[i]) << 16);
}

size_t smem_floats(int n, int ps) {
  return 2 * (size_t)n * kLd      // C and B tiles, transposed
         + (size_t)kTile * kLd    // score tile
         + (size_t)kTile * ps     // x tile
         + (size_t)n * ps         // carried state
         + 2 * (size_t)kMaxQ;     // cum and dt of the chunk
}

// dst[n][r] = src row (t + r), column n, for r < nrows; zero past them
template <typename T>
__device__ __forceinline__ void load_rows_t(const T* src, long long stride,
                                            int t, int nrows, int n_cols,
                                            float* dst) {
  for (int i = threadIdx.x; i < kTile * n_cols; i += kThreads) {
    const int r = i / n_cols, n = i - r * n_cols;
    dst[n * kLd + r] =
        r < nrows ? widen(src, (size_t)(t + r) * stride + n) : 0.f;
  }
}

template <typename T, int PS>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const Params p) {
  constexpr int TC = PS / 4;                  // threads along columns
  constexpr int TR = kThreads / TC;           // threads along rows
  constexpr int YR = kTile / TR;              // y rows per thread
  constexpr int NR = (kMaxN + TR - 1) / TR;   // state rows per thread
  static_assert(PS % 4 == 0 && kTile % TR == 0, "unsupported slice");

  extern __shared__ float smem[];
  __shared__ float s_warp[kThreads / 32];
  const int N = p.N;
  float* sCt = smem;                   // [N][kLd]   C tile, transposed
  float* sBt = sCt + N * kLd;          // [N][kLd]   B tile, transposed
  float* sSc = sBt + N * kLd;          // [kTile][kLd] scores
  float* sX = sSc + kTile * kLd;       // [kTile][PS] x tile (or weighted)
  float* sS = sX + kTile * PS;         // [N][PS]    carried state
  float* sCum = sS + N * PS;           // [kMaxQ]
  float* sDt = sCum + kMaxQ;           // [kMaxQ]

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % TC, ty = tid / TC;     // y and state tiles
  const int cx = tid % 16, cy = tid / 16;     // 4 x 4 tiles of C B^T
  const float a = p.a[h];
  const size_t row = (size_t)p.H * p.P;       // x and y: row t to t + 1
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * p.S * row +
                (size_t)h * p.P;
  const T* bb = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* cb = static_cast<const T*>(p.cm) + b * p.c_sb;
  const float* dtb = p.dt + (size_t)b * p.S * p.H + h;
  float* yb = p.y + (size_t)b * p.S * row + (size_t)h * p.P;
  const size_t st_base = ((size_t)b * p.H + h) * N * p.P + p0;

  for (int i = tid; i < N * PS; i += kThreads) {
    const int n = i / PS, c = i - n * PS;
    sS[i] = (p.init != nullptr && p0 + c < p.P)
                ? p.init[st_base + (size_t)n * p.P + c] : 0.f;
  }

  // x rows t .. t + nrows - 1 of this slice into sX; with `weighted`,
  // times dt_j exp(cum_end - cum_j) (j = chunk row)
  auto load_x = [&](int t, int j0, int nrows, bool weighted,
                    float cum_end) {
    for (int i = tid; i < kTile * PS; i += kThreads) {
      const int r = i / PS, c = i - r * PS;
      float v = 0.f;
      if (r < nrows && p0 + c < p.P) {
        v = widen(xb, (size_t)(t + r) * row + p0 + c);
        if (weighted)
          v *= sDt[j0 + r] * expf(cum_end - sCum[j0 + r]);
      }
      sX[i] = v;
    }
  };

  const int n_chunks = (p.S + p.Q - 1) / p.Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * p.Q;
    const int rows = min(p.Q, p.S - t0);
    __syncthreads();   // the previous chunk is done with sCum, sDt, sS

    // inclusive prefix sum of dt * a over the chunk, one row per thread
    {
      const float dtv = tid < rows ? dtb[(size_t)(t0 + tid) * p.H] : 0.f;
      float v = dtv * a;
      const int lane = tid & 31, w = tid >> 5;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += o;
      }
      if (lane == 31) s_warp[w] = v;
      sDt[tid] = dtv;
      __syncthreads();
      float base = 0.f;
      for (int i = 0; i < w; ++i) base += s_warp[i];
      sCum[tid] = base + v;
    }
    __syncthreads();
    const float cum_end = sCum[rows - 1];
    const int n_tiles = (rows + kTile - 1) / kTile;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      load_rows_t(cb, p.c_ss, t0 + i0, rows - i0, N, sCt);
      float acc[YR][4];
#pragma unroll
      for (int r = 0; r < YR; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        load_rows_t(bb, p.b_ss, t0 + j0, rows - j0, N, sBt);
        load_x(t0 + j0, j0, rows - j0, false, 0.f);
        __syncthreads();
        // scores[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i
        {
          float s[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) s[r][k] = 0.f;
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              cv[k] = sCt[n * kLd + cy + 16 * k];
              bv[k] = sBt[n * kLd + cx + 16 * k];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int k = 0; k < 4; ++k) s[r][k] = fmaf(cv[r], bv[k], s[r][k]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + cy + 16 * r;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int j = j0 + cx + 16 * k;
              sSc[(cy + 16 * r) * kLd + cx + 16 * k] =
                  (j <= i && i < rows)
                      ? s[r][k] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
            }
          }
        }
        __syncthreads();
        // y_i += scores[i][:] x[:]
        for (int j = 0; j < kTile; ++j) {
          float xv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) xv[k] = sX[j * PS + tx + TC * k];
#pragma unroll
          for (int r = 0; r < YR; ++r) {
            const float sv = sSc[(ty + TR * r) * kLd + j];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(sv, xv[k], acc[r][k]);
          }
        }
        __syncthreads();   // before the next key tile overwrites the tiles
      }

      // y_i += exp(cum_i) C_i . S_prev, then write the row tile
      float o[YR][4];
#pragma unroll
      for (int r = 0; r < YR; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) o[r][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float sv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) sv[k] = sS[n * PS + tx + TC * k];
#pragma unroll
        for (int r = 0; r < YR; ++r) {
          const float cv = sCt[n * kLd + ty + TR * r];
#pragma unroll
          for (int k = 0; k < 4; ++k) o[r][k] = fmaf(cv, sv[k], o[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < YR; ++r) {
        const int i = i0 + ty + TR * r;
        if (i >= rows) continue;
        const float e = expf(sCum[i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = p0 + tx + TC * k;
          if (c < p.P) yb[(size_t)(t0 + i) * row + c] = acc[r][k] + o[r][k] * e;
        }
      }
      __syncthreads();   // before the next query tile overwrites sCt
    }

    // S <- S exp(cum_end) + sum_j B_j (x_j dt_j exp(cum_end - cum_j))
    float u[NR][4];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) u[r][k] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile;
      load_rows_t(bb, p.b_ss, t0 + j0, rows - j0, N, sBt);
      load_x(t0 + j0, j0, rows - j0, true, cum_end);
      __syncthreads();
      for (int j = 0; j < kTile; ++j) {
        float xv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = sX[j * PS + tx + TC * k];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int n = ty + TR * r;
          if (n < N) {
            const float bv = sBt[n * kLd + j];
#pragma unroll
            for (int k = 0; k < 4; ++k) u[r][k] = fmaf(bv, xv[k], u[r][k]);
          }
        }
      }
      __syncthreads();
    }
    // each thread rewrites only the state entries it alone reads here
    const float g = expf(cum_end);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int n = ty + TR * r;
      if (n < N) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float& sv = sS[n * PS + tx + TC * k];
          sv = sv * g + u[r][k];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * PS; i += kThreads) {
    const int n = i / PS, c = i - n * PS;
    if (p0 + c < p.P) p.state[st_base + (size_t)n * p.P + c] = sS[i];
  }
}

template <typename T, int PS>
int launch(const Params& p, cudaStream_t st) {
  const size_t smem = smem_floats(p.N, PS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.P + PS - 1) / PS, p.H, p.B);
  ssd_kernel<T, PS><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int by_slice(const Params& p, int ps, cudaStream_t st) {
  switch (ps) {
    case 16: return launch<T, 16>(p, st);
    case 32: return launch<T, 32>(p, st);
    case 64: return launch<T, 64>(p, st);
  }
  return -1;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success), or -1 for shapes the kernel
// is not built for (P > 64, N > 128, Q > 256, a slice other than 16, 32
// or 64). Launches on `stream` and does not synchronise. `init` may be
// null (zero initial state).
int ssd_launch(const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, const float* init, float* y, float* state,
               int B, int S, int H, int P, int N, int Q, long long b_sb,
               long long b_ss, long long c_sb, long long c_ss, int bf16,
               int ps, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ)
    return -1;
  const Params p{x, dt, a, bm, cm, init, y, state, B, S, H, P, N, Q,
                 b_sb, b_ss, c_sb, c_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? by_slice<uint16_t>(p, ps, st) : by_slice<float>(p, ps, st);
}

}  // extern "C"
