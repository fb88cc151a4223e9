// Asymmetric float32-query x int8-row distance scan for Hopper (sm_90a),
// on bf16 tensor cores.
//
// Replaces the Pallas TPU kernel `quant_distance_pallas` /
// `_quant_distance_kernel` in src/repro/kernels/quant_distance/kernel.py
// (:52). Semantics are the TPU kernel's: every row is dequantized as
// x = c * scale + zero (one multiply, then one add, each rounded, as the
// plain version `quant_scores_ref` computes it), and for q [B, d] against
// rows [n, d] the output [B, n] float32 holds
//   l2:      2 q.x - |q|^2 - |x|^2
//   ip:      q.x
//   angular: q.x / ((|q| + 1e-12) (|x| + 1e-12))
//
// What bounds it on the H100. The least work reads the codes (n d bytes)
// and the queries once and writes the [B, n] float32 output once. At the
// main path's shape (B = 1,024, n = 50,000, d = 128) that is 0.21 GB,
// 0.063 ms at 3.35 TB/s. The products: 2 B n d = 13.1 GFLOP, 0.196 ms as
// float32 FMAs at 67 TFLOP/s (the bound of the CUDA-core kernel this file
// replaced); on the tensor cores in three bf16 pieces, as below, 3 x 2 B n
// d = 39.3 GFLOP, 0.040 ms at 989 TFLOP/s. So the bytes bound it, and the
// largest of them are the float32 scores written.
//
// Precision. q.x = sum_k u_k c_k + q.z, with u = q o scale (one rounded
// multiply a column). An int8 code is an integer in [-128, 127], exact in
// bf16. The tensor cores round each product's float32 sum toward zero, so
// a dot product chained through one accumulator drifts by up to an ulp of
// the running sum an instruction (about 1.2e-4 at |q|^2 ~ 128 over the 24
// products of d = 128, enough to swap rows 3.4e-5 apart). The query side
// is therefore split in fixed point: each query's u is scaled by one power
// of two, v = u 2^-E with |v| < 1 (E from the largest |u_k| of the row),
// and v is cut into three pieces on fixed grids, v1 = rint(v 2^8) 2^-8,
// v2 = rint((v - v1) 2^16) 2^-16, v3 = rint((v - v1 - v2) 2^24) 2^-24,
// each an integer of at most 8 bits on its grid (exact in bf16), together
// within 2^-25 of v. A product v1 c is an integer times 2^-8 of at most
// 15 bits, so the sum of 128 of them (22 bits) is exact in float32 in any
// order and under any rounding: v1 has an accumulator of its own, chained
// over the slice's k-steps, and is exact. v2 and v3 share a second one,
// 2^-8 as large, whose truncations are below 2^-30 of the dot product.
// The epilogue joins them with the norms without a rounding at the scale
// of |q|^2 where the scores are near: |q|^2, q.z and |x|^2 (from the
// rounded x_k, as the plain version rounds them) are summed in float64;
// T = 2^(E+1) times the v1 sum is exact and a multiple of 2^(E-7), and
// |q|^2 is held as its nearest multiple of 2^(E-7) plus a remainder, so
// T - |q|^2 is exact, and minus |x|^2 it is exact again wherever the score
// is small against |x|^2 (Sterbenz); the small terms (2^(E+1) times the
// v2, v3 sum, 2 q.z, the remainders) join last. Slices of 128 columns (d
// > 128) still meet in float32, rounded to nearest.

// Design: one persistent block an SM, warp-specialized, tensor copies in
// and out.
//   * A block of 12 warps owns 128 queries and walks row tiles of 64 rows,
//     blockIdx.x, + gridDim.x, ... (gridDim.x from the SM count). Warps
//     0-7 are two consumer warpgroups (64 queries each: the products and
//     the epilogue), warps 8-11 the producer warpgroup (copies and the
//     conversion). `setmaxnreg` moves registers from the producer (88) to
//     the consumers (208).
//   * d is cut into slices of 128 columns (padded with zero codes and zero
//     query pieces up to a multiple of 16); a stage is one (row tile,
//     slice). Up to d = 128 each consumer warp keeps the three pieces of
//     its 16 queries over the whole of d in registers (96 a thread, in the
//     wgmma A-fragment layout) for the whole kernel; above, it rebuilds
//     them from q and scale for each slice of each tile.
//   * Producer: a stage's 64 x 128 int8 codes come by one 2-D tensor copy
//     (TMA, 128-byte swizzle, zeros past n and d) into a ring of three
//     slots, completion on an mbarrier; when d % 16 != 0 the rows are not
//     16-byte aligned and the producer loads them itself. Scale and zero
//     are loaded once. Each stage is converted from int8 to bf16 into one
//     of two shared tiles in the 128-byte swizzle the tensor cores read (two
//     halves of 64 columns, rows of 128 bytes, 16-byte chunk c of row r at
//     c ^ (r % 8)): a code pair becomes a bf16 pair in four instructions (a
//     byte permute, two masks, one bf16x2 fma; exact). The same threads sum
//     |x|^2 of their half rows in float64 from the rounded x_k (l2 and
//     angular); the halves meet in a shuffle, and the row keeps |x|^2 as a
//     float32 pair (high, low).
//   * Named barriers pass the bf16 tiles: full (producer -> each consumer
//     warpgroup) and empty (each consumer warpgroup -> producer).
//   * Products: `wgmma` m64n64k16 bf16 -> float32, A (the query pieces)
//     from registers, B (the bf16 codes) from shared memory. The two
//     consumer warpgroups take turns (ping-pong): one issues its 24
//     products of a stage while the other runs its epilogue. The k-steps
//     of 16 go in order; within one, v3 and v2 into the small accumulator,
//     then v1 into its own.
//   * The largest |u_k|, |q|^2 and q.z of a query are found once per block
//     by the four lanes of a quad over their fragment columns (slice by
//     slice, k-step by k-step, columns 2t, 2t + 1, 2t + 8, 2t + 9; the
//     sums in float64), then reduced across the quad (lanes t, t^1, then
//     pairs t, t^2).
//   * Epilogue, per warp: the two accumulators, q.z and the norms joined
//     as above, the metric in registers (angular multiplies the dot
//     product by 1 / (|q| + 1e-12) and 1 / (|x| + 1e-12)), the
//     warp's 16 x 64 scores into its own staging boxes, then two 2-D tensor
//     stores (16 x 32 boxes, L2 evict-first: the scores are written once)
//     when n % 4 == 0, else 4-byte streaming stores. The stores drain while
//     the warp's next products run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 8;             // two warpgroups: products
constexpr int kProducerThreads = 128;         // one warpgroup: copies
constexpr int kThreads = 32 * kConsumerWarps + kProducerThreads;
constexpr int kTileQ = 16 * kConsumerWarps;   // queries of a block
constexpr int kTileN = 64;                    // rows of a tile
constexpr int kSlice = 128;                   // columns of d a stage holds
constexpr int kSteps = kSlice / 16;           // mma k-steps of a slice
constexpr int kNTiles = kTileN / 8;           // mma n-tiles of a row tile
constexpr int kStages = 3;                    // int8 ring
constexpr int kBufs = 3;                      // bf16 tiles
constexpr int kCodeBytes = kTileN * kSlice;   // 8 KB of codes a stage
// a ring slot holds a stage's codes, one tensor-copy box of 64 rows x 128
// bytes in the 128-byte swizzle (1 KB aligned)
constexpr int kSlotBytes = kCodeBytes;
// scale and zero are held for up to kSzSlices slices (d <= 8,192), loaded
// once; above that, one slice's at a time
constexpr int kSzSlices = 64;
constexpr int kHalfBytes = kTileN * 128;      // a half slice in bf16, 8 KB
constexpr int kBfBytes = 2 * kHalfBytes;      // a slice in bf16, 16 KB
// a warp's staging rows: 16 x kTileN float32 scores as boxes of 16 x 32
// (2 KB each, 1 KB aligned) in the 128-byte swizzle the tensor store reads
constexpr int kBoxCols = 32;
constexpr int kStagingFloats = 16 * kTileN;
// shared memory: 1 KB to align what follows, the bf16 tiles, the staging
// boxes, the ring, its mbarriers (64 bytes), the rows' norms of 4 tiles
// (a float2 a row)
constexpr size_t kSmemFixed =
    1024 + kBufs * kBfBytes + (size_t)kConsumerWarps * kStagingFloats * 4 +
    (size_t)kStages * kSlotBytes + 64 + 4 * kTileN * 8;
// + scale and zero, 1 KB a slice held
constexpr size_t kSmemMax = kSmemFixed + (size_t)kSzSlices * 2 * kSlice * 4;
constexpr float kEps = 1e-12f;                // angular epsilon

constexpr int kRowThreads = 2;                // producer threads a row
constexpr int kRowChunks = 8 / kRowThreads;   // 16-code chunks a thread
static_assert(kProducerThreads == kRowThreads * kTileN, "rows a stage");
// named barriers (0 is __syncthreads), each of the producer and one
// consumer warpgroup w: tile b full (kBarFull + 2 b + w, producer ->
// consumers), tile b empty (kBarEmpty + 2 b + w, consumers -> producer);
// the producer's own; and the consumers' turns at the tensor cores
// (kBarTurn + w)
constexpr int kBarFull = 1, kBarEmpty = 1 + 2 * kBufs;
constexpr int kBarProducer = 1 + 4 * kBufs, kBarTurn = kBarProducer + 1;
static_assert(kBarTurn + 1 < 16, "16 named barriers");
constexpr int kPair = kProducerThreads + 128;   // producer + one consumer
constexpr int kConsumers = 32 * kConsumerWarps;

#ifdef QUANT_PROFILE
// profiling builds: for each of the first kProfBlocks blocks and each warp,
// lane 0's SM cycles in each phase, summed over the block's stages.
// Consumers: 0 waiting for a tile and their turn, 1 the products, 2 the
// epilogue;
// producer: 0 waiting (its copies, a free tile), 1 the conversion, 2 its
// own barrier and issuing the next copy; 3 the whole kernel.
constexpr int kProfBlocks = 1024;
constexpr int kPhases = 4;
__device__ unsigned long long g_prof[kProfBlocks][kThreads / 32][kPhases];
#define PROF_START()                                                      \
  const size_t prof_blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;    \
  const long long prof_t0 = clock64();                                    \
  long long prof_t = prof_t0
#define PROF(ph)                                                          \
  if (lane == 0 && prof_blk < kProfBlocks) {                              \
    const long long now = clock64();                                      \
    g_prof[prof_blk][warp][ph] += now - prof_t;                           \
    prof_t = now;                                                         \
  }
#define PROF_END()                                                        \
  if (lane == 0 && prof_blk < kProfBlocks)                                \
    g_prof[prof_blk][warp][3] = clock64() - prof_t0
#else
#define PROF_START()
#define PROF(ph)
#define PROF_END()
#endif

struct Args {
  const float* q;          // [B, d]
  const int8_t* codes;     // [n, d]
  const float* scale;      // [d]
  const float* zero;       // [d]
  float* out;              // [B, n]
  int B, n, d, metric;     // metric: 0 l2, 1 ip, 2 angular
  int ns;                  // slices of d
  int rtiles;              // row tiles
  int vec_codes;           // d % 16 == 0 and codes 16-byte aligned
  int vec_out;             // n % 4 == 0 and out 16-byte aligned
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// (v0, v1), each |v| < 1, as three packed bf16 pairs of fixed-point pieces
// (v0 in the low half): p1 on the grid 2^-8, p2 on 2^-16, p3 on 2^-24, each
// an integer of at most 8 bits on its grid, so every value is exact in
// bf16; every step is exact in float32 but the last rounding, |v - p1 - p2
// - p3| <= 2^-25.
__device__ __forceinline__ void split_fixed(float v0, float v1, uint32_t& p1,
                                            uint32_t& p2, uint32_t& p3) {
  float a[2] = {v0, v1}, b[3][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float a1 = __fmul_rn(rintf(__fmul_rn(a[e], 256.f)), 0x1p-8f);
    const float r1 = __fsub_rn(a[e], a1);
    const float a2 = __fmul_rn(rintf(__fmul_rn(r1, 65536.f)), 0x1p-16f);
    const float r2 = __fsub_rn(r1, a2);
    b[0][e] = a1;
    b[1][e] = a2;
    b[2][e] = __fmul_rn(rintf(__fmul_rn(r2, 0x1p24f)), 0x1p-24f);
  }
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(b[0][0], b[0][1]);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(b[1][0], b[1][1]);
  const __nv_bfloat162 h3 = __floats2bfloat162_rn(b[2][0], b[2][1]);
  p1 = reinterpret_cast<const uint32_t&>(h1);
  p2 = reinterpret_cast<const uint32_t&>(h2);
  p3 = reinterpret_cast<const uint32_t&>(h3);
}

// Two int8 codes of `w` (bytes picked by `sel`: 0x4140 for bytes 0, 1,
// 0x4342 for bytes 2, 3) -> a bf16 pair, exactly: with b = 0x43 the high
// byte, (b, c & 0x7f) is 128 + (c & 0x7f) and (b, c & 0x80) is 128 or 256
// by c's sign bit, and their difference is c.
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t w,
                                                    uint32_t sel) {
  const uint32_t raw = __byte_perm(w, 0x43434343u, sel);
  const uint32_t lo7 = raw & 0xFF7FFF7Fu;
  const uint32_t sub = raw & 0xFF80FF80u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r) : "r"(sub), "r"(0xBF80BF80u), "r"(lo7));
  return r;
}

// d (+)= a b on the tensor cores, for the warpgroup: A 64 x 16 bf16 from
// registers (warp w holds rows 16 w.. in the mma.sync m16n8k16 A layout), B
// 16 x 64 bf16 from shared memory through `desc`, D 64 x 64 float32 (warp
// w's rows, d[j] = n-tile j in the m16n8 D layout). `accumulate` 0 ignores
// d's old values.
__device__ __forceinline__ void wgmma_64(float (&d)[kNTiles][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate),
        "l"(desc));
}
// waits for the warpgroup's products; d is named so that no read of it
// moves above the wait
__device__ __forceinline__ void wgmma_wait(float (&d)[kNTiles][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      :
      : "memory");
}
// Shared-memory matrix descriptor of a K-major bf16 operand in the
// 128-byte swizzle: rows of 64 values (128 bytes), 16-byte chunk c of row r
// at chunk c ^ (r % 8), groups of 8 rows 1 KB apart (the stride byte
// offset), the group at `saddr` 1 KB aligned but for the k-step's offset
// inside the row (32 bytes a step); the leading byte offset is unused.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(unsigned saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void store_cs(float* p, float v) {
  asm volatile("st.global.cs.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

// The codes of stage (row tile rt, slice sl) into a ring slot by plain
// loads (d % 16 != 0: rows are not 16-byte aligned for the tensor copy),
// in the same swizzle: chunk c of row r at chunk c ^ (r & 7), zero past n
// and d.
__device__ __forceinline__ void load_codes(const Args& a, unsigned char* slot,
                                           int rt, int sl, int tid) {
  const int k0 = sl * kSlice;
  for (int i = tid; i < kTileN * 8; i += kProducerThreads) {
    const int r = i >> 3, c = i & 7;
    const int row = rt * kTileN + r, k = k0 + 16 * c;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < a.n) {
      const int8_t* src = a.codes + (size_t)row * a.d;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (k + e < a.d)
          w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[k + e]))
                       << (8 * (e & 3));
    }
    *reinterpret_cast<uint4*>(slot + r * kSlice + ((c ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Scale and zero of `slices` slices from slice sl0 on, [slice][scale 128,
// zero 128], zero past d.
__device__ __forceinline__ void load_scale_zero(const Args& a, float* sz,
                                                int sl0, int slices,
                                                int tid) {
  for (int i = tid; i < slices * 2 * kSlice; i += kProducerThreads) {
    const int j = i % (2 * kSlice);
    const int k = (sl0 + i / (2 * kSlice)) * kSlice + j % kSlice;
    sz[i] = k < a.d ? __ldg((j < kSlice ? a.scale : a.zero) + k) : 0.f;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// a box of the codes tensor map (64 rows x 128 columns at (col, row)) into
// shared memory, its bytes counted on `bar`; rows past n and columns past
// d arrive as zeros
__device__ __forceinline__ void tensor_load(const CUtensorMap* map, void* dst,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

// registers a thread of the warpgroup may hold from here on: the producer
// gives up part of its share, the consumers take it
template <int N>
__device__ __forceinline__ void set_max_registers_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_max_registers_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
constexpr int kProducerRegs = 88, kConsumerRegs = 208;
static_assert(kProducerThreads * kProducerRegs +
                  32 * kConsumerWarps * kConsumerRegs <= 65536,
              "register file");

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A warp's staging box to the scores by the copy engine: the tensor map
// describes out [B, n] float32 with boxes of 16 rows x 32 columns in the
// 128-byte swizzle (rows past B and columns past n are not written), L2
// evict-first; tracked per issuing lane: `bulk_wait_read` before the box is
// written again, `bulk_wait` before the block exits.
__device__ __forceinline__ void tensor_store(const CUtensorMap* map,
                                             const float* src, int col,
                                             int row, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%1, %2}], [%3], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row), "r"(smem_addr(src)), "l"(policy)
      : "memory");
}
// float index of score (row, col) in a warp's staging boxes
__device__ __forceinline__ int stg_at(int row, int col) {
  return (col / kBoxCols) * 16 * kBoxCols + row * kBoxCols +
         ((((col % kBoxCols) >> 2) ^ (row & 7)) << 2) + (col & 3);
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory made visible to the copy engine
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// One stage from int8 to the bf16 tile, two halves of 64 columns in the
// 128-byte swizzle of `kmajor_sw128_desc`, by the producer warpgroups:
// kRowThreads threads a row, thread tid taking row tid / kRowThreads and
// its kRowChunks chunks of 16 columns from chunk v kRowChunks (v = tid %
// kRowThreads). It writes them into the row of the bf16 tile (made visible
// to the tensor cores' async proxy), and with `norms` adds those columns'
// x_k^2 to `part` in float64, in ascending k, from x_k = fl(fl(c_k
// scale_k) + zero_k). On the tile's last slice (`xfin` not null) the two
// parts of a row meet in a shuffle, p0 + p1, and the row's value for the
// epilogue goes to xfin: |x|^2 as (high, low) float32 for l2, (1 / (|x| +
// 1e-12), 0) for angular.
__device__ __forceinline__ void convert_stage(const unsigned char* slot,
                                              const float* sc,
                                              unsigned char* bf, int tid,
                                              bool norms, int metric,
                                              double& part, float2* xfin) {
  const int r = tid / kRowThreads, v = tid % kRowThreads;
  const float* zc = sc + kSlice;
#pragma unroll
  for (int j = 0; j < kRowChunks; ++j) {
    const int c = v * kRowChunks + j;  // int8 chunk: columns 16 c..16 c + 15
    const uint4 w = *reinterpret_cast<const uint4*>(
        slot + r * kSlice + ((c ^ (r & 7)) << 4));
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    uint32_t b[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b[2 * e] = codes_to_bf16x2(ws[e], 0x4140u);
      b[2 * e + 1] = codes_to_bf16x2(ws[e], 0x4342u);
    }
    // its two bf16 chunks: half c / 4, chunks 2 (c % 4), 2 (c % 4) + 1
    unsigned char* brow = bf + (c >> 2) * kHalfBytes + r * 128;
    const int cb = 2 * (c & 3);
    *reinterpret_cast<uint4*>(brow + ((cb ^ (r & 7)) << 4)) =
        make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(brow + (((cb + 1) ^ (r & 7)) << 4)) =
        make_uint4(b[4], b[5], b[6], b[7]);
    if (norms) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * c + 4 * e;
        const float4 s4 = *reinterpret_cast<const float4*>(sc + k);
        const float4 z4 = *reinterpret_cast<const float4*>(zc + k);
        const float cv[4] = {__uint_as_float(b[2 * e] << 16),
                             __uint_as_float(b[2 * e] & 0xFFFF0000u),
                             __uint_as_float(b[2 * e + 1] << 16),
                             __uint_as_float(b[2 * e + 1] & 0xFFFF0000u)};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const double x = __fadd_rn(__fmul_rn(cv[m], sv[m]), zv[m]);
          part = __fma_rn(x, x, part);
        }
      }
    }
  }
  fence_async_shared();
  if (norms && xfin != nullptr) {
    const double x = __dadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 1));
    if (v == 0) {
      const float hi = __double2float_rn(x);
      xfin[r] = metric == 2
                    ? make_float2(__frcp_rn(__fadd_rn(sqrtf(hi), kEps)), 0.f)
                    : make_float2(hi, __double2float_rn(x - hi));
    }
    part = 0.0;
  }
}

// A thread's columns of the slice at column k0 (those of its A fragments,
// zero past d) for query `row` (zero past B): fn(e, k, q, scale, zero).
template <typename Fn>
__device__ __forceinline__ void each_column(const Args& a, int row, int k0,
                                            int t, int hh, Fn fn) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + 16 * ks + 2 * t + 8 * r + e;
        float v = 0.f, sv = 0.f, zv = 0.f;
        if (row < a.B && k < a.d) {
          v = __ldg(a.q + (size_t)row * a.d + k);
          sv = __ldg(a.scale + k);
          zv = __ldg(a.zero + k);
        }
        fn(ks, 2 * r + hh, e, v, sv, zv);
      }
}

// What the epilogue needs of the warp's two queries qw + g + 8 hh (hh = 0,
// 1), found over all of d by the quad: 2^-E (inv, to scale u) and three
// constants. l2: k0 = 2^(E+1), k1 = |q|^2 rounded to a multiple of
// 2^(E-7), k2 = 2 q.z - the rest of |q|^2. ip and angular: k0 = 2^E, k1 =
// q.z, k2 = 1 / (|q| + 1e-12) (angular).
__device__ __forceinline__ void query_consts(const Args& a, int qw, int g,
                                             int t, float (&inv)[2],
                                             float (&k0)[2], float (&k1)[2],
                                             float (&k2)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qw + g + 8 * hh;
    float mx = 0.f;
    double qn = 0.0, qz = 0.0;
    for (int sl = 0; sl < a.ns; ++sl)
      each_column(a, row, sl * kSlice, t, hh,
                  [&](int, int, int, float v, float sv, float zv) {
                    mx = fmaxf(mx, fabsf(__fmul_rn(v, sv)));
                    qn = __fma_rn((double)v, (double)v, qn);
                    qz = __fma_rn((double)v, (double)zv, qz);
                  });
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, m));
      qn = __dadd_rn(qn, __shfl_xor_sync(0xffffffffu, qn, m));
      qz = __dadd_rn(qz, __shfl_xor_sync(0xffffffffu, qz, m));
    }
    int ex = 0;
    frexpf(mx, &ex);                       // |u_k| < 2^ex
    ex = ex < -125 ? -125 : (ex > 126 ? 126 : ex);
    inv[hh] = ldexpf(1.f, -ex);
    const float qn_hi = __double2float_rn(qn);
    if (a.metric == 0) {
      const double grid = ldexp(1.0, ex - 7), qn_r = rint(qn / grid) * grid;
      k0[hh] = ldexpf(1.f, ex + 1);
      k1[hh] = __double2float_rn(qn_r);
      k2[hh] = __double2float_rn(2.0 * qz - (qn - (double)k1[hh]));
    } else {
      k0[hh] = ldexpf(1.f, ex);
      k1[hh] = __double2float_rn(qz);
      k2[hh] = __frcp_rn(__fadd_rn(sqrtf(qn_hi), kEps));
    }
  }
}

// The warp's A fragments for the slice at column k0: the three fixed-point
// pieces of v = u 2^-E, u = q * scale, for queries qw + g, qw + g + 8 (zero
// past B and d).
__device__ __forceinline__ void build_a(const Args& a, int qw, int k0,
                                        uint32_t (&A)[kSteps][3][4],
                                        const float (&inv)[2], int g, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float pair[2];
    each_column(a, qw + g + 8 * hh, k0, t, hh,
                [&](int ks, int r, int e, float v, float sv, float) {
                  pair[e] = __fmul_rn(__fmul_rn(v, sv), inv[hh]);
                  if (e == 1)
                    split_fixed(pair[0], pair[1], A[ks][0][r], A[ks][1][r],
                                A[ks][2][r]);
                });
  }
}

// The epilogue of a row tile (rows row0..) for a consumer warp (queries
// qw..): the two accumulators (s1 of the v1 pieces, s23 of v2 and v3)
// joined with the query's constants (`query_consts`) and the rows' xf into
// the metric, the warp's staging boxes, the stores. l2: (T - |q|^2 on
// T's grid, exact) - |x|^2, then the small terms 2^(E+1) s23 + 2 q.z and
// the low parts, with T = 2^(E+1) s1 exact; ip: 2^E s1 + (2^E s23 + q.z);
// angular: that times 1 / (|q| + 1e-12) and 1 / (|x| + 1e-12).
__device__ __forceinline__ void epilogue(
    const Args& a, const CUtensorMap* out_map, const float (&acc1)[kNTiles][4],
    const float (&acc23)[kNTiles][4], float* stg, const float2* xf,
    const float (&k0)[2], const float (&k1)[2], const float (&k2)[2], int qw,
    int row0, int lane, uint64_t policy) {
  const int g = lane >> 2, t = lane & 3;
  const bool norms = a.metric != 1;
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    const int col = 8 * nt + 2 * t;
    float2 xv[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
    if (norms) {
      xv[0] = xf[col];
      xv[1] = xf[col + 1];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sc[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s1 = acc1[nt][2 * hh + e], s23 = acc23[nt][2 * hh + e];
        const float big = __fmul_rn(s1, k0[hh]);   // exact
        if (a.metric == 0) {
          const float h = __fsub_rn(__fsub_rn(big, k1[hh]), xv[e].x);
          const float small =
              __fsub_rn(__fmaf_rn(s23, k0[hh], k2[hh]), xv[e].y);
          sc[e] = __fadd_rn(h, small);
        } else {
          const float dot = __fadd_rn(big, __fmaf_rn(s23, k0[hh], k1[hh]));
          sc[e] = a.metric == 1
                      ? dot
                      : __fmul_rn(__fmul_rn(dot, k2[hh]), xv[e].x);
        }
      }
      *reinterpret_cast<float2*>(stg + stg_at(g + 8 * hh, col)) =
          make_float2(sc[0], sc[1]);
    }
  }
  if (a.vec_out) {
    fence_async_shared();
    __syncwarp();
    if (lane == 0 && qw < a.B) {
#pragma unroll
      for (int j = 0; j < kTileN / kBoxCols; ++j)
        if (row0 + j * kBoxCols < a.n)
          tensor_store(out_map, stg + j * 16 * kBoxCols,
                       row0 + j * kBoxCols, qw, policy);
      bulk_commit();
    }
  } else {
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int qrow = qw + i;
      if (qrow >= a.B) break;
      float* dst = a.out + (size_t)qrow * a.n + row0;
#pragma unroll
      for (int e = 0; e < kTileN / 32; ++e) {
        const int c = lane + 32 * e;
        if (row0 + c < a.n) store_cs(dst + c, stg[stg_at(i, c)]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
quant_distance_kernel(const Args a,
                      const __grid_constant__ CUtensorMap out_map,
                      const __grid_constant__ CUtensorMap codes_map) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* bf =                  // two bf16 tiles, 1 KB aligned
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* staging = reinterpret_cast<float*>(bf + kBufs * kBfBytes);
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      staging + kConsumerWarps * kStagingFloats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * kSlotBytes);
  float2* xfin = reinterpret_cast<float2*>(ring + kStages * kSlotBytes + 64);
  float* sz = reinterpret_cast<float*>(xfin + 4 * kTileN);   // xfin: [4][kTileN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x, gx = gridDim.x, ns = a.ns;
  const int S = (a.rtiles - bx + gx - 1) / gx * ns;   // stages of the block
  const bool norms = a.metric != 1;
  PROF_START();

  if (warp >= kConsumerWarps) {
    // the producer warpgroup: int8 stages through the ring, each converted
    // into bf16 tile s % kBufs once the consumers have released it
    set_max_registers_dec<kProducerRegs>();
    const int ptid = tid - 32 * kConsumerWarps;
    const bool tma = a.vec_codes, all_sz = ns <= kSzSlices;
    auto issue = [&](int s) {   // thread 0: stage s's codes into its slot
      uint64_t* bar = bars + s % kStages;
      mbar_expect_tx(bar, kCodeBytes);
      tensor_load(&codes_map, ring + (s % kStages) * kSlotBytes, bar,
                  (s % ns) * kSlice, (bx + s / ns * gx) * kTileN);
    };
    if (ptid == 0 && tma) {
      for (int i = 0; i < kStages; ++i) mbar_init(bars + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (all_sz) load_scale_zero(a, sz, 0, ns, ptid);
    named_sync(kBarProducer, kProducerThreads);
    if (ptid == 0 && tma)
      for (int s = 0; s < kStages && s < S; ++s) issue(s);
    double part = 0.0;
    for (int s = 0; s < S; ++s) {
      const int sl = s % ns;
      unsigned char* slot = ring + (s % kStages) * kSlotBytes;
      if (tma) mbar_wait(bars + s % kStages, (s / kStages) & 1);
      if (!tma || !all_sz) {
        if (!tma) load_codes(a, slot, bx + s / ns * gx, sl, ptid);
        if (!all_sz) load_scale_zero(a, sz, sl, 1, ptid);
        named_sync(kBarProducer, kProducerThreads);
      }
      if (s >= kBufs) {
        named_sync(kBarEmpty + 2 * (s % kBufs), kPair);
        named_sync(kBarEmpty + 2 * (s % kBufs) + 1, kPair);
      }
      PROF(0);
      convert_stage(slot, sz + (all_sz ? sl : 0) * 2 * kSlice,
                    bf + (s % kBufs) * kBfBytes, ptid, norms, a.metric,
                    part,
                    sl == ns - 1 ? xfin + ((s / ns) & 3) * kTileN : nullptr);
      named_arrive(kBarFull + 2 * (s % kBufs), kPair);
      named_arrive(kBarFull + 2 * (s % kBufs) + 1, kPair);
      PROF(1);
      named_sync(kBarProducer, kProducerThreads);   // the slot is read
      if (ptid == 0 && tma && s + kStages < S) issue(s + kStages);
      PROF(2);
    }
    for (int s = S > kBufs ? S - kBufs : 0; s < S; ++s) {
      named_sync(kBarEmpty + 2 * (s % kBufs), kPair);
      named_sync(kBarEmpty + 2 * (s % kBufs) + 1, kPair);
    }
    PROF_END();
    return;
  }

  // the consumer warpgroups: warp w owns queries qw.. qw + 15
  set_max_registers_inc<kConsumerRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int qw = blockIdx.y * kTileQ + 16 * warp;
  uint32_t A[kSteps][3][4];
  float inv[2], k0[2], k1[2], k2[2];
  query_consts(a, qw, g, t, inv, k0, k1, k2);
  if (ns == 1) build_a(a, qw, 0, A, inv, g, t);
  const uint64_t policy = evict_first_policy();

  // The two consumer warpgroups take turns at the tensor cores (ping-pong):
  // one issues a stage's products while the other runs its epilogue.
  const int wg = warp >> 2;
  if (wg == 1) named_arrive(kBarTurn, kConsumers);   // the first turn
  float acc1[kNTiles][4] = {}, acc23[kNTiles][4] = {};
  float* stg = staging + warp * kStagingFloats;
  for (int s = 0; s < S; ++s) {
    const int it = s / ns, sl = s % ns;
    if (ns > 1) build_a(a, qw, sl * kSlice, A, inv, g, t);
    named_sync(kBarFull + 2 * (s % kBufs) + wg, kPair);
    named_sync(kBarTurn + wg, kConsumers);
    PROF(0);
    // every k-step of the slice, those past d on zero codes and pieces
    const unsigned bfb = smem_addr(bf + (s % kBufs) * kBfBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const uint64_t desc =
          kmajor_sw128_desc(bfb + (ks >> 2) * kHalfBytes + (ks & 3) * 32);
      wgmma_64(acc23, A[ks][2], desc, ks > 0);
      wgmma_64(acc23, A[ks][1], desc, 1);
      wgmma_64(acc1, A[ks][0], desc, ks > 0);
    }
    wgmma_commit();
    named_arrive(kBarTurn + 1 - wg, kConsumers);
    wgmma_wait(acc1);
    wgmma_wait(acc23);
    // the tile is free (its row norms stay until tile it + 4 is filled)
    named_arrive(kBarEmpty + 2 * (s % kBufs) + wg, kPair);
    PROF(1);

    // Each slice's sums start from zero, and the slices of a tile meet in
    // float32 in order through the warp's staging boxes (s1 + s23 of each
    // slice, then the last slice's s1 joins the sum and its s23 stays).
    if (sl == 0) {   // the previous tile's stores have read the boxes
      if (lane == 0) bulk_wait_read();
      __syncwarp();
    }
    if (ns > 1) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2* p = reinterpret_cast<float2*>(
              stg + stg_at(g + 8 * hh, 8 * nt + 2 * t));
          const float2 v = sl == 0 ? make_float2(0.f, 0.f) : *p;
          float* a1 = &acc1[nt][2 * hh];
          const float* a23 = &acc23[nt][2 * hh];
          if (sl < ns - 1) {
            *p = make_float2(__fadd_rn(v.x, __fadd_rn(a1[0], a23[0])),
                             __fadd_rn(v.y, __fadd_rn(a1[1], a23[1])));
          } else {
            a1[0] = __fadd_rn(v.x, a1[0]);
            a1[1] = __fadd_rn(v.y, a1[1]);
          }
        }
    }
    if (sl == ns - 1)
      epilogue(a, &out_map, acc1, acc23, stg, xfin + (it & 3) * kTileN, k0,
               k1, k2, qw, (bx + it * gx) * kTileN, lane, policy);
    PROF(2);
  }
  if (wg == 0) named_sync(kBarTurn, kConsumers);   // the last turn
  if (lane == 0) bulk_wait();
  PROF_END();
}

}  // namespace

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against the driver library)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// a 2-D tensor map of a row-major [rows, cols] array, boxes of box_rows x
// box_cols in the 128-byte swizzle
static int encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                      const void* base, int rows, int cols, int box_rows,
                      int box_cols) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return -4;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -5;
}

extern "C" int quant_distance_launch(const void* q, const void* codes,
                                     const void* scale, const void* zero,
                                     void* out, int B, int n, int d,
                                     int metric, void* stream) {
  if (B < 1 || n < 1 || d < 1 || metric < 0 || metric > 2) return -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static int sms[64];                 // per device: SM count, once
  if (dev < 0 || dev >= 64) return -3;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(quant_distance_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemMax);
    if (err != cudaSuccess) return (int)err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  const int qtiles = (B + kTileQ - 1) / kTileQ;
  const int rtiles = (n + kTileN - 1) / kTileN;
  if (qtiles > 65535) return -2;
  int gx = sms[dev] / qtiles;
  gx = gx < 1 ? 1 : (gx > rtiles ? rtiles : gx);
  Args a;
  a.q = static_cast<const float*>(q);
  a.codes = static_cast<const int8_t*>(codes);
  a.scale = static_cast<const float*>(scale);
  a.zero = static_cast<const float*>(zero);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.n = n;
  a.d = d;
  a.metric = metric;
  a.ns = (d + kSlice - 1) / kSlice;
  a.rtiles = rtiles;
  a.vec_codes = d % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  a.vec_out = n % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  CUtensorMap out_map = {}, codes_map = {};
  if (a.vec_out) {
    const int e = encode_map(&out_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                             out, B, n, 16, kBoxCols);
    if (e != 0) return e;
  }
  if (a.vec_codes) {
    const int e = encode_map(&codes_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                             codes, n, d, kTileN, kSlice);
    if (e != 0) return e;
  }
  const size_t smem = kSmemFixed + (size_t)(a.ns <= kSzSlices ? a.ns : 1) *
                                       2 * kSlice * 4;
  quant_distance_kernel<<<dim3(gx, qtiles), kThreads, smem,
                          (cudaStream_t)stream>>>(a, out_map, codes_map);
  return (int)cudaGetLastError();
}

#ifdef QUANT_PROFILE
// copies the first `blocks` blocks' phase cycles to `out` (kThreads / 32
// warps x kPhases a block) and zeroes them
extern "C" int quant_distance_profile_phases() { return kPhases; }
extern "C" int quant_distance_profile_warps() { return kThreads / 32; }
extern "C" int quant_distance_profile(unsigned long long* out, int blocks) {
  const size_t n = sizeof(unsigned long long) * (kThreads / 32) * kPhases *
                   (size_t)(blocks < kProfBlocks ? blocks : kProfBlocks);
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, n);
  if (err != cudaSuccess) return (int)err;
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, g_prof);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(dev, 0, sizeof(g_prof));
}
#endif
