// Float32-accurate matrix products for Hopper (sm_90a) on the bfloat16
// tensor cores: C = op(A) op(B) (+ bias), each float32 operand split
// exactly into three bfloat16 terms inside the kernel.
//
// Replaces no TPU kernel: the JAX package leaves its float32 matrix
// products (flax nn.Dense in float32, GPT's tied head in float32) to XLA.
// Added because cuBLAS runs a float32 product with TF32 off on the FMA
// units (67 TFLOP/s on an H100 SXM), where the float32 BERT cell's Dense
// layers and GPT's float32 head spent most of their card time. Called by
// gradaccum_tpu_torch/ops/matmul.py (the models' Dense in float32 and GPT's
// tied head); built by gradaccum_tpu_torch/utils/cuda_build.py (nvcc, plain
// C interface, ctypes), like the flash sources.
//
// The split. A float32 x is hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), each rounded to nearest. For every normal x with
// |x| >= 2^-103 the three sum to x exactly: hi takes the top 8 bits of the
// significand, x - hi the next 16 (it is exact in float32), mid the top 8
// of those and lo the 8 left. A bfloat16 operand is its one term. The
// kernel forms the products of term pairs (i, j) with i + j <= 2: 6 for
// float32 x float32, 3 for float32 x bfloat16, 1 for bfloat16 x bfloat16.
// Each is a bf16 x bf16 product, exact in the float32 accumulator. The
// pairs left out, (mid, lo), (lo, mid) and (lo, lo), weigh at most about
// 2^-25 of a product, under float32's own half ulp. No TF32 anywhere.
//
// Accumulation. The tensor cores add into their float32 accumulator with
// a rounding of their own; over a long K the errors of that rounding need
// not cancel. So the products of a few K tiles (12 term-pair k16 steps:
// one tile in float32 x float32, two in float32 x bf16, six in bf16 x bf16)
// go into a fresh accumulator, which is then added to a float32 sum in
// registers, round to nearest: the promotion interval.
//
// What bounds it. At BERT-Large's Dense shapes over 16,384 rows (1024 x
// 1024 and 4096 x 1024 weights) a float32 x float32 product does 6 bf16
// products: 34.4 GFLOP x 6 for a 1024 x 1024 weight, 0.21 ms at the 989
// TFLOP/s of bf16 and 64 MB of float32 operands (0.02 ms at 3.35 TB/s):
// operations bound it. GPT-2 medium's head, [16,384 x 1,024] x [1,024 x
// 50,257], is one product forward and three in each backward product
// (1.69 TFLOP each): operations again.
//
// The design. A block computes a 128 x 128 tile of C over a range of K in
// tiles of 32 (split-K where the tiles alone do not fill the card; a second
// kernel sums the partial tiles in a fixed order, so every run gives the
// same bits). 384 threads: warpgroups 0 and 1 consume, 64 rows of the tile
// each, with wgmma m64n128k16 from shared memory; warpgroup 2 produces.
// - Loads. An operand whose rows and start are 16-byte aligned is copied
//   by the Tensor Memory Accelerator (TMA), a 2-D tensor map issued by the
//   producer's first thread (elements past M, N or K land as zeros); a
//   float32 one whose rows are not (GPT's head gradient is [16,384, 50,257]
//   float32, its rows 201,028 bytes apart: no tensor map can describe it,
//   and a padded copy would be 3.3 GB) by the producer's 128 threads with
//   4-byte cp.async, zero-filled past the edges. Both complete the tile's
//   "landed" mbarrier (expect_tx; cp.async.mbarrier.arrive.noinc), which
//   the producer waits on a few tiles later.
// - The split pass. A float32 operand lands raw in a staging ring; the
//   producer threads then write its three terms into the term ring, in the
//   layout the wgmma descriptors name, and arrive on the tile's "ready"
//   mbarrier. A bf16 operand is copied straight into the term ring. The
//   consumers release a term stage on its "empty" mbarrier.
// - Layouts. A K-major operand (rows contiguous along K) lies as [128
//   rows][32 k] bf16 with 64-byte rows swizzled over 64 bytes; an MN-major
//   one (contiguous along M or N: the dY^T and X of a weight gradient, the
//   W of an input gradient) as two panels [32 k][64] with 128-byte rows
//   swizzled over 128 bytes, read transposed by wgmma (bf16 allows both
//   transposes from shared memory). So forward (NT), input gradient (NN)
//   and weight gradient (TN) run without a transposed copy anywhere. These
//   are the layouts TMA's 64- and 128-byte swizzles write; float32 staging
//   tiles are TMA's 128-byte swizzle too ([128][32] K-major, four panels
//   [32 k][32] MN-major).
// - Products in flight. A consumer warpgroup keeps the products of up to
//   kDepth K tiles in flight (one tile's are a few hundred cycles of work
//   at one product a pair, against the latency of the wgmma pipe) and
//   drains them at each promotion.
// - Output. The consumers write float32 or bf16 from their sums, with the
//   bias added, straight to global memory, or float32 partial tiles to a
//   workspace under split-K.
//
// Layout of the arguments: A is M x K (K-major: element (m, k) at a[m lda
// + k]; MN-major: at a[k lda + m]); B is K x N (K-major: (k, n) at b[n ldb
// + k]; MN-major: at b[k ldb + n]); C is M x N at out[m ldc + n], or at
// out[n ldc + m] when out_trans (the wrapper computes C^T = B^T A^T to
// keep a float32 operand in A's place). A bfloat16 A takes a bfloat16 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kBM = 128, kBN = 128, kBK = 32;  // the block's tile of C, and of K
constexpr int kThreads = 384;                  // two consumer warpgroups, one producer
constexpr int kTermBytes = 128 * kBK * 2;      // one bf16 term of a 128 x 32 operand tile
constexpr int kStagingBytes = 128 * kBK * 4;   // one float32 operand tile as it lands
constexpr int kSmemBudget = 212992;            // shared memory for the rings (208 KB)

// The rings of a kernel whose A is float32 (AF) or bf16, and B likewise.
template <bool AF, bool BF>
struct Geometry {
  static constexpr int kTermsA = AF ? 3 : 1;
  static constexpr int kTermsB = BF ? 3 : 1;
  static constexpr bool kStaged = AF || BF;   // a float32 operand needs the split pass
  static constexpr bool kDirect = !AF || !BF;  // a bf16 operand is copied into the term ring
  static constexpr int kTermStage = (kTermsA + kTermsB) * kTermBytes;
  static constexpr int kStagingStage = (AF + BF) * kStagingBytes;
  // f32 x f32: 2 term and 3 staging stages; f32 x bf16: 5 and 3; bf16: 13 term stages
  static constexpr int kStagingStages = kStaged ? 3 : 0;
  static constexpr int kTermStages =
      (kSmemBudget - kStagingStages * kStagingStage) / kTermStage;
  static constexpr int kProducts = AF && BF ? 6 : kStaged ? 3 : 1;
  static constexpr int kPromote = 6 / kProducts;  // K tiles per promotion: 12 products x k16
  static constexpr int kDepth = kProducts == 1 ? 3 : 1;  // K tiles of products in flight
  // tiles the copies run ahead of the split pass; the "landed" barriers
  // cycle with the staging stages (or the term stages, with no staging)
  static constexpr int kLandedSlots = kStaged ? kStagingStages : kTermStages;
  static constexpr int kAhead = kStaged ? kStagingStages - 1 : kTermStages - kDepth;
  static constexpr int kStagingOff = kTermStages * kTermStage;
  static constexpr int kBarOff = kStagingOff + kStagingStages * kStagingStage;
  static constexpr int kBars = kLandedSlots + 2 * kTermStages;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;  // + the alignment of the base
  // While the consumers wait for tile j they hold tiles j - kDepth .. j - 1.
  // A bf16 operand copied straight into a term stage needs the stage free
  // when its copies are issued, and the producer issues those of tiles up
  // to j + kAhead - 1 before it makes tile j ready: they must not wait for
  // a stage the consumers hold. A split pass waits for its own tile's stage.
  static_assert(!kDirect || kAhead + kDepth <= kTermStages, "term ring too shallow");
  static_assert(kDirect || kDepth < kTermStages, "term ring too shallow");
  static_assert(kAhead < kLandedSlots, "landed barriers reused before they are waited on");
  static_assert(kTermStages >= 2 && kSmem <= 232448, "shared memory");
};

// the operands' tensor maps, in the parameter space where TMA reads them
struct Maps {
  CUtensorMap a, b;
};

struct GemmParams {
  const void* a;
  const void* b;
  const float* bias;  // per column of C (per row when out_trans), or null
  void* out;
  float* ws;  // split-K partial tiles [splits][M][N], or null
  long long lda, ldb, ldc;
  int M, N, K;
  int tiles_m, tiles_n, m_fastest;
  int k_tiles_per_split;
  int a_tma, b_tma;  // copied by TMA (rows and start 16-byte aligned), else 4-byte cp.async
  int out_bf16, out_trans;
};

// ---------------------------------------------------------------------------
// cp.async into shared memory, zero-filled past `valid` bytes
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid)
               : "memory");
}

// the barrier's phase completes once this thread's copies so far have
// landed (its arrival was counted in the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a box of a 2-D tensor map ({column, row}) into shared memory; completes
// its bytes of the barrier's expected transaction
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// ---------------------------------------------------------------------------
// Shared-memory layouts
// ---------------------------------------------------------------------------

// a bf16 term tile, K-major: [128 rows][32 k], 64-byte rows, 16-byte chunk q
// of row r at chunk q ^ ((r >> 1) & 3) (the 64-byte swizzle)
__device__ __forceinline__ int term_k(int r, int q) { return r * 64 + ((q ^ ((r >> 1) & 3)) << 4); }

// MN-major: two panels [32 k][64], 128-byte rows, chunk q (of 16) of row k at
// panel q / 8, chunk (q % 8) ^ (k % 8) (the 128-byte swizzle)
__device__ __forceinline__ int term_mn(int k, int q) {
  return (q >> 3) * 4096 + k * 128 + (((q & 7) ^ (k & 7)) << 4);
}

// a float32 staging tile as TMA's 128-byte swizzle writes it: K-major
// [128 rows][32 k] (128-byte rows, 16-byte chunk u at u ^ (r % 8)), and
// MN-major four panels [32 k][32] (chunk u of 32 along the row in panel
// u / 8, at chunk (u % 8) ^ (k % 8))
__device__ __forceinline__ int staged_k(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }
__device__ __forceinline__ int staged_mn(int k, int u) {
  return (u >> 3) * 4096 + k * 128 + (((u & 7) ^ (k & 7)) << 4);
}

// wgmma descriptors of one k16 step kk of a term tile at `tile`: K-major
// rows row0.. (groups of 8 rows 512 bytes apart; a step moves 32 bytes into
// the swizzled row), MN-major from panel `panel` (8 k rows 1024 bytes
// apart, the next 64 columns in the next panel, 4096 bytes on)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  return make_desc(tile + row0 * 64 + kk * 32, 16, 512, 2);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int panel, int kk) {
  return make_desc(tile + panel * 4096 + kk * 2048, 4096, 1024, 1);
}

// d (m64n128, f32) = or += A B from shared memory, A and B K-major (0) or
// MN-major (1, transposed in the instruction). Thread 4 g + t of warp w
// holds rows 16 w + g (d[4 i], d[4 i + 1]) and 16 w + g + 8 (d[4 i + 2],
// d[4 i + 3]) at columns 8 i + 2 t, 8 i + 2 t + 1.
template <int TA, int TB>
__device__ __forceinline__ void wgmma128(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// ---------------------------------------------------------------------------
// The split
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float low_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float high_f(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// x0, x1 -> their hi, mid and lo terms, two bf16 in each word (x0 low)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = bf16x2(x0, x1);
  const float r0 = x0 - low_f(hi), r1 = x1 - high_f(hi);
  mid = bf16x2(r0, r1);
  lo = bf16x2(r0 - low_f(mid), r1 - high_f(mid));
}

// 8 float32 (two 16-byte chunks) -> one 16-byte chunk of each term
__device__ __forceinline__ void split8(const float4& x, const float4& y, unsigned char* hi,
                                       unsigned char* mid, unsigned char* lo) {
  uint4 h, m, l;
  split2(x.x, x.y, h.x, m.x, l.x);
  split2(x.z, x.w, h.y, m.y, l.y);
  split2(y.x, y.y, h.z, m.z, l.z);
  split2(y.z, y.w, h.w, m.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(mid) = m;
  *reinterpret_cast<uint4*>(lo) = l;
}

// one float32 operand tile from staging into its three term tiles (the
// producer's 128 threads, 4 output chunks each)
template <bool MN>
__device__ __forceinline__ void split_pass(const unsigned char* staging, unsigned char* terms,
                                           int pt) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int c = it * 128 + pt;
    if constexpr (MN) {
      // 8 threads read one k row across two panels: the second four read
      // their second chunk first, so each read meets 8 bank groups
      const int k = c >> 4, q = c & 15, swap = (q >> 2) & 1;
      const int dst = term_mn(k, q);
      const float4 first = *reinterpret_cast<const float4*>(staging + staged_mn(k, 2 * q + swap));
      const float4 second =
          *reinterpret_cast<const float4*>(staging + staged_mn(k, 2 * q + 1 - swap));
      split8(swap ? second : first, swap ? first : second, terms + dst, terms + kTermBytes + dst,
             terms + 2 * kTermBytes + dst);
    } else {
      const int r = c >> 2, q = c & 3;
      const int dst = term_k(r, q);
      const float4 x = *reinterpret_cast<const float4*>(staging + staged_k(r, 2 * q));
      const float4 y = *reinterpret_cast<const float4*>(staging + staged_k(r, 2 * q + 1));
      split8(x, y, terms + dst, terms + kTermBytes + dst, terms + 2 * kTermBytes + dst);
    }
  }
}

// ---------------------------------------------------------------------------
// The producer's copies of one operand tile
// ---------------------------------------------------------------------------

// One K tile (k0 .. k0 + 31) of a float32 operand whose rows are not
// 16-byte aligned, M or N range from c0 (of `extent`), into its staging
// tile by 4-byte copies, a warp over 32 consecutive elements of a row.
// K-major: element (c, k) at base[c ld + k]; MN-major: at base[k ld + c].
template <bool MN>
__device__ __forceinline__ void load_narrow(unsigned char* dst, const float* base, long long ld,
                                            int c0, int extent, int k0, int K, int pt) {
  // each thread keeps one column (K-major: k0 + pt % 32; MN-major: c0 + pt)
  // and walks rows 4 (K-major) or 1 (MN-major) apart
  const int col = MN ? pt : pt & 31;
  const int line0 = MN ? 0 : pt >> 5;
  constexpr int kStep = MN ? 1 : 4;
  const long long gcol = MN ? (long long)c0 + col : (long long)k0 + col;
  const long long grow0 = MN ? (long long)k0 : (long long)c0 + line0;
  const bool col_in = gcol < (MN ? extent : K);
  const long long rows = MN ? K : extent;
  const float* src = base + grow0 * ld + gcol;
#pragma unroll 8
  for (int it = 0; it < 32; ++it) {
    const int line = line0 + it * kStep;
    const bool in = col_in && grow0 + it * kStep < rows;
    const int off = (MN ? staged_mn(line, col >> 2) : staged_k(line, col >> 2)) + (col & 3) * 4;
    cp_async4(dst + off, in ? src + (long long)it * kStep * ld : base, in ? 4 : 0);
  }
}

// The TMA copies of one operand tile: K-major one box [128 rows][32 k];
// MN-major [32 k][128] in panels of 128 bytes (4 of float32, 2 of bf16)
template <bool F32, bool MN>
__device__ __forceinline__ void load_tma(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int k0) {
  if constexpr (!MN) {
    tma_load_2d(dst, map, bar, k0, c0);
  } else {
    constexpr int panel = F32 ? 32 : 64;
#pragma unroll
    for (int q = 0; q < 128 / panel; ++q) tma_load_2d(dst + q * 4096, map, bar, c0 + q * panel, k0);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// the products of one K tile (two k16 steps), smaller term pairs first
template <bool AF, bool BF, bool AMN, bool BMN>
__device__ __forceinline__ void issue_products(float* acc, uint32_t stage, int wg, int fresh) {
  using G = Geometry<AF, BF>;
  constexpr int kPairs[6][2] = {{1, 1}, {2, 0}, {0, 2}, {1, 0}, {0, 1}, {0, 0}};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const int i = kPairs[p][0], j = kPairs[p][1];
      if (i >= G::kTermsA || j >= G::kTermsB) continue;
      const uint32_t ta = stage + i * kTermBytes;
      const uint32_t tb = stage + (G::kTermsA + j) * kTermBytes;
      const uint64_t da = AMN ? desc_mn(ta, wg, kk) : desc_k(ta, wg * 64, kk);
      const uint64_t db = BMN ? desc_mn(tb, 0, kk) : desc_k(tb, 0, kk);
      const bool first = kk == 0 && (p == 0 || (G::kProducts == 3 && p == 1) ||
                                     (G::kProducts == 1 && p == 5));
      wgmma128<AMN, BMN>(acc, da, db, first ? !fresh : 1);
    }
  }
}

template <bool AF, bool BF, bool AMN, bool BMN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_bf16x3_kernel(const GemmParams p, const __grid_constant__ Maps maps) {
  using G = Geometry<AF, BF>;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = aligned_smem(raw);
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + G::kBarOff);
  uint64_t* ready = landed + G::kLandedSlots;
  uint64_t* empty = ready + G::kTermStages;
  const int tid = threadIdx.x;

  const int tile = blockIdx.x;
  const int tm = p.m_fastest ? tile % p.tiles_m : tile / p.tiles_n;
  const int tn = p.m_fastest ? tile / p.tiles_m : tile % p.tiles_n;
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int kt0 = blockIdx.z * p.k_tiles_per_split;
  const int nk = min((p.K + kBK - 1) / kBK - kt0, p.k_tiles_per_split);  // >= 1

  if (tid == 0) {
    // each producer thread's cp.async arrival, and the first one's expect_tx
    for (int s = 0; s < G::kLandedSlots; ++s) mbar_init(&landed[s], 129);
    for (int s = 0; s < G::kTermStages; ++s) {
      mbar_init(&ready[s], 128);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: the copies of tile i run kAhead tiles ahead of the
    // split pass of tile i - kAhead, which comes first in an iteration: the
    // consumers, who hold the tile before the one they wait for, then never
    // wait on a copy that waits for them
    const int pt = tid - 256;
    for (int i = 0; i < nk + G::kAhead; ++i) {
      const int j = i - G::kAhead;
      if (j >= 0) {
        const int s = j % G::kTermStages;
        mbar_wait(&landed[j % G::kLandedSlots], (j / G::kLandedSlots) & 1);
        if constexpr (G::kStaged) {
          if (!G::kDirect && j >= G::kTermStages) mbar_wait(&empty[s], ((j / G::kTermStages) - 1) & 1);
          unsigned char* terms = smem + s * G::kTermStage;
          const unsigned char* staging =
              smem + G::kStagingOff + (j % G::kStagingStages) * G::kStagingStage;
          if constexpr (AF) split_pass<AMN>(staging, terms, pt);
          if constexpr (BF)
            split_pass<BMN>(staging + (AF ? kStagingBytes : 0), terms + G::kTermsA * kTermBytes, pt);
        }
        fence_proxy_async();  // the terms (and bf16 copies) to wgmma's proxy
        mbar_arrive(&ready[s]);
        // the staging stage of tile j is reused by tile j + kStagingStages,
        // whose copies the next iteration issues
        if constexpr (G::kStaged) producer_sync();
      }
      if (i < nk) {
        const int s = i % G::kTermStages;
        // a bf16 operand goes straight into the term stage: wait until the
        // consumers have freed it (tile i - kTermStages)
        if (G::kDirect && i >= G::kTermStages) mbar_wait(&empty[s], ((i / G::kTermStages) - 1) & 1);
        unsigned char* terms = smem + s * G::kTermStage;
        unsigned char* staging = smem + G::kStagingOff + (i % (G::kStaged ? G::kStagingStages : 1)) *
                                                             G::kStagingStage;
        const int k0 = (kt0 + i) * kBK;
        uint64_t* bar = &landed[i % G::kLandedSlots];
        unsigned char* a_dst = AF ? staging : terms;
        unsigned char* b_dst = BF ? staging + (AF ? kStagingBytes : 0) : terms + G::kTermsA * kTermBytes;
        if (pt == 0) {
          constexpr int a_bytes = AF ? kStagingBytes : kTermBytes, b_bytes = BF ? kStagingBytes : kTermBytes;
          mbar_arrive_expect_tx(bar, (p.a_tma ? a_bytes : 0) + (p.b_tma ? b_bytes : 0));
          if (p.a_tma) load_tma<AF, AMN>(a_dst, &maps.a, bar, m0, k0);
          if (p.b_tma) load_tma<BF, BMN>(b_dst, &maps.b, bar, n0, k0);
        }
        if constexpr (AF) {
          if (!p.a_tma)
            load_narrow<AMN>(a_dst, static_cast<const float*>(p.a), p.lda, m0, p.M, k0, p.K, pt);
        }
        if constexpr (BF) {
          if (!p.b_tma)
            load_narrow<BMN>(b_dst, static_cast<const float*>(p.b), p.ldb, n0, p.N, k0, p.K, pt);
        }
        cp_async_arrive(bar);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = tid >> 7;
  const uint32_t base = smem_addr(smem);
  float acc[64], sum[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = sum[e] = 0.f;
  int kt = 0, released = 0;
  do {
    const int s = kt % G::kTermStages;
    mbar_wait(&ready[s], (kt / G::kTermStages) & 1);
    wgmma_fence();
    issue_products<AF, BF, AMN, BMN>(acc, base + s * G::kTermStage, wg, kt % G::kPromote == 0);
    wgmma_commit();
    if (kt % G::kPromote == G::kPromote - 1 || kt == nk - 1) {
      wgmma_wait<0>();
      fence_regs<64>(acc);
      for (; released <= kt; ++released) mbar_arrive(&empty[released % G::kTermStages]);
#pragma unroll
      for (int e = 0; e < 64; ++e) sum[e] += acc[e];
    } else {
      wgmma_wait<G::kDepth>();  // the tiles before the last kDepth are read
      for (; released <= kt - G::kDepth; ++released) mbar_arrive(&empty[released % G::kTermStages]);
    }
  } while (++kt < nk);

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  float* ws = p.ws ? p.ws + (size_t)blockIdx.z * p.M * p.N : nullptr;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * i + e;
        if (row >= p.M || col >= p.N) continue;
        float v = sum[4 * i + 2 * h + e];
        if (ws) {
          ws[(size_t)row * p.N + col] = v;
          continue;
        }
        if (p.bias) v += p.bias[p.out_trans ? row : col];
        const size_t at = p.out_trans ? (size_t)col * p.ldc + row : (size_t)row * p.ldc + col;
        if (p.out_bf16) static_cast<bf16*>(p.out)[at] = __float2bfloat16_rn(v);
        else static_cast<float*>(p.out)[at] = v;
      }
    }
  }
}

// split-K: C = the sum of the partial tiles in split order, plus the bias
__global__ void gemm_splitk_sum_kernel(const GemmParams p, int splits) {
  const size_t total = (size_t)p.M * p.N;
  for (size_t at = (size_t)blockIdx.x * blockDim.x + threadIdx.x; at < total;
       at += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += p.ws[z * total + at];
    const int row = (int)(at / p.N), col = (int)(at % p.N);
    if (p.bias) v += p.bias[p.out_trans ? row : col];
    const size_t o = p.out_trans ? (size_t)col * p.ldc + row : (size_t)row * p.ldc + col;
    if (p.out_bf16) static_cast<bf16*>(p.out)[o] = __float2bfloat16_rn(v);
    else static_cast<float*>(p.out)[o] = v;
  }
}

template <bool AF, bool BF, bool AMN, bool BMN>
int launch(const GemmParams& p, const Maps& maps, int splits, cudaStream_t stream) {
  constexpr int smem = Geometry<AF, BF>::kSmem;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      gemm_bf16x3_kernel<AF, BF, AMN, BMN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  gemm_bf16x3_kernel<AF, BF, AMN, BMN>
      <<<dim3(p.tiles_m * p.tiles_n, 1, splits), kThreads, smem, stream>>>(p, maps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t total = (size_t)p.M * p.N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  gemm_splitk_sum_kernel<<<blocks, 256, 0, stream>>>(p, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host: the operands' tensor maps
// ---------------------------------------------------------------------------

struct MapKey2 {
  const void* ptr;
  int f32;
  long long rows, cols, ld;
  int box_cols, box_rows;
  bool operator==(const MapKey2& o) const {
    return ptr == o.ptr && f32 == o.f32 && rows == o.rows && cols == o.cols && ld == o.ld &&
           box_cols == o.box_cols && box_rows == o.box_rows;
  }
};

// The tensor map of a [rows, cols] matrix (row pitch ld elements) in boxes
// of box_rows x box_cols, swizzled over the box's row bytes (64 or 128).
// The last maps each thread encoded are kept: a map is a function of these
// values alone, and an encode costs host time.
static bool map_2d(CUtensorMap* out, const void* ptr, bool f32, long long rows, long long cols,
                   long long ld, int box_cols, int box_rows) {
  constexpr int kSize = 64;
  thread_local MapKey2 keys[kSize];
  thread_local CUtensorMap cached[kSize];
  thread_local int used = 0, next = 0;
  const MapKey2 key{ptr, (int)f32, rows, cols, ld, box_cols, box_rows};
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *out = cached[i];
      return true;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  // the encoder needs the device's context current in this thread (see
  // hopper.cuh: autograd's device thread may not have made it so yet)
  thread_local const bool bound = [] {
    int dev = 0;
    return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
  }();
  if (!bound) return false;
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  int slot = next;
  if (used < kSize) slot = used++;
  else next = (next + 1) % kSize;
  if (encode(&cached[slot], f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols * elem == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    keys[slot] = MapKey2{nullptr, 0, 0, 0, 0, 0, 0};
    return false;
  }
  keys[slot] = key;
  *out = cached[slot];
  return true;
}

// an operand's map: K-major [extent, K] in boxes [128][32]; MN-major
// [K, extent] in boxes [32][128 bytes of columns]
static bool operand_map(CUtensorMap* out, const void* ptr, bool f32, bool mn, int extent, int K,
                        long long ld) {
  if (!mn) return map_2d(out, ptr, f32, extent, K, ld, kBK, 128);
  return map_2d(out, ptr, f32, K, extent, ld, f32 ? 32 : 64, kBK);
}

}  // namespace

extern "C" {

// C = op(A) op(B) (+ bias) as the header says. a_f32 / b_f32: the operand's
// type (a bf16 A takes a bf16 B); a_mn / b_mn: MN-major; a_tma / b_tma: the
// operand's start and row pitch are 16-byte aligned, so TMA copies it (a
// bf16 operand must be). splits > 1: the K tiles are cut into `splits`
// ranges of k_tiles_per_split, summed through `ws` ([splits, M, N] float32).
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments it does not take (a tensor map it could not encode).
int gemm_bf16x3(int a_f32, int b_f32, int a_mn, int b_mn, const void* a, const void* b,
                const float* bias, void* out, float* ws, long long lda, long long ldb,
                long long ldc, int M, int N, int K, int m_fastest, int splits,
                int k_tiles_per_split, int a_tma, int b_tma, int out_bf16, int out_trans,
                void* stream) {
  if ((!a_f32 && b_f32) || (!a_f32 && !a_tma) || (!b_f32 && !b_tma))
    return (int)cudaErrorInvalidValue;
  GemmParams p{a, b, bias, out, splits > 1 ? ws : nullptr, lda, ldb, ldc, M, N, K,
               (M + kBM - 1) / kBM, (N + kBN - 1) / kBN, m_fastest, k_tiles_per_split,
               a_tma, b_tma, out_bf16, out_trans};
  Maps maps;
  if ((a_tma && !operand_map(&maps.a, a, a_f32, a_mn, M, K, lda)) ||
      (b_tma && !operand_map(&maps.b, b, b_f32, b_mn, N, K, ldb)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = (a_f32 ? 8 : 0) | (b_f32 ? 4 : 0) | (a_mn ? 2 : 0) | (b_mn ? 1 : 0);
  switch (key) {
    case 15: return launch<true, true, true, true>(p, maps, splits, st);
    case 14: return launch<true, true, true, false>(p, maps, splits, st);
    case 13: return launch<true, true, false, true>(p, maps, splits, st);
    case 12: return launch<true, true, false, false>(p, maps, splits, st);
    case 11: return launch<true, false, true, true>(p, maps, splits, st);
    case 10: return launch<true, false, true, false>(p, maps, splits, st);
    case 9: return launch<true, false, false, true>(p, maps, splits, st);
    case 8: return launch<true, false, false, false>(p, maps, splits, st);
    case 3: return launch<false, false, true, true>(p, maps, splits, st);
    case 2: return launch<false, false, true, false>(p, maps, splits, st);
    case 1: return launch<false, false, false, true>(p, maps, splits, st);
    case 0: return launch<false, false, false, false>(p, maps, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
