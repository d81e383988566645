// Flash attention for Hopper (sm_90a), float32: forward (K1), dq + delta
// (K2) and dk/dv + per-head dmask (K3).
//
// Replaces, for float32 inputs, the TPU kernels
//   _fwd_kernel  gradaccum_tpu/ops/flash_attention.py:127 (K1)
//   _dq_kernel   gradaccum_tpu/ops/flash_attention.py:348 (K2), with the
//                delta = rowsum(dO * O) that _flash_backward computes
//                before it (:476)
//   _dkv_kernel  gradaccum_tpu/ops/flash_attention.py:399 (K3)
// Every matrix product of the three runs on the tensor cores in 3xTF32,
// with wgmma (below).
//
// Built by gradaccum_tpu_torch/utils/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes by
// gradaccum_tpu_torch/ops/flash_attention.py. The wrapper there checks
// device, dtype, shape, contiguity and 16-byte alignment, allocates every
// output, and raises when a function below returns a non-zero
// cudaGetLastError().
//
// Which dtype runs where (fixed, by dtype, in the wrapper): every bfloat16
// kernel runs in flash_attention_tc.cu, and bfloat16 never reaches this
// file. The wrapper's route key for this file is "tf32x3".
//
// Layout (the JAX package's): q, k, v, dO, o, dq, dk, dv are [B, H, S, D]
// contiguous; the optional additive key mask is [B, 1, 1, S] in the input
// dtype; lse and delta are [B, H, S] float32 (the dq kernel writes delta,
// the dk/dv kernel reads it); dmask is [B, H, S] float32 (one row per head,
// summed over heads by the caller). Every sum is float32.
//
// What bounds them, against the data-sheet peaks of an H100 SXM at its
// 700 W power limit (the card measured: NVIDIA H100 80GB HBM3, 700.00 W).
// At the BERT-Small shape [8, 8, 128, 64] float32 (mask, dropout), K1 / K2
// / K3 move 8.5 / 12.7 / 12.7 MB (2.5 / 3.8 / 3.8 us at 3.35 TB/s) and do
// 0.27 / 0.40 / 0.54 GFLOP: 1.6 / 2.4 / 3.3 us at the 165 TFLOP/s of
// float32-accurate products this card has (495 TFLOP/s of TF32, three
// products each), 4.0 / 6.0 / 8.0 us at the 67 TFLOP/s of float32 FMA:
// bytes bound all three. At GPT-Small's [8, 8, 512, 64], causal, K1 / K2 /
// K3 move 33.6 / 50.6 / 50.6 MB (10.0 / 15.1 / 15.1 us) and do 2.15 / 3.22
// / 4.29 GFLOP (13.0 / 19.5 / 26.0 us at 165 TFLOP/s; 32 / 48 / 64 us at
// 67): operations bound them. At gpt_lm's [16, 4, 64, 32], causal, K1
// moves 2.1 MB (0.63 us) and does 0.017 GFLOP (0.10 us): bytes. At
// [2, 8, 8192, 64] (padded mask) K1 does 275 GFLOP (1.67 ms): operations.
// What holds K1 above those bounds: per stage of 32 keys a block of 64
// rows has 0.4 us of 3xTF32 products at the tensor cores' peak for
// S = Q K^T and as much for O += P V, beside an element-wise softmax over
// 64 x 32 scores that its one consumer warpgroup cannot overlap with its
// own products; and at BERT's and gpt_lm's short rows a block meets one to
// four stages, so the copies' latency before its first product weighs as
// much as its products.
//
// 3xTF32: each float32 operand x is split into big = cvt.rna.tf32(x) (the
// low 13 bits cleared, so big is exactly a TF32 value) and small =
// cvt.rna.tf32(x - big), and a product is three tensor-core products into
// one float32 accumulator per k step of 8: small_a big_b, then big_a
// small_b, then big_a big_b. The dropped small_a small_b term and the
// rounding of small are about 2^-22 of each product, near float32's own
// rounding, where one TF32 product errs by about 2^-11.
//
// K1, K2 and K3 are Hopper designs, and what that does about the limits of
// the mma.sync design they replaced (4 warps of 16 rows each, every warp
// reading every streamed 32-row stage through 32-bit ld.shared fragment
// loads, all 128 threads issuing cp.async copies into two stages and
// splitting them, a __syncthreads per stage, so that copies and splits
// never overlapped products; K1 also split Q again at every 16-key step
// and rescaled O every 16 keys):
// - A block is two warpgroups: warpgroup 0 (128 threads) owns the block's
//   64 output rows and only multiplies and does the element-wise work;
//   warpgroup 1 produces. Its first thread issues every TMA copy (3-D tensor
//   maps over [B*H, S, D], rows past S arrive as zeros and never read the
//   next slice) into full/empty-mbarrier stages: the block's own rows once
//   (Q in K1; Q and dO in K2; K and V in K3), then a ring of stages (K and
//   V, 32 keys, in K1 and K2; Q and dO, 32 queries, in K3). Its 128 threads
//   fill each stage's small vectors (K1's and K2's mask row, K3's lse,
//   delta and row seeds) and run the split pass, then arrive on the stage's
//   "ready" mbarrier: the consumers issue no copy, no split and no
//   __syncthreads. K1's producer issues its first stages' copies together
//   with Q's and splits Q while they land.
// - Operands. wgmma reads float32 (.tf32) operands from shared memory
//   K-major only: the transpose bits are for 16-bit types. Each tile lands
//   raw as TMA writes it, in K-major panels of 32 floats (16 at D = 16)
//   with 16-byte chunks swizzled over the panel's 128 (64) bytes, which is
//   the layout the wgmma descriptor names, so reads are free of bank
//   conflicts. The split pass writes big = tf32(x) in place and small =
//   tf32(x - big) into a twin tile of the same layout. The products that
//   contract over the rows TMA wrote (K1's O += drop(P) V, K3's
//   dV += drop(P^T) dO and dK += dS^T Q, K2's dq += dS K) need the
//   transposes: the split pass also writes big and small of V^T (K1, which
//   needs V in no other form), dO^T and Q^T (K3) and K^T (K2), [D][rows]
//   tiles in the same swizzle, one thread per row so that each transposed
//   store of a warp fills one 128-byte row. Their columns hold the stage's
//   rows in a_split's k order, so the accumulator of S (S^T, dP^T) is the
//   register A operand of the next product with no shuffle.
// - Products. S = Q K^T (K1, K2), dP = dO V^T (K2), S^T = K Q^T and
//   dP^T = V dO^T (K3) are wgmma.m64nNk8 with both operands from shared
//   memory, three per k step (small·big, big·small, big·big, each from its
//   own tile). drop(P) (K1), dS (K2), drop(P^T) and dS^T (K3) are split
//   into big and small in registers (a_split: the rounding of cvt.rna.tf32
//   in integer instructions) and are the A of the second products, three
//   per k step, B the transposes. Their exp is exp_fast (ex2.approx). K1
//   and K2 leave the second product in flight while they issue the next
//   stage's first ones (three stages, two at D = 128); one wait covers them
//   all, then the stage is released. K1 rescales O between that wait and
//   its next P V, once a stage. K3 waits for its dV and dK within the stage
//   and releases the stage there: with its two stages the producer then has
//   a whole stage's time to copy and split the next but one
//   (kernel_variants dkv_in_flight leaves the products in flight;
//   fwd_pv_waited makes K1 wait as K3 does).
// - ptxas keeps the products of a stage in flight together only if no
//   non-wgmma instruction may define an accumulator while a product runs;
//   else it serializes every wgmma of the kernel (its C7515 report, which
//   chip_smoke.py's build phase fails on). Hence the element-wise results
//   go into registers of their own (the scores, the split A operands),
//   never over an accumulator (K1 rescales O where no product is in
//   flight), and the consumers' loops are do-while loops: every block has
//   a stage, and a loop that may run no time joins the zeros of its
//   skipped path to the final wait (kernel_variants loop_may_skip).
// - The element-wise loops (scores and softmax, P, the keep bits, dS,
//   dmask) are unrolled and branch-free: the bounds and dropout tests are
//   resolved per tile.
// - Shared memory at D = 64: K1 32 KB of own tiles (Q, big and small) and
//   three stages of five 8 KB tiles (K, K small, V, V^T, V^T small),
//   155 KB; K3 64 KB of own tiles (K, V, big and small) and two stages of
//   eight 8 KB tiles (Q, dO, Q^T, dO^T, big and small), 194 KB; K2 64 KB of
//   own tiles and three stages of six 8 KB tiles (K, V, K^T), 210 KB. One
//   block per SM, one consumer warpgroup: the main path's float32 shapes
//   (BERT's S = 128, gpt_lm's S = 64) fill the card with 64-row blocks.
//   At D = 128 the stages are short: K1 and K2 stream 16 keys a stage (two
//   stages), K3 8 queries (three stages). __launch_bounds__(256, 1): the
//   consumers' accumulators (o, dq, or dk and dv: D/2 floats each a thread)
//   get up to 255 registers.
// - Blocks are taken row block by row block, each for every (b, h), the
//   longest first (block_coords): under causal masking the last query rows
//   (K1, K2) and the first key rows (K3) meet the most pairs.
// - Causal: K1 and K2 stop after the block's last query row, K3 starts at
//   the block's first key. Elements past the diagonal are masked one by
//   one.
//
// Attention dropout is the JAX package's counter-based hash
// (flash_common.cuh): the decision for element (b, h, i, j) is a
// murmur3-finalizer chain keyed by the seed, the (b, h) slice, the query
// position and the key position, kept when the hash is below
// round(keep * 2^32). All three kernels draw it for each accumulator slot
// at its (query, key) position. It reproduces the TPU kernels' bits.

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using flash::keep;
using flash::Params;
using flash::drop_slice;
using flash::row_seed;
using flash::row_seed_of;
using flash::slice_seed;

// ---------------------------------------------------------------------------
// Geometry, and the 3xTF32 split
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;         // rows of the consumer warpgroup: wgmma's M, a block's rows
constexpr int kThreads = 256;       // the consumer warpgroup, then the producer warpgroup
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may opt into
constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// queries per K3 stage and its stages; keys per K1 and K2 stage and their
// stages. D = 128 needs short stages: K2's and K3's own tiles alone take
// 128 KB, K1's 64 KB.
template <int D>
__host__ __device__ constexpr int dkv_rows() { return D == 128 ? 8 : 32; }
template <int D>
__host__ __device__ constexpr int dkv_stages() { return D == 64 ? 2 : 3; }
template <int D>
__host__ __device__ constexpr int dq_keys() { return D == 128 ? 16 : 32; }
template <int D>
__host__ __device__ constexpr int dq_stages() { return D == 128 ? 2 : 3; }

// x rounded to TF32 (10 mantissa bits, nearest, ties away from zero), with
// the 13 bits below it cleared so the register also reads as that float
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// the 3xTF32 split: big = tf32(x), small = tf32(x - big); the tensor core
// reads only the upper 19 bits of small, so they need no clearing
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// a register A operand, split: per warp the m16k8 A fragment of
// mma.m16n8k8 (rows g, g + 8 at k = t, t, t + 4, t + 4; lane = 4 g + t)
template <int N>
struct Split {
  uint32_t big[N];
  uint32_t small[N];
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The block's (b, h) and first output row, with the blocks taken in
// launch order slice by slice: every (b, h) of one row block before the
// next. Causal attention gives the row blocks unequal work (the last query
// rows meet the most keys, the first key rows the most queries), so the
// longest go first (`last_first`: the forward and dq kernels) and the
// short ones fill the tail.
__device__ __forceinline__ void block_coords(const Params& p, bool last_first, int& b,
                                             int& h, int& bh, int& row0) {
  const int slices = gridDim.y * gridDim.z;
  const int linear = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int rb = linear / slices;
  bh = linear - rb * slices;
  b = bh / p.H;
  h = bh - b * p.H;
  row0 = (last_first ? gridDim.x - 1 - rb : rb) * kWgRows;
}

// a warp's 16 x D accumulators (the wgmma m64nD layout, 8 columns a chunk)
// to rows row_a (rows g, times mul_a) and row_a + 8 (times mul_b) of a
// [S, D] slice: each quad writes 32 contiguous bytes
template <int D>
__device__ __forceinline__ void store_rows_c(float* out, const float (&acc)[D / 8][4],
                                             float mul_a, float mul_b, int row_a, int S,
                                             int t) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < S)
      *reinterpret_cast<float2*>(out + (size_t)row_a * D + col) =
          make_float2(acc[n][0] * mul_a, acc[n][1] * mul_a);
    if (row_b < S)
      *reinterpret_cast<float2*>(out + (size_t)row_b * D + col) =
          make_float2(acc[n][2] * mul_b, acc[n][3] * mul_b);
  }
}

// ---------------------------------------------------------------------------
// Shared-memory tiles, 3xTF32 wgmma, the split pass
// ---------------------------------------------------------------------------

// A float32 tile of `rows` rows and K columns as TMA writes it, and as the
// split pass writes its twins and transposes: K / P panels of [rows][P],
// P = min(K, 32), rows of R = 4P bytes whose 16-byte chunks are swizzled by
// the row (the 32, 64 or 128-byte mode, chosen by R). That is the K-major
// layout a wgmma descriptor names. Every tile starts on 1024 bytes and every
// panel on a multiple of its swizzle's period.
template <int K>
struct Tile32 {
  static constexpr int P = K < 32 ? K : 32;
  static constexpr int R = 4 * P;
  static constexpr int kCount = K / P;
  static constexpr int kSteps = P / 8;  // k8 steps along a panel's row
  static constexpr uint64_t kLayout = R == 128 ? 1 : R == 64 ? 2 : 3;  // wgmma swizzle code
  static_assert(kCount * P == K && P % 8 == 0, "Tile32: whole panels of whole k8 steps");
};

// byte offset of element (row, col) of a Tile32<K> tile of `rows` rows: the
// swizzle XORs the 16-byte chunk (offset bits 4 and up) with the offset's
// bits from 7 up, as many as the mode has
template <int K>
__host__ __device__ constexpr uint32_t tile_off(int rows, int row, int col) {
  using T = Tile32<K>;
  const uint32_t off = (col / T::P) * rows * T::R + row * T::R + (col % T::P) * 4;
  return off ^ (((off >> 7) & (T::R / 16 - 1)) << 4);
}

// a_split feeds the tensor core k index l of each 8-row step as stage row
// 2 (l % 4) + l / 4; stage row r therefore sits at k index k_slot(r) of the
// transposed tiles that are the B of those products
__host__ __device__ constexpr int k_slot(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
}

// K-major descriptor of rows row0 .. of a Tile32<K> tile of `rows` rows at
// shared address `tile`, its k8 step kk: 32 bytes of a swizzled row, groups
// of 8 rows 8 R bytes apart
template <int K>
__device__ __forceinline__ uint64_t desc32(uint32_t tile, int rows, int row0, int kk) {
  using T = Tile32<K>;
  const uint32_t addr = tile + (kk / T::kSteps) * rows * T::R + row0 * T::R +
                        (kk % T::kSteps) * 32;
  return make_desc(addr, 16, 8 * T::R, T::kLayout);
}

#define ACC4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define ACC8(i) ACC4(i), ACC4((i) + 4)
#define ACC16(i) ACC8(i), ACC8((i) + 8)
#define ACC32(i) ACC16(i), ACC16((i) + 16)

// d (m64nN, f32) = or += A (64 x 8 tf32, K-major in shared memory) B (N x 8,
// K-major in shared memory); scale_d = 0 ignores d. Thread 4 g + t of warp
// w holds rows 16 w + g (d[4 i], d[4 i + 1]) and 16 w + g + 8 (d[4 i + 2],
// d[4 i + 3]) at columns 8 i + 2 t, 8 i + 2 t + 1: the mma.m16n8 C layout
// of each 8-column chunk i, per warp. TF32 operands are read K-major only.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t a, uint64_t b, int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32, "wgmma_tf32_ss: N is 8, 16 or 32");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
        : ACC4(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : ACC8(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : ACC16(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

// d (m64nN, f32) += A (64 x 8 tf32 in registers: per warp the m16k8 A
// fragment of mma.m16n8k8, rows g, g + 8 at k = t, t, t + 4, t + 4) B (N x 8,
// K-major in shared memory)
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_tf32_rs: N is 16, 32 or 64");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : ACC8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : ACC16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : ACC32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

#undef ACC32
#undef ACC16
#undef ACC8
#undef ACC4

// d (m64nN) = or += A B over one k8 step in 3xTF32, A and B from shared
// memory, each as a big and a small tile: small_a big_b, then big_a small_b,
// then big_a big_b into the one accumulator, as mma3 does
template <int N>
__device__ __forceinline__ void mma3_ss(float* d, uint64_t a_big, uint64_t a_small,
                                        uint64_t b_big, uint64_t b_small, int scale_d) {
  wgmma_tf32_ss<N>(d, a_small, b_big, scale_d);
  wgmma_tf32_ss<N>(d, a_big, b_small, 1);
  wgmma_tf32_ss<N>(d, a_big, b_big, 1);
}

// d (m64 x D) += A B over k8 step kk in 3xTF32: A split in registers, B a
// pair of transposed tiles ([D][K], Tile32<K>, big at t_big and small at
// t_small), at most 64 columns of d a wgmma
template <int D, int K>
__device__ __forceinline__ void mma3_rs(float* d, const Split<4>& a, uint32_t t_big,
                                        uint32_t t_small, int kk) {
  constexpr int kN = D < 64 ? D : 64;
#pragma unroll
  for (int n = 0; n < D / kN; ++n) {
    float* dn = d + n * (kN / 2);
    wgmma_tf32_rs<kN>(dn, a.small, desc32<K>(t_big, D, n * kN, kk));
    wgmma_tf32_rs<kN>(dn, a.big, desc32<K>(t_small, D, n * kN, kk));
    wgmma_tf32_rs<kN>(dn, a.big, desc32<K>(t_big, D, n * kN, kk));
  }
}

// The split pass, run by the producer warpgroup's 128 threads (thread
// `tid`) over a tile of Rows rows and D columns that TMA has landed raw
// (Tile32<D>): with kRows big = tf32(x) in place and small = tf32(x - big)
// into the twin at `small`; with kTranspose big and small of the transpose
// ([D][Rows], Tile32<Rows>, stage row r at column k_slot(r)) at t_big and
// t_small (K1's V needs only its transpose, and keeps its raw tile). A
// thread takes row r = tid % Rows and every (512 / Rows)-th 16-byte chunk of
// it, all its loads first: the float4 accesses of 8 lanes meet 8 different
// swizzled chunks, and at Rows = 32 each transposed store of a warp fills
// one 128-byte row, so neither conflicts on banks.
template <int D, int Rows, bool kRows, bool kTranspose>
__device__ __forceinline__ void split_pass(unsigned char* tile, unsigned char* small,
                                           unsigned char* t_big, unsigned char* t_small,
                                           int tid) {
  static_assert(Rows * D % 512 == 0 && 128 % Rows == 0, "split_pass: whole float4s a thread");
  constexpr int kIt = Rows * D / 512, kCols = 512 / Rows;
  const int r = tid % Rows, c0 = 4 * (tid / Rows);
  float4 x[kIt];
#pragma unroll
  for (int it = 0; it < kIt; ++it)
    x[it] = *reinterpret_cast<const float4*>(tile + tile_off<D>(Rows, r, c0 + it * kCols));
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int c = c0 + it * kCols;
    const uint32_t off = tile_off<D>(Rows, r, c);
    float4 lo;
    float* xb = &x[it].x;
    float* xs = &lo.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, sm;
      split(xb[e], hi, sm);
      xb[e] = __uint_as_float(hi);
      xs[e] = __uint_as_float(sm);
    }
    if constexpr (kRows) {
      *reinterpret_cast<float4*>(tile + off) = x[it];
      *reinterpret_cast<float4*>(small + off) = lo;
    }
    if constexpr (kTranspose) {
      const int col = k_slot(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t t_off = tile_off<Rows>(D, c + e, col);
        *reinterpret_cast<float*>(t_big + t_off) = xb[e];
        *reinterpret_cast<float*>(t_small + t_off) = xs[e];
      }
    }
  }
}

// The element-wise results of the three kernels (drop(P), dS, drop(P^T),
// dS^T) split for the register A of the second products: big = x rounded to TF32 as
// cvt.rna.tf32 rounds every finite value (to nearest, ties away from zero:
// half of the dropped range added to the magnitude bits, then cleared),
// and small = the same of x - big, low bits cleared too. Two integer
// instructions a rounding where cvt.rna.tf32 and the clearing take about
// five (kernel_variants expf_cvt undoes this and exp_fast). A NaN stays NaN
// or becomes an infinity whose small part is NaN: a non-finite value still
// makes a non-finite product.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the A fragment (Split<4>, k in the order that k_slot inverts) of an
// accumulator chunk c (8 columns, the C fragment of mma.m16n8k8 per warp:
// c0..c3 are rows g, g, g + 8, g + 8 at columns 2 t, 2 t + 1, 2 t,
// 2 t + 1): c0, c2, c1, c3 are A rows g, g + 8, g, g + 8 at k = t, t,
// t + 4, t + 4, so k index l stands for column 2 (l % 4) + l / 4. Split
// with rna_tf32
__device__ __forceinline__ void a_split(Split<4>& a, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a.big[i] = rna_tf32(x[i]);
    a.small[i] = rna_tf32(x[i] - __uint_as_float(a.big[i]));
  }
}

// e^x as 2^(x log2 e) in one MUFU.EX2 (ex2.approx.ftz: about 2 ulp; a
// result below 2^-126 is 0, which no sum of P or dS at float32's
// tolerance tells from it; every P of a row is measured against its lse),
// where expf adds a range reduction.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// the tensor maps of K1, and of K2 and K3 (__grid_constant__: they stay in
// the parameter space, where TMA reads them)
struct FwdMaps {
  CUtensorMap q, k, v;
};

struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

// K1's shared memory, in bytes from the aligned start: the block's own
// tiles Q, Q small ([64][D] each); the stages, each K, K small, V as TMA
// lands it ([kKeys][D]) and V^T, V^T small ([D][kKeys]); each stage's mask
// row; then the barriers own_full, own_ready, full[], ready[], empty[].
template <int D>
struct FwdLayout {
  static constexpr int kKeys = dq_keys<D>();
  static constexpr int kStages = dq_stages<D>();
  static constexpr int kOwn = kWgRows * D * 4;  // one own tile
  static constexpr int kTile = kKeys * D * 4;   // one of a stage's five tiles
  static constexpr int kStage0 = 2 * kOwn;
  static constexpr int kMask = kStage0 + kStages * 5 * kTile;
  static constexpr int kBars = kMask + kStages * kKeys * 4;
  static constexpr int kSmem = kBars + 8 * (2 + 3 * kStages) + 1024;
  static_assert(kSmem <= kSmemLimit, "K1's shared memory exceeds a block's");
};

// K3's shared memory, in bytes from the aligned start: the block's own
// tiles K, K small, V, V small ([64][D] each); the stages, each Q, Q small,
// dO, dO small ([kRows][D]) and Q^T, Q^T small, dO^T, dO^T small
// ([D][kRows]); each stage's lse, delta and row seeds; the block's key mask;
// then the barriers own_full, own_ready, full[], ready[], empty[].
template <int D>
struct DkvLayout {
  static constexpr int kRows = dkv_rows<D>();
  static constexpr int kStages = dkv_stages<D>();
  static constexpr int kOwn = kWgRows * D * 4;  // one own tile
  static constexpr int kTile = kRows * D * 4;   // one of a stage's eight tiles
  static constexpr int kStage0 = 4 * kOwn;
  static constexpr int kLse = kStage0 + kStages * 8 * kTile;
  static constexpr int kDelta = kLse + kStages * kRows * 4;
  static constexpr int kSeed = kDelta + kStages * kRows * 4;
  static constexpr int kKeyMask = kSeed + kStages * kRows * 4;
  static constexpr int kBars = kKeyMask + kWgRows * 4;
  static constexpr int kSmem = kBars + 8 * (2 + 3 * kStages) + 1024;
  static_assert(kSmem <= kSmemLimit, "K3's shared memory exceeds a block's");
};

// K2's shared memory: the block's own tiles Q, Q small, dO, dO small
// ([64][D] each); the stages, each K, K small, V, V small ([kKeys][D]) and
// K^T, K^T small ([D][kKeys]); each stage's mask row; then the barriers
// own_full, own_ready, full[], ready[], empty[].
template <int D>
struct DqLayout {
  static constexpr int kKeys = dq_keys<D>();
  static constexpr int kStages = dq_stages<D>();
  static constexpr int kOwn = kWgRows * D * 4;
  static constexpr int kTile = kKeys * D * 4;  // one of a stage's six tiles
  static constexpr int kStage0 = 4 * kOwn;
  static constexpr int kMask = kStage0 + kStages * 6 * kTile;
  static constexpr int kBars = kMask + kStages * kKeys * 4;
  static constexpr int kSmem = kBars + 8 * (2 + 3 * kStages) + 1024;
  static_assert(kSmem <= kSmemLimit, "K2's shared memory exceeds a block's");
};

// the barriers of K1, K2 and K3: own_full (TMA of the own tiles), own_ready
// (split), and per stage full (TMA), ready (split) and empty (consumed)
struct Bars {
  uint64_t *own_full, *own_ready, *full, *ready, *empty;
};

__device__ __forceinline__ Bars init_bars(unsigned char* at, int stages) {
  uint64_t* b = reinterpret_cast<uint64_t*>(at);
  const Bars bars{b, b + 1, b + 2, b + 2 + stages, b + 2 + 2 * stages};
  if (threadIdx.x == 0) {
    mbar_init(bars.own_full, 1);
    mbar_init(bars.own_ready, 128);
    for (int st = 0; st < stages; ++st) {
      mbar_init(&bars.full[st], 1);
      mbar_init(&bars.ready[st], 128);
      mbar_init(&bars.empty[st], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bars;
}

// TMA of `rows` rows from row `row0` of slice `bh` into a Tile32<D> tile,
// one box per panel
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int row0, int bh) {
  using T = Tile32<D>;
#pragma unroll
  for (int c = 0; c < T::kCount; ++c) tma_load(dst + c * rows * T::R, map, bar, c * T::P, row0, bh);
}

// ---------------------------------------------------------------------------
// K1, forward, float32. Replaces _fwd_kernel
// (gradaccum_tpu/ops/flash_attention.py:127, launched by _flash_forward
// :266) for float32; bfloat16 runs flash_attention_tc.cu. One block per
// (b, h, 64 query rows): warpgroup 0 consumes, warpgroup 1 produces. The
// producer's first thread copies the block's Q rows once and streams key
// stages (K and V, 32 rows, 16 at D = 128) with TMA, the first stages
// together with Q; its 128 threads fill each stage's mask row and run the
// split pass: Q into big and small once, each stage's K into big and small
// and its V into the transposes V^T, big and small. The consumer
// warpgroup computes S = Q K^T (64 queries x the stage's keys) with 3xTF32
// wgmma from shared memory, then in float32 s = S scale + mask_j (-inf past
// S and past the diagonal), the online softmax (the row max across the
// quad, O and the lane's partial l rescaled by exp(m_old - m_new)),
// p = exp(s - m_new), l += p (undropped), the keep bits keep(rseed_i, j)
// that scale p by 1/keep or zero it, and adds O += drop(P) V (drop(P)
// split in registers, B V^T). That product stays in flight while the next
// stage's S is issued; one wait covers both, then the stage is released.
// At the end l is summed across the quad; o = O / l and lse = m + log l.
// Every row meets key 0 in its first stage (key 0 is never past S or past
// a diagonal), so m is finite from then on; a row whose stage holds only
// -inf scores rescales against 0 instead of -inf, so exp(-inf - -inf) is
// never formed. Causal: the key stages stop after the block's last row;
// elements past the diagonal are masked one by one.
// Bound: see the header.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const Params p, const __grid_constant__ FwdMaps maps) {
  using L = FwdLayout<D>;
  constexpr int kKeys = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* mask_s = reinterpret_cast<float*>(smem + L::kMask);  // [stage][kKeys]

  const int S = p.S;
  int b, h, bh, q0;
  block_coords(p, true, b, h, bh, q0);
  const int k_end = p.causal ? min(S, q0 + kWgRows) : S;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    prefetch_map(&maps.q);
    prefetch_map(&maps.k);
    prefetch_map(&maps.v);
  }
  const Bars bars = init_bars(smem + L::kBars, L::kStages);

  if (threadIdx.x >= 128) {  // the producer warpgroup
    const int tid = threadIdx.x - 128;
    // stage `tile`'s K and V, by the first thread
    auto issue = [&](int tile) {
      const int st = tile % L::kStages;
      unsigned char* stage = smem + L::kStage0 + st * 5 * L::kTile;
      mbar_arrive_expect_tx(&bars.full[st], 2 * L::kTile);
      tma_tile<D>(stage, &maps.k, &bars.full[st], kKeys, tile * kKeys, bh);
      tma_tile<D>(stage + 2 * L::kTile, &maps.v, &bars.full[st], kKeys, tile * kKeys, bh);
    };
    // Q and the first stages (free until the ring wraps) fly together
    if (tid == 0) {
      mbar_arrive_expect_tx(bars.own_full, L::kOwn);
      tma_tile<D>(smem, &maps.q, bars.own_full, kWgRows, q0, bh);
      for (int tile = 0; tile < L::kStages && tile < n_tiles; ++tile) issue(tile);
    }
    const float* mask =
        p.mask != nullptr ? static_cast<const float*>(p.mask) + (size_t)b * S : nullptr;
    int tile = 0;  // every block has a stage: a do loop, as in K2
    do {
      const int st = tile % L::kStages;
      const uint32_t phase = (tile / L::kStages) & 1;
      const int j0 = tile * kKeys;
      unsigned char* stage = smem + L::kStage0 + st * 5 * L::kTile;
      mbar_wait(&bars.empty[st], phase ^ 1);
      if (tid == 0 && tile >= L::kStages) issue(tile);
      for (int j = tid; j < kKeys; j += 128)
        mask_s[st * kKeys + j] = (mask != nullptr && j0 + j < S) ? mask[j0 + j] : 0.f;
      if (tile == 0) {  // Q, split once while the first stage lands
        mbar_wait(bars.own_full, 0);
        split_pass<D, kWgRows, true, false>(smem, smem + L::kOwn, nullptr, nullptr, tid);
        fence_proxy_async();
        mbar_arrive(bars.own_ready);
      }
      mbar_wait(&bars.full[st], phase);
      split_pass<D, kKeys, true, false>(stage, stage + L::kTile, nullptr, nullptr, tid);
      split_pass<D, kKeys, false, true>(stage + 2 * L::kTile, nullptr, stage + 3 * L::kTile,
                                        stage + 4 * L::kTile, tid);
      fence_proxy_async();
      mbar_arrive(&bars.ready[st]);
    } while (++tile < n_tiles);
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this lane's two query rows: a (g) and b (g + 8) of the warp's 16
  const int row_w = q0 + warp * 16;
  const int row_a = row_w + g, row_b = row_a + 8;
  uint32_t rseed_a = 0u, rseed_b = 0u;
  if (p.dropout) {
    const uint32_t seed = (uint32_t)(*p.seed);
    rseed_a = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_a);
    rseed_b = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_b);
  }
  const uint32_t base = smem_addr(smem);
  const uint32_t q_big = base, q_small = base + L::kOwn;

  float acc[D / 2], s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  // the online softmax of rows a and b: running max, and this lane's
  // partial sum of the undropped p over the keys it holds
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  Split<4> pa[kKeys / 8];  // drop(P) split, the A operand of P V, chunk n keys 8 n .. 8 n + 7

  mbar_wait(bars.own_ready, 0);
  int tile = 0;  // every block has a stage: a do loop, as in K2
  do {
    const int st = tile % L::kStages;
    const uint32_t phase = (tile / L::kStages) & 1;
    const int j0 = tile * kKeys;
    const uint32_t stage = base + L::kStage0 + st * 5 * L::kTile;

    // S = Q K^T: 64 queries x kKeys keys. The previous stage's P V may
    // still run: one wait covers both, then that stage is released.
    mbar_wait(&bars.ready[st], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      mma3_ss<kKeys>(s, desc32<D>(q_big, kWgRows, 0, kk), desc32<D>(q_small, kWgRows, 0, kk),
                     desc32<D>(stage, kKeys, 0, kk), desc32<D>(stage + L::kTile, kKeys, 0, kk),
                     kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kKeys / 2>(s);
    fence_regs<D / 2>(acc);
    if (tile > 0) mbar_arrive(&bars.empty[(tile - 1) % L::kStages]);

    // element-wise, in float32: the scores (into x, never over the
    // accumulator of S), the stage's row max, the rescale of O and l, and
    // drop(P), split into pa. The bounds and dropout tests are resolved per
    // tile, as in K2.
    const float* ms = mask_s + st * kKeys;
    const bool edge = j0 + kKeys > S || (p.causal && j0 + kKeys - 1 > row_w);
    auto softmax = [&](auto edge_c, auto dropout_c) {
      constexpr bool kEdge = decltype(edge_c)::value, kDropout = decltype(dropout_c)::value;
      float x[kKeys / 2];
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        const float2 mk = *reinterpret_cast<const float2*>(ms + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sc = s[4 * n + e] * p.scale + ((e & 1) ? mk.y : mk.x);
          if constexpr (kEdge) {
            const int j = j0 + n * 8 + 2 * t + (e & 1);
            if (j >= S || (p.causal && j > (e < 2 ? row_a : row_b))) sc = -INFINITY;
          }
          x[4 * n + e] = sc;
          if (e < 2) mx_a = fmaxf(mx_a, sc);
          else mx_b = fmaxf(mx_b, sc);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float corr_a = exp_fast(m_a - base_a), corr_b = exp_fast(m_b - base_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= corr_a;
        acc[4 * i + 1] *= corr_a;
        acc[4 * i + 2] *= corr_b;
        acc[4 * i + 3] *= corr_b;
      }
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        float pd[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pt = exp_fast(x[4 * n + e] - (e < 2 ? base_a : base_b));
          if (e < 2) sum_a += pt;
          else sum_b += pt;
          if constexpr (kDropout) {
            const int j = j0 + n * 8 + 2 * t + (e & 1);
            pt = keep(e < 2 ? rseed_a : rseed_b, (uint32_t)j, p.threshold) ? pt * p.inv_keep
                                                                           : 0.f;
          }
          pd[e] = pt;
        }
        a_split(pa[n], pd);
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
    };
    if (edge) {
      if (p.dropout) softmax(std::true_type(), std::true_type());
      else softmax(std::true_type(), std::false_type());
    } else {
      if (p.dropout) softmax(std::false_type(), std::true_type());
      else softmax(std::false_type(), std::false_type());
    }

    // O += drop(P) V: k = the stage's keys, n = D, B the transposes V^T
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kKeys / 8; ++c)
      mma3_rs<D, kKeys>(acc, pa[c], stage + 3 * L::kTile, stage + 4 * L::kTile, c);
    wgmma_commit();
  } while (++tile < n_tiles);
  wgmma_wait_all();
  fence_regs<D / 2>(acc);

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (t == 0) {
    float* lse = p.out_f32 + (size_t)bh * S;
    if (row_a < S) lse[row_a] = m_a + logf(l_a);
    if (row_b < S) lse[row_b] = m_b + logf(l_b);
  }
  store_rows_c<D>(static_cast<float*>(p.out0) + (size_t)bh * S * D,
                  *reinterpret_cast<const float(*)[D / 8][4]>(acc), 1.f / l_a, 1.f / l_b, row_a,
                  S, t);
}

// ---------------------------------------------------------------------------
// K3, dk/dv (+ per-head dmask), float32. Replaces _dkv_kernel
// (gradaccum_tpu/ops/flash_attention.py:399, from _flash_backward :466).
// One block per (b, h, 64 key rows): warpgroup 0 consumes, warpgroup 1
// produces. The producer's first thread copies the block's K and V rows
// once and streams query stages (Q and dO, 32 rows, 8 at D = 128) with TMA;
// its 128 threads fill each stage's lse, delta and row seeds and run the
// split pass: K and V into big and small, each stage's Q and dO into big
// and small and into their transposes. The consumer warpgroup computes
// S^T = K Q^T and dP^T = V dO^T (64 keys x the stage's queries) with
// 3xTF32 wgmma from shared memory, then P^T = exp(S^T scale + mask_j -
// lse_i), the keep bits keep(rseed_i, j), dS^T = P^T (drop(dP^T) - delta_i),
// all float32, and adds dV += drop(P^T) dO and dK += dS^T Q (A split in
// registers, B the transposes) and dmask_j += sum_i dS^T. dk is scaled by
// the softmax scale once, at the end. Causal: the query stages start at the
// block's first key; elements past the diagonal are masked one by one.
// Bound: see the header.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const Params p, const __grid_constant__ BwdMaps maps) {
  using L = DkvLayout<D>;
  constexpr int kRows = L::kRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);          // [stage][kRows]
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);      // [stage][kRows]
  uint32_t* rseed_s = reinterpret_cast<uint32_t*>(smem + L::kSeed);  // [stage][kRows]
  float* key_mask = reinterpret_cast<float*>(smem + L::kKeyMask);   // [64]

  const int S = p.S;
  int b, h, bh, k0;
  block_coords(p, false, b, h, bh, k0);
  const int i_begin = p.causal ? k0 : 0;
  const int n_tiles = (S - i_begin + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    prefetch_map(&maps.q);
    prefetch_map(&maps.k);
    prefetch_map(&maps.v);
    prefetch_map(&maps.dout);
  }
  const Bars bars = init_bars(smem + L::kBars, L::kStages);

  if (threadIdx.x >= 128) {  // the producer warpgroup
    const int tid = threadIdx.x - 128;
    if (tid == 0) {
      mbar_arrive_expect_tx(bars.own_full, 2 * L::kOwn);
      tma_tile<D>(smem, &maps.k, bars.own_full, kWgRows, k0, bh);
      tma_tile<D>(smem + 2 * L::kOwn, &maps.v, bars.own_full, kWgRows, k0, bh);
    }
    for (int j = tid; j < kWgRows; j += 128)
      key_mask[j] = (p.mask != nullptr && k0 + j < S)
                        ? static_cast<const float*>(p.mask)[(size_t)b * S + k0 + j]
                        : 0.f;
    mbar_wait(bars.own_full, 0);
    split_pass<D, kWgRows, true, false>(smem, smem + L::kOwn, nullptr, nullptr, tid);
    split_pass<D, kWgRows, true, false>(smem + 2 * L::kOwn, smem + 3 * L::kOwn, nullptr, nullptr,
                                  tid);
    fence_proxy_async();
    mbar_arrive(bars.own_ready);
    // the dropout key of this block's (batch, head) slice, once
    const uint32_t sseed =
        p.dropout ? slice_seed((uint32_t)(*p.seed), drop_slice(p, b, h)) : 0u;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int st = tile % L::kStages;
      const uint32_t phase = (tile / L::kStages) & 1;
      const int i0 = i_begin + tile * kRows;
      unsigned char* stage = smem + L::kStage0 + st * 8 * L::kTile;
      mbar_wait(&bars.empty[st], phase ^ 1);
      if (tid == 0) {
        mbar_arrive_expect_tx(&bars.full[st], 2 * L::kTile);
        tma_tile<D>(stage, &maps.q, &bars.full[st], kRows, i0, bh);
        tma_tile<D>(stage + 2 * L::kTile, &maps.dout, &bars.full[st], kRows, i0, bh);
      }
      // lse, delta and the row seeds; 0 past S
      for (int j = tid; j < kRows; j += 128) {
        const int i = i0 + j;
        const bool in = i < S;
        lse_s[st * kRows + j] = in ? p.lse[(size_t)bh * S + i] : 0.f;
        delta_s[st * kRows + j] = in ? p.delta[(size_t)bh * S + i] : 0.f;
        rseed_s[st * kRows + j] = p.dropout ? row_seed_of(sseed, (uint32_t)i) : 0u;
      }
      mbar_wait(&bars.full[st], phase);
      split_pass<D, kRows, true, true>(stage, stage + L::kTile, stage + 4 * L::kTile,
                                 stage + 5 * L::kTile, tid);
      split_pass<D, kRows, true, true>(stage + 2 * L::kTile, stage + 3 * L::kTile,
                                 stage + 6 * L::kTile, stage + 7 * L::kTile, tid);
      fence_proxy_async();
      mbar_arrive(&bars.ready[st]);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this lane's two key rows: a (g) and b (g + 8) of the warp's 16
  const int key_w = k0 + warp * 16;
  const int key_a = key_w + g, key_b = key_a + 8;
  const uint32_t base = smem_addr(smem);
  const uint32_t k_big = base, k_small = base + L::kOwn;
  const uint32_t v_big = base + 2 * L::kOwn, v_small = base + 3 * L::kOwn;

  float dk[D / 2], dv[D / 2], sT[kRows / 2], dpT[kRows / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) {
    sT[i] = 0.f;
    dpT[i] = 0.f;
  }
  float dmask_a = 0.f, dmask_b = 0.f;
  // drop(P^T) and dS^T, split: the A operands of dV += drop(P^T) dO and
  // dK += dS^T Q, chunk n covering queries 8 n .. 8 n + 7 of the stage. The
  // element-wise work writes them and never the accumulators of S^T and
  // dP^T, so that ptxas keeps the products of a stage in flight together.
  Split<4> pa[kRows / 8], sa[kRows / 8];

  mbar_wait(bars.own_ready, 0);
  const float mask_a = key_mask[warp * 16 + g], mask_b = key_mask[warp * 16 + g + 8];
  // every block has a stage (n_tiles >= 1): a loop that may run no time
  // would join a path that never issued a product to the wait below, and
  // ptxas would serialize every wgmma (C7515)
  int tile = 0;
  do {
    const int st = tile % L::kStages;
    const uint32_t phase = (tile / L::kStages) & 1;
    const int i0 = i_begin + tile * kRows;
    const uint32_t stage = base + L::kStage0 + st * 8 * L::kTile;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x kRows queries
    mbar_wait(&bars.ready[st], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      mma3_ss<kRows>(sT, desc32<D>(k_big, kWgRows, 0, kk), desc32<D>(k_small, kWgRows, 0, kk),
                     desc32<D>(stage, kRows, 0, kk), desc32<D>(stage + L::kTile, kRows, 0, kk),
                     kk);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      mma3_ss<kRows>(dpT, desc32<D>(v_big, kWgRows, 0, kk), desc32<D>(v_small, kWgRows, 0, kk),
                     desc32<D>(stage + 2 * L::kTile, kRows, 0, kk),
                     desc32<D>(stage + 3 * L::kTile, kRows, 0, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kRows / 2>(sT);
    fence_regs<kRows / 2>(dpT);

    // element-wise, in float32: drop(P^T) and dS^T, split into pa and sa.
    // The bounds and dropout tests are resolved per tile: each of the four
    // cases is one branch-free unrolled loop.
    const float* ls = lse_s + st * kRows;
    const float* dls = delta_s + st * kRows;
    const uint32_t* rs = rseed_s + st * kRows;
    const bool edge = i0 + kRows > S || (p.causal && i0 < key_w + 16);
    auto elementwise = [&](auto edge_c, auto dropout_c) {
      constexpr bool kEdge = decltype(edge_c)::value, kDropout = decltype(dropout_c)::value;
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) {
        const int il = n * 8 + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(ls + il);
        const float2 delta2 = *reinterpret_cast<const float2*>(dls + il);
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? key_a : key_b;
          float pt = exp_fast(sT[4 * n + e] * p.scale + (e < 2 ? mask_a : mask_b) -
                              ((e & 1) ? lse2.y : lse2.x));
          if constexpr (kEdge) {
            const int i = i0 + il + (e & 1);
            if (i >= S || (p.causal && j > i)) pt = 0.f;
          }
          float dp = dpT[4 * n + e];
          float pdrop = pt;
          if constexpr (kDropout) {
            const bool kept = keep(rs[il + (e & 1)], (uint32_t)j, p.threshold);
            dp = kept ? dp * p.inv_keep : 0.f;
            pdrop = kept ? pt * p.inv_keep : 0.f;
          }
          ds[e] = pt * (dp - ((e & 1) ? delta2.y : delta2.x));
          pd[e] = pdrop;
        }
        dmask_a += ds[0] + ds[1];
        dmask_b += ds[2] + ds[3];
        a_split(pa[n], pd);
        a_split(sa[n], ds);
      }
    };
    if (edge) {
      if (p.dropout) elementwise(std::true_type(), std::true_type());
      else elementwise(std::true_type(), std::false_type());
    } else {
      if (p.dropout) elementwise(std::false_type(), std::true_type());
      else elementwise(std::false_type(), std::false_type());
    }

    // dV += drop(P^T) dO, dK += dS^T Q: k = the stage's queries, n = D
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kRows / 8; ++c) {
      mma3_rs<D, kRows>(dv, pa[c], stage + 6 * L::kTile, stage + 7 * L::kTile, c);
      mma3_rs<D, kRows>(dk, sa[c], stage + 4 * L::kTile, stage + 5 * L::kTile, c);
    }
    wgmma_commit();
    // waited for here, not with the next stage's products: the stage is then
    // released a stage earlier, and with two stages the producer has the
    // whole next stage's time to copy and split into it
    wgmma_wait_all();
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    mbar_arrive(&bars.empty[st]);
  } while (++tile < n_tiles);

  dmask_a = quad_sum(dmask_a);
  dmask_b = quad_sum(dmask_b);
  if (p.out_f32 != nullptr && t == 0) {
    float* dm = p.out_f32 + (size_t)bh * S;
    if (key_a < S) dm[key_a] = dmask_a;
    if (key_b < S) dm[key_b] = dmask_b;
  }
  const size_t slice = (size_t)bh * S * D;
  store_rows_c<D>(static_cast<float*>(p.out0) + slice,
                  *reinterpret_cast<const float(*)[D / 8][4]>(dk), p.scale, p.scale, key_a, S, t);
  store_rows_c<D>(static_cast<float*>(p.out1) + slice,
                  *reinterpret_cast<const float(*)[D / 8][4]>(dv), 1.f, 1.f, key_a, S, t);
}

// ---------------------------------------------------------------------------
// K2, dq (+ delta), float32. Replaces _dq_kernel
// (gradaccum_tpu/ops/flash_attention.py:348, from _flash_backward :466) and
// the delta = rowsum(dO * O) that _flash_backward computes before it
// (:476). One block per (b, h, 64 query rows): warpgroup 0 consumes,
// warpgroup 1 produces. The producer's first thread copies the block's Q
// and dO rows once and streams key stages (K and V, 32 rows, 16 at
// D = 128) with TMA; its 128 threads fill each stage's mask row and run the
// split pass: Q and dO into big and small, each stage's K and V into big
// and small and K also into its transpose. The consumer warpgroup computes
// S = Q K^T and dP = dO V^T (64 queries x the stage's keys) with 3xTF32
// wgmma from shared memory, then P = exp(S scale + mask_j - lse_i), the
// keep bits keep(rseed_i, j), dS = P (drop(dP) - delta_i), all float32, and
// adds dq += dS K (dS split in registers, B K^T). That product stays in
// flight while the next stage's S and dP are issued; one wait covers all of
// them, then the stage is released. dq is scaled by the softmax scale once,
// at the end. Causal: the key stages stop after the block's last query row;
// elements past the diagonal are masked one by one.
// delta (plain float32 FMA over dO and O read from device memory, not a
// matrix product) is computed by the consumers before the key loop, summed
// across the 4 lanes that share a row, used in place and written out for K3.
// Bound: see the header.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const Params p, const __grid_constant__ BwdMaps maps) {
  using L = DqLayout<D>;
  constexpr int kKeys = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* mask_s = reinterpret_cast<float*>(smem + L::kMask);  // [stage][kKeys]

  const int S = p.S;
  int b, h, bh, q0;
  block_coords(p, true, b, h, bh, q0);
  const int k_end = p.causal ? min(S, q0 + kWgRows) : S;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    prefetch_map(&maps.q);
    prefetch_map(&maps.k);
    prefetch_map(&maps.v);
    prefetch_map(&maps.dout);
  }
  const Bars bars = init_bars(smem + L::kBars, L::kStages);

  if (threadIdx.x >= 128) {  // the producer warpgroup
    const int tid = threadIdx.x - 128;
    if (tid == 0) {
      mbar_arrive_expect_tx(bars.own_full, 2 * L::kOwn);
      tma_tile<D>(smem, &maps.q, bars.own_full, kWgRows, q0, bh);
      tma_tile<D>(smem + 2 * L::kOwn, &maps.dout, bars.own_full, kWgRows, q0, bh);
    }
    mbar_wait(bars.own_full, 0);
    split_pass<D, kWgRows, true, false>(smem, smem + L::kOwn, nullptr, nullptr, tid);
    split_pass<D, kWgRows, true, false>(smem + 2 * L::kOwn, smem + 3 * L::kOwn, nullptr, nullptr,
                                  tid);
    fence_proxy_async();
    mbar_arrive(bars.own_ready);
    const float* mask =
        p.mask != nullptr ? static_cast<const float*>(p.mask) + (size_t)b * S : nullptr;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int st = tile % L::kStages;
      const uint32_t phase = (tile / L::kStages) & 1;
      const int j0 = tile * kKeys;
      unsigned char* stage = smem + L::kStage0 + st * 6 * L::kTile;
      mbar_wait(&bars.empty[st], phase ^ 1);
      if (tid == 0) {
        mbar_arrive_expect_tx(&bars.full[st], 2 * L::kTile);
        tma_tile<D>(stage, &maps.k, &bars.full[st], kKeys, j0, bh);
        tma_tile<D>(stage + 2 * L::kTile, &maps.v, &bars.full[st], kKeys, j0, bh);
      }
      for (int j = tid; j < kKeys; j += 128)
        mask_s[st * kKeys + j] = (mask != nullptr && j0 + j < S) ? mask[j0 + j] : 0.f;
      mbar_wait(&bars.full[st], phase);
      split_pass<D, kKeys, true, true>(stage, stage + L::kTile, stage + 4 * L::kTile,
                                 stage + 5 * L::kTile, tid);
      split_pass<D, kKeys, true, false>(stage + 2 * L::kTile, stage + 3 * L::kTile, nullptr,
                                  nullptr, tid);
      fence_proxy_async();
      mbar_arrive(&bars.ready[st]);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this lane's two query rows: a (g) and b (g + 8) of the warp's 16
  const int row_w = q0 + warp * 16;
  const int row_a = row_w + g, row_b = row_a + 8;
  const bool in_a = row_a < S, in_b = row_b < S;
  const size_t slice = (size_t)bh * S * D;
  const float* dout = static_cast<const float*>(p.dout) + slice;

  // delta of rows a and b, while the copies fly: lane t of the quad takes
  // the 16-byte chunks t, t + 4, ... of each row, from device memory
  float delta_a = 0.f, delta_b = 0.f;
  {
    const float* o = static_cast<const float*>(p.o) + slice;
#pragma unroll
    for (int c = t; c < D / 4; c += 4) {
      if (in_a) {
        const float4 x = *reinterpret_cast<const float4*>(dout + (size_t)row_a * D + 4 * c);
        const float4 y = *reinterpret_cast<const float4*>(o + (size_t)row_a * D + 4 * c);
        delta_a = fmaf(x.x, y.x, delta_a);
        delta_a = fmaf(x.y, y.y, delta_a);
        delta_a = fmaf(x.z, y.z, delta_a);
        delta_a = fmaf(x.w, y.w, delta_a);
      }
      if (in_b) {
        const float4 x = *reinterpret_cast<const float4*>(dout + (size_t)row_b * D + 4 * c);
        const float4 y = *reinterpret_cast<const float4*>(o + (size_t)row_b * D + 4 * c);
        delta_b = fmaf(x.x, y.x, delta_b);
        delta_b = fmaf(x.y, y.y, delta_b);
        delta_b = fmaf(x.z, y.z, delta_b);
        delta_b = fmaf(x.w, y.w, delta_b);
      }
    }
  }
  delta_a = quad_sum(delta_a);
  delta_b = quad_sum(delta_b);
  if (t == 0) {
    float* delta = p.out_f32 + (size_t)bh * S;
    if (in_a) delta[row_a] = delta_a;
    if (in_b) delta[row_b] = delta_b;
  }
  const float lse_a = in_a ? p.lse[(size_t)bh * S + row_a] : 0.f;
  const float lse_b = in_b ? p.lse[(size_t)bh * S + row_b] : 0.f;
  uint32_t rseed_a = 0u, rseed_b = 0u;
  if (p.dropout) {
    const uint32_t seed = (uint32_t)(*p.seed);
    rseed_a = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_a);
    rseed_b = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_b);
  }
  const uint32_t base = smem_addr(smem);
  const uint32_t q_big = base, q_small = base + L::kOwn;
  const uint32_t do_big = base + 2 * L::kOwn, do_small = base + 3 * L::kOwn;

  float dq[D / 2], s[kKeys / 2], dp[kKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) {
    s[i] = 0.f;
    dp[i] = 0.f;
  }
  Split<4> sa[kKeys / 8];  // dS split, the A operand of dS K, chunk n keys 8 n .. 8 n + 7

  mbar_wait(bars.own_ready, 0);
  int tile = 0;  // every block has a stage: a do loop, as in K3
  do {
    const int st = tile % L::kStages;
    const uint32_t phase = (tile / L::kStages) & 1;
    const int j0 = tile * kKeys;
    const uint32_t stage = base + L::kStage0 + st * 6 * L::kTile;

    // S = Q K^T and dP = dO V^T: 64 queries x kKeys keys. The previous
    // stage's dS K may still run: one wait covers all three, then that
    // stage is released.
    mbar_wait(&bars.ready[st], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      mma3_ss<kKeys>(s, desc32<D>(q_big, kWgRows, 0, kk), desc32<D>(q_small, kWgRows, 0, kk),
                     desc32<D>(stage, kKeys, 0, kk), desc32<D>(stage + L::kTile, kKeys, 0, kk),
                     kk);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      mma3_ss<kKeys>(dp, desc32<D>(do_big, kWgRows, 0, kk),
                     desc32<D>(do_small, kWgRows, 0, kk),
                     desc32<D>(stage + 2 * L::kTile, kKeys, 0, kk),
                     desc32<D>(stage + 3 * L::kTile, kKeys, 0, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kKeys / 2>(s);
    fence_regs<kKeys / 2>(dp);
    fence_regs<D / 2>(dq);
    if (tile > 0) mbar_arrive(&bars.empty[(tile - 1) % L::kStages]);

    // element-wise, in float32: dS, split into sa (never written over the
    // accumulator of S, as in K3). The bounds and dropout tests are resolved
    // per tile, as in K3.
    const float* ms = mask_s + st * kKeys;
    const bool edge = j0 + kKeys > S || (p.causal && j0 + kKeys - 1 > row_w);
    auto elementwise = [&](auto edge_c, auto dropout_c) {
      constexpr bool kEdge = decltype(edge_c)::value, kDropout = decltype(dropout_c)::value;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        const float2 mk = *reinterpret_cast<const float2*>(ms + n * 8 + 2 * t);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + n * 8 + 2 * t + (e & 1);
          float pt = exp_fast(s[4 * n + e] * p.scale + ((e & 1) ? mk.y : mk.x) -
                              (e < 2 ? lse_a : lse_b));
          if constexpr (kEdge) {
            if (j >= S || (p.causal && j > (e < 2 ? row_a : row_b))) pt = 0.f;
          }
          float d = dp[4 * n + e];
          if constexpr (kDropout)
            d = keep(e < 2 ? rseed_a : rseed_b, (uint32_t)j, p.threshold) ? d * p.inv_keep : 0.f;
          ds[e] = pt * (d - (e < 2 ? delta_a : delta_b));
        }
        a_split(sa[n], ds);
      }
    };
    if (edge) {
      if (p.dropout) elementwise(std::true_type(), std::true_type());
      else elementwise(std::true_type(), std::false_type());
    } else {
      if (p.dropout) elementwise(std::false_type(), std::true_type());
      else elementwise(std::false_type(), std::false_type());
    }

    // dq += dS K: k = the stage's keys, n = D
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kKeys / 8; ++c)
      mma3_rs<D, kKeys>(dq, sa[c], stage + 4 * L::kTile, stage + 5 * L::kTile, c);
    wgmma_commit();
  } while (++tile < n_tiles);
  wgmma_wait_all();
  fence_regs<D / 2>(dq);

  store_rows_c<D>(static_cast<float*>(p.out0) + slice,
                  *reinterpret_cast<const float(*)[D / 8][4]>(dq), p.scale, p.scale, row_a, S,
                  t);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// K1, K2 and K3: the shared-memory opt-in once per kernel instance, then
// the launch on (row blocks, H, B), which block_coords reads. The
// attribute belongs to the device that is current at the first launch: one
// card per process.
template <typename Maps, void (*Kernel)(Params, Maps)>
int launch_tma(size_t smem, const Params& p, int B, const Maps& maps, cudaStream_t stream) {
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid((p.S + kWgRows - 1) / kWgRows, p.H, B);
  Kernel<<<grid, kThreads, smem, stream>>>(p, maps);
  return (int)cudaGetLastError();
}

enum Which { kFwd, kDq, kDkv };

// K1's own tile (Q) is a box of 64 rows and its stages (K, V) of dq_keys;
// K2's own tiles (Q, dO) are boxes of 64 rows and its stages (K, V) of
// dq_keys; K3's own (K, V) of 64 and its stages (Q, dO) of dkv_rows
template <int D>
int launch_d(Which which, const Params& p, int B, cudaStream_t stream) {
  const int slices = B * p.H;
  if (which == kFwd) {
    FwdMaps maps;
    if (!tensor_map(&maps.q, p.q, kF32, slices, p.S, D, kWgRows) ||
        !tensor_map(&maps.k, p.k, kF32, slices, p.S, D, dq_keys<D>()) ||
        !tensor_map(&maps.v, p.v, kF32, slices, p.S, D, dq_keys<D>()))
      return (int)cudaErrorInvalidValue;
    return launch_tma<FwdMaps, flash_fwd_kernel<D>>(FwdLayout<D>::kSmem, p, B, maps, stream);
  }
  BwdMaps maps;
  const int own = kWgRows, streamed = which == kDq ? dq_keys<D>() : dkv_rows<D>();
  const int q_rows = which == kDq ? own : streamed, k_rows = which == kDq ? streamed : own;
  if (!tensor_map(&maps.q, p.q, kF32, slices, p.S, D, q_rows) ||
      !tensor_map(&maps.dout, p.dout, kF32, slices, p.S, D, q_rows) ||
      !tensor_map(&maps.k, p.k, kF32, slices, p.S, D, k_rows) ||
      !tensor_map(&maps.v, p.v, kF32, slices, p.S, D, k_rows))
    return (int)cudaErrorInvalidValue;
  if (which == kDq)
    return launch_tma<BwdMaps, flash_dq_kernel<D>>(DqLayout<D>::kSmem, p, B, maps, stream);
  return launch_tma<BwdMaps, flash_dkv_kernel<D>>(DkvLayout<D>::kSmem, p, B, maps, stream);
}

int dispatch(Which which, int dtype, int D, const Params& p, int B,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // float32 only
  switch (D) {
    case 16: return launch_d<16>(which, p, B, s);
    case 32: return launch_d<32>(which, p, B, s);
    case 64: return launch_d<64>(which, p, B, s);
    case 128: return launch_d<128>(which, p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype must be 0 (float32); bfloat16 runs the same-named *_tc functions of
// flash_attention_tc.cu. Each returns the cudaError_t of its launch.
extern "C" int flash_fwd(int dtype, int D, const void* q, const void* k,
                         const void* v, const void* mask, const int64_t* seed,
                         void* o, float* lse, int B, int H, int S,
                         float scale, int causal, uint32_t threshold,
                         float inv_keep, int dropout, int head_offset, int heads_total, void* stream) {
  Params p = flash::make_params(q, k, v, mask, seed, H, S, scale, causal,
                                threshold, inv_keep, dropout);
  p.head_offset = (uint16_t)head_offset;
  p.heads_total = (uint16_t)heads_total;
  p.out0 = o;
  p.out_f32 = lse;
  return dispatch(kFwd, dtype, D, p, B, stream);
}

// delta (written) is rowsum(dout * o), [B, H, S] float32, for flash_bwd_dkv
extern "C" int flash_bwd_dq(int dtype, int D, const void* q, const void* k,
                            const void* v, const void* mask,
                            const int64_t* seed, const void* dout,
                            const void* o, const float* lse, void* dq,
                            float* delta, int B, int H, int S, float scale,
                            int causal, uint32_t threshold, float inv_keep,
                            int dropout, int head_offset, int heads_total, void* stream) {
  Params p = flash::make_params(q, k, v, mask, seed, H, S, scale, causal,
                                threshold, inv_keep, dropout);
  p.head_offset = (uint16_t)head_offset;
  p.heads_total = (uint16_t)heads_total;
  p.dout = dout;
  p.o = o;
  p.lse = lse;
  p.out0 = dq;
  p.out_f32 = delta;
  return dispatch(kDq, dtype, D, p, B, stream);
}

extern "C" int flash_bwd_dkv(int dtype, int D, const void* q, const void* k,
                             const void* v, const void* mask,
                             const int64_t* seed, const void* dout,
                             const float* lse, const float* delta, void* dk,
                             void* dv, float* dmask, int B, int H, int S,
                             float scale, int causal, uint32_t threshold,
                             float inv_keep, int dropout, int head_offset, int heads_total, void* stream) {
  Params p = flash::make_params(q, k, v, mask, seed, H, S, scale, causal,
                                threshold, inv_keep, dropout);
  p.head_offset = (uint16_t)head_offset;
  p.heads_total = (uint16_t)heads_total;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out0 = dk;
  p.out1 = dv;
  p.out_f32 = dmask;
  return dispatch(kDkv, dtype, D, p, B, stream);
}

// The tensor-map cache's counts (hopper.cuh) since the library was loaded:
// lookups (one for each map a K1, K2 or K3 launch needs) and encodes (the
// lookups that missed, each a call into libcuda)
extern "C" long long flash_f32_map_lookups() { return map_lookups.load(); }

extern "C" long long flash_f32_map_encodes() { return map_encodes.load(); }
