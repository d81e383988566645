// Flash attention for Hopper (sm_90a), float32: forward (K1), dq + delta
// (K2) and dk/dv + per-head dmask (K3).
//
// Replaces, for float32 inputs, the TPU kernels
//   _fwd_kernel  gradaccum_tpu/ops/flash_attention.py:127 (K1)
//   _dq_kernel   gradaccum_tpu/ops/flash_attention.py:348 (K2), with the
//                delta = rowsum(dO * O) that _flash_backward computes
//                before it (:476)
//   _dkv_kernel  gradaccum_tpu/ops/flash_attention.py:399 (K3)
// Every matrix product of the three runs on the tensor cores as 3xTF32
// mma.sync (below).
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
// moves 2.1 MB (0.63 us) and does 0.017 GFLOP (0.10 us): bytes.
//
// The design (one for all three kernels), and what it does about the limits
// of the scalar kernels it replaced (one thread per row, two shared-memory
// loads per FMA, element-wise tile loads with a __syncthreads per 32-row
// tile, and dk[D], dv[D] per thread, which spilled at D = 128):
// - Every product is mma.sync.m16n8k8 tf32 -> f32: S = Q K^T and
//   O += drop(P) V in K1; S = Q K^T, dP = dO V^T, dq += dS K in K2;
//   S^T = K Q^T, dP^T = V dO^T, dv += drop(P^T) dO, dk += dS^T Q in K3. Each
//   float32 operand x is split into big = cvt.rna.tf32(x) and
//   small = cvt.rna.tf32(x - big), and a product is three mma into one
//   float32 accumulator: small_a big_b, then big_a small_b, then big_a big_b.
//   The dropped small_a small_b term and the rounding of small are about
//   2^-22 of each product, near float32's own rounding, where one TF32
//   product errs by about 2^-11.
// - A block is 4 warps owning 64 output rows, 16 per warp (query rows for
//   K1 and K2, key rows for K3). The other operand streams through shared
//   memory in 32-row stages fetched by 16-byte cp.async copies, zero-filled
//   past S and double-buffered, one __syncthreads per stage. A warp works
//   16 streamed rows at a time. No sum crosses blocks, so no atomics.
// - Each stage is split once, when it lands: every thread splits the
//   16-byte chunks it copied itself (it sees its own copies after
//   cp.async.wait_group, so no barrier is needed first), the big parts in
//   place and the small parts into a twin tile. The four warps then read
//   their B fragments already split, with no arithmetic; splitting at each
//   use made every warp split every streamed value again.
// - The own rows (Q in K1; Q and dO in K2; K and V in K3) stay raw in
//   shared memory and are split at use. The k loop of S (and dP) is
//   unrolled, so the compiler keeps those fragments in registers across a
//   stage's steps where registers allow (K1 unrolls at most 8 k steps: at
//   D = 128 all 16 held so spilled). For K1 a twin tile of Q, split once
//   when it lands, measured 2-19 % slower than this (PERF.md; python3 -m
//   gradaccum_tpu_torch.utils.kernel_variants q_twin_tile): its fragments
//   are then read from shared memory at every step.
//   __launch_bounds__(128, 1) lets the compiler use up to 255 registers a
//   thread: without the bound it held dk/dv at D = 32 to 96 registers and
//   spilled. Shared memory (own tiles, eight stage tiles of D + 4 floats a
//   row) is 87 KB (K1) and 104 KB (K2, K3) a block at D = 64 (two blocks an
//   SM), 169 and 203 KB at D = 128 (one).
// - The accumulators live in m16n8 C fragments spread over the warp: 16 x D
//   floats per warp for o and dq, twice that for dk and dv, D/2 and D
//   registers a thread.
// - Shared-memory rows are D + 4 floats. The fragment loads are 32-bit
//   ld.shared: A fragments and the B fragments of S and dP read rows g and
//   columns t (+4), banks 4 g + t; the B fragments of o, dq, dv and dk read
//   rows 2 t and 2 t + 1 at column g, banks 8 t + g (+4). Both are free of
//   bank conflicts at every D, and so are the stages' twin tiles, which sit
//   a multiple of 32 floats further on.
// - Blocks are taken row block by row block, each for every (b, h), the
//   longest first (block_coords): under causal masking the last query rows
//   (K1, K2) and the first key rows (K3) meet the most pairs, and ending on
//   the short ones keeps the last wave from running on a few SMs.
// - P and dS go from one product to the next in registers, with no shuffle
//   and no trip through shared memory. The m16n8 C fragment holds rows g,
//   g + 8 at columns 2 t, 2 t + 1; the m16k8 A fragment holds rows g, g + 8
//   at columns t, t + 4. A sum over k may visit k in any order, so each
//   8-wide k step of o += drop(P) V, dq += dS K, dv += drop(P^T) dO and
//   dk += dS^T Q feeds the tensor core its k index l as streamed row
//   2 (l % 4) + l / 4: the C registers (c0, c2, c1, c3) are then the A
//   fragment, and the B fragment is read from streamed rows 2 t and 2 t + 1.
// - Causal: K1 and K2 stop after the block's last query row and a warp
//   after its own; K3 starts at the block's first key and a warp skips the
//   query steps before its own. Elements past the diagonal are masked one
//   by one.
// - K1's online softmax runs on the C fragments of S, 16 keys a step: each
//   lane holds rows g and g + 8 at 4 keys of the step, the row max is taken
//   across the quad, and the output registers and the lane's partial sum l
//   are rescaled by exp(m_old - m_new). l is summed across the quad once,
//   at the end. Keys past S or past the diagonal score -inf before the max.
// - delta (K2) is plain float32 FMA over dO and O read from device memory,
//   summed across the 4 lanes that share a row; it is not a matrix
//   product. dmask (K3) sums dS per key in float32 across the quad.
//
// Attention dropout is the JAX package's counter-based hash
// (flash_common.cuh): the decision for element (b, h, i, j) is a
// murmur3-finalizer chain keyed by the seed, the (b, h) slice, the query
// position and the key position, kept when the hash is below
// round(keep * 2^32). All three kernels draw it for each C fragment slot
// at its (query, key) position. It reproduces the TPU kernels' bits.

#include "flash_common.cuh"

namespace {

using flash::keep;
using flash::Params;
using flash::drop_slice;
using flash::row_seed;
using flash::row_seed_of;
using flash::slice_seed;

// ---------------------------------------------------------------------------
// Tensor-core helpers, 3xTF32. Shared-memory tiles are [rows][D + kPad]
// float32.
//
// Fragment layout of mma.m16n8k8 tf32 (lane = 4 g + t): A (16 x 8) a0..a3
// are rows g, g + 8, g, g + 8 at columns t, t, t + 4, t + 4; B (8 x 8) b0,
// b1 are rows t, t + 4 at column g; C (16 x 8) c0..c3 are rows g, g, g + 8,
// g + 8 at columns 2 t, 2 t + 1, 2 t, 2 t + 1.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockRows = 16 * kWarps;  // output rows per block, 16 per warp
constexpr int kStage = 32;               // streamed rows per pipeline stage
constexpr int kStep = 16;                // streamed rows per step of a warp
constexpr int kPad = 4;                  // float padding per shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// an operand's fragment registers, split
template <int N>
struct Split {
  uint32_t big[N];
  uint32_t small[N];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small terms first, then big x big
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(d, a.small, b.big[0], b.big[1]);
  mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

// A fragment of rows row0.. (16) and columns col0.. (8) of a tile
template <int D>
__device__ __forceinline__ void load_a(Split<4>& a, const float* tile, int row0,
                                       int col0, int g, int t) {
  const float* r = tile + (row0 + g) * (D + kPad) + col0 + t;
  split(r[0], a.big[0], a.small[0]);
  split(r[8 * (D + kPad)], a.big[1], a.small[1]);
  split(r[4], a.big[2], a.small[2]);
  split(r[8 * (D + kPad) + 4], a.big[3], a.small[3]);
}

// The B operands come from streamed tiles that split_tile has split: the
// big parts in the tile, the small parts `small` floats after it.

// B fragment when the tile holds B^T as rows: n = rows row0..row0+7,
// k = columns col0..col0+7
template <int D>
__device__ __forceinline__ void load_b_rows(Split<2>& b, const float* tile, int small,
                                            int row0, int col0, int g, int t) {
  const float* r = tile + (row0 + g) * (D + kPad) + col0 + t;
  b.big[0] = __float_as_uint(r[0]);
  b.small[0] = __float_as_uint(r[small]);
  b.big[1] = __float_as_uint(r[4]);
  b.small[1] = __float_as_uint(r[small + 4]);
}

// B fragment when the tile holds B itself: k = rows row0..row0+7 in the
// order of a_from_c (k index l at row 2 (l % 4) + l / 4), n = columns
// col0..col0+7
template <int D>
__device__ __forceinline__ void load_b_cols(Split<2>& b, const float* tile, int small,
                                            int row0, int col0, int g, int t) {
  const float* r = tile + (row0 + 2 * t) * (D + kPad) + col0 + g;
  b.big[0] = __float_as_uint(r[0]);
  b.small[0] = __float_as_uint(r[small]);
  b.big[1] = __float_as_uint(r[D + kPad]);
  b.small[1] = __float_as_uint(r[small + D + kPad]);
}

// the A fragment (16 x 8, k in load_b_cols's order) of a C fragment's
// values: c0, c2, c1, c3 are A rows g, g + 8, g, g + 8 at k = t, t, t + 4,
// t + 4, which are C columns 2 t, 2 t, 2 t + 1, 2 t + 1
__device__ __forceinline__ void a_from_c(Split<4>& a, const float (&c)[4]) {
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// rows [r0, r0 + NR) of a [S, D] slice into a tile; rows past S are zero
template <int D, int NR>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int S) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < NR * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool valid = r0 + r < S;
    cp_async16(dst + r * (D + kPad) + c * 4,
               src + (size_t)(valid ? r0 + r : 0) * D + c * 4, valid);
  }
}

// Split, in place, the 16-byte chunks of a tile that this thread copied
// with load_tile<D, NR>: big parts stay, small parts go `small` floats on.
// After cp.async.wait_group a thread sees its own copies, so this needs no
// barrier before it, only the one after.
template <int D, int NR>
__device__ __forceinline__ void split_tile(float* tile, int small) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < NR * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    float4* x = reinterpret_cast<float4*>(tile + r * (D + kPad) + c * 4);
    float4 big = *x, sm;
    float* b = &big.x;
    float* s = &sm.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t hi, lo;
      split(b[i], hi, lo);
      b[i] = __uint_as_float(hi);
      s[i] = __uint_as_float(lo);
    }
    *x = big;
    *reinterpret_cast<float4*>(tile + small + r * (D + kPad) + c * 4) = sm;
  }
}

// The block's (b, h) and first output row, with the blocks taken in
// launch order slice by slice: every (b, h) of one row block before the
// next. Causal attention gives the row blocks unequal work (the last query
// rows meet the most keys, the first key rows the most queries), so the
// longest go first (`last_first`: the dq kernel) and the short ones fill
// the tail.
__device__ __forceinline__ void block_coords(const Params& p, bool last_first, int& b,
                                             int& h, int& bh, int& row0) {
  const int slices = gridDim.y * gridDim.z;
  const int linear = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int rb = linear / slices;
  bh = linear - rb * slices;
  b = bh / p.H;
  h = bh - b * p.H;
  row0 = (last_first ? gridDim.x - 1 - rb : rb) * kBlockRows;
}

// a warp's 16 x D accumulators to rows row_a (C rows g, times mul_a) and
// row_a + 8 (times mul_b) of a [S, D] slice: each quad writes 32
// contiguous bytes
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
// K1, forward, float32. Replaces _fwd_kernel
// (gradaccum_tpu/ops/flash_attention.py:127, launched by _flash_forward
// :266) for float32; bfloat16 runs flash_attention_tc.cu. One block per
// (b, h, 64 query rows); warp w owns rows 16 w .. 16 w + 15, whose Q rows
// stay raw in shared memory and are split at use. The keys and values (and
// the mask row) stream through two 32-row stages, each split into its TF32
// parts once it lands.
// Per 16 keys, each warp computes S = Q K^T (16 queries x 16 keys), then in
// float32 s = S scale + mask_j (-inf past S and past the diagonal), the
// online softmax (row max across the quad, rescale of o and of the lane's
// partial l by exp(m_old - m_new)), p = exp(s - m_new), l += p (undropped),
// the keep bits keep(rseed_i, j) that scale p by 1/keep or zero it, and
// adds O += drop(P) V, the B operand read from the V stage by rows. At the
// end l is summed across the quad; o = O / l and lse = m + log l.
// Every row meets key 0 in its first step (key 0 is never past S or past a
// diagonal), so m is finite from then on; a row whose step holds only -inf
// scores rescales against 0 instead of -inf, so exp(-inf - -inf) is never
// formed.
// Bound: see the header (bytes at BERT-Small and gpt_lm, operations at
// GPT-Small at 165 TFLOP/s).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const Params p) {
  constexpr int kStride = D + kPad;
  constexpr int kStageElems = kStage * kStride;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [kBlockRows][kStride]
  // [2 stages][K, K small, V, V small][kStage][kStride], split as in K2
  float* kv_s = q_s + kBlockRows * kStride;
  float* mask_s = kv_s + 8 * kStageElems;  // [2][kStage]

  const int S = p.S;
  int b, h, bh, q0;
  block_coords(p, true, b, h, bh, q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t slice = (size_t)bh * S * D;
  const float* k = static_cast<const float*>(p.k) + slice;
  const float* v = static_cast<const float*>(p.v) + slice;
  const float* mask =
      p.mask != nullptr ? static_cast<const float*>(p.mask) + (size_t)b * S : nullptr;

  const int k_end = p.causal ? min(S, q0 + kBlockRows) : S;
  const int n_stages = (k_end + kStage - 1) / kStage;

  // key/value stage `stage` (and its mask row, 0 past S or without a mask)
  // into buffer `st`
  auto load_kv = [&](int stage, int st) {
    const int j0 = stage * kStage;
    float* ks = kv_s + st * 4 * kStageElems;
    load_tile<D, kStage>(ks, k, j0, S);
    load_tile<D, kStage>(ks + 2 * kStageElems, v, j0, S);
    if (threadIdx.x < kStage) {
      const int j = j0 + threadIdx.x;
      mask_s[st * kStage + threadIdx.x] = (mask != nullptr && j < S) ? mask[j] : 0.f;
    }
  };

  load_tile<D, kBlockRows>(q_s, static_cast<const float*>(p.q) + slice, q0, S);
  load_kv(0, 0);
  cp_async_commit();

  // this lane's two query rows: a (g) and b (g + 8) of the warp's 16
  const int row_w = q0 + warp * 16;  // the warp's first row
  const int row_a = row_w + g, row_b = row_a + 8;
  uint32_t rseed_a = 0u, rseed_b = 0u;
  if (p.dropout) {
    const uint32_t seed = (uint32_t)(*p.seed);
    rseed_a = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_a);
    rseed_b = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_b);
  }
  // keys past this bound meet none of the warp's rows
  const int warp_end = p.causal ? min(k_end, row_w + 16) : k_end;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // the online softmax of rows a and b: running max, and this lane's
  // partial sum of the undropped p over the keys it holds
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int stage = 0; stage < n_stages; ++stage) {
    const int st = stage & 1;
    if (stage + 1 < n_stages) load_kv(stage + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage (and Q) landed; the next may be in flight
    float* ks = kv_s + st * 4 * kStageElems;
    float* vs = ks + 2 * kStageElems;
    split_tile<D, kStage>(ks, kStageElems);
    split_tile<D, kStage>(vs, kStageElems);
    __syncthreads();
    const float* ms = mask_s + st * kStage;
    const int j0 = stage * kStage;

    for (int c = 0; c < kStage / kStep && j0 + c * kStep < warp_end; ++c) {
      // S = Q K^T: 16 queries x 16 keys, 2 n-tiles. At most 8 k steps are
      // unrolled: the compiler then keeps Q's split fragments in registers
      // across the stage's steps up to D = 64 (64 registers); all 16 of
      // D = 128 held so spilled.
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < D / 8; ++kk) {
        Split<4> qa;
        load_a<D>(qa, q_s, warp * 16, kk * 8, g, t);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          Split<2> kb;
          load_b_rows<D>(kb, ks, kStageElems, c * kStep + n * 8, kk * 8, g, t);
          mma3(sc[n], qa, kb);
        }
      }

      // element-wise, in float32: scores, the step's row max, the rescale
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = c * kStep + n * 8 + 2 * t + (e & 1);
          const int j = j0 + jl;
          float x = sc[n][e] * p.scale + ms[jl];
          if (j >= S || (p.causal && j > (e < 2 ? row_a : row_b))) x = -INFINITY;
          sc[n][e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x);
          else mx_b = fmaxf(mx_b, x);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float corr_a = expf(m_a - base_a), corr_b = expf(m_b - base_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= corr_a;
      l_b *= corr_b;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][0] *= corr_a;
        acc[dn][1] *= corr_a;
        acc[dn][2] *= corr_b;
        acc[dn][3] *= corr_b;
      }
      // sc becomes drop(P); l sums the undropped p
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pt = expf(sc[n][e] - (e < 2 ? base_a : base_b));
          if (e < 2) l_a += pt;
          else l_b += pt;
          if (p.dropout) {
            const int j = j0 + c * kStep + n * 8 + 2 * t + (e & 1);
            pt = keep(e < 2 ? rseed_a : rseed_b, (uint32_t)j, p.threshold) ? pt * p.inv_keep
                                                                           : 0.f;
          }
          sc[n][e] = pt;
        }
      }

      // O += drop(P) V: k = these 16 keys (two steps of 8), n = D
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        Split<4> pa;
        a_from_c(pa, sc[n]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          Split<2> vb;
          load_b_cols<D>(vb, vs, kStageElems, c * kStep + n * 8, dn * 8, g, t);
          mma3(acc[dn], pa, vb);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's copy
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (t == 0) {
    float* lse = p.out_f32 + (size_t)bh * S;
    if (row_a < S) lse[row_a] = m_a + logf(l_a);
    if (row_b < S) lse[row_b] = m_b + logf(l_b);
  }
  store_rows_c<D>(static_cast<float*>(p.out0) + slice, acc, 1.f / l_a, 1.f / l_b, row_a, S,
                  t);
}

// ---------------------------------------------------------------------------
// K2, dq (+ delta), float32. Replaces _dq_kernel
// (gradaccum_tpu/ops/flash_attention.py:348, from _flash_backward :466) and
// the delta = rowsum(dO * O) that _flash_backward computes before it
// (:476). One block per (b, h, 64 query rows); warp w owns rows
// 16 w .. 16 w + 15, whose Q and dO rows stay in shared memory. The keys
// and values (and the mask row) stream through two 32-row stages, each
// split into its TF32 parts once it lands.
// Per 16 keys, each warp computes S = Q K^T and dP = dO V^T (16 queries x
// 16 keys), then P = exp(S scale + mask_j - lse_i), the keep bits
// keep(rseed_i, j), dS = P (drop(dP) - delta_i), all float32, and adds
// dq += dS K, the B operand read from the same K stage by rows. dq is
// scaled by the softmax scale once, at the end.
// Bound: see the header (bytes at BERT-Small, operations at GPT-Small at
// 165 TFLOP/s).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_kernel(const Params p) {
  constexpr int kStride = D + kPad;
  constexpr int kStageElems = kStage * kStride;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [kBlockRows][kStride]
  float* do_s = q_s + kBlockRows * kStride;         // [kBlockRows][kStride]
  // [2 stages][K, K small, V, V small][kStage][kStride]: split_tile splits
  // each stage into big (in place) and small parts once it lands
  float* kv_s = do_s + kBlockRows * kStride;
  float* mask_s = kv_s + 8 * kStageElems;  // [2][kStage]

  const int S = p.S;
  int b, h, bh, q0;
  block_coords(p, true, b, h, bh, q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t slice = (size_t)bh * S * D;
  const float* dout = static_cast<const float*>(p.dout) + slice;
  const float* k = static_cast<const float*>(p.k) + slice;
  const float* v = static_cast<const float*>(p.v) + slice;
  const float* mask =
      p.mask != nullptr ? static_cast<const float*>(p.mask) + (size_t)b * S : nullptr;

  const int k_end = p.causal ? min(S, q0 + kBlockRows) : S;
  const int n_stages = (k_end + kStage - 1) / kStage;

  // key/value stage `stage` (and its mask row, 0 past S or without a mask)
  // into buffer `st`
  auto load_kv = [&](int stage, int st) {
    const int j0 = stage * kStage;
    float* ks = kv_s + st * 4 * kStageElems;
    load_tile<D, kStage>(ks, k, j0, S);
    load_tile<D, kStage>(ks + 2 * kStageElems, v, j0, S);
    if (threadIdx.x < kStage) {
      const int j = j0 + threadIdx.x;
      mask_s[st * kStage + threadIdx.x] = (mask != nullptr && j < S) ? mask[j] : 0.f;
    }
  };

  load_tile<D, kBlockRows>(q_s, static_cast<const float*>(p.q) + slice, q0, S);
  load_tile<D, kBlockRows>(do_s, dout, q0, S);
  load_kv(0, 0);
  cp_async_commit();

  // this lane's two query rows: a (g) and b (g + 8) of the warp's 16
  const int row_w = q0 + warp * 16;  // the warp's first row
  const int row_a = row_w + g, row_b = row_a + 8;
  const bool in_a = row_a < S, in_b = row_b < S;

  // delta of rows a and b, while the copies fly: lane t of the quad takes
  // the 16-byte chunks t, t + 4, ... of each row, from device memory (O is
  // read once; dO's copy in shared memory may not have landed)
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
  // keys past this bound meet none of the warp's rows
  const int warp_end = p.causal ? min(k_end, row_w + 16) : k_end;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int stage = 0; stage < n_stages; ++stage) {
    const int st = stage & 1;
    if (stage + 1 < n_stages) load_kv(stage + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage (and Q, dO) landed; the next may be in flight
    float* ks = kv_s + st * 4 * kStageElems;
    float* vs = ks + 2 * kStageElems;
    split_tile<D, kStage>(ks, kStageElems);
    split_tile<D, kStage>(vs, kStageElems);
    __syncthreads();
    const float* ms = mask_s + st * kStage;
    const int j0 = stage * kStage;

    for (int c = 0; c < kStage / kStep && j0 + c * kStep < warp_end; ++c) {
      // S = Q K^T and dP = dO V^T: 16 queries x 16 keys, 2 n-tiles each
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = 0.f;
          dp[n][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        Split<4> qa, da;
        load_a<D>(qa, q_s, warp * 16, kk * 8, g, t);
        load_a<D>(da, do_s, warp * 16, kk * 8, g, t);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          Split<2> kb, vb;
          load_b_rows<D>(kb, ks, kStageElems, c * kStep + n * 8, kk * 8, g, t);
          load_b_rows<D>(vb, vs, kStageElems, c * kStep + n * 8, kk * 8, g, t);
          mma3(sc[n], qa, kb);
          mma3(dp[n], da, vb);
        }
      }

      // element-wise, in float32: sc becomes dS
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = c * kStep + n * 8 + 2 * t + (e & 1);
          const int j = j0 + jl;
          const int row = e < 2 ? row_a : row_b;
          float pt = expf(sc[n][e] * p.scale + ms[jl] - (e < 2 ? lse_a : lse_b));
          if (j >= S || (p.causal && j > row)) pt = 0.f;
          float d = dp[n][e];
          if (p.dropout)
            d = keep(e < 2 ? rseed_a : rseed_b, (uint32_t)j, p.threshold) ? d * p.inv_keep
                                                                          : 0.f;
          sc[n][e] = pt * (d - (e < 2 ? delta_a : delta_b));
        }
      }

      // dq += dS K: k = these 16 keys (two steps of 8), n = D
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        Split<4> sa;
        a_from_c(sa, sc[n]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          Split<2> kb;
          load_b_cols<D>(kb, ks, kStageElems, c * kStep + n * 8, dn * 8, g, t);
          mma3(acc[dn], sa, kb);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's copy
  }

  store_rows_c<D>(static_cast<float*>(p.out0) + slice, acc, p.scale, p.scale, row_a, S,
                  t);
}

// ---------------------------------------------------------------------------
// K3, dk/dv (+ per-head dmask), float32. Replaces _dkv_kernel
// (gradaccum_tpu/ops/flash_attention.py:399, from _flash_backward :466).
// One block per (b, h, 64 key rows); warp w owns keys 16 w .. 16 w + 15,
// whose K and V rows stay in shared memory. The queries (Q, dO, lse, delta
// and the query rows' dropout seeds) stream through two 32-row stages, Q
// and dO split into their TF32 parts once they land. Per 16 queries, each warp computes S^T = K Q^T and
// dP^T = V dO^T (16 keys x 16 queries), then P^T = exp(S^T scale + mask_j
// - lse_i), the keep bits keep(rseed_i, j), dS^T = P^T (drop(dP^T) -
// delta_i), all float32, and adds dv += drop(P^T) dO, dk += dS^T Q and
// dmask_j += sum_i dS^T. dk is scaled by the softmax scale once, at the
// end.
// Bound: see the header.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_kernel(const Params p) {
  constexpr int kStride = D + kPad;
  constexpr int kStageElems = kStage * kStride;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // [kBlockRows][kStride]
  float* v_s = k_s + kBlockRows * kStride;          // [kBlockRows][kStride]
  // [2 stages][Q, Q small, dO, dO small][kStage][kStride], split as in K2
  float* qdo_s = v_s + kBlockRows * kStride;
  float* lse_s = qdo_s + 8 * kStageElems;  // [2][kStage]
  float* delta_s = lse_s + 2 * kStage;              // [2][kStage]
  uint32_t* rseed_s = reinterpret_cast<uint32_t*>(delta_s + 2 * kStage);  // [2][kStage]

  const int S = p.S;
  int b, h, bh, k0;
  block_coords(p, false, b, h, bh, k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t slice = (size_t)bh * S * D;
  const float* q = static_cast<const float*>(p.q) + slice;
  const float* dout = static_cast<const float*>(p.dout) + slice;
  const float* mask = static_cast<const float*>(p.mask);
  // the dropout key of this block's (batch, head) slice, once
  const uint32_t sseed =
      p.dropout ? slice_seed((uint32_t)(*p.seed), drop_slice(p, b, h)) : 0u;

  const int i_begin = p.causal ? k0 : 0;
  const int n_stages = (S - i_begin + kStage - 1) / kStage;

  // query stage `stage` into buffer `st`: Q, dO, lse, delta and the row
  // seeds; rows past S are zero
  auto load_q = [&](int stage, int st) {
    const int i0 = i_begin + stage * kStage;
    float* qs = qdo_s + st * 4 * kStageElems;
    load_tile<D, kStage>(qs, q, i0, S);
    load_tile<D, kStage>(qs + 2 * kStageElems, dout, i0, S);
    if (threadIdx.x < kStage) {
      const int i = i0 + threadIdx.x;
      const bool in = i < S;
      lse_s[st * kStage + threadIdx.x] = in ? p.lse[(size_t)bh * S + i] : 0.f;
      delta_s[st * kStage + threadIdx.x] = in ? p.delta[(size_t)bh * S + i] : 0.f;
      rseed_s[st * kStage + threadIdx.x] =
          p.dropout ? row_seed_of(sseed, (uint32_t)i) : 0u;
    }
  };

  load_tile<D, kBlockRows>(k_s, static_cast<const float*>(p.k) + slice, k0, S);
  load_tile<D, kBlockRows>(v_s, static_cast<const float*>(p.v) + slice, k0, S);
  load_q(0, 0);
  cp_async_commit();

  // this lane's two key rows: a (g) and b (g + 8) of the warp's 16
  const int key_w = k0 + warp * 16;  // the warp's first key
  const int key_a = key_w + g, key_b = key_a + 8;
  const float mask_a = (mask != nullptr && key_a < S) ? mask[(size_t)b * S + key_a] : 0.f;
  const float mask_b = (mask != nullptr && key_b < S) ? mask[(size_t)b * S + key_b] : 0.f;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }
  float dmask_a = 0.f, dmask_b = 0.f;

  for (int stage = 0; stage < n_stages; ++stage) {
    const int st = stage & 1;
    if (stage + 1 < n_stages) load_q(stage + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage (and K, V) landed
    float* qs = qdo_s + st * 4 * kStageElems;
    float* dos = qs + 2 * kStageElems;
    split_tile<D, kStage>(qs, kStageElems);
    split_tile<D, kStage>(dos, kStageElems);
    __syncthreads();
    const float* ls = lse_s + st * kStage;
    const float* dls = delta_s + st * kStage;
    const uint32_t* rs = rseed_s + st * kStage;
    const int i0 = i_begin + stage * kStage;

    for (int c = 0; c < kStage / kStep && i0 + c * kStep < S; ++c) {
      // causal: queries before the warp's first key meet none of its keys
      if (p.causal && i0 + c * kStep + kStep <= key_w) continue;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries, 2 n-tiles each
      float sT[2][4], dpT[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sT[n][e] = 0.f;
          dpT[n][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        Split<4> ka, va;
        load_a<D>(ka, k_s, warp * 16, kk * 8, g, t);
        load_a<D>(va, v_s, warp * 16, kk * 8, g, t);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          Split<2> qb, db;
          load_b_rows<D>(qb, qs, kStageElems, c * kStep + n * 8, kk * 8, g, t);
          load_b_rows<D>(db, dos, kStageElems, c * kStep + n * 8, kk * 8, g, t);
          mma3(sT[n], ka, qb);
          mma3(dpT[n], va, db);
        }
      }

      // element-wise, in float32: sT becomes dS^T, dpT drop(P^T)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = c * kStep + n * 8 + 2 * t + (e & 1);
          const int i = i0 + il;
          const int j = e < 2 ? key_a : key_b;
          float pt = expf(sT[n][e] * p.scale + (e < 2 ? mask_a : mask_b) - ls[il]);
          if (i >= S || (p.causal && j > i)) pt = 0.f;
          float dp = dpT[n][e];
          float pdrop = pt;
          if (p.dropout) {
            const bool kept = keep(rs[il], (uint32_t)j, p.threshold);
            dp = kept ? dp * p.inv_keep : 0.f;
            pdrop = kept ? pt * p.inv_keep : 0.f;
          }
          const float ds = pt * (dp - dls[il]);
          if (e < 2) dmask_a += ds;
          else dmask_b += ds;
          sT[n][e] = ds;
          dpT[n][e] = pdrop;
        }
      }

      // dV += drop(P^T) dO, dK += dS^T Q: k = these 16 queries, n = D
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        Split<4> pa, sa;
        a_from_c(pa, dpT[n]);
        a_from_c(sa, sT[n]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          Split<2> db, qb;
          load_b_cols<D>(db, dos, kStageElems, c * kStep + n * 8, dn * 8, g, t);
          load_b_cols<D>(qb, qs, kStageElems, c * kStep + n * 8, dn * 8, g, t);
          mma3(dv[dn], pa, db);
          mma3(dk[dn], sa, qb);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's copy
  }

  dmask_a = quad_sum(dmask_a);
  dmask_b = quad_sum(dmask_b);
  if (p.out_f32 != nullptr && t == 0) {
    float* dm = p.out_f32 + (size_t)bh * S;
    if (key_a < S) dm[key_a] = dmask_a;
    if (key_b < S) dm[key_b] = dmask_b;
  }
  store_rows_c<D>(static_cast<float*>(p.out0) + slice, dk, p.scale, p.scale, key_a, S, t);
  store_rows_c<D>(static_cast<float*>(p.out1) + slice, dv, 1.f, 1.f, key_a, S, t);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// own tiles (K1: Q; K2: Q and dO; K3: K and V), eight stage tiles, and the
// mask rows (K1, K2) or the query rows' lse, delta and seeds (K3)
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((kBlockRows + 8 * kStage) * (D + kPad) + 2 * kStage);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * kBlockRows + 8 * kStage) * (D + kPad) + 2 * kStage);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * kBlockRows + 8 * kStage) * (D + kPad) + 6 * kStage);
}

enum Which { kFwd, kDq, kDkv };

template <int D>
int launch_d(Which which, const Params& p, int B, cudaStream_t stream) {
  if (which == kFwd)
    return flash::launch<flash_fwd_kernel<D>>(fwd_smem<D>(), p, B, kBlockRows, kThreads,
                                              stream);
  if (which == kDq)
    return flash::launch<flash_dq_kernel<D>>(dq_smem<D>(), p, B, kBlockRows, kThreads,
                                             stream);
  return flash::launch<flash_dkv_kernel<D>>(dkv_smem<D>(), p, B, kBlockRows, kThreads,
                                            stream);
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
