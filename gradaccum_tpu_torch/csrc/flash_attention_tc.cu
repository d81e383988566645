// Flash attention for Hopper (sm_90a) on the tensor cores, bfloat16:
// forward (K1), dq + delta (K2) and dk/dv + per-head dmask (K3).
//
// Replaces, for bfloat16 inputs, the TPU kernels
//   _fwd_kernel  gradaccum_tpu/ops/flash_attention.py:127 (K1)
//   _dq_kernel   gradaccum_tpu/ops/flash_attention.py:348 (K2), with the
//                delta = rowsum(dO * O) that _flash_backward computes
//                before it (:476)
//   _dkv_kernel  gradaccum_tpu/ops/flash_attention.py:399 (K3)
// float32 inputs run the 3xTF32 kernels of flash_attention.cu: the wrapper
// in gradaccum_tpu_torch/ops/flash_attention.py routes by dtype, with no
// fallback. Built by gradaccum_tpu_torch/utils/cuda_build.py (nvcc, plain C
// interface, ctypes), like flash_attention.cu; layouts, dropout bits and
// outputs are that file's (see its header).
//
// Bound at the BERT-Small shape [8, 8, 128, 64] bf16, mask, dropout 0.1:
//   K1 moves 4.2 MB (1.3 us at 3.35 TB/s) and does 0.27 GFLOP (0.3 us at
//      989 TFLOP/s): bytes bound it.
//   K2 moves 6.4 MB (1.9 us) and does 0.40 GFLOP (0.4 us): bytes.
//   K3 moves 6.4 MB (1.9 us) and does 0.54 GFLOP (0.5 us): bytes again.
// So the tensor-core rate is not the limit; what is left after moving the
// products onto them is latency: the loads, the dropout hash and exp2.
//
// What the design does about the limits of the scalar kernels it replaced
// (one thread per row, scalar FMA with two shared-memory loads each,
// element-wise tile loads with a __syncthreads per 32-row tile, 133/168
// registers):
// - Every product is mma.sync.m16n8k16 bf16 -> f32. A block is 4 warps
//   owning 64 output rows, 16 per warp (query rows for K1 and K2, key rows
//   for K3); grid (S/64, H, B) is 128 blocks at the main shape, one wave on
//   132 SMs. No sum crosses blocks, so no atomics.
// - Tiles of 64 streamed rows arrive by 16-byte cp.async copies (zero-filled
//   past S), double-buffered: the next tile's copy is in flight while the
//   current one is used. One __syncthreads per 64-row tile.
// - Rows in shared memory are padded by 16 bytes (D + 8 bf16), so the 8
//   rows an ldmatrix reads fall on 8 different 16-byte bank groups: no
//   bank conflicts for ldmatrix or ldmatrix.trans.
// - The softmax probabilities and dS stay in registers: the f32
//   accumulator of one product is rounded to bf16 and used as the A operand
//   of the next (the m16n8 C layout of two n-tiles is the m16k16 A layout),
//   so P and dS never touch shared memory.
// - The dropout decision is made on each accumulator element at the
//   (query, key) position its fragment slot holds, from a row seed computed
//   once per query row: the same bits as the float32 kernels and the TPU.
//
// Numerics: scores, the online softmax, lse, the normalizer l, delta, dS
// and dmask are float32. P (K1), dS (K2, as _dq_kernel rounds it at :385),
// drop(P)^T and dS^T (K3) are rounded to bf16 before their second product,
// as in every tensor-core flash kernel: about 2^-9 relative per term. l sums
// the undropped, unrounded p, as the float32 forward does. delta sums the
// products of bf16 pairs, each exact in f32. exp is exp2f on scores
// pre-scaled by log2(e).

#include "flash_common.cuh"

namespace {

using flash::kNegInf;
using flash::keep;
using flash::Params;
using flash::drop_slice;
using flash::row_seed;
using flash::row_seed_of;
using flash::slice_seed;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockRows = 16 * kWarps;  // output rows per block, 16 per warp
constexpr int kTile = 64;                // streamed rows per pipeline stage
constexpr int kPad = 8;                  // bf16 padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

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

// four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats to a bf16x2 register, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Tiles. Shared-memory tiles are [rows][D + kPad] bf16.
//
// Fragment layout of mma.m16n8k16 (lane = 4 g + t): the C/D element e of a
// 16x8 n-tile is row g + 8 (e / 2), column 2 t + (e % 2). The A operand's
// registers a0..a3 hold rows g, g + 8, g, g + 8 at columns 2 t (+1), plus 8
// for a2 and a3; so the C elements of n-tiles 2c and 2c + 1 packed pairwise
// are the A operand of the 16 columns of chunk c.
// ---------------------------------------------------------------------------

// rows [r0, r0 + NR) of a [S, D] slice into a tile; rows past S are zero
template <int D, int NR>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < NR * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool valid = r0 + r < S;
    cp_async16(dst + r * (D + kPad) + c * 8,
               src + (size_t)(valid ? r0 + r : 0) * D + c * 8, valid);
  }
}

// A operand (16 rows from row0, the 16 columns from col0) of a tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int col0, int lane) {
  const int r = row0 + (lane % 8) + ((lane / 8) % 2) * 8;
  ldsm_x4(a, tile + r * (D + kPad) + col0 + (lane / 16) * 8);
}

// B operands of two n-tiles when the tile holds B^T as rows: n = rows
// row0..row0+15, k = columns col0..col0+15. b[0], b[1] are n-tile rows
// row0..+7; b[2], b[3] rows row0+8..+15.
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile,
                                            int row0, int col0, int lane) {
  const int r = row0 + (lane % 8) + (lane / 16) * 8;
  ldsm_x4(b, tile + r * (D + kPad) + col0 + ((lane / 8) % 2) * 8);
}

// B operands of two n-tiles when the tile holds B itself: k = rows
// row0..row0+15, n = columns col0..col0+15. b[0], b[1] are columns
// col0..+7; b[2], b[3] columns col0+8..+15.
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile,
                                            int row0, int col0, int lane) {
  const int r = row0 + (lane % 8) + ((lane / 8) % 2) * 8;
  ldsm_x4_t(b, tile + r * (D + kPad) + col0 + (lane / 16) * 8);
}

// Write a warp's 16 x D f32 accumulators (times `mul`) as bf16 into rows
// row0.. of a tile, then copy the warp's rows to rows [out0, ...) of a
// [S, D] slice with 16-byte stores. Only the calling warp's rows are used.
template <int D>
__device__ __forceinline__ void store_warp_rows(bf16* tile, int row0,
                                                const float (&acc)[D / 8][4],
                                                float mul_a, float mul_b,
                                                bf16* out, int out0, int S,
                                                int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    bf16* r = tile + (row0 + g) * (D + kPad) + n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(r) = pack_bf16(acc[n][0] * mul_a, acc[n][1] * mul_a);
    *reinterpret_cast<uint32_t*>(r + 8 * (D + kPad)) =
        pack_bf16(acc[n][2] * mul_b, acc[n][3] * mul_b);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    if (out0 + r < S)
      *reinterpret_cast<uint4*>(out + (size_t)(out0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(tile + (row0 + r) * (D + kPad) + c * 8);
  }
}

// Key/value tile `tile` of a [S, D] slice into stage `st` of kv_s
// ([2 stages][K, V][kTile][D + kPad]), with the tile's row of the batch's
// key mask, times log2 e, into mask_s[st] (0 past S or without a mask)
template <int D>
__device__ __forceinline__ void load_kv_tile(bf16* kv_s, float* mask_s,
                                             const bf16* k, const bf16* v,
                                             const bf16* mask_b, int S,
                                             int tile, int st) {
  constexpr int kTileElems = kTile * (D + kPad);
  const int k0 = tile * kTile;
  bf16* ks = kv_s + st * 2 * kTileElems;
  load_tile<D, kTile>(ks, k, k0, S);
  load_tile<D, kTile>(ks + kTileElems, v, k0, S);
  if (threadIdx.x < kTile) {
    const int j = k0 + threadIdx.x;
    mask_s[st * kTile + threadIdx.x] =
        (mask_b != nullptr && j < S) ? __bfloat162float(mask_b[j]) * kLog2e : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K1, forward. One block per (b, h, 64 query rows); warp w owns rows
// 16 w .. 16 w + 15 of the block. The key/value tiles stream through two
// shared-memory stages. Per tile, each warp computes S = Q K^T (16 x 64, f32
// in registers), scales and masks it, runs the online softmax (row max and
// sum across the 4 lanes that share a row), draws the dropout bits, and
// adds bf16(drop(P)) V to its 16 x D accumulator. Causal: the key loop stops
// after the block's last query row, and each element past its row's
// diagonal is masked.
// Output: o = acc / l (bf16, staged through shared memory for 16-byte
// stores) and lse = m + log l (f32).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_tc_kernel(const Params p) {
  constexpr int kStride = D + kPad;
  constexpr int kTileElems = kTile * kStride;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockRows][kStride]
  bf16* kv_s = q_s + kBlockRows * kStride;        // [2 stages][K, V][kTile][kStride]
  float* mask_s = reinterpret_cast<float*>(kv_s + 4 * kTileElems);  // [2][kTile]

  const int S = p.S;
  const int b = blockIdx.z, h = blockIdx.y, bh = b * p.H + h;
  const int q0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t slice = (size_t)bh * S * D;
  const bf16* k = static_cast<const bf16*>(p.k) + slice;
  const bf16* v = static_cast<const bf16*>(p.v) + slice;
  const bf16* mask =
      p.mask != nullptr ? static_cast<const bf16*>(p.mask) + (size_t)b * S : nullptr;

  const int k_end = p.causal ? min(S, q0 + kBlockRows) : S;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  load_tile<D, kBlockRows>(q_s, static_cast<const bf16*>(p.q) + slice, q0, S);
  load_kv_tile<D>(kv_s, mask_s, k, v, mask, S, 0, 0);
  cp_async_commit();

  // this lane's two query rows: a (g) and b (g + 8) of the warp's 16
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  uint32_t rseed_a = 0u, rseed_b = 0u;
  if (p.dropout) {
    const uint32_t seed = (uint32_t)(*p.seed);
    rseed_a = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_a);
    rseed_b = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_b);
  }
  const float scale_log2 = p.scale * kLog2e;

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (log2 units) and normalizer of rows a and b; l is this
  // lane's partial sum over its columns, summed across the quad at the end
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) load_kv_tile<D>(kv_s, mask_s, k, v, mask, S, tile + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) landed; the next may be in flight
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a<D>(qf[kk], q_s, warp * 16, kk * 16, lane);
    }
    const bf16* ks = kv_s + st * 2 * kTileElems;
    const bf16* vs = ks + kTileElems;
    const float* ms = mask_s + st * kTile;
    const int k0 = tile * kTile;

    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        load_b_rows<D>(bk, ks, c * 16, kk * 16, lane);
        mma(s[2 * c], qf[kk], bk[0], bk[1]);
        mma(s[2 * c + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, mask (log2 units), causal cut, keys past S; the tile's row max
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n * 8 + 2 * t + (e & 1);
        const int j = k0 + jl;
        const int row = e < 2 ? row_a : row_b;
        float x = s[n][e] * scale_log2 + ms[jl];
        if (j >= S || (p.causal && j > row)) x = kNegInf;
        s[n][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
    const float m_new_a = fmaxf(m_a, quad_max(mx_a));
    const float m_new_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = exp2f(m_a - m_new_a), corr_b = exp2f(m_b - m_new_b);
    m_a = m_new_a;
    m_b = m_new_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // P = exp2(S - m); l sums the undropped p; drop(P) in bf16 becomes the
    // A operand of P V, chunk c covering keys 16 c .. 16 c + 15
    uint32_t pf[kTile / 16][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = exp2f(s[n][e] - (e < 2 ? m_a : m_b));
        if (e < 2) l_a += pv[e];
        else l_b += pv[e];
        if (p.dropout) {
          const uint32_t j = (uint32_t)(k0 + n * 8 + 2 * t + (e & 1));
          pv[e] = keep(e < 2 ? rseed_a : rseed_b, j, p.threshold) ? pv[e] * p.inv_keep
                                                                  : 0.f;
        }
      }
      pf[n / 2][(n % 2) * 2] = pack_bf16(pv[0], pv[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }

    // acc += drop(P) V: k = the tile's 64 keys, n = D
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        uint32_t bv[4];
        load_b_cols<D>(bv, vs, c * 16, dc * 16, lane);
        mma(acc[2 * dc], pf[c], bv[0], bv[1]);
        mma(acc[2 * dc + 1], pf[c], bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's copy
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (t == 0) {
    float* lse = p.out_f32 + (size_t)bh * S;
    if (row_a < S) lse[row_a] = m_a * kLn2 + logf(l_a);
    if (row_b < S) lse[row_b] = m_b * kLn2 + logf(l_b);
  }
  // q_s is free (Q lives in registers since tile 0): stage o there
  store_warp_rows<D>(q_s, warp * 16, acc, 1.f / l_a, 1.f / l_b,
                     static_cast<bf16*>(p.out0) + slice, q0 + warp * 16, S, lane);
}

// ---------------------------------------------------------------------------
// K2, dq (+ delta). One block per (b, h, 64 query rows); warp w owns rows
// 16 w .. 16 w + 15, whose Q and dO rows sit in registers as A operands for
// the whole key loop. The key/value tiles (and the mask row, times log2 e)
// stream through two shared-memory stages, as in K1. Per 16 keys of a tile,
// each warp computes S = Q K^T and dP = dO V^T (16 queries x 16 keys, f32),
// then P = exp(S scale + mask_j - lse_i), the keep bits keep(rseed_i, j),
// dS = P (drop(dP) - delta_i), and adds dq += bf16(dS) K, the B operand read
// transposed (ldmatrix.trans) from the same K tile. dq is scaled by the
// softmax scale once at the end. Causal: the key loop stops after the
// block's last query row, and each element past its row's diagonal is
// masked.
// delta_i = sum_d dO_id O_id is computed here, not by a pass before: each
// lane reads its rows' O elements straight from device memory in the
// A-operand layout of its dO fragments (O is read once, so it is not
// staged), multiplies the bf16 pairs in f32 and sums across the 4 lanes
// that share a row. delta is used in place and written out for K3.
// Live registers: the Q and dO fragments (D/4 each) and the dq accumulator
// (D/2), against K3's K, V fragments and dK, dV accumulators (D/4 + D/4 +
// D/2 + D/2); 16 scores and 16 dP values per chunk beside them.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_tc_kernel(const Params p) {
  constexpr int kStride = D + kPad;
  constexpr int kTileElems = kTile * kStride;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockRows][kStride]
  bf16* do_s = q_s + kBlockRows * kStride;        // [kBlockRows][kStride]
  bf16* kv_s = do_s + kBlockRows * kStride;       // [2 stages][K, V][kTile][kStride]
  float* mask_s = reinterpret_cast<float*>(kv_s + 4 * kTileElems);  // [2][kTile]

  const int S = p.S;
  const int b = blockIdx.z, h = blockIdx.y, bh = b * p.H + h;
  const int q0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t slice = (size_t)bh * S * D;
  const bf16* k = static_cast<const bf16*>(p.k) + slice;
  const bf16* v = static_cast<const bf16*>(p.v) + slice;
  const bf16* mask =
      p.mask != nullptr ? static_cast<const bf16*>(p.mask) + (size_t)b * S : nullptr;

  const int k_end = p.causal ? min(S, q0 + kBlockRows) : S;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  // two copy groups: Q and dO first, then the first key/value tile
  load_tile<D, kBlockRows>(q_s, static_cast<const bf16*>(p.q) + slice, q0, S);
  load_tile<D, kBlockRows>(do_s, static_cast<const bf16*>(p.dout) + slice, q0, S);
  cp_async_commit();
  load_kv_tile<D>(kv_s, mask_s, k, v, mask, S, 0, 0);
  cp_async_commit();

  // this lane's two query rows: a (g) and b (g + 8) of the warp's 16
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const bool in_a = row_a < S, in_b = row_b < S;

  // O of rows a and b in the A-operand layout (as dof below): of[kk][0..3]
  // are rows a, b, a, b at columns 16 kk + 2 t (+1), plus 8 for [2] and [3];
  // zero past S. Loaded now, so the loads fly while Q and dO land.
  uint32_t of[D / 16][4];
  {
    const bf16* o = static_cast<const bf16*>(p.o) + slice;
    const uint32_t* oa = reinterpret_cast<const uint32_t*>(o + (size_t)(in_a ? row_a : 0) * D);
    const uint32_t* ob = reinterpret_cast<const uint32_t*>(o + (size_t)(in_b ? row_b : 0) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = (kk * 16 + 2 * t) / 2;  // in bf16 pairs
      of[kk][0] = in_a ? oa[c] : 0u;
      of[kk][1] = in_b ? ob[c] : 0u;
      of[kk][2] = in_a ? oa[c + 4] : 0u;
      of[kk][3] = in_b ? ob[c + 4] : 0u;
    }
  }
  const float lse_a = in_a ? p.lse[(size_t)bh * S + row_a] * kLog2e : 0.f;
  const float lse_b = in_b ? p.lse[(size_t)bh * S + row_b] * kLog2e : 0.f;
  uint32_t rseed_a = 0u, rseed_b = 0u;
  if (p.dropout) {
    const uint32_t seed = (uint32_t)(*p.seed);
    rseed_a = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_a);
    rseed_b = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_b);
  }
  const float scale_log2 = p.scale * kLog2e;

  // Q and dO into registers, and delta, before the key loop, so that the O
  // fragments are dead before it starts
  cp_async_wait<1>();  // Q and dO landed; the first key/value tile may be in flight
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
  float delta_a = 0.f, delta_b = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<D>(qf[kk], q_s, warp * 16, kk * 16, lane);
    load_a<D>(dof[kk], do_s, warp * 16, kk * 16, lane);
    // the products of bf16 pairs are exact in f32
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dof[kk][r]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&of[kk][r]));
      if (r % 2 == 0) delta_a += x.x * y.x + x.y * y.y;
      else delta_b += x.x * y.x + x.y * y.y;
    }
  }
  delta_a = quad_sum(delta_a);
  delta_b = quad_sum(delta_b);
  if (t == 0) {
    float* delta = p.out_f32 + (size_t)bh * S;
    if (in_a) delta[row_a] = delta_a;
    if (in_b) delta[row_b] = delta_b;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) load_kv_tile<D>(kv_s, mask_s, k, v, mask, S, tile + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile landed; the next may be in flight
    __syncthreads();
    const bf16* ks = kv_s + st * 2 * kTileElems;
    const bf16* vs = ks + kTileElems;
    const float* ms = mask_s + st * kTile;
    const int k0 = tile * kTile;

#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {  // 16 keys at a time
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
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4], bv[4];
        load_b_rows<D>(bk, ks, c * 16, kk * 16, lane);
        load_b_rows<D>(bv, vs, c * 16, kk * 16, lane);
        mma(sc[0], qf[kk], bk[0], bk[1]);
        mma(sc[1], qf[kk], bk[2], bk[3]);
        mma(dp[0], dof[kk], bv[0], bv[1]);
        mma(dp[1], dof[kk], bv[2], bv[3]);
      }

      // element-wise, in f32; dS in bf16 is the A operand of dS K
      uint32_t sa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = c * 16 + n * 8 + 2 * t + (e & 1);
          const int j = k0 + jl;
          const int row = e < 2 ? row_a : row_b;
          float pt = exp2f(sc[n][e] * scale_log2 + ms[jl] - (e < 2 ? lse_a : lse_b));
          if (j >= S || (p.causal && j > row)) pt = 0.f;
          float d = dp[n][e];
          if (p.dropout)
            d = keep(e < 2 ? rseed_a : rseed_b, (uint32_t)j, p.threshold) ? d * p.inv_keep
                                                                          : 0.f;
          ds[e] = pt * (d - (e < 2 ? delta_a : delta_b));
        }
        sa[n * 2] = pack_bf16(ds[0], ds[1]);
        sa[n * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dq += dS K: k = these 16 keys, n = D
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        uint32_t bk[4];
        load_b_cols<D>(bk, ks, c * 16, dc * 16, lane);
        mma(acc[2 * dc], sa, bk[0], bk[1]);
        mma(acc[2 * dc + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's copy
  }

  // q_s is free (Q lives in registers since tile 0): stage dq there
  store_warp_rows<D>(q_s, warp * 16, acc, p.scale, p.scale,
                     static_cast<bf16*>(p.out0) + slice, q0 + warp * 16, S, lane);
}

// ---------------------------------------------------------------------------
// K3, dk/dv (+ per-head dmask). One block per (b, h, 64 key rows); warp w
// owns keys 16 w .. 16 w + 15, whose K and V rows sit in registers as A
// operands. The query tiles (Q, dO, lse, delta and the query rows' dropout
// seeds) stream through two shared-memory stages. Per 16 queries of a tile,
// each warp computes S^T = K Q^T and dP^T = V dO^T (16 keys x 16 queries,
// f32), then P^T = exp(S^T scale + mask_j - lse_i), the keep bits
// keep(rseed_i, j), dS^T = P^T (drop(dP^T) - delta_i), and adds
// dV += bf16(drop(P^T)) dO, dK += bf16(dS^T) Q and dmask_j += sum_i dS^T
// (f32). dk is scaled by the softmax scale once at the end. Causal: the
// query tiles before the block's first key hold no pair and are skipped;
// the rest are masked per element.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_tc_kernel(const Params p) {
  constexpr int kStride = D + kPad;
  constexpr int kTileElems = kTile * kStride;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockRows][kStride]
  bf16* v_s = k_s + kBlockRows * kStride;         // [kBlockRows][kStride]
  bf16* qdo_s = v_s + kBlockRows * kStride;       // [2 stages][Q, dO][kTile][kStride]
  float* lse_s = reinterpret_cast<float*>(qdo_s + 4 * kTileElems);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                                // [2][kTile]
  uint32_t* rseed_s = reinterpret_cast<uint32_t*>(delta_s + 2 * kTile);  // [2][kTile]

  const int S = p.S;
  const int b = blockIdx.z, h = blockIdx.y, bh = b * p.H + h;
  const int k0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t slice = (size_t)bh * S * D;
  const bf16* q = static_cast<const bf16*>(p.q) + slice;
  const bf16* dout = static_cast<const bf16*>(p.dout) + slice;
  const bf16* mask = static_cast<const bf16*>(p.mask);
  // the dropout key of this block's (batch, head) slice, once
  const uint32_t sseed =
      p.dropout ? slice_seed((uint32_t)(*p.seed), drop_slice(p, b, h)) : 0u;

  const int i_begin = p.causal ? k0 : 0;
  const int n_tiles = (S - i_begin + kTile - 1) / kTile;

  // query tile `tile` into stage `st`: Q, dO, lse (log2 units), delta and
  // the row seeds; rows past S are zero
  auto load_q = [&](int tile, int st) {
    const int i0 = i_begin + tile * kTile;
    bf16* qs = qdo_s + st * 2 * kTileElems;
    load_tile<D, kTile>(qs, q, i0, S);
    load_tile<D, kTile>(qs + kTileElems, dout, i0, S);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      const bool in = i < S;
      lse_s[st * kTile + threadIdx.x] = in ? p.lse[(size_t)bh * S + i] * kLog2e : 0.f;
      delta_s[st * kTile + threadIdx.x] = in ? p.delta[(size_t)bh * S + i] : 0.f;
      rseed_s[st * kTile + threadIdx.x] =
          p.dropout ? row_seed_of(sseed, (uint32_t)i) : 0u;
    }
  };

  load_tile<D, kBlockRows>(k_s, static_cast<const bf16*>(p.k) + slice, k0, S);
  load_tile<D, kBlockRows>(v_s, static_cast<const bf16*>(p.v) + slice, k0, S);
  load_q(0, 0);
  cp_async_commit();

  // this lane's two key rows: a (g) and b (g + 8) of the warp's 16
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const float mask_a =
      (mask != nullptr && key_a < S) ? __bfloat162float(mask[(size_t)b * S + key_a]) * kLog2e
                                     : 0.f;
  const float mask_b =
      (mask != nullptr && key_b < S) ? __bfloat162float(mask[(size_t)b * S + key_b]) * kLog2e
                                     : 0.f;
  const float scale_log2 = p.scale * kLog2e;

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }
  float dmask_a = 0.f, dmask_b = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) load_q(tile + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a<D>(kf[kk], k_s, warp * 16, kk * 16, lane);
        load_a<D>(vf[kk], v_s, warp * 16, kk * 16, lane);
      }
    }
    const bf16* qs = qdo_s + st * 2 * kTileElems;
    const bf16* dos = qs + kTileElems;
    const float* ls = lse_s + st * kTile;
    const float* dls = delta_s + st * kTile;
    const uint32_t* rs = rseed_s + st * kTile;
    const int i0 = i_begin + tile * kTile;

#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {  // 16 queries at a time
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
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bq[4], bd[4];
        load_b_rows<D>(bq, qs, c * 16, kk * 16, lane);
        load_b_rows<D>(bd, dos, c * 16, kk * 16, lane);
        mma(sT[0], kf[kk], bq[0], bq[1]);
        mma(sT[1], kf[kk], bq[2], bq[3]);
        mma(dpT[0], vf[kk], bd[0], bd[1]);
        mma(dpT[1], vf[kk], bd[2], bd[3]);
      }

      // element-wise, in f32; A operands of the two products in bf16
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = c * 16 + n * 8 + 2 * t + (e & 1);
          const int i = i0 + il;
          const int j = e < 2 ? key_a : key_b;
          float pt = exp2f(sT[n][e] * scale_log2 + (e < 2 ? mask_a : mask_b) - ls[il]);
          if (i >= S || (p.causal && j > i)) pt = 0.f;
          float dp = dpT[n][e];
          float pdrop = pt;
          if (p.dropout) {
            const bool kept = keep(rs[il], (uint32_t)j, p.threshold);
            dp = kept ? dp * p.inv_keep : 0.f;
            pdrop = kept ? pt * p.inv_keep : 0.f;
          }
          ds[e] = pt * (dp - dls[il]);
          pd[e] = pdrop;
        }
        dmask_a += ds[0] + ds[1];
        dmask_b += ds[2] + ds[3];
        pa[n * 2] = pack_bf16(pd[0], pd[1]);
        pa[n * 2 + 1] = pack_bf16(pd[2], pd[3]);
        sa[n * 2] = pack_bf16(ds[0], ds[1]);
        sa[n * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += drop(P^T) dO, dK += dS^T Q: k = these 16 queries, n = D
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        uint32_t bd[4], bq[4];
        load_b_cols<D>(bd, dos, c * 16, dc * 16, lane);
        load_b_cols<D>(bq, qs, c * 16, dc * 16, lane);
        mma(dv[2 * dc], pa, bd[0], bd[1]);
        mma(dv[2 * dc + 1], pa, bd[2], bd[3]);
        mma(dk[2 * dc], sa, bq[0], bq[1]);
        mma(dk[2 * dc + 1], sa, bq[2], bq[3]);
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
  // k_s and v_s are free (K and V live in registers since tile 0)
  store_warp_rows<D>(k_s, warp * 16, dk, p.scale, p.scale,
                     static_cast<bf16*>(p.out0) + slice, k0 + warp * 16, S, lane);
  store_warp_rows<D>(v_s, warp * 16, dv, 1.f, 1.f,
                     static_cast<bf16*>(p.out1) + slice, k0 + warp * 16, S, lane);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(bf16) * (kBlockRows + 4 * kTile) * (D + kPad) + sizeof(float) * 2 * kTile;
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (2 * kBlockRows + 4 * kTile) * (D + kPad) + sizeof(float) * 2 * kTile;
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(bf16) * (2 * kBlockRows + 4 * kTile) * (D + kPad) +
         sizeof(float) * 6 * kTile;
}

enum Which { kFwd, kDq, kDkv };

template <int D>
int launch_d(Which which, const Params& p, int B, cudaStream_t stream) {
  if (which == kFwd)
    return flash::launch<flash_fwd_tc_kernel<D>>(fwd_smem<D>(), p, B, kBlockRows,
                                                 kThreads, stream);
  if (which == kDq)
    return flash::launch<flash_dq_tc_kernel<D>>(dq_smem<D>(), p, B, kBlockRows,
                                                kThreads, stream);
  return flash::launch<flash_dkv_tc_kernel<D>>(dkv_smem<D>(), p, B, kBlockRows,
                                               kThreads, stream);
}

int dispatch(Which which, int dtype, int D, const Params& p, int B,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return (int)cudaErrorInvalidValue;  // bfloat16 only
  switch (D) {
    case 16: return launch_d<16>(which, p, B, s);
    case 32: return launch_d<32>(which, p, B, s);
    case 64: return launch_d<64>(which, p, B, s);
    case 128: return launch_d<128>(which, p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The signatures of flash_fwd / flash_bwd_dq / flash_bwd_dkv in
// flash_attention.cu; dtype must be 1 (bfloat16). Each returns the
// cudaError_t of its launch.
extern "C" int flash_fwd_tc(int dtype, int D, const void* q, const void* k,
                            const void* v, const void* mask,
                            const int64_t* seed, void* o, float* lse, int B,
                            int H, int S, float scale, int causal,
                            uint32_t threshold, float inv_keep, int dropout,
                            int head_offset, int heads_total, void* stream) {
  Params p = flash::make_params(q, k, v, mask, seed, H, S, scale, causal,
                                threshold, inv_keep, dropout);
  p.head_offset = (uint16_t)head_offset;
  p.heads_total = (uint16_t)heads_total;
  p.out0 = o;
  p.out_f32 = lse;
  return dispatch(kFwd, dtype, D, p, B, stream);
}

extern "C" int flash_bwd_dq_tc(int dtype, int D, const void* q, const void* k,
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

extern "C" int flash_bwd_dkv_tc(int dtype, int D, const void* q, const void* k,
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
