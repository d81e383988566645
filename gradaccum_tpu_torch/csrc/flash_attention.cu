// Flash attention for Hopper (sm_90a), scalar route: forward, dq (+ delta)
// and dk/dv (+ dmask), float32 only.
//
// Built by gradaccum_tpu_torch/utils/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes by
// gradaccum_tpu_torch/ops/flash_attention.py. The wrapper there checks
// device, dtype, shape and contiguity, allocates every output, and raises
// when a function below returns a non-zero cudaGetLastError().
//
// Which dtype runs where (fixed, by dtype, in the wrapper): every bfloat16
// kernel (K1, K2, K3) runs on the tensor cores in flash_attention_tc.cu, and
// bfloat16 never reaches this file; this file serves float32, because only
// plain float32 FMA (no TF32) holds the float32 tolerances against the
// plain PyTorch version.
//
// Layout (the JAX package's): q, k, v, dO, o, dq, dk, dv are [B, H, S, D]
// contiguous; the optional additive key mask is [B, 1, 1, S] in the input
// dtype; lse and delta are [B, H, S] float32 (the dq kernel writes delta,
// the dk/dv kernel reads it); dmask is [B, H, S] float32 (one row per head,
// summed over heads by the caller). Every sum is float32.
//
// Design, shared by the three kernels. The TPU kernels walk a sequential
// grid axis over k-blocks (or q-blocks) and carry their sums in VMEM
// scratch. Here that axis is a loop inside one CUDA block: a block owns
// kRows rows of the output (query rows for the forward and dq, key rows
// for dk/dv), one thread per row, and streams the other operand through
// shared memory kTile rows at a time. Each thread keeps its running sums
// in registers and its own input rows in shared memory padded to D+1
// floats (conflict-free per-thread reads); the streamed tile is read by
// every thread at the same address (a broadcast). No sum crosses blocks,
// so no atomics and no second pass.
//
// What bounds it. At the BERT-Small shape [8, 8, 128, 64] in float32 each
// kernel moves 8.5-13 MB, a bound of 2.5-3.9 us at 3.35 TB/s, and does
// 0.27-0.54 GFLOP, 4-8 us at the 67 TFLOP/s of float32 FMA.
// These kernels do the products as scalar float32 FMA with one thread per
// row, so the rate of FMA and shared-memory load instructions bounds them,
// and B*H*S = 8192 threads leave most of the card's warp slots empty.
//
// Attention dropout is the JAX package's counter-based hash
// (flash_common.cuh): the decision for element (b, h, i, j) is a
// murmur3-finalizer chain keyed by the seed, the (b, h) slice, the query
// position and the key position, kept when the hash is below
// round(keep * 2^32). It reproduces the TPU kernels' bits.

#include "flash_common.cuh"

namespace {

using flash::kNegInf;
using flash::keep;
using flash::Params;
using flash::row_seed;

constexpr int kRows = 64;  // output rows per block, one thread each
constexpr int kTile = 32;  // streamed rows per shared-memory tile

// rows [r0, r0 + n) of a [S, D] slice into a [kRows][D+1] (or [kTile][D])
// tile; rows past S read as zero
template <int D, int NROWS, int STRIDE>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int S) {
  for (int idx = threadIdx.x; idx < NROWS * D; idx += kRows) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * STRIDE + d] = (r0 + r < S) ? src[(size_t)(r0 + r) * D + d] : 0.f;
  }
}

// kRows rows of a [kRows][D+1] tile to rows [r0, ...) of a [S, D] slice,
// coalesced
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float* src, int r0,
                                           int S) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kRows) {
    const int r = idx / D;
    const int d = idx - r * D;
    if (r0 + r < S) dst[(size_t)(r0 + r) * D + d] = src[r * (D + 1) + d];
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// ---------------------------------------------------------------------------
// K1, forward, float32. Replaces _fwd_kernel
// (gradaccum_tpu/ops/flash_attention.py:127, launched by _flash_forward
// :266) for float32; bfloat16 runs flash_attention_tc.cu. One block per
// (b, h, kRows query rows); the k-block grid axis becomes the loop over key
// tiles, with the online softmax (m, l, acc) of each row in its thread's
// registers. l sums the undropped p; the dropout keep mask then scales p by
// 1/keep before p.V.
// Causal: the loop stops after the block's last query row, and each row
// stops at its own diagonal.
// Bound at [8,8,128,64] float32: 8.5 MB to move (2.5 us at 3.35 TB/s)
// against 0.27 GFLOP (4 us at the 67 TFLOP/s of float32 FMA). This kernel
// does the FLOPs as scalar FMA, two shared-memory loads each, on 8192
// threads: FMA issue, not memory, bounds it.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kRows)
    flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kRows][D+1] own query rows
  float* k_s = q_s + kRows * (D + 1);  // [kTile][D]
  float* v_s = k_s + kTile * D;        // [kTile][D]
  float* mask_s = v_s + kTile * D;     // [kTile]

  const int S = p.S;
  const int b = blockIdx.z, h = blockIdx.y, bh = b * p.H + h;
  const int q0 = blockIdx.x * kRows;
  const int row = q0 + threadIdx.x;
  const bool active = row < S;
  const size_t slice = (size_t)bh * S * D;
  const float* q = static_cast<const float*>(p.q) + slice;
  const float* k = static_cast<const float*>(p.k) + slice;
  const float* v = static_cast<const float*>(p.v) + slice;
  const float* mask = static_cast<const float*>(p.mask);

  load_rows<D, kRows, D + 1>(q_s, q, q0, S);
  const uint32_t rseed =
      p.dropout ? row_seed((uint32_t)(*p.seed), (uint32_t)bh, (uint32_t)row) : 0u;
  const float* qr = q_s + threadIdx.x * (D + 1);

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  const int k_end = p.causal ? min(S, q0 + kRows) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int kn = min(kTile, S - k0);
    __syncthreads();
    load_rows<D, kTile, D>(k_s, k, k0, S);
    load_rows<D, kTile, D>(v_s, v, k0, S);
    if (threadIdx.x < kTile)
      mask_s[threadIdx.x] = (mask != nullptr && threadIdx.x < kn)
                                ? mask[(size_t)b * S + k0 + threadIdx.x]
                                : 0.f;
    __syncthreads();
    if (!active) continue;
    const int jn = p.causal ? min(kn, row - k0 + 1) : kn;
    if (jn <= 0) continue;

    float s[kTile];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = kNegInf;
      if (j < jn) {
        s[j] = dot_row<D>(qr, k_s + j * D) * p.scale + mask_s[j];
        tile_max = fmaxf(tile_max, s[j]);
      }
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < jn) {
        float pj = expf(s[j] - m_new);
        l += pj;
        if (p.dropout)
          pj = keep(rseed, (uint32_t)(k0 + j), p.threshold) ? pj * p.inv_keep : 0.f;
        const float* vj = v_s + j * D;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vj[d], acc[d]);
      }
    }
    m = m_new;
  }

  __syncthreads();  // q_s is reused to stage the output rows
  if (active) {
    float* orow = q_s + threadIdx.x * (D + 1);
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / l;
    p.out_f32[(size_t)bh * S + row] = m + logf(l);
  }
  __syncthreads();
  store_rows<D>(static_cast<float*>(p.out0) + slice, q_s, q0, S);
}

// ---------------------------------------------------------------------------
// K2, dq (+ delta), float32. Replaces _dq_kernel
// (gradaccum_tpu/ops/flash_attention.py:348, from _flash_backward :466) for
// float32, and the row correction delta = rowsum(dO * O) that
// _flash_backward computes before it (:476); bfloat16 runs
// flash_attention_tc.cu. One block per (b, h, kRows query rows); each
// thread first takes the dot of its dO row with its O row (delta, written
// for the dk/dv kernel), then the loop over key tiles recomputes
// P = exp(S - lse), dP = dO.V^T (dropped and scaled like the forward),
// dS = P (dP - delta), and sums dq += dS.K in registers; the softmax scale
// is applied once at the end.
// Bound at [8,8,128,64] float32: 12.7 MB (3.8 us) against 0.40 GFLOP (6 us
// of float32 FMA); as for the forward, the rate of scalar FMA bounds it.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kRows)
    flash_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // [kRows][D+1] own query rows
  float* do_s = q_s + kRows * (D + 1);   // [kRows][D+1] own dO rows
  float* k_s = do_s + kRows * (D + 1);   // [kTile][D]
  float* v_s = k_s + kTile * D;          // [kTile][D]
  float* mask_s = v_s + kTile * D;       // [kTile]

  const int S = p.S;
  const int b = blockIdx.z, h = blockIdx.y, bh = b * p.H + h;
  const int q0 = blockIdx.x * kRows;
  const int row = q0 + threadIdx.x;
  const bool active = row < S;
  const size_t slice = (size_t)bh * S * D;
  const float* k = static_cast<const float*>(p.k) + slice;
  const float* v = static_cast<const float*>(p.v) + slice;
  const float* mask = static_cast<const float*>(p.mask);

  load_rows<D, kRows, D + 1>(q_s, static_cast<const float*>(p.q) + slice, q0, S);
  load_rows<D, kRows, D + 1>(do_s, static_cast<const float*>(p.dout) + slice, q0, S);
  const float lse_r = active ? p.lse[(size_t)bh * S + row] : 0.f;
  const uint32_t rseed =
      p.dropout ? row_seed((uint32_t)(*p.seed), (uint32_t)bh, (uint32_t)row) : 0u;
  const float* qr = q_s + threadIdx.x * (D + 1);
  const float* dor = do_s + threadIdx.x * (D + 1);

  // delta = dO . O of this thread's row: its O row straight from device
  // memory (read once, so not staged), its dO row from the tile
  __syncthreads();  // do_s is filled by every thread
  float delta_r = 0.f;
  if (active) {
    const float* orow = static_cast<const float*>(p.o) + slice + (size_t)row * D;
#pragma unroll 16
    for (int d = 0; d < D; ++d) delta_r = fmaf(dor[d], orow[d], delta_r);
    p.out_f32[(size_t)bh * S + row] = delta_r;
  }

  float dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;

  const int k_end = p.causal ? min(S, q0 + kRows) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int kn = min(kTile, S - k0);
    __syncthreads();
    load_rows<D, kTile, D>(k_s, k, k0, S);
    load_rows<D, kTile, D>(v_s, v, k0, S);
    if (threadIdx.x < kTile)
      mask_s[threadIdx.x] = (mask != nullptr && threadIdx.x < kn)
                                ? mask[(size_t)b * S + k0 + threadIdx.x]
                                : 0.f;
    __syncthreads();
    if (!active) continue;
    const int jn = p.causal ? min(kn, row - k0 + 1) : kn;
    for (int j = 0; j < jn; ++j) {
      const float* kj = k_s + j * D;
      const float pj = expf(dot_row<D>(qr, kj) * p.scale + mask_s[j] - lse_r);
      float dp = dot_row<D>(dor, v_s + j * D);
      if (p.dropout)
        dp = keep(rseed, (uint32_t)(k0 + j), p.threshold) ? dp * p.inv_keep : 0.f;
      const float ds = pj * (dp - delta_r);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
    }
  }

  __syncthreads();  // q_s is reused to stage the output rows
  if (active) {
    float* out = q_s + threadIdx.x * (D + 1);
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = dq[d] * p.scale;
  }
  __syncthreads();
  store_rows<D>(static_cast<float*>(p.out0) + slice, q_s, q0, S);
}

// ---------------------------------------------------------------------------
// K3, dk/dv (+ per-head dmask), float32. Replaces _dkv_kernel
// (gradaccum_tpu/ops/flash_attention.py:399, from _flash_backward :466) for
// float32; bfloat16 runs flash_attention_tc.cu.
// One block per (b, h, kRows key rows); the loop over query tiles recomputes
// P and dS for the block's keys and sums dv += drop(P)^T.dO,
// dk += dS^T.Q and, with a mask, dmask += sum_i dS in registers. Causal:
// the loop starts at the tile holding the block's first key, and each key
// skips the queries before it.
// Bound at [8,8,128,64] float32: 13.0 MB (3.9 us) against 0.54 GFLOP (8 us
// of float32 FMA), the most work of the three; scalar FMA issue bounds it.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kRows)
    flash_dkv_kernel(const Params p) {
  extern __shared__ float smem[];
  float* k_s = smem;                     // [kRows][D+1] own key rows
  float* v_s = k_s + kRows * (D + 1);    // [kRows][D+1] own value rows
  float* q_s = v_s + kRows * (D + 1);    // [kTile][D]
  float* do_s = q_s + kTile * D;         // [kTile][D]
  float* lse_s = do_s + kTile * D;       // [kTile]
  float* delta_s = lse_s + kTile;        // [kTile]
  uint32_t* rseed_s = reinterpret_cast<uint32_t*>(delta_s + kTile);  // [kTile]

  const int S = p.S;
  const int b = blockIdx.z, h = blockIdx.y, bh = b * p.H + h;
  const int k0 = blockIdx.x * kRows;
  const int key = k0 + threadIdx.x;
  const bool active = key < S;
  const size_t slice = (size_t)bh * S * D;
  const float* q = static_cast<const float*>(p.q) + slice;
  const float* dout = static_cast<const float*>(p.dout) + slice;
  const float* mask = static_cast<const float*>(p.mask);
  const uint32_t seed = p.dropout ? (uint32_t)(*p.seed) : 0u;

  load_rows<D, kRows, D + 1>(k_s, static_cast<const float*>(p.k) + slice, k0, S);
  load_rows<D, kRows, D + 1>(v_s, static_cast<const float*>(p.v) + slice, k0, S);
  const float mask_j = (mask != nullptr && active) ? mask[(size_t)b * S + key] : 0.f;
  const float* kr = k_s + threadIdx.x * (D + 1);
  const float* vr = v_s + threadIdx.x * (D + 1);

  float dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  float dmask = 0.f;

  const int i_begin = p.causal ? (k0 / kTile) * kTile : 0;
  for (int i0 = i_begin; i0 < S; i0 += kTile) {
    const int qn = min(kTile, S - i0);
    __syncthreads();
    load_rows<D, kTile, D>(q_s, q, i0, S);
    load_rows<D, kTile, D>(do_s, dout, i0, S);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      const bool in = threadIdx.x < qn;
      lse_s[threadIdx.x] = in ? p.lse[(size_t)bh * S + i] : 0.f;
      delta_s[threadIdx.x] = in ? p.delta[(size_t)bh * S + i] : 0.f;
      rseed_s[threadIdx.x] = p.dropout ? row_seed(seed, (uint32_t)bh, (uint32_t)i) : 0u;
    }
    __syncthreads();
    if (!active) continue;
    const int i_first = p.causal ? max(0, key - i0) : 0;
    for (int i = i_first; i < qn; ++i) {
      const float* qi = q_s + i * D;
      const float* doi = do_s + i * D;
      const float pij = expf(dot_row<D>(qi, kr) * p.scale + mask_j - lse_s[i]);
      float dp = dot_row<D>(doi, vr);
      float pd = pij;
      if (p.dropout) {
        const bool kept = keep(rseed_s[i], (uint32_t)key, p.threshold);
        dp = kept ? dp * p.inv_keep : 0.f;
        pd = kept ? pij * p.inv_keep : 0.f;
      }
      const float ds = pij * (dp - delta_s[i]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(pd, doi[d], dv[d]);
        dk[d] = fmaf(ds, qi[d], dk[d]);
      }
      dmask += ds;
    }
  }

  __syncthreads();  // k_s / v_s are reused to stage the output rows
  if (active) {
    float* dkr = k_s + threadIdx.x * (D + 1);
    float* dvr = v_s + threadIdx.x * (D + 1);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkr[d] = dk[d] * p.scale;
      dvr[d] = dv[d];
    }
    if (p.out_f32 != nullptr) p.out_f32[(size_t)bh * S + key] = dmask;
  }
  __syncthreads();
  store_rows<D>(static_cast<float*>(p.out0) + slice, k_s, k0, S);
  store_rows<D>(static_cast<float*>(p.out1) + slice, v_s, k0, S);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kRows * (D + 1) + 2 * kTile * D + kTile);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kRows * (D + 1) + 2 * kTile * D + kTile);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * kRows * (D + 1) + 2 * kTile * D + 3 * kTile);
}

enum Which { kFwd, kDq, kDkv };

template <int D>
int launch_d(Which which, const Params& p, int B, cudaStream_t stream) {
  if (which == kFwd)
    return flash::launch<flash_fwd_kernel<D>>(fwd_smem<D>(), p, B, kRows, kRows, stream);
  if (which == kDq)
    return flash::launch<flash_dq_kernel<D>>(dq_smem<D>(), p, B, kRows, kRows, stream);
  return flash::launch<flash_dkv_kernel<D>>(dkv_smem<D>(), p, B, kRows, kRows, stream);
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
                         float inv_keep, int dropout, void* stream) {
  Params p = flash::make_params(q, k, v, mask, seed, H, S, scale, causal,
                                threshold, inv_keep, dropout);
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
                            int dropout, void* stream) {
  Params p = flash::make_params(q, k, v, mask, seed, H, S, scale, causal,
                                threshold, inv_keep, dropout);
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
                             float inv_keep, int dropout, void* stream) {
  Params p = flash::make_params(q, k, v, mask, seed, H, S, scale, causal,
                                threshold, inv_keep, dropout);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out0 = dk;
  p.out1 = dv;
  p.out_f32 = dmask;
  return dispatch(kDkv, dtype, D, p, B, stream);
}
