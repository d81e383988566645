// What the two flash-attention sources share: the hash dropout, the
// argument block of every kernel and the launch. Included by
// flash_attention.cu (scalar kernels) and flash_attention_tc.cu (tensor-core
// kernels); each is compiled on its own into a library of its own, so
// nothing here needs external linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;

// ---------------------------------------------------------------------------
// Hash dropout: replaces _hash_u32 / _keep_from_positions / _tile_keep of
// gradaccum_tpu/ops/flash_attention.py:67-96, bit for bit.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  return x ^ (x >> 16);
}

// slice seed from (seed, b*H + h), then the row seed from the query position
__device__ __forceinline__ uint32_t row_seed(uint32_t seed, uint32_t bh,
                                             uint32_t q_pos) {
  const uint32_t slice_seed = hash_u32(seed + bh * kGolden);
  return hash_u32(q_pos + slice_seed * kGolden);
}

__device__ __forceinline__ bool keep(uint32_t rseed, uint32_t k_pos,
                                     uint32_t threshold) {
  return hash_u32(k_pos + rseed * kGolden) < threshold;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* mask;  // nullptr: no mask
  const int64_t* seed;  // device scalar; read only when dropout is on
  const void* dout;
  const float* lse;
  const float* delta;
  void* out0;  // o (fwd), dq (dq), dk (dkv)
  void* out1;  // dv (dkv)
  float* out_f32;  // lse (fwd); dmask per head (dkv), nullptr when not wanted
  int H;
  int S;
  float scale;
  int causal;
  uint32_t threshold;
  float inv_keep;
  int dropout;
};

inline Params make_params(const void* q, const void* k, const void* v,
                          const void* mask, const int64_t* seed, int H, int S,
                          float scale, int causal, uint32_t threshold,
                          float inv_keep, int dropout) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.seed = seed;
  p.H = H;
  p.S = S;
  p.scale = scale;
  p.causal = causal;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  p.dropout = dropout;
  return p;
}

// One block per (rows output rows, head, batch). Returns cudaGetLastError().
template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Params& p, int B, int rows,
           int threads, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory needs an explicit opt-in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + rows - 1) / rows, p.H, B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace flash
