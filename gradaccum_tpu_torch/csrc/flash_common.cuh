// What the two flash-attention sources share: the hash dropout and the
// argument block of every kernel. Included by
// flash_attention.cu (float32 kernels) and flash_attention_tc.cu (bfloat16
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

// slice seed from (seed, the slice b*H + h), then the row seed from the
// query position
__device__ __forceinline__ uint32_t slice_seed(uint32_t seed, uint32_t bh) {
  return hash_u32(seed + bh * kGolden);
}

__device__ __forceinline__ uint32_t row_seed_of(uint32_t sseed, uint32_t q_pos) {
  return hash_u32(q_pos + sseed * kGolden);
}

__device__ __forceinline__ uint32_t row_seed(uint32_t seed, uint32_t bh,
                                             uint32_t q_pos) {
  return row_seed_of(slice_seed(seed, bh), q_pos);
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
  const void* o;  // the forward's output (dq, for delta)
  const float* lse;
  const float* delta;
  void* out0;  // o (fwd), dq (dq), dk (dkv)
  void* out1;  // dv (dkv)
  // lse (fwd); delta (dq); dmask per head (dkv), nullptr when not wanted
  float* out_f32;
  int H;
  int S;
  float scale;
  int causal;
  uint32_t threshold;
  float inv_keep;
  int dropout;
  // the dropout key's (batch, head) slice is b*heads_total + head_offset + h:
  // a launch on heads [head_offset, head_offset + H) of a heads_total-head
  // attention (one rank's heads under tensor parallelism) draws exactly that
  // slice of the whole attention's keep mask. Defaults 0 and H. 16 bits
  // each, so that the block stays 128 bytes.
  uint16_t head_offset;
  uint16_t heads_total;
};

// the (batch, head) slice the dropout hash keys on: the launch's (b, h)
// placed in the whole attention, b*H + h under the defaults
__device__ __forceinline__ uint32_t drop_slice(const Params& p, int b, int h) {
  return (uint32_t)(b * p.heads_total + p.head_offset + h);
}

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
  p.head_offset = 0;
  p.heads_total = (uint16_t)H;
  return p;
}

}  // namespace flash
