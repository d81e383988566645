// Hopper primitives that both flash-attention sources use: mbarriers, TMA
// copies, setmaxnreg, wgmma's fences and shared-memory descriptors, and the
// host's cache of tensor maps. Included by flash_attention_tc.cu (bfloat16
// kernels) and flash_attention.cu (float32 kernels); each is compiled on its
// own into a library of its own. The host part is static (internal
// linkage), so that each library has its own map cache and its own counts:
// an inline variable and a function-local static of an inline function
// are GNU unique symbols, which the loader binds to one object across both
// libraries (their counts then read the same). Not an unnamed namespace:
// nvcc names every unnamed namespace of a file alike in its host stubs, and
// the sources' own would then clash with this one.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda call is linked
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive, and expect `bytes` more from TMA copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// wait until the phase of parity `parity` has completed. A wait that has
// not completed after about 10 s traps: a fault in the pipeline's
// bookkeeping then ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0, tries = 0;
  uint64_t since = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((++tries & 0xFFFFu) == 0) {
      const uint64_t now = global_ns();
      if (since == 0) since = now;
      else if (now - since > 10000000000ull) __trap();
    }
  }
}

// a box of a 3-D tensor map ({column, row, slice} of [B*H, S, D]) into
// shared memory; completes `bytes` of the barrier's expected transaction
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int slice) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(slice)
      : "memory");
}

// this thread's writes to shared memory made visible to the async proxy
// (wgmma's operand reads, TMA) before an arrive that publishes them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// warpgroup-wide changes of the registers each thread holds
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that write them
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma matrix descriptor: start address, leading and stride byte offsets,
// swizzle mode
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// the 1024-byte aligned start of a block's dynamic shared memory (the
// launch asks for 1024 bytes more than the layout needs)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// Host: tensor maps (static: one cache and one count a library)
// ---------------------------------------------------------------------------

// libcuda's cuTensorMapEncodeTiled, reached through the runtime, so the
// library needs no -lcuda; nullptr where libcuda lacks it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a [slices, S, D] tensor of `dtype` (bfloat16 or float32)
// at `ptr` whose box is `box_rows` rows of one panel of 128 / element bytes
// columns (min(D, 64) bf16, min(D, 32) float32), swizzled over the panel's
// row bytes: the three dimensions keep a box inside its (batch, head) slice,
// so rows past S are zero-filled. A map is a function of these six values
// alone, so the last maps each thread encoded are kept and reused: the
// encoding costs host time on every call that misses. The element type is
// part of the key: a float32 and a bf16 tensor that reuse one allocator
// block never share a map.
struct MapKey {
  const void* ptr;
  CUtensorMapDataType dtype;
  int slices, S, D, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && dtype == o.dtype && slices == o.slices && S == o.S && D == o.D &&
           box_rows == o.box_rows;
  }
};

// every lookup and every encode (a miss) of the caches of all threads of
// this library, for its exported counts
static std::atomic<long long> map_lookups{0}, map_encodes{0};

struct MapCache {
  // a layer's three bf16 kernels use 6 maps at D = 64; with 32 entries a
  // scan-mode BERT-Small update (4 layers x K = 4 micro-batches, whose
  // activations move between micro-batches) missed 43 of its 176 lookups
  static constexpr int kSize = 128;
  MapKey keys[kSize];
  CUtensorMap maps[kSize];
  int used = 0, next = 0;
};

static bool tensor_map(CUtensorMap* out, const void* ptr, CUtensorMapDataType dtype, int slices,
                       int S, int D, int box_rows) {
  thread_local MapCache cache;
  const MapKey key{ptr, dtype, slices, S, D, box_rows};
  map_lookups.fetch_add(1, std::memory_order_relaxed);
  for (int i = 0; i < cache.used; ++i)
    if (cache.keys[i] == key) {
      *out = cache.maps[i];
      return true;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  // the encoder is a driver call and fails (CUDA_ERROR_INVALID_CONTEXT)
  // unless the device's context is current in this thread. The runtime
  // makes it current at a thread's first runtime call that needs it, which
  // a fresh thread may not have made yet: autograd's device thread, when
  // the attention's backward is the first node it runs.
  thread_local const bool bound = [] {
    int dev = 0;
    return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
  }();
  if (!bound) return false;
  const int elem = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const int P = D < 128 / elem ? D : 128 / elem;  // panel columns
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elem, (cuuint64_t)S * D * elem};
  const cuuint32_t box[3] = {(cuuint32_t)P, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = P * elem == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : P * elem == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  map_encodes.fetch_add(1, std::memory_order_relaxed);
  int slot = cache.next;
  if (cache.used < MapCache::kSize) slot = cache.used++;
  else cache.next = (cache.next + 1) % MapCache::kSize;
  if (encode(&cache.maps[slot], dtype, 3, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    cache.keys[slot] = MapKey{nullptr, dtype, 0, 0, 0, 0};
    return false;
  }
  cache.keys[slot] = key;
  *out = cache.maps[slot];
  return true;
}

}  // namespace hopper
