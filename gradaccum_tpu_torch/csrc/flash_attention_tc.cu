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
// At long sequences the products bound all three: at [2, 8, 8192, 64] K1
// does 275 GFLOP (0.28 ms), K2 412 GFLOP (0.42 ms) and K3 550 GFLOP
// (0.56 ms).
//
// All three are Hopper designs: warp-specialized blocks whose operands are
// copied by the Tensor Memory Accelerator (TMA) and multiplied by wgmma.
// What that does about the limits of the mma.sync design they replaced
// (4 warps of 16 rows each, every warp reading every streamed tile through
// ldmatrix for its own 16 rows, all 128 threads issuing cp.async copies
// between two stages and a __syncthreads per tile):
// - Shared-memory reads. wgmma reads its B operand once per warpgroup of
//   64 rows, not once per warp of 16: a streamed K/V (K1, K2) or Q/dO (K3)
//   tile is read a quarter as often, and the 64x16 A operands (Q in K1; Q
//   and dO in K2; K and V in K3) come straight from shared memory through a
//   descriptor. Tiles lie as TMA writes them: [rows][min(D, 64)] panels
//   with 16-byte chunks swizzled by the row (32, 64 or 128 bytes at D = 16,
//   32, >= 64), which is the layout the descriptors name, so no read
//   conflicts on banks. The stored [rows, D] layout serves both as the
//   K-major B of S = QK^T and, transposed in the instruction (MN-major), as
//   the B of P V (K1) and of dS K (K2, the same K stage as its S = QK^T).
// - Copies. One producer warp (the first of the block's last warpgroup)
//   issues every TMA copy (3-D tensor maps over [B*H, S, D], so rows past
//   S arrive as zeros and never read the next (batch, head) slice), fills
//   the small per-row vectors (K1's and K2's mask row, K3's key mask, lse,
//   delta and row seeds; masks and lse times log2 e), and runs 2-3 stages
//   ahead of the consumers on full/empty mbarriers. The consumers issue no
//   copy and no __syncthreads. setmaxnreg hands the producer warpgroup's
//   registers to the consumers (56 and 224 a thread), on a warp-uniform
//   role. ptxas still fits the whole kernel in the 168 a thread that
//   __launch_bounds__(384) leaves (the consumers' SASS stops at R165), so
//   K3 at D = 64 is written to need no more: its keys and their mask are
//   read again from the thread index and shared memory each tile.
// - Rows per block. Two consumer warpgroups (128 rows) share each streamed
//   tile when the grid holds at least a wave of 128-row blocks; below that
//   (BERT's S = 128) one warpgroup of 64 rows keeps 128 blocks in flight on
//   132 SMs. The choice is made per launch (consumers_for), in the same
//   kernel. At D = 128 a block has one consumer warpgroup (256 threads
//   with the producer's, up to 255 registers each) for its D/2-float
//   accumulators.
// - Turns. With two consumer warpgroups, named barriers make them issue
//   their products in turns, so one's tensor-core work runs while the
//   other's element-wise work does; K1 leaves its P V, and K2 its dS K, in
//   flight while it issues the next tile's products. The element-wise loops
//   are unrolled and branch-free: the bounds and dropout tests are resolved
//   per tile.
// - Registers. The probabilities (K1), dS (K2), drop(P^T) and dS^T (K3)
//   never touch shared memory: the f32 accumulator of one product is
//   rounded to bf16 and used as the register A operand of the next (the
//   m64nN accumulator of two 8-column chunks is the m64k16 A fragment). The
//   online softmax, lse, the keep bits, dS, dS^T and the dmask sums run on
//   the accumulator fragments; the keep bit of each element is keep(row
//   seed, key) at the (query, key) position the fragment slot holds, as the
//   TPU draws it.
//
// Numerics: scores, the online softmax, lse, the normalizer l, delta, dS
// and dmask are float32. P (K1), dS (K2, as _dq_kernel rounds it at :385),
// drop(P)^T and dS^T (K3) are rounded to bf16 before their second product,
// as in every tensor-core flash kernel: about 2^-9 relative per term. l sums
// the undropped, unrounded p, as the float32 forward does. delta sums the
// products of bf16 pairs, each exact in f32. exp is 2^x on scores
// pre-scaled by log2(e), by ex2.approx.ftz in all three kernels (a term
// below 2^-126 of its row's maximum, or of exp(lse) in K2 and K3, is 0).

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using flash::kNegInf;
using flash::keep;
using flash::Params;
using flash::drop_slice;
using flash::row_seed;
using flash::row_seed_of;
using flash::slice_seed;
typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// Hopper: wgmma on bf16 (the mbarriers, TMA and descriptors are hopper.cuh's)
// ---------------------------------------------------------------------------

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

constexpr int kWgRows = 64;        // output rows of one consumer warpgroup (wgmma M)
constexpr int kMaxConsumers = 2;   // consumer warpgroups per block, at most
constexpr int kFwdKeys = 128;      // keys per K1 stage
constexpr int kProducerRegs = 56;  // setmaxnreg of a two-consumer block: the producer's
constexpr int kConsumerRegs = 224; // and each consumer warpgroup's registers
constexpr int kDkvStages = 3;      // query stages of K3
constexpr int kDqKeys = 64;        // keys per K2 stage
constexpr int kDqStages = 3;       // key/value stages of K2
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may opt into
// K2's K and V boxes are K3's (kWgRows rows), so the two kernels share maps
static_assert(kDqKeys == kWgRows, "K2 streams K and V in K3's boxes");

// at D = 128 a block has one consumer warpgroup, so that its accumulators
// (D/2 floats of each output a thread) get up to 255 registers
template <int D>
__host__ __device__ constexpr int max_consumers() { return D == 128 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int fwd_stages() { return D == 128 ? 2 : 3; }  // K/V stages of K1
template <int D>
__host__ __device__ constexpr int dkv_rows() { return D == 128 ? 32 : 64; }  // queries per K3 stage

// 2^x, flushing results below 2^-126 to zero (a softmax term that small
// is 0 in every sum it enters); one MUFU instruction
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barriers 1 and 2 order the two consumer warpgroups' turns to issue
// their products (256 threads: one warpgroup syncs, the other arrives)
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// A shared-memory tile of `rows` rows and D bf16 columns as TMA writes it:
// D / P panels of [rows][P], P = min(D, 64), rows of R = 2P bytes whose
// 16-byte chunks are swizzled by the row (the 32, 64 or 128-byte mode of
// the tensor map, chosen by R). Every tile and panel starts on 1024 bytes.
template <int D>
struct Panels {
  static constexpr int P = D < 64 ? D : 64;
  static constexpr int R = 2 * P;
  static constexpr int kCount = D / P;
  static constexpr int kSteps = P / 16;  // k16 steps along the columns of a panel
  static constexpr uint64_t kLayout = R == 128 ? 1 : R == 64 ? 2 : 3;  // wgmma swizzle code
};

// K-major operand: rows row0 .. row0 + (64 or N) of a tile at `tile` (an
// A of M = 64 rows, or a B of N rows), its k16 step kk along D. Groups of
// 8 rows lie 8 R bytes apart; a step inside a swizzled row moves the start
// by 32 bytes.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0, int kk) {
  using T = Panels<D>;
  const uint32_t addr = tile + (kk / T::kSteps) * rows * T::R + row0 * T::R +
                        (kk % T::kSteps) * 32;
  return make_desc(addr, 16, 8 * T::R, T::kLayout);
}

// MN-major B operand: the tile's rows 16 kk .. 16 kk + 15 are the k16
// step, the P columns of panel `panel` its N (wgmma transposes it)
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int panel, int kk) {
  using T = Panels<D>;
  const uint32_t addr = tile + panel * rows * T::R + kk * 16 * T::R;
  return make_desc(addr, rows * T::R, 8 * T::R, T::kLayout);
}

// d (m64nN, f32) = or += A (64 x 16, K-major in shared memory) B (N x 16,
// K-major in shared memory); scale_d = 0 ignores d. Thread 4 g + t of
// warp w holds rows 16 w + g (d[4 i], d[4 i + 1]) and 16 w + g + 8
// (d[4 i + 2], d[4 i + 3]) at columns 8 i + 2 t, 8 i + 2 t + 1: the
// mma.m16n8 C layout of each 8-column chunk i, per warp.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N is 32, 64 or 128");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 128) {
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
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

// d (m64nN, f32) += A (64 x 16 bf16 in registers: per warp the m16k16 A
// fragment of mma.m16n8k16) B (16 x N, MN-major in shared memory)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_rs: N is 16, 32 or 64");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
}

// the arguments of each kernel beside Params (__grid_constant__: they stay
// in the parameter space, where TMA reads the maps): one tensor map of each
// operand a kernel copies with TMA, and the softmax scale times log2 e,
// which an FFMA then reads from there and not from a register. K2 and K3
// copy the same four operands.
struct FwdArgs {
  CUtensorMap q, k, v;
  float scale_log2;
};
struct BwdArgs {
  CUtensorMap q, k, v, dout;
  float scale_log2;
};

// The block's batch, head and row block. Causal launches put the row
// blocks in the slowest grid dimension, the heaviest first (K1's and K2's
// last, K3's first), so that the longest blocks start in the first wave.
struct BlockPos {
  int b, h, x;
};
__device__ __forceinline__ BlockPos block_pos(const Params& p, bool last_rows_heaviest) {
  if (!p.causal) return {(int)blockIdx.z, (int)blockIdx.y, (int)blockIdx.x};
  const int x = last_rows_heaviest ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  return {(int)blockIdx.y, (int)blockIdx.x, x};
}

// K1's shared memory, in bytes from the aligned start: the block's Q rows
// (room for max_consumers warpgroups), the K and V stages, each stage's
// mask row (f32, times log2 e), then the barriers: q_full, k_full[],
// m_full[], v_full[], empty[].
template <int D>
struct FwdLayout {
  static constexpr int kStages = fwd_stages<D>();
  static constexpr int kQRows = max_consumers<D>() * kWgRows;
  static constexpr int kTileBytes = kFwdKeys * D * 2;  // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQRows * D * 2;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kMask = kV + kStages * kTileBytes;
  static constexpr int kBars = kMask + kStages * kFwdKeys * 4;
  static constexpr int kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kSmem <= kSmemLimit, "K1's shared memory exceeds a block's");
};

// K3's shared memory: the block's K and V rows, the Q and dO stages, each
// stage's lse (times log2 e), delta and row seeds, the block's key mask
// (times log2 e), then the barriers: kv_full, m_full, q_full[], r_full[],
// empty[].
template <int D>
struct DkvLayout {
  static constexpr int kStages = kDkvStages;
  static constexpr int kRows = dkv_rows<D>();
  static constexpr int kKRows = max_consumers<D>() * kWgRows;
  static constexpr int kTileBytes = kRows * D * 2;  // one Q or dO stage
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKRows * D * 2;
  static constexpr int kQ = kV + kKRows * D * 2;
  static constexpr int kDo = kQ + kStages * kTileBytes;
  static constexpr int kLse = kDo + kStages * kTileBytes;
  static constexpr int kDelta = kLse + kStages * kRows * 4;
  static constexpr int kSeed = kDelta + kStages * kRows * 4;
  static constexpr int kKeyMask = kSeed + kStages * kRows * 4;
  static constexpr int kBars = kKeyMask + kKRows * 4;
  static constexpr int kSmem = kBars + 8 * (2 + 3 * kStages) + 1024;
  static_assert(kSmem <= kSmemLimit, "K3's shared memory exceeds a block's");
};

// K2's shared memory: the block's Q and dO rows (room for max_consumers
// warpgroups), the K and V stages, each stage's mask row (f32, times
// log2 e), then the barriers: q_full, kv_full[], m_full[], empty[].
template <int D>
struct DqLayout {
  static constexpr int kStages = kDqStages;
  static constexpr int kQRows = max_consumers<D>() * kWgRows;
  static constexpr int kTileBytes = kDqKeys * D * 2;  // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kQRows * D * 2;
  static constexpr int kK = kDo + kQRows * D * 2;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kMask = kV + kStages * kTileBytes;
  static constexpr int kBars = kMask + kStages * kDqKeys * 4;
  static constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kSmem <= kSmemLimit, "K2's shared memory exceeds a block's");
};

// ---------------------------------------------------------------------------
// K1, forward. One block per (b, h, 64 or 128 query rows): each consumer
// warpgroup c takes 64 rows (its warp w rows 64 c + 16 w .. + 15), the
// last warpgroup produces. The producer warp copies the block's Q rows once and
// streams K and V tiles of 128 keys with their mask row through the stages.
// Per tile, each consumer warpgroup computes S = Q K^T (64 x 128, f32 in
// registers) with wgmma from shared memory, scales and masks it, runs the
// online softmax (row max and sum across the 4 lanes that share a row),
// draws the dropout bits, and adds bf16(drop(P)) V (P from registers, V
// from shared memory, transposed by the instruction) to its 64 x D
// accumulator. K and V have barriers of their own, so S = Q K^T and the
// softmax run while V lands. Causal: the key loop stops after the block's
// last query row, and each element past its row's diagonal is masked.
// Output: o = acc / l (bf16) and lse = m + log l (f32), straight from the
// accumulator fragments.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128 * (max_consumers<D>() + 1), 1)
    flash_fwd_tc_kernel(const Params p, const __grid_constant__ FwdArgs args) {
  using L = FwdLayout<D>;
  using T = Panels<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* m_full = k_full + L::kStages;
  uint64_t* v_full = m_full + L::kStages;
  uint64_t* empty = v_full + L::kStages;
  float* mask_s = reinterpret_cast<float*>(smem + L::kMask);  // [stage][kFwdKeys]

  const int consumers = blockDim.x / 128 - 1;
  const int rows = consumers * kWgRows;
  const int S = p.S;
  const BlockPos pos = block_pos(p, true);
  const int b = pos.b, h = pos.h, bh = b * p.H + h;
  const int q0 = pos.x * rows;
  const int k_end = p.causal ? min(S, q0 + rows) : S;
  const int n_tiles = (k_end + kFwdKeys - 1) / kFwdKeys;

  if (threadIdx.x == 0) {
    prefetch_map(&args.q);
    prefetch_map(&args.k);
    prefetch_map(&args.v);
    mbar_init(q_full, 1);
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&m_full[st], 32);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], consumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform across each warp (so that ptxas holds each role
  // to its setmaxnreg count): consumers 0 .. consumers - 1, then the producer
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == consumers) {  // the producer warpgroup; its first warp works
    if constexpr (max_consumers<D>() > 1) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, rows * D * 2);
      for (int w = 0; w < consumers; ++w)
        for (int c = 0; c < T::kCount; ++c)
          tma_load(smem + L::kQ + c * L::kQRows * T::R + w * kWgRows * T::R, &args.q, q_full,
                   c * T::P, q0 + w * kWgRows, bh);
    }
    const bf16* mask =
        p.mask != nullptr ? static_cast<const bf16*>(p.mask) + (size_t)b * S : nullptr;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int st = tile % L::kStages;
      mbar_wait(&empty[st], ((tile / L::kStages) & 1) ^ 1);
      const int k0 = tile * kFwdKeys;
      if (lane == 0) {
        mbar_arrive_expect_tx(&k_full[st], L::kTileBytes);
        for (int c = 0; c < T::kCount; ++c)
          tma_load(smem + L::kK + st * L::kTileBytes + c * kFwdKeys * T::R, &args.k,
                   &k_full[st], c * T::P, k0, bh);
        mbar_arrive_expect_tx(&v_full[st], L::kTileBytes);
        for (int c = 0; c < T::kCount; ++c)
          tma_load(smem + L::kV + st * L::kTileBytes + c * kFwdKeys * T::R, &args.v,
                   &v_full[st], c * T::P, k0, bh);
      }
      float* ms = mask_s + st * kFwdKeys;
      for (int j = lane; j < kFwdKeys; j += 32)
        ms[j] = (mask != nullptr && k0 + j < S) ? __bfloat162float(mask[k0 + j]) * kLog2e : 0.f;
      mbar_arrive(&m_full[st]);
    }
    return;
  }

  if constexpr (max_consumers<D>() > 1) setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg;  // consumer warpgroup
  // with two consumer warpgroups, each issues its products in its turn
  // (warpgroup 0 first), so one's tensor-core work runs while the other
  // does its element-wise work
  const bool turns = consumers > 1;
  if (turns && cw == 1) turn_pass(1);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int warp_row0 = q0 + cw * kWgRows + warp * 16;
  // this lane's two query rows: a (g) and b (g + 8) of the warp's 16
  const int row_a = warp_row0 + g, row_b = row_a + 8;
  uint32_t rseed_a = 0u, rseed_b = 0u;
  if (p.dropout) {
    const uint32_t seed = (uint32_t)(*p.seed);
    rseed_a = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_a);
    rseed_b = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_b);
  }
  const uint32_t base = smem_addr(smem);

  float acc[D / 2], s[kFwdKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kFwdKeys / 2; ++i) s[i] = 0.f;
  // running max (log2 units) and normalizer of rows a and b; l is this
  // lane's partial sum over its columns, summed across the quad at the end
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  uint32_t pf[kFwdKeys / 16][4];  // drop(P) in bf16, the A operand of P V
  mbar_wait(q_full, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % L::kStages;
    const uint32_t phase = (tile / L::kStages) & 1;
    const int k0 = tile * kFwdKeys;

    // S = Q K^T: 64 rows x 128 keys. The previous tile's P V may still run:
    // one wait covers both, then that tile's stage is released.
    mbar_wait(&k_full[st], phase);
    if (turns) turn_wait(1 + cw);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kFwdKeys>(s, desc_k<D>(base + L::kQ, L::kQRows, cw * kWgRows, kk),
                         desc_k<D>(base + L::kK + st * L::kTileBytes, kFwdKeys, 0, kk), kk);
    wgmma_commit();
    if (turns && !(cw == 1 && tile == n_tiles - 1)) turn_pass(2 - cw);
    wgmma_wait_all();
    fence_regs<kFwdKeys / 2>(s);
    fence_regs<D / 2>(acc);
    if (tile > 0) mbar_arrive(&empty[(tile - 1) % L::kStages]);

    // scale, mask (log2 units), causal cut, keys past S; the tile's row max.
    // The bounds and dropout tests are resolved per tile: each of the four
    // cases is one branch-free unrolled loop.
    mbar_wait(&m_full[st], phase);
    const float* ms = mask_s + st * kFwdKeys;
    const bool edge = k0 + kFwdKeys > S || (p.causal && k0 + kFwdKeys - 1 > warp_row0);
    auto softmax = [&](auto edge_c, auto dropout_c) {
      constexpr bool kEdge = decltype(edge_c)::value, kDropout = decltype(dropout_c)::value;
      // two partial maxima and sums per row, for shorter dependency chains
      float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};  // [row a/b][n % 2]
#pragma unroll
      for (int n = 0; n < kFwdKeys / 8; ++n) {
        const float2 mk = *reinterpret_cast<const float2*>(ms + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[4 * n + e], args.scale_log2, (e & 1) ? mk.y : mk.x);
          if constexpr (kEdge) {
            const int j = k0 + n * 8 + 2 * t + (e & 1);
            if (j >= S || (p.causal && j > (e < 2 ? row_a : row_b))) x = kNegInf;
          }
          s[4 * n + e] = x;
          mx[e / 2][n % 2] = fmaxf(mx[e / 2][n % 2], x);
        }
      }
      const float m_new_a = fmaxf(m_a, quad_max(fmaxf(mx[0][0], mx[0][1])));
      const float m_new_b = fmaxf(m_b, quad_max(fmaxf(mx[1][0], mx[1][1])));
      const float corr_a = exp2_ftz(m_a - m_new_a), corr_b = exp2_ftz(m_b - m_new_b);
      m_a = m_new_a;
      m_b = m_new_b;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= corr_a;
        acc[4 * i + 1] *= corr_a;
        acc[4 * i + 2] *= corr_b;
        acc[4 * i + 3] *= corr_b;
      }

      // P = exp2(S - m); l sums the undropped p; drop(P) in bf16 becomes the
      // A operand of P V, chunk c covering keys 16 c .. 16 c + 15
      float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int n = 0; n < kFwdKeys / 8; ++n) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[e] = exp2_ftz(s[4 * n + e] - (e < 2 ? m_a : m_b));
          sum[e / 2][n % 2] += pv[e];
          if constexpr (kDropout) {
            const uint32_t j = (uint32_t)(k0 + n * 8 + 2 * t + (e & 1));
            pv[e] = keep(e < 2 ? rseed_a : rseed_b, j, p.threshold) ? pv[e] * p.inv_keep : 0.f;
          }
        }
        pf[n / 2][(n % 2) * 2] = pack_bf16(pv[0], pv[1]);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      }
      l_a = fmaf(l_a, corr_a, sum[0][0] + sum[0][1]);
      l_b = fmaf(l_b, corr_b, sum[1][0] + sum[1][1]);
    };
    if (edge) {
      if (p.dropout) softmax(std::true_type(), std::true_type());
      else softmax(std::true_type(), std::false_type());
    } else {
      if (p.dropout) softmax(std::false_type(), std::true_type());
      else softmax(std::false_type(), std::false_type());
    }

    // acc += drop(P) V: k = the tile's 128 keys, n = D (one wgmma per panel)
    mbar_wait(&v_full[st], phase);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kFwdKeys / 16; ++c)
#pragma unroll
      for (int pn = 0; pn < T::kCount; ++pn)
        wgmma_rs<T::P>(acc + pn * (T::P / 2), pf[c],
                       desc_mn<D>(base + L::kV + st * L::kTileBytes, kFwdKeys, pn, c), 1);
    wgmma_commit();
  }
  wgmma_wait_all();
  fence_regs<D / 2>(acc);

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (t == 0) {
    float* lse = p.out_f32 + (size_t)bh * S;
    if (row_a < S) lse[row_a] = m_a * kLn2 + logf(l_a);
    if (row_b < S) lse[row_b] = m_b * kLn2 + logf(l_b);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  bf16* out = static_cast<bf16*>(p.out0) + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) =
          pack_bf16(acc[4 * i] * inv_a, acc[4 * i + 1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_b * D + col) =
          pack_bf16(acc[4 * i + 2] * inv_b, acc[4 * i + 3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// K3, dk/dv (+ per-head dmask). One block per (b, h, 64 or 128 key rows):
// each consumer warpgroup c takes 64 keys (its warp w keys 64 c + 16 w ..
// + 15), the last warpgroup produces. The producer warp copies the block's K and V
// rows once and streams query tiles (Q, dO, and the rows' lse, delta and
// dropout seeds) of 64 queries (32 at D = 128) through the stages. Per
// tile, each consumer warpgroup computes S^T = K Q^T and dP^T = V dO^T
// (64 keys x the tile's queries, f32) with wgmma from shared memory, then
// P^T = exp(S^T scale + mask_j - lse_i), the keep bits keep(rseed_i, j),
// dS^T = P^T (drop(dP^T) - delta_i), and adds dV += bf16(drop(P^T)) dO,
// dK += bf16(dS^T) Q (register A operands; dO and Q from the same stage,
// transposed by the instruction) and dmask_j += sum_i dS^T (f32). dk is
// scaled by the softmax scale once at the end. Causal: the query tiles
// before the block's first key hold no pair and are skipped; the rest are
// masked per element.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128 * (max_consumers<D>() + 1), 1)
    flash_dkv_tc_kernel(const Params p, const __grid_constant__ BwdArgs args) {
  using L = DkvLayout<D>;
  using T = Panels<D>;
  constexpr int kRows = L::kRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* m_full = kv_full + 1;
  uint64_t* q_full = m_full + 1;
  uint64_t* r_full = q_full + L::kStages;
  uint64_t* empty = r_full + L::kStages;
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);        // [stage][kRows]
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);    // [stage][kRows]
  uint32_t* rseed_s = reinterpret_cast<uint32_t*>(smem + L::kSeed);  // [stage][kRows]

  const int consumers = blockDim.x / 128 - 1;
  const int rows = consumers * kWgRows;
  const int S = p.S;
  const BlockPos pos = block_pos(p, false);
  const int b = pos.b, h = pos.h, bh = b * p.H + h;
  const int k0 = pos.x * rows;
  const int i_begin = p.causal ? k0 : 0;
  const int n_tiles = (S - i_begin + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    prefetch_map(&args.q);
    prefetch_map(&args.k);
    prefetch_map(&args.v);
    prefetch_map(&args.dout);
    mbar_init(kv_full, 1);
    mbar_init(m_full, 32);
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&q_full[st], 1);
      mbar_init(&r_full[st], 32);
      mbar_init(&empty[st], consumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform across each warp (so that ptxas holds each role
  // to its setmaxnreg count): consumers 0 .. consumers - 1, then the producer
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == consumers) {  // the producer warpgroup; its first warp works
    if constexpr (max_consumers<D>() > 1) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * rows * D * 2);
      for (int w = 0; w < consumers; ++w)
        for (int c = 0; c < T::kCount; ++c) {
          const int at = c * L::kKRows * T::R + w * kWgRows * T::R;
          tma_load(smem + L::kK + at, &args.k, kv_full, c * T::P, k0 + w * kWgRows, bh);
          tma_load(smem + L::kV + at, &args.v, kv_full, c * T::P, k0 + w * kWgRows, bh);
        }
    }
    // the block's key mask, times log2 e (0 past S or without a mask): read
    // from here once a tile, it holds no register through the loop
    float* key_mask = reinterpret_cast<float*>(smem + L::kKeyMask);
    for (int j = lane; j < rows; j += 32)
      key_mask[j] = (p.mask != nullptr && k0 + j < S)
                        ? __bfloat162float(static_cast<const bf16*>(p.mask)[(size_t)b * S + k0 + j]) *
                              kLog2e
                        : 0.f;
    mbar_arrive(m_full);
    // the dropout key of this block's (batch, head) slice, once
    const uint32_t sseed =
        p.dropout ? slice_seed((uint32_t)(*p.seed), drop_slice(p, b, h)) : 0u;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int st = tile % L::kStages;
      mbar_wait(&empty[st], ((tile / L::kStages) & 1) ^ 1);
      const int i0 = i_begin + tile * kRows;
      if (lane == 0) {
        mbar_arrive_expect_tx(&q_full[st], 2 * L::kTileBytes);
        for (int c = 0; c < T::kCount; ++c) {
          const int at = st * L::kTileBytes + c * kRows * T::R;
          tma_load(smem + L::kQ + at, &args.q, &q_full[st], c * T::P, i0, bh);
          tma_load(smem + L::kDo + at, &args.dout, &q_full[st], c * T::P, i0, bh);
        }
      }
      // lse (log2 units), delta and the row seeds; 0 past S
      for (int j = lane; j < kRows; j += 32) {
        const int i = i0 + j;
        const bool in = i < S;
        lse_s[st * kRows + j] = in ? p.lse[(size_t)bh * S + i] * kLog2e : 0.f;
        delta_s[st * kRows + j] = in ? p.delta[(size_t)bh * S + i] : 0.f;
        rseed_s[st * kRows + j] = p.dropout ? row_seed_of(sseed, (uint32_t)i) : 0u;
      }
      mbar_arrive(&r_full[st]);
    }
    return;
  }

  if constexpr (max_consumers<D>() > 1) setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg;  // consumer warpgroup
  // with two consumer warpgroups, each issues its products in its turn
  // (warpgroup 0 first), so one's tensor-core work runs while the other
  // does its element-wise work
  const bool turns = consumers > 1;
  if (turns && cw == 1) turn_pass(1);
  const int t = threadIdx.x % 4;  // this lane's column pair in each 8-column chunk
  // this lane's two key rows, a (g) and b (g + 8) of its warp's 16 (lane
  // 4 g + t): the block's keys kl and kl + 8, computed again where used
  // from the thread index, which holds fewer registers through the loop
  // than the keys and their mask values would
  auto key_local = [] { return (int)(threadIdx.x / 32) * 16 + (int)(threadIdx.x % 32) / 4; };
  const float* key_mask = reinterpret_cast<const float*>(smem + L::kKeyMask);
  const uint32_t base = smem_addr(smem);

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

  mbar_wait(kv_full, 0);
  mbar_wait(m_full, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % L::kStages;
    const uint32_t phase = (tile / L::kStages) & 1;
    const int i0 = i_begin + tile * kRows;
    const uint32_t qs = base + L::kQ + st * L::kTileBytes;
    const uint32_t dos = base + L::kDo + st * L::kTileBytes;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x kRows queries
    mbar_wait(&q_full[st], phase);
    if (turns) turn_wait(1 + cw);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kRows>(sT, desc_k<D>(base + L::kK, L::kKRows, cw * kWgRows, kk),
                      desc_k<D>(qs, kRows, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kRows>(dpT, desc_k<D>(base + L::kV, L::kKRows, cw * kWgRows, kk),
                      desc_k<D>(dos, kRows, 0, kk), kk);
    wgmma_commit();
    if (turns && !(cw == 1 && tile == n_tiles - 1)) turn_pass(2 - cw);
    wgmma_wait_all();
    fence_regs<kRows / 2>(sT);
    fence_regs<kRows / 2>(dpT);

    // element-wise, in f32; A operands of the two products in bf16, chunk
    // c covering queries 16 c .. 16 c + 15 of the tile
    mbar_wait(&r_full[st], phase);
    const float* ls = lse_s + st * kRows;
    const float* dls = delta_s + st * kRows;
    const uint32_t* rs = rseed_s + st * kRows;
    const bool edge = i0 + kRows > S || (p.causal && i0 < k0 + rows);
    uint32_t pa[kRows / 16][4], sa[kRows / 16][4];
    // the bounds and dropout tests resolved per tile, as in K1
    auto elementwise = [&](auto edge_c, auto dropout_c) {
      constexpr bool kEdge = decltype(edge_c)::value, kDropout = decltype(dropout_c)::value;
      const int kl = key_local();
      const int key_a = k0 + kl, key_b = key_a + 8;
      const float mask_a = key_mask[kl], mask_b = key_mask[kl + 8];
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) {
        const int il = n * 8 + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(ls + il);
        const float2 delta2 = *reinterpret_cast<const float2*>(dls + il);
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? key_a : key_b;
          float pt = exp2_ftz(fmaf(sT[4 * n + e], args.scale_log2, e < 2 ? mask_a : mask_b) -
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
        pa[n / 2][(n % 2) * 2] = pack_bf16(pd[0], pd[1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(pd[2], pd[3]);
        sa[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
        sa[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
    };
    if (edge) {
      if (p.dropout) elementwise(std::true_type(), std::true_type());
      else elementwise(std::true_type(), std::false_type());
    } else {
      if (p.dropout) elementwise(std::false_type(), std::true_type());
      else elementwise(std::false_type(), std::false_type());
    }

    // dV += drop(P^T) dO, dK += dS^T Q: k = the tile's queries, n = D (one
    // wgmma per panel)
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c)
#pragma unroll
      for (int pn = 0; pn < T::kCount; ++pn) {
        wgmma_rs<T::P>(dv + pn * (T::P / 2), pa[c], desc_mn<D>(dos, kRows, pn, c), 1);
        wgmma_rs<T::P>(dk + pn * (T::P / 2), sa[c], desc_mn<D>(qs, kRows, pn, c), 1);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    mbar_arrive(&empty[st]);  // the stage may be refilled
  }

  dmask_a = quad_sum(dmask_a);
  dmask_b = quad_sum(dmask_b);
  const int key_a = k0 + key_local(), key_b = key_a + 8;
  if (p.out_f32 != nullptr && t == 0) {
    float* dm = p.out_f32 + (size_t)bh * S;
    if (key_a < S) dm[key_a] = dmask_a;
    if (key_b < S) dm[key_b] = dmask_b;
  }
  bf16* dk_out = static_cast<bf16*>(p.out0) + (size_t)bh * S * D;
  bf16* dv_out = static_cast<bf16*>(p.out1) + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (key_a < S) {
      *reinterpret_cast<uint32_t*>(dk_out + (size_t)key_a * D + col) =
          pack_bf16(dk[4 * i] * p.scale, dk[4 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + (size_t)key_a * D + col) =
          pack_bf16(dv[4 * i], dv[4 * i + 1]);
    }
    if (key_b < S) {
      *reinterpret_cast<uint32_t*>(dk_out + (size_t)key_b * D + col) =
          pack_bf16(dk[4 * i + 2] * p.scale, dk[4 * i + 3] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + (size_t)key_b * D + col) =
          pack_bf16(dv[4 * i + 2], dv[4 * i + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2, dq (+ delta). One block per (b, h, 64 or 128 query rows): each
// consumer warpgroup c takes 64 rows (its warp w rows 64 c + 16 w .. + 15),
// the last warpgroup produces. The producer warp copies the block's Q and
// dO rows once and streams K and V tiles of 64 keys with their mask row
// through the stages. Per tile, each consumer warpgroup computes S = Q K^T
// and dP = dO V^T (64 rows x 64 keys, f32 in registers) with wgmma from
// shared memory, then P = exp(S scale + mask_j - lse_i), the keep bits
// keep(rseed_i, j), dS = P (drop(dP) - delta_i), and adds bf16(dS) K (dS
// from registers, K from the stage S read, transposed by the instruction)
// to its 64 x D accumulator. That product stays in flight while the next
// tile's S and dP are issued: one wait covers all three, then the stage is
// released. dq is scaled by the softmax scale once at the end. Causal: the
// key loop stops after the block's last query row, and each element past
// its row's diagonal is masked.
// delta_i = sum_d dO_id O_id is computed by the consumers before the key
// loop: each lane reads its two rows' O and dO pairs from device memory at
// the columns its accumulator fragment holds, multiplies the bf16 pairs in
// f32 and sums across the 4 lanes that share a row. delta is used in place
// and written out for K3.
// ---------------------------------------------------------------------------

// x . y of two bf16 pairs, in f32 (each product is exact)
__device__ __forceinline__ float dot_bf16x2(uint32_t x, uint32_t y) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  return a.x * b.x + a.y * b.y;
}

template <int D>
__global__ void __launch_bounds__(128 * (max_consumers<D>() + 1), 1)
    flash_dq_tc_kernel(const Params p, const __grid_constant__ BwdArgs args) {
  using L = DqLayout<D>;
  using T = Panels<D>;
  constexpr int kDoBox = dkv_rows<D>();  // rows of a dO box: K3's, so the two share the map
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = q_full + 1;
  uint64_t* m_full = kv_full + L::kStages;
  uint64_t* empty = m_full + L::kStages;
  float* mask_s = reinterpret_cast<float*>(smem + L::kMask);  // [stage][kDqKeys]

  const int consumers = blockDim.x / 128 - 1;
  const int rows = consumers * kWgRows;
  const int S = p.S;
  const BlockPos pos = block_pos(p, true);
  const int b = pos.b, h = pos.h, bh = b * p.H + h;
  const int q0 = pos.x * rows;
  const int k_end = p.causal ? min(S, q0 + rows) : S;
  const int n_tiles = (k_end + kDqKeys - 1) / kDqKeys;

  if (threadIdx.x == 0) {
    prefetch_map(&args.q);
    prefetch_map(&args.k);
    prefetch_map(&args.v);
    prefetch_map(&args.dout);
    mbar_init(q_full, 1);
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&kv_full[st], 1);
      mbar_init(&m_full[st], 32);
      mbar_init(&empty[st], consumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform across each warp (so that ptxas holds each role
  // to its setmaxnreg count): consumers 0 .. consumers - 1, then the producer
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == consumers) {  // the producer warpgroup; its first warp works
    if constexpr (max_consumers<D>() > 1) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * rows * D * 2);
      for (int w = 0; w < consumers; ++w)
        for (int c = 0; c < T::kCount; ++c) {
          const int at = c * L::kQRows * T::R + w * kWgRows * T::R;
          tma_load(smem + L::kQ + at, &args.q, q_full, c * T::P, q0 + w * kWgRows, bh);
          for (int r = 0; r < kWgRows; r += kDoBox)
            tma_load(smem + L::kDo + at + r * T::R, &args.dout, q_full, c * T::P,
                     q0 + w * kWgRows + r, bh);
        }
    }
    const bf16* mask =
        p.mask != nullptr ? static_cast<const bf16*>(p.mask) + (size_t)b * S : nullptr;
    int tile = 0;  // every block has a tile (key 0): a do loop, as the consumers'
    do {
      const int st = tile % L::kStages;
      mbar_wait(&empty[st], ((tile / L::kStages) & 1) ^ 1);
      const int k0 = tile * kDqKeys;
      if (lane == 0) {
        mbar_arrive_expect_tx(&kv_full[st], 2 * L::kTileBytes);
        for (int c = 0; c < T::kCount; ++c) {
          const int at = st * L::kTileBytes + c * kDqKeys * T::R;
          tma_load(smem + L::kK + at, &args.k, &kv_full[st], c * T::P, k0, bh);
          tma_load(smem + L::kV + at, &args.v, &kv_full[st], c * T::P, k0, bh);
        }
      }
      float* ms = mask_s + st * kDqKeys;
      for (int j = lane; j < kDqKeys; j += 32)
        ms[j] = (mask != nullptr && k0 + j < S) ? __bfloat162float(mask[k0 + j]) * kLog2e : 0.f;
      mbar_arrive(&m_full[st]);
    } while (++tile < n_tiles);
    return;
  }

  if constexpr (max_consumers<D>() > 1) setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg;  // consumer warpgroup
  // with two consumer warpgroups, each issues its products in its turn
  // (warpgroup 0 first), so one's tensor-core work runs while the other
  // does its element-wise work
  const bool turns = consumers > 1;
  if (turns && cw == 1) turn_pass(1);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int warp_row0 = q0 + cw * kWgRows + warp * 16;
  // this lane's two query rows: a (g) and b (g + 8) of the warp's 16
  const int row_a = warp_row0 + g, row_b = row_a + 8;
  const bool in_a = row_a < S, in_b = row_b < S;
  const size_t slice = (size_t)bh * S;

  // delta of rows a and b: the bf16 pairs at columns 8 i + 2 t, summed
  // across the quad; 0 past S
  float delta_a = 0.f, delta_b = 0.f;
  {
    const uint32_t* o = static_cast<const uint32_t*>(p.o) + slice * (D / 2);
    const uint32_t* dout = static_cast<const uint32_t*>(p.dout) + slice * (D / 2);
    const size_t at_a = (size_t)(in_a ? row_a : 0) * (D / 2) + t;
    const size_t at_b = (size_t)(in_b ? row_b : 0) * (D / 2) + t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (in_a) delta_a += dot_bf16x2(dout[at_a + 4 * i], o[at_a + 4 * i]);
      if (in_b) delta_b += dot_bf16x2(dout[at_b + 4 * i], o[at_b + 4 * i]);
    }
  }
  delta_a = quad_sum(delta_a);
  delta_b = quad_sum(delta_b);
  if (t == 0) {
    if (in_a) p.out_f32[slice + row_a] = delta_a;
    if (in_b) p.out_f32[slice + row_b] = delta_b;
  }
  const float lse_a = in_a ? p.lse[slice + row_a] * kLog2e : 0.f;
  const float lse_b = in_b ? p.lse[slice + row_b] * kLog2e : 0.f;
  uint32_t rseed_a = 0u, rseed_b = 0u;
  if (p.dropout) {
    const uint32_t seed = (uint32_t)(*p.seed);
    rseed_a = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_a);
    rseed_b = row_seed(seed, drop_slice(p, b, h), (uint32_t)row_b);
  }
  const uint32_t base = smem_addr(smem);

  float dq[D / 2], s[kDqKeys / 2], dp[kDqKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kDqKeys / 2; ++i) {
    s[i] = 0.f;
    dp[i] = 0.f;
  }

  uint32_t sa[kDqKeys / 16][4];  // dS in bf16, the A operand of dS K
  mbar_wait(q_full, 0);
  // every block has a tile (key 0): a loop that may run no time would join
  // a path that never issued a product to the wait below, and ptxas would
  // serialize every wgmma of the kernel (C7515), as in the float32 dq kernel
  int tile = 0;
  do {
    const int st = tile % L::kStages;
    const uint32_t phase = (tile / L::kStages) & 1;
    const int k0 = tile * kDqKeys;
    const uint32_t ks = base + L::kK + st * L::kTileBytes;

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys. The previous tile's
    // dS K may still run: one wait covers all three, then that tile's
    // stage is released.
    mbar_wait(&kv_full[st], phase);
    if (turns) turn_wait(1 + cw);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kDqKeys>(s, desc_k<D>(base + L::kQ, L::kQRows, cw * kWgRows, kk),
                        desc_k<D>(ks, kDqKeys, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kDqKeys>(dp, desc_k<D>(base + L::kDo, L::kQRows, cw * kWgRows, kk),
                        desc_k<D>(base + L::kV + st * L::kTileBytes, kDqKeys, 0, kk), kk);
    wgmma_commit();
    if (turns && !(cw == 1 && tile == n_tiles - 1)) turn_pass(2 - cw);
    wgmma_wait_all();
    fence_regs<kDqKeys / 2>(s);
    fence_regs<kDqKeys / 2>(dp);
    fence_regs<D / 2>(dq);
    if (tile > 0) mbar_arrive(&empty[(tile - 1) % L::kStages]);

    // P, the keep bits and dS in f32; bf16(dS) becomes the A operand of
    // dS K, chunk c covering keys 16 c .. 16 c + 15. The bounds and dropout
    // tests are resolved per tile, as in K1.
    mbar_wait(&m_full[st], phase);
    const float* ms = mask_s + st * kDqKeys;
    const bool edge = k0 + kDqKeys > S || (p.causal && k0 + kDqKeys - 1 > warp_row0);
    auto elementwise = [&](auto edge_c, auto dropout_c) {
      constexpr bool kEdge = decltype(edge_c)::value, kDropout = decltype(dropout_c)::value;
#pragma unroll
      for (int n = 0; n < kDqKeys / 8; ++n) {
        const float2 mk = *reinterpret_cast<const float2*>(ms + n * 8 + 2 * t);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + n * 8 + 2 * t + (e & 1);
          float pt = exp2_ftz(fmaf(s[4 * n + e], args.scale_log2, (e & 1) ? mk.y : mk.x) -
                              (e < 2 ? lse_a : lse_b));
          if constexpr (kEdge) {
            if (j >= S || (p.causal && j > (e < 2 ? row_a : row_b))) pt = 0.f;
          }
          float d = dp[4 * n + e];
          if constexpr (kDropout)
            d = keep(e < 2 ? rseed_a : rseed_b, (uint32_t)j, p.threshold) ? d * p.inv_keep : 0.f;
          ds[e] = pt * (d - (e < 2 ? delta_a : delta_b));
        }
        sa[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
        sa[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
    };
    if (edge) {
      if (p.dropout) elementwise(std::true_type(), std::true_type());
      else elementwise(std::true_type(), std::false_type());
    } else {
      if (p.dropout) elementwise(std::false_type(), std::true_type());
      else elementwise(std::false_type(), std::false_type());
    }

    // dq += dS K: k = the tile's 64 keys, n = D (one wgmma per panel)
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kDqKeys / 16; ++c)
#pragma unroll
      for (int pn = 0; pn < T::kCount; ++pn)
        wgmma_rs<T::P>(dq + pn * (T::P / 2), sa[c], desc_mn<D>(ks, kDqKeys, pn, c), 1);
    wgmma_commit();
  } while (++tile < n_tiles);
  wgmma_wait_all();
  fence_regs<D / 2>(dq);

  bf16* out = static_cast<bf16*>(p.out0) + slice * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (in_a)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) =
          pack_bf16(dq[4 * i] * p.scale, dq[4 * i + 1] * p.scale);
    if (in_b)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_b * D + col) =
          pack_bf16(dq[4 * i + 2] * p.scale, dq[4 * i + 3] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// consumer warpgroups per block: two (128 rows) when the kernel instance
// has room for two and the grid of 128-row blocks fills every SM at least
// once, else one (64 rows). One card per process, as the launch's opt-in assumes.
int consumers_for(int most, int slices, int S) {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int rows = kMaxConsumers * kWgRows;
  return most >= kMaxConsumers && slices * ((S + rows - 1) / rows) >= sms ? kMaxConsumers : 1;
}

// Each kernel: the shared-memory opt-in once per kernel instance, then the
// launch on (row blocks, H, B), or (H, B, row blocks) when causal, with
// `consumers` warpgroups and the producer's
template <typename Args, void (*Kernel)(Params, Args)>
int launch_hopper(size_t smem, int most, const Params& p, int B, const Args& args,
                  cudaStream_t stream) {
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int consumers = consumers_for(most, B * p.H, p.S);
  const int rows = consumers * kWgRows;
  const int blocks = (p.S + rows - 1) / rows;
  const dim3 grid = p.causal ? dim3(p.H, B, blocks) : dim3(blocks, p.H, B);  // as block_pos
  Kernel<<<grid, 128 * (consumers + 1), smem, stream>>>(p, args);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd(const Params& p, int B, cudaStream_t stream) {
  FwdArgs args;
  args.scale_log2 = p.scale * kLog2e;
  const int slices = B * p.H;
  if (!tensor_map(&args.q, p.q, kBf16, slices, p.S, D, kWgRows) ||
      !tensor_map(&args.k, p.k, kBf16, slices, p.S, D, kFwdKeys) ||
      !tensor_map(&args.v, p.v, kBf16, slices, p.S, D, kFwdKeys))
    return (int)cudaErrorInvalidValue;
  return launch_hopper<FwdArgs, flash_fwd_tc_kernel<D>>(FwdLayout<D>::kSmem, max_consumers<D>(),
                                                        p, B, args, stream);
}

// K2's K and V maps are K3's (kDqKeys = kWgRows rows) and its dO map too
// (dkv_rows rows, two boxes a warpgroup at D = 128): per layer it adds no
// map to the cache that K1 and K3 have not already filled
template <int D>
int launch_dq(const Params& p, int B, cudaStream_t stream) {
  BwdArgs args;
  args.scale_log2 = p.scale * kLog2e;
  const int slices = B * p.H;
  if (!tensor_map(&args.q, p.q, kBf16, slices, p.S, D, kWgRows) ||
      !tensor_map(&args.k, p.k, kBf16, slices, p.S, D, kDqKeys) ||
      !tensor_map(&args.v, p.v, kBf16, slices, p.S, D, kDqKeys) ||
      !tensor_map(&args.dout, p.dout, kBf16, slices, p.S, D, dkv_rows<D>()))
    return (int)cudaErrorInvalidValue;
  return launch_hopper<BwdArgs, flash_dq_tc_kernel<D>>(DqLayout<D>::kSmem, max_consumers<D>(),
                                                       p, B, args, stream);
}

template <int D>
int launch_dkv(const Params& p, int B, cudaStream_t stream) {
  BwdArgs args;
  args.scale_log2 = p.scale * kLog2e;
  const int slices = B * p.H;
  if (!tensor_map(&args.k, p.k, kBf16, slices, p.S, D, kWgRows) ||
      !tensor_map(&args.v, p.v, kBf16, slices, p.S, D, kWgRows) ||
      !tensor_map(&args.q, p.q, kBf16, slices, p.S, D, dkv_rows<D>()) ||
      !tensor_map(&args.dout, p.dout, kBf16, slices, p.S, D, dkv_rows<D>()))
    return (int)cudaErrorInvalidValue;
  return launch_hopper<BwdArgs, flash_dkv_tc_kernel<D>>(DkvLayout<D>::kSmem, max_consumers<D>(),
                                                        p, B, args, stream);
}

enum Which { kFwd, kDq, kDkv };

template <int D>
int launch_d(Which which, const Params& p, int B, cudaStream_t stream) {
  if (which == kFwd) return launch_fwd<D>(p, B, stream);
  if (which == kDq) return launch_dq<D>(p, B, stream);
  return launch_dkv<D>(p, B, stream);
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

// The tensor-map caches' counts (hopper.cuh) since the library was loaded: lookups (one
// for each map a launch needs) and encodes (the lookups that missed, each a
// call into libcuda)
extern "C" long long flash_tc_map_lookups() { return map_lookups.load(); }

extern "C" long long flash_tc_map_encodes() { return map_encodes.load(); }
