// K7d: the fused W8A8 ViT tower's fc1, hq = quant(act(acc * (ws * s2) + b),
// 1 / s3), written int8 (M, N), on int8 wgmma + TMA.
//
// Replaces `_fc1_kernel` (multimeditron_tpu/ops/vit_int8_fused.py:145,
// reached through `fc1_gelu_quant` :588).
//
// What bounds it on the H100: operations. At the ViT-L/14 encode shape
// (M = 256 x 257 = 65,792, K = 1024, N = 4096) a call is 5.5e11 int8
// operations, 0.2789 ms at 1,979 TOPS, against 0.34 GB of device-memory
// traffic (0.10 ms). Two more costs stand in the way: the operand reads from
// L2 (M N K (1 / BM + 1 / BN) bytes, 4.3 GB a call with 128 x 128 tiles) and
// the epilogue, which no tensor core runs: for each of the 270 M outputs the
// exact activation (for quick_gelu_approx an exp2f, a bf16 rounding and an
// IEEE reciprocal, instructions that run at a quarter of the FMA rate or
// less) and an int8 store.
//
// The design: a persistent grid, one block an SM, walking 128 x 128 output
// tiles (128 x 64 for gelu) with N fastest (the blocks in flight share their activation rows;
// the 4 MB weight stays in L2). Each block has three warpgroups. Warpgroup
// 0 loads: one warp keeps a ring of six 32 KB stages (128 bytes of K of
// the tile's activation and weight rows) full by TMA, and gives registers
// up with setmaxnreg. Warpgroups 1 and 2 take the tiles in turns (ping-
// pong): each multiplies its whole tile (two wgmma m64n128k32 a step, s8 x
// s8 -> s32 from shared memory, 128 accumulators a thread) and then runs
// the epilogue on its accumulators (dequantise and add the bias in one
// fmaf, activate, quantise) while the other warpgroup's K loop keeps the
// tensor cores busy. The K loops take turns in tile order (named barriers).
// The int8 tile goes to shared memory in the 128-byte swizzle (conflict-free
// 2-byte stores) and leaves in one TMA store, which clips rows past M.
//
// Measured alternatives (PERF.md, kernel_ab.py): both warpgroups sharing a
// 128 x 256 tile (m64n256k32, fewer L2 reads, no overlap of the epilogue)
// was slower, and so was a cluster of two blocks along M sharing each
// weight tile by TMA multicast (every stage then waits for both blocks).
// Any M >= 1, N % 128 == 0 and K % 64 == 0 run (TMA reads zeros past M
// and K). Every output comes from one fixed sequence of operations: two
// runs are bitwise equal.
#include "int8_wgmma.cuh"

namespace {

using namespace mmt::i8w;
using mmt::i8::activate;

constexpr int kBM = 128;  // rows of an output tile, one consumer warpgroup's
constexpr int kThreads = 3 * 128;
constexpr int kStages = 6;

// An output tile has 128 columns, or 64 for gelu, whose erfcf needs the
// registers of half the accumulators. The ring's stages hold the tile's
// activation rows, then its weight rows; each consumer warpgroup has its
// own int8 tile for the TMA store.
template <int kAct>
struct Tile {
  static constexpr int kBN = kAct == 3 ? 64 : 128;
  using RingT = Ring<kBM, kBN>;
  static constexpr int kOutBytes = kBM * kBN;
  static constexpr int kOut = kStages * RingT::kStageBytes;
  static constexpr int kTable = kOut + 2 * kOutBytes;  // 128 reciprocals (quick_gelu_approx)
  static constexpr int kBars = kTable + 128 * 4;
  static constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;  // + room to align to 1024
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// Named barriers: 1 + c orders warpgroup c's K loop after the other's (256
// threads: one arrives, one waits); 3 + c is warpgroup c's own (128).
constexpr int kOrderBarrier = 1, kTileBarrier = 3;

// Byte offset of (row r, column c) of a kBN-wide int8 tile in the swizzle
// of its width: 16-byte chunk c / 16 of row r goes to chunk (c / 16) ^
// (r % 8) of 128-byte rows, or (c / 16) ^ (r / 2 % 4) of 64-byte rows.
template <int kBN>
__device__ __forceinline__ int swizzled(int r, int c) {
  const int chunk = kBN == 128 ? ((c >> 4) ^ r) & 7 : ((c >> 4) ^ (r >> 1)) & 3;
  return r * kBN + (chunk << 4) + (c & 15);
}

// 1 / x for a bf16 value x >= 1 (quick_gelu_approx's denominator), without
// the reciprocal instruction and its slow-path branch, which keep the
// epilogue from interleaving outputs: x = 2^E (1 + m / 128) and
// table[m] = __frcp_rn(1 + m / 128), so 1 / x is table[m] with E taken off
// its exponent, the same bits as __frcp_rn(x) while 1 / x is normal
// (E <= 125). Above that (and for inf or NaN) it returns 0: the activation
// g / x is then below 2^-125 |g| and quantises to 0, as the exact one does
// (a NaN g stays NaN).
__device__ __forceinline__ float recip_bf16(float x, const float* table) {
  const uint32_t bits = __float_as_uint(x), e = bits >> 23;
  const uint32_t t = __float_as_uint(table[(bits >> 16) & 127]);
  return e <= 127 + 125 ? __uint_as_float(t - ((e - 127) << 23)) : 0.f;
}

// 2^x by the MUFU unit, flushing a subnormal result to 0. exp2f is the same
// instruction with a rescaling around it for results below 2^-126; the
// caller adds 1, which a subnormal cannot move, so the sum is exp2f's.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// int8_mma.cuh's activate, with quick_gelu_approx's reciprocal from the table.
template <int kAct>
__device__ __forceinline__ float activate_fc1(float g, const float* table) {
  if constexpr (kAct == 0) {
    const float e = ex2_ftz(__fmul_rn(-2.4554396102104056f, g));
    return __fmul_rn(g, recip_bf16(mmt::i8::bf16_round(__fadd_rn(1.f, e)), table));
  } else {
    return activate(g, kAct);
  }
}

template <int kAct>
__global__ void __launch_bounds__(kThreads, 1)
fc1_act_quant_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap out_map, const float* __restrict__ ws,
                     const float* __restrict__ bias, int M, int N, int K, float s, float inv_s) {
  using Tl = Tile<kAct>;
  using RingT = typename Tl::RingT;
  constexpr int kBN = Tl::kBN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tl::kBars);
  float* table = reinterpret_cast<float*>(smem + Tl::kTable);
  const RingT ring{smem, full, full + kStages, kStages};
  const int lane = threadIdx.x % mmt::kWarpSize;
  if (threadIdx.x == 0) {
    ring.init(4);  // each stage is one warpgroup's
    mmt::hopper::fence_barrier_init();
  }
  if (threadIdx.x < 128) table[threadIdx.x] = __frcp_rn(1.f + threadIdx.x / 128.f);
  __syncthreads();

  const int n_k = (K + kRowBytes - 1) / kRowBytes;
  const int n_n = N / kBN;
  const int n_tiles = (M + kBM - 1) / kBM * n_n;

  if (threadIdx.x < 128) {
    MMT_I8W_PRODUCER_REGS();
    if (threadIdx.x >= mmt::kWarpSize) return;
    int t = 0;
    for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
      const int m0 = (u / n_n) * kBM, n0 = (u % n_n) * kBN;
      for (int kb = 0; kb < n_k; ++kb, ++t) {
        ring.wait_empty(t);
        if (lane == 0) ring.load(t, &a_map, m0, &w_map, n0, kb * kRowBytes);
        __syncwarp();
      }
    }
    return;
  }

  MMT_I8W_CONSUMER_REGS();
  const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x / mmt::kWarpSize) % 4;
  const int g = lane / 4, t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* out_tile = smem + Tl::kOut + c * Tl::kOutBytes;
  int acc[2][kBN / 2];
  int i = 0;
  for (int u = blockIdx.x; u < n_tiles; u += gridDim.x, ++i) {
    if (i % 2 != c) continue;  // the other warpgroup's tile
    const int m0 = (u / n_n) * kBM, n0 = (u % n_n) * kBN;
    // A warpgroup waits on a stage's full barrier by the parity of its use,
    // which is sound only once the stage's previous use has landed: the
    // previous tile, the other warpgroup's, has finished its K loop.
    if (i > 0) named_sync(kOrderBarrier + c, 256);
    mainloop<2, kBN>(acc, ring, i * n_k, n_k, 0, RingT::kYOffset, lane);
    if (u + gridDim.x < n_tiles) named_arrive(kOrderBarrier + 1 - c, 256);

    if (leader) bulk_wait_all<true>();  // the previous tile's store has read out_tile
    named_sync(kTileBarrier + c, 128);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 w2 = *reinterpret_cast<const float2*>(ws + n0 + col);
      const float2 b2 = *reinterpret_cast<const float2*>(bias + n0 + col);
      const float sc0 = __fmul_rn(w2.x, s), sc1 = __fmul_rn(w2.y, s);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * mi + 16 * warp + g + 8 * h;
          const float x0 = activate_fc1<kAct>(
              fmaf(static_cast<float>(acc[mi][4 * j + 2 * h]), sc0, b2.x), table);
          const float x1 = activate_fc1<kAct>(
              fmaf(static_cast<float>(acc[mi][4 * j + 2 * h + 1]), sc1, b2.y), table);
          *reinterpret_cast<uint16_t*>(out_tile + swizzled<kBN>(r, col)) = quant2(x0, x1, inv_s);
        }
    }
    fence_proxy_async();
    named_sync(kTileBarrier + c, 128);
    if (leader) {
      tma_store_2d(&out_map, out_tile, n0, m0);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_all<false>();
}

template <int kAct>
int launch(const void* a, const void* w, const void* ws, const void* bias, void* out, int M,
           int K, int N, float s, float inv_s, cudaStream_t stream) {
  using Tl = Tile<kAct>;
  CUtensorMap a_map, w_map, out_map;
  int err = make_int8_map(&a_map, a, M, K, kBM);
  if (err == 0) err = make_int8_map(&w_map, w, N, K, Tl::kBN);
  if (err == 0) err = make_int8_map(&out_map, out, M, N, kBM, Tl::kBN);
  if (err != 0) return err;
  auto kernel = fc1_act_quant_kernel<kAct>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorNoDevice);
  const int tiles = (M + kBM - 1) / kBM * (N / Tl::kBN);
  fc1_act_quant_kernel<kAct><<<tiles < sms ? tiles : sms, kThreads, Tl::kSmem, stream>>>(
      a_map, w_map, out_map, static_cast<const float*>(ws), static_cast<const float*>(bias), M,
      N, K, s, inv_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) int8, w (N, K) int8, ws / bias (N,) float -> out (M, N) int8.
// act: 0 quick_gelu_approx, 1 quick_gelu, 2 gelu_pytorch_tanh, 3 gelu.
extern "C" int mmt_int8_fc1_act_quant(const void* a, const void* w, const void* ws,
                                      const void* bias, void* out, int M, int K, int N, float s,
                                      float inv_s, int act, void* stream) {
  if (M < 1 || K < 64 || K % 64 != 0 || N < 128 || N % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0: return launch<0>(a, w, ws, bias, out, M, K, N, s, inv_s, st);
    case 1: return launch<1>(a, w, ws, bias, out, M, K, N, s, inv_s, st);
    case 2: return launch<2>(a, w, ws, bias, out, M, K, N, s, inv_s, st);
    case 3: return launch<3>(a, w, ws, bias, out, M, K, N, s, inv_s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
