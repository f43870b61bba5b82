// K7b and the projection half of K7g: the fused W8A8 ViT tower's QKV
// projection, val = acc * (ws * s0) + b over the (3 D, K) weight of q, k and
// v rows, on int8 wgmma + TMA.
//
// Replaces, in multimeditron_tpu/ops/vit_int8_fused.py:
// - `_qkv_kernel` (K7b, :111, reached through `qkv_int8` :520): q, k and v as
//   three separate (M, D) tensors in the residual stream's dtype (bf16 or
//   float32), or, with static q/k/v scales, each quantised to int8 at its
//   own scale (the (L, 4) calibration's layer);
// - the projection of `_qkv_attn_kernel` (:217, reached through
//   `qkv_attn_int8` :767): q8 = quant(val, 1 / sq), k8 = quant(val, 1 / sk)
//   and v = bf16(val); vit_int8_attention.cu then attends.
//
// What bounds it on the H100: operations. At the ViT-L/14 encode shape
// (M = 256 x 257 = 65,792, K = 1024, N = 3 D = 3072) a call is 4.1e11 int8
// operations, 0.2092 ms at 1,979 TOPS, against 0.34 GB of device-memory
// traffic for K7g's outputs (0.10 ms).
//
// The design is K7d's (vit_int8_fc1.cu): a persistent grid, one block an
// SM, walking 128 x 128 output tiles with N fastest (the blocks in flight
// share their activation rows; the 3 MB weight stays in L2). Two consumer
// warpgroups take the tiles in turns (ping-pong): each multiplies its whole
// tile (two wgmma m64n128k32 a step, s8 x s8 -> s32, 128 accumulators a
// thread), then runs the epilogue while the other warpgroup's K loop keeps
// the tensor cores busy; named barriers order the K loops in tile order.
// One more warp, the producer, keeps a ring of five 32 KB stages (128 bytes
// of K of the tile's activation and weight rows) full by TMA. 288 threads a
// block and no setmaxnreg: K7d's 384 threads with setmaxnreg 40 / 232
// spilled here (-Xptxas -v), this layout does not.
//
// The epilogue is a policy of the one kernel: what each of q, k and v is
// stored as (K7g's projection: int8, int8, bf16; K7b: three float32, bf16
// or int8 outputs). D % 128 == 0, so a tile lies in one of q, k and v and
// picks its output once. An int8 tile (128 bytes a row) and each 64-column
// half of a bf16 tile go through a 16 KB shared slab of the warpgroup's two
// in the 128-byte swizzle (conflict-free 2- and 4-byte stores) and leave by
// TMA stores, which clip rows past M. A float32 tile (K7b's f32 form, off
// the main path) is stored straight from registers. (Six stages and one
// slab, the halves of a bf16 tile taking turns in it, measured slower.)
//
// Rounding is that of the Pallas body (int8_mma.cuh): ws * s0 by __fmul_rn,
// val by one fmaf, the int8 rounding by quant2 (int8_wgmma.cuh: the same
// values as quant), bf16 by __floats2bfloat162_rn. Every output comes from
// one fixed sequence of operations: two runs are bitwise equal. TMA reads
// zeros past M and K, so any M >= 1 and K % 64 == 0 run.
#include "int8_wgmma.cuh"

namespace {

using namespace mmt::i8w;

constexpr int kBM = 128, kBN = 128;  // an output tile, one consumer warpgroup's
constexpr int kThreads = 2 * 128 + 32;  // two consumer warpgroups, then the producer warp
constexpr int kStages = 5;
using RingT = Ring<kBM, kBN>;        // the tile's activation rows, then its weight rows
constexpr int kSlabBytes = kBM * kRowBytes;  // 128 rows of 128 bytes
constexpr int kOut = kStages * RingT::kStageBytes;  // then two slabs a consumer warpgroup
constexpr int kBars = kOut + 2 * 2 * kSlabBytes;
constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;  // + room to align to 1024
static_assert(kSmem <= 232448, "shared memory of one block");

// Named barriers: 1 + c orders warpgroup c's K loop after the other's (256
// threads: one arrives, one waits); 3 + c is warpgroup c's own (128).
constexpr int kOrderBarrier = 1, kSlabBarrier = 3;

// What an output is stored as (the entry points' out_code).
enum Kind : int { kF32 = 0, kBf16 = 1, kInt8 = 2 };

// The epilogue policy: the kinds of q, k and v.
template <int kQ, int kK, int kV>
struct Kinds {
  __host__ __device__ static constexpr int of(int j) { return j == 0 ? kQ : (j == 1 ? kK : kV); }
};
using Project = Kinds<kInt8, kInt8, kBf16>;  // K7g's projection
template <int kOutKind>
using Split = Kinds<kOutKind, kOutKind, kOutKind>;  // K7b

// Byte offset of (row r, byte b) of a slab of 128-byte rows in the 128-byte
// swizzle: 16-byte chunk b / 16 of row r goes to chunk (b / 16) ^ (r % 8).
__device__ __forceinline__ int swizzled(int r, int b) {
  return r * kRowBytes + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// Tile columns [64 kH, 64 kH + 64) into the warpgroup's slabs: bytes
// [64 kH, 64 kH + 64) of the one slab of an int8 tile, or the whole of slab
// kH of a bf16 tile. ws and bias start at the tile's first column.
template <int kKind, int kH>
__device__ __forceinline__ void write_half(const int (&acc)[2][kBN / 2], unsigned char* slabs,
                                           const float* ws, const float* bias, float s0,
                                           float inv, int warp, int g, int t4) {
  unsigned char* slab = slabs + (kKind == kInt8 ? 0 : kH * kSlabBytes);
#pragma unroll
  for (int j = 8 * kH; j < 8 * kH + 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 w2 = *reinterpret_cast<const float2*>(ws + col);
    const float2 b2 = *reinterpret_cast<const float2*>(bias + col);
    const float sc0 = __fmul_rn(w2.x, s0), sc1 = __fmul_rn(w2.y, s0);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * mi + 16 * warp + g + 8 * h;
        const float x0 = fmaf(static_cast<float>(acc[mi][4 * j + 2 * h]), sc0, b2.x);
        const float x1 = fmaf(static_cast<float>(acc[mi][4 * j + 2 * h + 1]), sc1, b2.y);
        if constexpr (kKind == kInt8) {
          *reinterpret_cast<uint16_t*>(slab + swizzled(r, col)) = quant2(x0, x1, inv);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(slab + swizzled(r, 2 * (col - 64 * kH))) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
  }
}

// A warpgroup's int8 or bf16 tile through its slabs (one for int8, two for
// bf16), by TMA stores at column c0 of the output.
template <int kKind>
__device__ __forceinline__ void store_tile(const int (&acc)[2][kBN / 2], unsigned char* slabs,
                                           const CUtensorMap* map, int c0, int m0,
                                           const float* ws, const float* bias, float s0,
                                           float inv, int c, int warp, int g, int t4,
                                           bool leader) {
  constexpr int kSlabsUsed = kKind == kInt8 ? 1 : 2, kBytes = kKind == kInt8 ? 1 : 2;
  if (leader) bulk_wait_all<true>();  // the previous tile's stores have read the slabs
  named_sync(kSlabBarrier + c, 128);
  write_half<kKind, 0>(acc, slabs, ws, bias, s0, inv, warp, g, t4);
  write_half<kKind, 1>(acc, slabs, ws, bias, s0, inv, warp, g, t4);
  fence_proxy_async();
  named_sync(kSlabBarrier + c, 128);
  if (leader) {
#pragma unroll
    for (int p = 0; p < kSlabsUsed; ++p)
      tma_store_2d(map, slabs + p * kSlabBytes, kBytes * c0 + kRowBytes * p, m0);
    bulk_commit();
  }
}

// A float32 tile straight from registers (rows below M).
__device__ __forceinline__ void store_f32(const int (&acc)[2][kBN / 2], float* out, int D,
                                          int M, int m0, const float* ws, const float* bias,
                                          float s0, int warp, int g, int t4) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 w2 = *reinterpret_cast<const float2*>(ws + col);
    const float2 b2 = *reinterpret_cast<const float2*>(bias + col);
    const float sc0 = __fmul_rn(w2.x, s0), sc1 = __fmul_rn(w2.y, s0);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 64 * mi + 16 * warp + g + 8 * h;
        if (row < M)
          *reinterpret_cast<float2*>(out + size_t(row) * D + col) =
              make_float2(fmaf(static_cast<float>(acc[mi][4 * j + 2 * h]), sc0, b2.x),
                          fmaf(static_cast<float>(acc[mi][4 * j + 2 * h + 1]), sc1, b2.y));
      }
  }
}

// q, k and v: each int8 or bf16 output's TMA map (as rows of bytes), each
// float32 output's pointer, each int8 output's 1 / scale.
template <class Policy>
__global__ void __launch_bounds__(kThreads, 1)
qkv_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, float* q32, float* k32, float* v32,
                const float* __restrict__ ws, const float* __restrict__ bias, int M, int K,
                int D, float s0, float inv_q, float inv_k, float inv_v) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  const RingT ring{smem, full, full + kStages, kStages};
  const int lane = threadIdx.x % mmt::kWarpSize;
  if (threadIdx.x == 0) {
    ring.init(4);  // each stage is one warpgroup's
    mmt::hopper::fence_barrier_init();
  }
  __syncthreads();

  const int n_k = (K + kRowBytes - 1) / kRowBytes;
  const int n_n = 3 * D / kBN;
  const int n_tiles = (M + kBM - 1) / kBM * n_n;

  if (threadIdx.x >= 256) {  // the producer warp
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

  const int c = threadIdx.x / 128, warp = (threadIdx.x / mmt::kWarpSize) % 4;
  const int g = lane / 4, t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* slabs = smem + kOut + c * 2 * kSlabBytes;
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

    // q, k or v, and the tile's first column there
    const int j = (n0 >= D) + (n0 >= 2 * D), c0 = n0 - j * D;
    const int kind = Policy::of(j);
    const CUtensorMap* map = j == 0 ? &q_map : (j == 1 ? &k_map : &v_map);
    const float inv = j == 0 ? inv_q : (j == 1 ? inv_k : inv_v);
    if (kind == kInt8) {
      store_tile<kInt8>(acc, slabs, map, c0, m0, ws + n0, bias + n0, s0, inv, c, warp, g, t4,
                        leader);
    } else if (kind == kBf16) {
      store_tile<kBf16>(acc, slabs, map, c0, m0, ws + n0, bias + n0, s0, inv, c, warp, g, t4,
                        leader);
    } else {
      store_f32(acc, (j == 0 ? q32 : (j == 1 ? k32 : v32)) + c0, D, M, m0, ws + n0, bias + n0,
                s0, warp, g, t4);
    }
  }
  if (leader) bulk_wait_all<false>();
}

// q, k, v (M, D) each; ws / bias (3 D,) float.
template <class Policy>
int launch(const void* a, const void* w, const void* ws, const void* bias, void* const out[3],
           int M, int K, int D, float s0, const float inv[3], cudaStream_t stream) {
  if (M < 1 || K < 64 || K % 64 != 0 || D < 128 || D % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map, w_map, maps[3] = {};
  int err = make_int8_map(&a_map, a, M, K, kBM);
  if (err == 0) err = make_int8_map(&w_map, w, 3 * D, K, kBN);
  for (int j = 0; j < 3 && err == 0; ++j) {
    // an int8 or bf16 output as rows of bytes: D of int8, 2 D of bf16
    const int kind = Policy::of(j);
    if (kind != kF32) err = make_int8_map(&maps[j], out[j], M, kind == kInt8 ? D : 2 * D, kBM);
  }
  if (err != 0) return err;
  auto kernel = qkv_gemm_kernel<Policy>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorNoDevice);
  const int tiles = (M + kBM - 1) / kBM * (3 * D / kBN);
  kernel<<<tiles < sms ? tiles : sms, kThreads, kSmem, stream>>>(
      a_map, w_map, maps[0], maps[1], maps[2], static_cast<float*>(out[0]),
      static_cast<float*>(out[1]), static_cast<float*>(out[2]), static_cast<const float*>(ws),
      static_cast<const float*>(bias), M, K, D, s0, inv[0], inv[1], inv[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) int8, w (3 D, K) int8 (q, k, v rows), ws / bias (3 D,) float ->
// q8, k8 (M, D) int8 and v (M, D) bf16.
extern "C" int mmt_int8_qkv_project(const void* a, const void* w, const void* ws,
                                    const void* bias, void* q8, void* k8, void* v, int M, int K,
                                    int D, float s0, float inv_q, float inv_k, void* stream) {
  void* const outs[3] = {q8, k8, v};
  const float inv[3] = {inv_q, inv_k, 1.f};
  return launch<Project>(a, w, ws, bias, outs, M, K, D, s0, inv,
                         static_cast<cudaStream_t>(stream));
}

// K7b. a (M, K) int8, w (3 D, K) int8 (q, k, v rows), ws / bias (3 D,) float
// -> q, k, v (M, D) each: out_code 0 float32, 1 bf16, 2 int8 (quantised by
// inv_q, inv_k, inv_v).
extern "C" int mmt_int8_qkv_split(const void* a, const void* w, const void* ws, const void* bias,
                                  void* q, void* k, void* v, int M, int K, int D, float s0,
                                  float inv_q, float inv_k, float inv_v, int out_code,
                                  void* stream) {
  void* const outs[3] = {q, k, v};
  const float inv[3] = {inv_q, inv_k, inv_v};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case kF32: return launch<Split<kF32>>(a, w, ws, bias, outs, M, K, D, s0, inv, st);
    case kBf16: return launch<Split<kBf16>>(a, w, ws, bias, outs, M, K, D, s0, inv, st);
    case kInt8: return launch<Split<kInt8>>(a, w, ws, bias, outs, M, K, D, s0, inv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
