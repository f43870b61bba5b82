// K7b and the projection half of K7g: tiled int8 GEMMs with a per-column
// epilogue, for the fused W8A8 ViT tower (K7d, fc1, is vit_int8_fc1.cu).
//
// Replaces, in multimeditron_tpu/ops/vit_int8_fused.py:
// - `_qkv_kernel` (K7b, :111, reached through `qkv_int8` :520): q, k and v =
//   acc * (ws * s0) + b as three separate (M, D) tensors in the residual
//   stream's dtype (bf16 or float32), or, with static q/k/v scales, each
//   quantised to int8 at its own scale (the (L, 4) calibration's layer);
// - the projection of `_qkv_attn_kernel` (:217, reached through
//   `qkv_attn_int8` :767): q8 = quant(acc * (ws * s0) + b, 1 / sq), k8 the
//   same with 1 / sk, and v in bf16; vit_int8_attention.cu then attends.
//
// What bounds it on the H100: operations. The QKV projection at the
// ViT-L/14 encode shape (M = 256 x 257 = 65,792, K = 1024, N = 3072) is
// 4.1e11 int8 operations, 0.21 ms at 1,979 TOPS, and so is K7b's.
//
// The design: one block of 8 warps per 128 x 128 output tile, each warp a
// 64 x 32 sub-tile of 4 x 4 mma.sync m16n8k32 accumulators fed by
// ldmatrix; K streams through four cp.async stages of 64 bytes (80 KB, two
// blocks an SM; int8_mma.cuh). The int32 accumulators never leave
// registers: the epilogue dequantises, adds the bias and quantises (or
// rounds to bf16) in place; each thread reads its 8 columns' scales and
// biases once. Blocks walk the output columns fastest, so the blocks in
// flight share one 128-row activation tile and the whole weight stays in L2.
// wgmma, TMA and a persistent schedule (vit_int8_fc1.cu's) are later work
// here.
#include "int8_mma.cuh"

namespace {

using namespace mmt::i8;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kStages = 4;
constexpr int kSmem = kStages * (kBM + kBN) * kLd;  // 80 KB: two blocks an SM

// An epilogue gives each output column pair its dequantisation scale
// (ws * s) and bias once per thread (scale, shift), then finishes and stores
// two adjacent outputs of a row from their int32 accumulators (put).
struct QkvEpilogue {
  const float* ws;    // (3, D)
  const float* bias;  // (3, D)
  int8_t* q8;
  int8_t* k8;
  __nv_bfloat16* v;
  int D;
  float s0, inv_q, inv_k;

  __device__ __forceinline__ float2 scale(int col) const {
    return make_float2(__fmul_rn(ws[col], s0), __fmul_rn(ws[col + 1], s0));
  }
  __device__ __forceinline__ float2 shift(int col) const { return make_float2(bias[col], bias[col + 1]); }
  __device__ __forceinline__ void put(int row, int col, int a0, int a1, float2 sc, float2 b) const {
    const int j = col / D, c = col - j * D;
    const float x0 = fmaf(static_cast<float>(a0), sc.x, b.x);
    const float x1 = fmaf(static_cast<float>(a1), sc.y, b.y);
    const size_t at = size_t(row) * D + c;
    if (j == 2) {
      *reinterpret_cast<__nv_bfloat162*>(v + at) = __floats2bfloat162_rn(x0, x1);
    } else {
      const float inv = j == 0 ? inv_q : inv_k;
      char2 q;
      q.x = quant(x0, inv);
      q.y = quant(x1, inv);
      *reinterpret_cast<char2*>((j == 0 ? q8 : k8) + at) = q;
    }
  }
};

// K7b: q, k, v (columns [0, D), [D, 2 D), [2 D, 3 D) of the product) into
// three (M, D) tensors of type T; inv[j] quantises output j when T is int8.
template <typename T>
struct QkvSplitEpilogue {
  const float* ws;    // (3, D)
  const float* bias;  // (3, D)
  T* out[3];
  int D;
  float s0;
  float inv[3];

  __device__ __forceinline__ float2 scale(int col) const {
    return make_float2(__fmul_rn(ws[col], s0), __fmul_rn(ws[col + 1], s0));
  }
  __device__ __forceinline__ float2 shift(int col) const { return make_float2(bias[col], bias[col + 1]); }
  __device__ __forceinline__ void put(int row, int col, int a0, int a1, float2 sc, float2 b) const {
    const int j = col / D;
    store2(out[j] + size_t(row) * D + (col - j * D), fmaf(static_cast<float>(a0), sc.x, b.x),
           fmaf(static_cast<float>(a1), sc.y, b.y), inv[j]);
  }
};

template <class Epilogue>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N, int K,
                 Epilogue epi) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm0 = (warp / 4) * 64, wn0 = (warp % 4) * 32;
  int acc[4][4][4];
  gemm_mainloop<kBM, kBN, 4, 4, kThreads, kStages>(acc, smem, A, B, M, N, K, m0, n0, wm0, wn0, lane);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn0 + 8 * j + 2 * t;
    const float2 sc = epi.scale(col), b = epi.shift(col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + wm0 + 16 * i + g;
      if (row < M) epi.put(row, col, acc[i][j][0], acc[i][j][1], sc, b);
      if (row + 8 < M) epi.put(row + 8, col, acc[i][j][2], acc[i][j][3], sc, b);
    }
  }
}

template <class Epilogue>
int launch(const void* a, const void* w, int M, int N, int K, const Epilogue& epi,
           cudaStream_t stream) {
  if (M < 1 || K % kBK != 0 || N % kBN != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<Epilogue>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<Epilogue><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w), M, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) int8, w (3 D, K) int8 (q, k, v rows), ws / bias (3 D,) float ->
// q8, k8 (M, D) int8 and v (M, D) bf16.
extern "C" int mmt_int8_qkv_project(const void* a, const void* w, const void* ws,
                                    const void* bias, void* q8, void* k8, void* v, int M, int K,
                                    int D, float s0, float inv_q, float inv_k, void* stream) {
  if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const QkvEpilogue epi{static_cast<const float*>(ws), static_cast<const float*>(bias),
                        static_cast<int8_t*>(q8), static_cast<int8_t*>(k8),
                        static_cast<__nv_bfloat16*>(v), D, s0, inv_q, inv_k};
  return launch(a, w, M, 3 * D, K, epi, static_cast<cudaStream_t>(stream));
}

// K7b. a (M, K) int8, w (3 D, K) int8 (q, k, v rows), ws / bias (3 D,) float
// -> q, k, v (M, D) each: out_code 0 float32, 1 bf16, 2 int8 (quantised by
// inv_q, inv_k, inv_v).
extern "C" int mmt_int8_qkv_split(const void* a, const void* w, const void* ws, const void* bias,
                                  void* q, void* k, void* v, int M, int K, int D, float s0,
                                  float inv_q, float inv_k, float inv_v, int out_code,
                                  void* stream) {
  if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  switch (out_code) {
    case 0: {
      const QkvSplitEpilogue<float> epi{wsf, bf, {static_cast<float*>(q), static_cast<float*>(k),
                                                  static_cast<float*>(v)}, D, s0, {1.f, 1.f, 1.f}};
      return launch(a, w, M, 3 * D, K, epi, st);
    }
    case 1: {
      const QkvSplitEpilogue<__nv_bfloat16> epi{
          wsf, bf, {static_cast<__nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k),
                    static_cast<__nv_bfloat16*>(v)}, D, s0, {1.f, 1.f, 1.f}};
      return launch(a, w, M, 3 * D, K, epi, st);
    }
    case 2: {
      const QkvSplitEpilogue<int8_t> epi{wsf, bf, {static_cast<int8_t*>(q), static_cast<int8_t*>(k),
                                                   static_cast<int8_t*>(v)}, D, s0,
                                         {inv_q, inv_k, inv_v}};
      return launch(a, w, M, 3 * D, K, epi, st);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
