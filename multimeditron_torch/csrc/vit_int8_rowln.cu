// K7a, K7c with a float o and K7f: the W8A8 ViT kernels that end in a
// LayerNorm of a whole row, quantised to int8 for the next product. K7e (fc2
// + residual + LayerNorm) shares their body but has its own kernel on int8
// wgmma + TMA, vit_int8_fc2.cu, and K7c with an int8 o (K = 1024) runs that
// kernel too; `res_ln_quant_kernel` here stays K7c's float-o form's and
// `finish_rows` K7f's tail.
//
// Replaces, in multimeditron_tpu/ops/vit_int8_fused.py:
// - `_ln_quant_kernel` (:105, via `ln_quant` :501): xq = quant(LN(x), 1 / s);
// - `_oproj_ln_kernel` with a float o (:128, :134-135, via `oproj_ln_quant`
//   :556): x' = acc * (ws * s) + b + x_res, written in the residual's dtype,
//   and xq = quant(LN(x'), 1 / s_next), where A is the (L, 4) and (L, 7)
//   calibrations' float o (or K7g's float output), which the kernel
//   quantises by 1 / s1 as it stages it (`QuantRows`, the Pallas kernel's
//   `_quant_f32(o, 1 / s1)`);
// - `_mlp_fused_kernel` (K7f, :179, via `mlp_fused` :673): fc1 -> activation
//   -> quantisation -> fc2 -> residual -> LayerNorm -> quantisation in one
//   kernel; the int8 hidden never reaches device memory.
//
// What bounds it on the H100: K7a by bytes (one read of x, one int8 write).
// K7c (K = 1024) at the ViT-L/14 encode shape: the o-projection's 1.4e11
// operations (0.07 ms at 1,979 TOPS) sit below its 0.47 GB with a bf16 o
// (0.14 ms), so it is bound by bytes. K7f's two products are
// 1.1e12 operations (0.56 ms).
//
// The design: the LayerNorm needs the whole row (D = 1024), so a block owns
// BM = 16 or 32 rows x all D columns: 8 warps along the columns (D / 8 each)
// times 1 or 2 along the rows, mma.sync m16n8k32 with K streamed through two
// cp.async stages (int8_mma.cuh). The weight stage is D x 64 bytes (80 KB at
// D = 1024), so a block holds one SM; 32-row blocks halve the weight
// re-reads from L2 and are taken when there are enough rows to fill the card.
// After the K loop acc * (ws * s) + b (one fmaf) is staged in shared memory
// over the spent stages (BM x (D + 4) floats, 128 KB at BM = 32); then one
// warp per row adds the residual in the Pallas kernel's order, writes
// x' once, and takes a two-pass f32 LayerNorm of the f32 x' (not of the
// stored bf16) before the int8 quantisation. Rounding follows the Pallas
// body op for op (int8_mma.cuh; rintf, 1 / sqrtf): only the LayerNorm's sums
// are taken in another order.
//
// K7f keeps that tail and puts the MLP before it: a block of 16 rows walks F
// in 128-column chunks; per chunk, fc1 (16 x 128, K = D, four cp.async
// stages) ends in the activation and the int8 quantisation into a 16 x 128
// shared tile, and that tile is at once the A operand of fc2's partial
// product into the block's (16 x D) int32 accumulator, which stays in
// registers (64 a thread at D = 1024) for all of F. Both weights (4 MB each
// at ViT-L) are re-read from L2 by every block: the simple design, not a
// fast one (the Pallas author measured the whole-MLP kernel slower than the
// split pair on the TPU too).
#include "int8_mma.cuh"

namespace {

using namespace mmt::i8;

constexpr int kWarpsN = 8;

// Four consecutive values as float (16-byte load for float, 8-byte for bf16).
__device__ __forceinline__ float4 load4f(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4f(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4f(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float& at(float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// A float (M, K) operand quantised by inv_s as it is staged: K7c's o when
// it arrives as bf16 or float32. Eight values a thread at a time, plain loads
// and shared stores (gemm_accumulate's barrier covers them).
template <typename T>
struct QuantRows {
  const T* __restrict__ p;
  int n_rows, ld;
  float inv_s;

  template <int kRows, int kThreads>
  __device__ __forceinline__ void load(int8_t* dst, int row0, int k0) const {
    constexpr int kChunks = kRows * (kBK / 8);
#pragma unroll
    for (int e = threadIdx.x; e < kChunks; e += kThreads) {
      const int r = e / (kBK / 8), c = (e % (kBK / 8)) * 8;
      const T* src = p + size_t(min(row0 + r, n_rows - 1)) * ld + k0 + c;
      const float4 lo = load4f(src), hi = load4f(src + 4);
      char4 q0, q1;
      q0.x = quant(lo.x, inv_s);
      q0.y = quant(lo.y, inv_s);
      q0.z = quant(lo.z, inv_s);
      q0.w = quant(lo.w, inv_s);
      q1.x = quant(hi.x, inv_s);
      q1.y = quant(hi.y, inv_s);
      q1.z = quant(hi.z, inv_s);
      q1.w = quant(hi.w, inv_s);
      *reinterpret_cast<char4*>(dst + r * kLd + c) = q0;
      *reinterpret_cast<char4*>(dst + r * kLd + c + 4) = q1;
    }
  }
};

// An int8 operand already in shared memory (K7f's hidden tile), rows `ld`
// bytes apart, copied into the stage.
struct SharedRows {
  const int8_t* p;
  int ld;

  template <int kRows, int kThreads>
  __device__ __forceinline__ void load(int8_t* dst, int row0, int k0) const {
    constexpr int kChunks = kRows * (kBK / 16);
#pragma unroll
    for (int e = threadIdx.x; e < kChunks; e += kThreads) {
      const int r = e / (kBK / 16), c = (e % (kBK / 16)) * 16;
      *reinterpret_cast<uint4*>(dst + r * kLd + c) =
          *reinterpret_cast<const uint4*>(p + (row0 + r) * ld + k0 + c);
    }
  }
};

// One warp: LayerNorm of a row held as lane-owned float4 chunks (columns
// 4 lane + 128 i), then quant(., inv_s) into out[0 .. D).
template <int D>
__device__ __forceinline__ void row_ln_quant(float4 (&x)[D / 128], const float* __restrict__ lnw,
                                             const float* __restrict__ lnb, float eps, float inv_s,
                                             int8_t* __restrict__ out, int lane) {
  constexpr int kChunks = D / 128;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum = __fadd_rn(sum, at(x[i], e));
  const float mean = __fdiv_rn(mmt::warp_sum(sum), static_cast<float>(D));
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = __fsub_rn(at(x[i], e), mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
  const float var = __fdiv_rn(mmt::warp_sum(sq), static_cast<float>(D));
  const float rstd = __fdiv_rn(1.f, sqrtf(__fadd_rn(var, eps)));
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = 4 * lane + 128 * i;
    float4 w = load4f(lnw + c), b = load4f(lnb + c);
    char4 q;
    q.x = quant(fmaf(__fmul_rn(__fsub_rn(x[i].x, mean), rstd), w.x, b.x), inv_s);
    q.y = quant(fmaf(__fmul_rn(__fsub_rn(x[i].y, mean), rstd), w.y, b.y), inv_s);
    q.z = quant(fmaf(__fmul_rn(__fsub_rn(x[i].z, mean), rstd), w.z, b.z), inv_s);
    q.w = quant(fmaf(__fmul_rn(__fsub_rn(x[i].w, mean), rstd), w.w, b.w), inv_s);
    *reinterpret_cast<char4*>(out + c) = q;
  }
}

// K7a: one warp per row.
template <int D, typename T>
__global__ void __launch_bounds__(256)
ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                const float* __restrict__ lnb, int8_t* __restrict__ out, int M, float eps,
                float inv_s) {
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  float4 v[D / 128];
#pragma unroll
  for (int i = 0; i < D / 128; ++i) v[i] = load4f(x + size_t(row) * D + 4 * lane + 128 * i);
  row_ln_quant<D>(v, lnw, lnb, eps, inv_s, out + size_t(row) * D, lane);
}

template <int D, int WM>
struct RowLn {
  static constexpr int kBM = 16 * WM;
  static constexpr int kWarps = WM * kWarpsN;
  static constexpr int kThreads = kWarps * mmt::kWarpSize;
  static constexpr int kNT = D / (8 * kWarpsN);  // 8-column tiles per warp
  static constexpr int kLdF = D + 4;              // staged f32 row stride
  static constexpr int kStages = 2;  // a D-row weight stage is 80 KB at D = 1024
  static constexpr size_t kSmem =
      kStages * size_t(kBM + D) * kLd > size_t(kBM) * kLdF * 4 ? kStages * size_t(kBM + D) * kLd
                                                               : size_t(kBM) * kLdF * 4;
};

// The tail of K7c and K7f: acc * (ws * s) + b staged in float32 over the
// spent stages of `smem`, then, one warp a row, x' = staged + x_res (written
// in x_res's dtype) and quant(LN(x'), inv_s). The warp holds rows wm0 + g
// (+ 8) of the block at columns wn0 + 8 j + 2 t (+ 1).
template <int D, int BM, int NT, int kWarps, typename T>
__device__ __forceinline__ void finish_rows(const int (&acc)[1][NT][4], unsigned char* smem,
                                            const float* __restrict__ ws,
                                            const float* __restrict__ bias, float s,
                                            const T* __restrict__ xres,
                                            const float* __restrict__ lnw,
                                            const float* __restrict__ lnb, T* __restrict__ xout,
                                            int8_t* __restrict__ xq, int M, int m0, int wm0,
                                            int wn0, float inv_s, float eps) {
  constexpr int kLdF = D + 4;  // staged f32 row stride
  float* stage = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wn0 + 8 * j + 2 * t;
    const float sc0 = __fmul_rn(ws[col], s), sc1 = __fmul_rn(ws[col + 1], s);
    const float b0 = bias[col], b1 = bias[col + 1];
    float* r0 = stage + (wm0 + g) * kLdF + col;
    float* r1 = r0 + 8 * kLdF;
    r0[0] = fmaf(static_cast<float>(acc[0][j][0]), sc0, b0);
    r0[1] = fmaf(static_cast<float>(acc[0][j][1]), sc1, b1);
    r1[0] = fmaf(static_cast<float>(acc[0][j][2]), sc0, b0);
    r1[1] = fmaf(static_cast<float>(acc[0][j][3]), sc1, b1);
  }
  __syncthreads();

  for (int r = warp; r < BM; r += kWarps) {
    const int row = m0 + r;
    if (row >= M) break;
    float4 x[D / 128];
#pragma unroll
    for (int i = 0; i < D / 128; ++i) {
      const int c = 4 * lane + 128 * i;
      const float4 p = load4f(stage + r * kLdF + c);
      const float4 res = load4f(xres + size_t(row) * D + c);
      x[i] = make_float4(__fadd_rn(p.x, res.x), __fadd_rn(p.y, res.y), __fadd_rn(p.z, res.z),
                         __fadd_rn(p.w, res.w));
      store4f(xout + size_t(row) * D + c, x[i]);
    }
    row_ln_quant<D>(x, lnw, lnb, eps, inv_s, xq + size_t(row) * D, lane);
  }
}

// K7c with a float o; ALoad is QuantRows<T>.
template <int D, int WM, typename T, class ALoad>
__global__ void __launch_bounds__(RowLn<D, WM>::kThreads)
res_ln_quant_kernel(ALoad a, const int8_t* __restrict__ W, const float* __restrict__ ws,
                    const float* __restrict__ bias, const T* __restrict__ xres,
                    const float* __restrict__ lnw, const float* __restrict__ lnb,
                    T* __restrict__ xout, int8_t* __restrict__ xq, int M, int K, float s,
                    float inv_s, float eps) {
  using R = RowLn<D, WM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int m0 = blockIdx.x * R::kBM;
  const int wm0 = (warp / kWarpsN) * 16, wn0 = (warp % kWarpsN) * (D / kWarpsN);
  int acc[1][R::kNT][4];
  zero(acc);
  gemm_accumulate<R::kBM, D, 1, R::kNT, R::kThreads, R::kStages>(
      acc, reinterpret_cast<int8_t*>(smem), a, Int8Rows{W, D, K}, K, m0, 0, wm0, wn0, lane);
  finish_rows<D, R::kBM, R::kNT, R::kWarps>(acc, smem, ws, bias, s, xres, lnw, lnb, xout, xq, M,
                                            m0, wm0, wn0, inv_s, eps);
}

template <int D, int WM, typename T, class ALoad>
int launch_res_ln(const ALoad& a, const void* w, const void* ws, const void* bias,
                  const void* xres, const void* lnw, const void* lnb, void* xout, void* xq, int M,
                  int K, float s, float inv_s, float eps, cudaStream_t stream) {
  using R = RowLn<D, WM>;
  auto kernel = res_ln_quant_kernel<D, WM, T, ALoad>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(R::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + R::kBM - 1) / R::kBM;
  kernel<<<blocks, R::kThreads, R::kSmem, stream>>>(
      a, static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<const T*>(xres),
      static_cast<const float*>(lnw), static_cast<const float*>(lnb), static_cast<T*>(xout),
      static_cast<int8_t*>(xq), M, K, s, inv_s, eps);
  return static_cast<int>(cudaGetLastError());
}

// 32-row blocks once there are at least two per SM of an H100 (132 SMs)
template <int D, typename T, class ALoad>
int launch_res_ln_rows(const ALoad& a, const void* w, const void* ws, const void* bias,
                       const void* xres, const void* lnw, const void* lnb, void* xout, void* xq,
                       int M, int K, float s, float inv_s, float eps, cudaStream_t stream) {
  return M >= 32 * 2 * 132
             ? launch_res_ln<D, 2, T>(a, w, ws, bias, xres, lnw, lnb, xout, xq, M, K, s, inv_s,
                                      eps, stream)
             : launch_res_ln<D, 1, T>(a, w, ws, bias, xres, lnw, lnb, xout, xq, M, K, s, inv_s,
                                      eps, stream);
}

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

template <int D>
struct Mlp {
  static constexpr int kBM = 16;
  static constexpr int kThreads = kWarpsN * mmt::kWarpSize;
  static constexpr int kBF = 128;                // hidden columns a chunk, 16 a warp
  static constexpr int kNT = D / (8 * kWarpsN);  // fc2: 8-column tiles a warp
  static constexpr int kLdH = kBF + 16;          // hidden tile row stride (bytes)
  static constexpr int kStages1 = 4, kStages2 = 2;
  // fc1's stages, fc2's stages and the LayerNorm's staged rows share one
  // region; the hidden tile lies after it
  static constexpr size_t kRegion = cmax(cmax(size_t(kStages2) * (kBM + D) * kLd,
                                              size_t(kStages1) * (kBM + kBF) * kLd),
                                         size_t(kBM) * (D + 4) * 4);
  static constexpr size_t kSmem = kRegion + size_t(kBM) * kLdH;
};

// K7f. xq (M, D), w1 (F, D), w2 (D, F) int8; the hidden int8 lives in `hs`.
template <int D, typename T>
__global__ void __launch_bounds__(Mlp<D>::kThreads)
mlp_fused_kernel(const int8_t* __restrict__ xq, const T* __restrict__ xres,
                 const int8_t* __restrict__ w1, const float* __restrict__ w1s,
                 const float* __restrict__ b1, const int8_t* __restrict__ w2,
                 const float* __restrict__ w2s, const float* __restrict__ b2,
                 const float* __restrict__ lnw, const float* __restrict__ lnb,
                 T* __restrict__ xout, int8_t* __restrict__ xq_out, int M, int F, float s2,
                 float inv_s3, float s3, float inv_s0n, float eps, int act) {
  using P = Mlp<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* region = reinterpret_cast<int8_t*>(smem);
  int8_t* hs = region + P::kRegion;
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * P::kBM;
  const int wn1 = warp * (P::kBF / kWarpsN), wn2 = warp * (D / kWarpsN);
  int acc2[1][P::kNT][4];
  zero(acc2);
  for (int f0 = 0; f0 < F; f0 += P::kBF) {
    int acc1[1][2][4];
    zero(acc1);
    gemm_accumulate<P::kBM, P::kBF, 1, 2, P::kThreads, P::kStages1>(
        acc1, region, Int8Rows{xq, M, D}, Int8Rows{w1, F, D}, D, m0, f0, 0, wn1, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = wn1 + 8 * j + 2 * t, f = f0 + col;
      const float sc0 = __fmul_rn(w1s[f], s2), sc1 = __fmul_rn(w1s[f + 1], s2);
      const float c0 = b1[f], c1 = b1[f + 1];
      char2 lo, hi;
      lo.x = quant(activate(fmaf(static_cast<float>(acc1[0][j][0]), sc0, c0), act), inv_s3);
      lo.y = quant(activate(fmaf(static_cast<float>(acc1[0][j][1]), sc1, c1), act), inv_s3);
      hi.x = quant(activate(fmaf(static_cast<float>(acc1[0][j][2]), sc0, c0), act), inv_s3);
      hi.y = quant(activate(fmaf(static_cast<float>(acc1[0][j][3]), sc1, c1), act), inv_s3);
      *reinterpret_cast<char2*>(hs + g * P::kLdH + col) = lo;
      *reinterpret_cast<char2*>(hs + (g + 8) * P::kLdH + col) = hi;
    }
    __syncthreads();  // the hidden tile is whole before fc2 stages it
    gemm_accumulate<P::kBM, D, 1, P::kNT, P::kThreads, P::kStages2>(
        acc2, region, SharedRows{hs, P::kLdH}, Int8Rows{w2 + f0, D, F}, P::kBF, 0, 0, 0, wn2,
        lane);
  }
  finish_rows<D, P::kBM, P::kNT, kWarpsN>(acc2, smem, w2s, b2, s3, xres, lnw, lnb, xout, xq_out,
                                          M, m0, 0, wn2, inv_s0n, eps);
}

template <int D, typename T>
int launch_mlp(const void* xq, const void* xres, const void* w1, const void* w1s, const void* b1,
               const void* w2, const void* w2s, const void* b2, const void* lnw, const void* lnb,
               void* xout, void* xq_out, int M, int F, float s2, float inv_s3, float s3,
               float inv_s0n, float eps, int act, cudaStream_t stream) {
  using P = Mlp<D>;
  auto kernel = mlp_fused_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(M + P::kBM - 1) / P::kBM, P::kThreads, P::kSmem, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const T*>(xres),
      static_cast<const int8_t*>(w1), static_cast<const float*>(w1s),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
      static_cast<const float*>(w2s), static_cast<const float*>(b2),
      static_cast<const float*>(lnw), static_cast<const float*>(lnb), static_cast<T*>(xout),
      static_cast<int8_t*>(xq_out), M, F, s2, inv_s3, s3, inv_s0n, eps, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the statement with `kD` bound to the tower width `d` (128, 256, 768
// or 1024); any other width returns cudaErrorInvalidValue.
#define MMT_DISPATCH_VIT_WIDTH(d, ...)                \
  do {                                                \
    if ((d) == 128) {                                 \
      constexpr int kD = 128;                         \
      __VA_ARGS__;                                    \
    } else if ((d) == 256) {                          \
      constexpr int kD = 256;                         \
      __VA_ARGS__;                                    \
    } else if ((d) == 768) {                          \
      constexpr int kD = 768;                         \
      __VA_ARGS__;                                    \
    } else if ((d) == 1024) {                         \
      constexpr int kD = 1024;                        \
      __VA_ARGS__;                                    \
    } else {                                          \
      return static_cast<int>(cudaErrorInvalidValue); \
    }                                                 \
  } while (0)

// x (M, D) float or bf16, lnw / lnb (D,) float -> out (M, D) int8.
extern "C" int mmt_int8_ln_quant(const void* x, const void* lnw, const void* lnb, void* out, int M,
                                 int D, float eps, float inv_s, int dtype, void* stream) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  MMT_DISPATCH_VIT_WIDTH(D, MMT_DISPATCH_DTYPE(dtype, {
    ln_quant_kernel<kD, scalar_t><<<(M + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const scalar_t*>(x), static_cast<const float*>(lnw),
        static_cast<const float*>(lnb), static_cast<int8_t*>(out), M, eps, inv_s);
    return static_cast<int>(cudaGetLastError());
  }));
}

// K7c with a float o: o (M, K) in xres's dtype, quantised by inv_s_o as it is
// staged; w (D, K) int8, ws / bias / lnw / lnb (D,) float, xres (M, D) float
// or bf16 -> xout (M, D) in xres's dtype, xq (M, D) int8.
extern "C" int mmt_float_res_ln_quant(const void* o, const void* w, const void* ws,
                                      const void* bias, const void* xres, const void* lnw,
                                      const void* lnb, void* xout, void* xq, int M, int K, int D,
                                      float s, float inv_s_o, float inv_s, float eps, int dtype,
                                      void* stream) {
  if (M < 1 || K % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MMT_DISPATCH_VIT_WIDTH(D, MMT_DISPATCH_DTYPE(dtype, {
    const QuantRows<scalar_t> rows{static_cast<const scalar_t*>(o), M, K, inv_s_o};
    return launch_res_ln_rows<kD, scalar_t>(rows, w, ws, bias, xres, lnw, lnb, xout, xq, M, K, s,
                                            inv_s, eps, st);
  }));
}

// K7f. xq (M, D) int8, xres (M, D) float or bf16, w1 (F, D) and w2 (D, F)
// int8, w1s / b1 (F,), w2s / b2 / lnw / lnb (D,) float -> xout (M, D) in
// xres's dtype, xq_out (M, D) int8. act: 1 quick_gelu, 2 gelu_pytorch_tanh,
// 3 gelu (the approximate sigmoid is refused, as the Pallas kernel does).
extern "C" int mmt_int8_mlp_fused(const void* xq, const void* xres, const void* w1,
                                  const void* w1s, const void* b1, const void* w2,
                                  const void* w2s, const void* b2, const void* lnw,
                                  const void* lnb, void* xout, void* xq_out, int M, int D, int F,
                                  float s2, float inv_s3, float s3, float inv_s0n, float eps,
                                  int act, int dtype, void* stream) {
  if (M < 1 || F < 128 || F % 128 != 0 || act < 1 || act > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MMT_DISPATCH_VIT_WIDTH(D, MMT_DISPATCH_DTYPE(dtype, {
    return launch_mlp<kD, scalar_t>(xq, xres, w1, w1s, b1, w2, w2s, b2, lnw, lnb, xout, xq_out, M,
                                    F, s2, inv_s3, s3, inv_s0n, eps, act, st);
  }));
}
