// K9: the weight-only int8 matmul of the quantised Llama decoder,
// out = (x @ widen(w_q)) * w_s with float32 accumulation and one cast.
//
// Replaces multimeditron_tpu/ops/wo_matmul.py `_wo_kernel` (:31, reached
// through `wo_matmul_pallas` :47): widen the int8 weight to the activation's
// type, take the product with float32 accumulation, scale each column, cast
// once. x is (M, K) float32 or bf16, w_q (N, K) int8 with K contiguous (one
// row per output column), w_s (N,) float32, out (M, N) in x's type.
//
// What bounds it on the H100: bytes at decode, operations at prefill. A
// Llama-3.1-8B decode step (M = 8) streams 7.50 GB of int8 weights through
// its 129 calls: 2.24 ms at 3.35 TB/s; a W8A16 prefill of 8 x 512 rows
// (M = 4,096) is 5.72e13 bf16 operations: 57.8 ms at 989 TFLOP/s.
//
// The design (bf16): 4 warps a block, each warp 4 n-tiles of 8 columns (128
// columns a block) over 16 (M <= 16) or 64 rows, mma.sync m16n8k16 with
// float32 accumulators. x and the weight stream through a 4-stage cp.async
// pipeline, 64 K values a stage; a weight stage is 128 rows x 64 bytes, read
// from shared memory with one 16-byte load per lane and n-tile and widened
// int8 -> bf16 in registers (exact: |w| <= 127) by byte permutes and one
// float32 subtraction, not the conversion units (`widen4`). K is permuted inside each
// 64-value chunk so that lane t's 16 bytes of a weight row are the 16 K
// values of four consecutive mma k-steps; x's A fragments take the same
// permutation (a sum does not care about its order), so no shuffle or
// transpose is needed. Where N / 128 blocks cannot fill the SMs (o and down
// at N = 4,096, qkv, gate-up), K is split and a second pass sums the float32
// slices in a fixed order, then scales and casts: no atomics, the same
// result on every run. Rows past M and columns past N read the last row or
// column and are never stored. float32 activations run on the CUDA cores:
// a 64 x 64 tile a block of 256 threads, 4 x 4 outputs a thread. wgmma, TMA,
// a persistent schedule and a fused lm_head + sampling are later work.
#include <stdint.h>

#include "flash.cuh"
#include "int8_mma.cuh"

namespace {

using mmt::i8::cp_async16;
using mmt::i8::cp_async_commit;
using mmt::i8::cp_async_wait;

constexpr int kChunk = 64;              // K values a pipeline stage
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * mmt::kWarpSize;
constexpr int kNT = 4;                  // 8-column n-tiles a warp
constexpr int kBN = kWarps * kNT * 8;   // 128 columns a block
constexpr int kStages = 4;
constexpr int kXLd = kChunk + 8;        // bf16 row stride of an x stage: 144 bytes
constexpr int kWLd = kChunk;            // byte row stride of a weight stage

template <int MT>
struct Tile {
  static constexpr int kBM = 16 * MT;
  static constexpr int kXBytes = kBM * kXLd * 2;
  static constexpr int kStageBytes = kXBytes + kBN * kWLd;
  static constexpr int kSmem = kStages * kStageBytes;
};

// One stage: rows [m0, m0 + BM) of x and [n0, n0 + 128) of w over K values
// [k0, k0 + 64). Rows past the end copy the last row.
template <int MT>
__device__ __forceinline__ void load_stage(uint8_t* stage, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ w, int M, int N, int K,
                                           int m0, int n0, int k0) {
  constexpr int kXVec = kChunk * 2 / 16;  // 16-byte pieces of an x row
  for (int e = threadIdx.x; e < Tile<MT>::kBM * kXVec; e += kThreads) {
    const int r = e / kXVec, c = (e % kXVec) * 8;
    const int row = min(m0 + r, M - 1);
    cp_async16(stage + (r * kXLd + c) * 2, x + size_t(row) * K + k0 + c);
  }
  constexpr int kWVec = kChunk / 16;
  uint8_t* ws = stage + Tile<MT>::kXBytes;
  for (int e = threadIdx.x; e < kBN * kWVec; e += kThreads) {
    const int r = e / kWVec, c = (e % kWVec) * 16;
    const int row = min(n0 + r, N - 1);
    cp_async16(ws + r * kWLd + c, w + size_t(row) * K + k0 + c);
  }
}

__device__ __forceinline__ float s8(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * byte)) & 0xffu));
}

// Four int8 of `word` (byte 0 first) -> two bf16 pairs, exactly, without the
// conversion units (I2F and F2F run at a sixteenth of the FP32 rate and
// bounded the first version at decode): byte b, biased to u = b + 128, goes
// into the mantissa of 2^23 (0x4B000000 | u = 2^23 + u), one subtraction of
// 2^23 + 128 leaves b as a float32 whose low 16 bits are zero (|b| <= 128),
// so its high half is b in bf16.
__device__ __forceinline__ void widen4(uint32_t word, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kBias;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
wo_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ w_s, __nv_bfloat16* __restrict__ out,
               float* __restrict__ partial, int M, int K, int N, int chunks_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * Tile<MT>::kBM, n0 = blockIdx.y * kBN, wn0 = warp * kNT * 8;
  const int c0 = blockIdx.z * chunks_per_split;
  const int nk = min(chunks_per_split, K / kChunk - c0);

  float acc[MT][kNT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int kt) {
    load_stage<MT>(smem + (kt % kStages) * Tile<MT>::kStageBytes, x, w, M, N, K, m0, n0,
                   (c0 + kt) * kChunk);
  };
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // ... for every thread, and stage kt - 1 is spent
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const uint8_t* stage = smem + (kt % kStages) * Tile<MT>::kStageBytes;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage);
    const uint8_t* wsm = stage + Tile<MT>::kXBytes;
    // B fragments of k-step s: bytes 4s, 4s+1 (b0) and 4s+2, 4s+3 (b1) of
    // lane t's 16 bytes of weight row wn0 + 8j + g, widened to bf16 pairs
    uint32_t b[kNT][4][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const uint4 raw = *reinterpret_cast<const uint4*>(wsm + (wn0 + 8 * j + g) * kWLd + 16 * t);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) widen4(words[s], b[j][s][0], b[j][s][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      // rows g and g + 8 of m-tile i: 16 bf16 at K offset 16t, as words
      // 0..7 (word v holds K offsets 16t + 2v, 16t + 2v + 1)
      const __nv_bfloat16* r0 = xs + (16 * i + g) * kXLd + 16 * t;
      const __nv_bfloat16* r1 = r0 + 8 * kXLd;
      const uint4 p0 = *reinterpret_cast<const uint4*>(r0);
      const uint4 p1 = *reinterpret_cast<const uint4*>(r0 + 8);
      const uint4 q0 = *reinterpret_cast<const uint4*>(r1);
      const uint4 q1 = *reinterpret_cast<const uint4*>(r1 + 8);
      const uint32_t lo[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const uint32_t hi[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t a[4] = {lo[2 * s], hi[2 * s], lo[2 * s + 1], hi[2 * s + 1]};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mmt::flash::mma::mma_bf16(acc[i][j], a, b[j][s][0], b[j][s][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulators: rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn0 + 8 * j + 2 * t + e;
      if (col >= N) continue;
      const float scale = w_s[col];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 16 * i + g + 8 * h;
          if (row >= M) continue;
          const float v = acc[i][j][2 * h + e];
          if (partial != nullptr) {
            partial[(size_t(blockIdx.z) * M + row) * N + col] = v;
          } else {
            out[size_t(row) * N + col] = __float2bfloat16_rn(__fmul_rn(v, scale));
          }
        }
      }
    }
  }
}

// out = (sum over splits, in order, of the float32 slices) * w_s, cast once.
template <typename T>
__global__ void wo_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ w_s,
                                 T* __restrict__ out, int M, int N, int splits) {
  const size_t total = size_t(M) * N;
  for (size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += size_t(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum = __fadd_rn(sum, partial[size_t(z) * total + idx]);
    out[idx] = mmt::from_float<T>(__fmul_rn(sum, w_s[idx % N]));
  }
}

// float32 activations on the CUDA cores.
constexpr int kFT = 64;   // rows and columns of a tile
constexpr int kFK = 32;   // K values a step
constexpr int kFLd = kFT + 4;

__global__ void __launch_bounds__(256)
wo_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ w_s, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float xs[kFK][kFLd];  // transposed: xs[k][row]
  __shared__ __align__(16) float wt[kFK][kFLd];  // wt[k][col]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kFT, n0 = blockIdx.y * kFT;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int v = threadIdx.x; v < kFT * kFK / 4; v += 256) {
      const int r = v / (kFK / 4), c = (v % (kFK / 4)) * 4;
      const float4 val = *reinterpret_cast<const float4*>(x + size_t(min(m0 + r, M - 1)) * K + k0 + c);
      xs[c][r] = val.x;
      xs[c + 1][r] = val.y;
      xs[c + 2][r] = val.z;
      xs[c + 3][r] = val.w;
    }
    if (threadIdx.x < kFT * kFK / 16) {
      const int r = threadIdx.x / (kFK / 16), c = (threadIdx.x % (kFK / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(w + size_t(min(n0 + r, N - 1)) * K + k0 + c);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int q = 0; q < 16; ++q) wt[c + q][r] = s8(words[q / 4], q % 4);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&wt[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col < N) out[size_t(row) * N + col] = __fmul_rn(acc[i][j], w_s[col]);
    }
  }
}

template <int MT>
int launch_bf16(const void* x, const void* w, const float* w_s, void* out, float* partial, int M,
                int K, int N, int splits, int chunks_per_split, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wo_bf16_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<MT>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + Tile<MT>::kBM - 1) / Tile<MT>::kBM, (N + kBN - 1) / kBN, splits);
  wo_bf16_kernel<MT><<<grid, kThreads, Tile<MT>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), w_s,
      static_cast<__nv_bfloat16*>(out), splits > 1 ? partial : nullptr, M, K, N,
      chunks_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) float32 (dtype 0) or bf16 (dtype 1), w (N, K) int8, w_s (N,)
// float -> out (M, N) in x's type. K must be a multiple of 64. bf16 splits
// K into `splits` slices of `chunks_per_split` 64-value chunks; with
// splits > 1, `partial` is float32 scratch of splits * M * N values. float32
// takes splits = 1.
extern "C" int mmt_wo_matmul(const void* x, const void* w, const void* w_s, void* out,
                             void* partial, int M, int K, int N, int splits, int chunks_per_split,
                             int dtype, void* stream) {
  const int chunks = K / kChunk;
  if (M < 1 || N < 1 || K < kChunk || K % kChunk != 0 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks ||
      (splits > 1 && partial == nullptr) || (dtype == 0 && splits != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ws = static_cast<const float*>(w_s);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) {
    const dim3 grid((M + kFT - 1) / kFT, (N + kFT - 1) / kFT);
    wo_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                       static_cast<const int8_t*>(w), ws,
                                       static_cast<float*>(out), M, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = M <= 16 ? launch_bf16<1>(x, w, ws, out, part, M, K, N, splits, chunks_per_split, s)
                          : launch_bf16<4>(x, w, ws, out, part, M, K, N, splits, chunks_per_split, s);
  if (err != 0 || splits == 1) return err;
  const size_t total = size_t(M) * N;
  const size_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  wo_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
      part, ws, static_cast<__nv_bfloat16*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}
