// The serving engine's sampler in one pass: JAX's Threefry-2x32 bits,
// Gumbel noise, temperature and both argmaxes, one int32 token a row.
//
// Replaces no TPU kernel: the JAX engine leaves `jax.random.categorical` to
// XLA, which fuses it. The port's eager twin (`serve/prng.py`, composed in
// `ops/sampling.py` `sample_plain`) runs it as ~150 int64 elementwise passes
// over rows x vocab; this kernel keeps every intermediate in registers and
// writes nothing of rows x vocab.
//
// For row r, column c, with logit x (bf16 or f32, read once) and temperature
// t (the fused form; the plain form takes the logits as already scaled):
//   greedy  = argmax_c x
//   scaled  = x / max(t, 1e-6)                       (IEEE division)
//   bits    = o1 ^ o2, (o1, o2) = threefry2x32(key, (0, counter))
//   u       = max(float(bits >> 9 | 0x3F800000) - 1, tiny)   (uniform on [tiny, 1))
//   sampled = argmax_c (-log(-log(u)) + scaled)
//   token   = t > 1e-6 ? sampled : greedy
// The counter is the element's flat index over the rows x vocab tensor under
// one key, or its column under one key a row (JAX's vmap over fold_in keys).
// Every step rounds as the eager chain on the card does, so the tokens are
// its tokens bit for bit: accurate logf, __fdiv_rn, and __fmul_rn / __fadd_rn
// where nvcc's default --fmad=true could contract a multiply and an add.
// Argmax order is torch.argmax's: NaN above every number, then the larger
// value, ties to the first index.
//
// What bounds it on the H100: integer operations, not bytes. The hash costs
// ~75 uint32 operations an element (20 rounds of add, rotate, xor; five key
// injections); 128 x 98,304 bf16 logits are 25 MB (~8 us at 3.35 TB/s) and
// ~0.93 G operations (~56 us at 64 INT32 lanes a cycle on 132 SMs at 1.98 GHz).
//
// Design: every block takes kChunk = 2,048 columns of one row, 8 a thread
// (one 16-byte load of bf16, two of f32, when the row is 16-byte aligned),
// so a step's rows x vocab fills the card in many short waves whatever the
// batch: 128 x 98,304 gives 6,144 blocks, 32 x 131,072 gives 2,048. A block
// keeps its (value, index) pairs, greedy and sampled, reduces them by warp
// shuffles and shared memory and writes one pair of each to a partial
// buffer; a second launch, one warp a row, reduces a row's partials and
// writes its token. Nothing persists between calls, so a CUDA graph replays
// both launches as they are. A row at t <= 1e-6 (greedy) skips the hash.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // columns a block takes
constexpr float kTiny = 1.17549435e-38f;       // float32's smallest normal: JAX's minval
constexpr float kMinTemp = 1e-6f;

// threefry2x32 of the counter (0, lo) under (k1, k2), the two words XORed:
// JAX's partitionable random_bits for one element.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2, uint32_t lo) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  uint32_t x1 = k1, x2 = lo + k2;
#define MMT_ROUND(r) \
  x1 += x2;          \
  x2 = __funnelshift_l(x2, x2, r) ^ x1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      MMT_ROUND(13) MMT_ROUND(15) MMT_ROUND(26) MMT_ROUND(6)
    } else {
      MMT_ROUND(17) MMT_ROUND(29) MMT_ROUND(16) MMT_ROUND(24)
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
#undef MMT_ROUND
  return x1 ^ x2;
}

// -log(-log(u)), u uniform on [tiny, 1) from the bits, as jax.random.gumbel
// computes it in float32: minval + u * (maxval - minval), and maxval - minval
// is 1 in float32.
__device__ __forceinline__ float gumbel_noise(uint32_t bits) {
  float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  u = __fadd_rn(__fmul_rn(u, 1.0f), kTiny);
  u = u < kTiny ? kTiny : u;
  return -logf(-logf(u));
}

// Does (a, ia) come before (b, ib) in torch.argmax's order?
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a > b || (a == b && ia < ib);
}

struct Best {
  float v;
  int i;
  __device__ __forceinline__ void take(float w, int j) {
    if (better(w, j, v, i)) v = w, i = j;
  }
  __device__ __forceinline__ void warp_reduce() {
#pragma unroll
    for (int o = mmt::kWarpSize / 2; o > 0; o >>= 1)
      take(__shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
  }
};

__device__ __forceinline__ Best empty_best() { return Best{-INFINITY, INT_MAX}; }

template <typename T, bool kVec>
__device__ __forceinline__ void load8(const T* __restrict__ row, int c0, int V, float (&x)[kPerThread]) {
  if constexpr (kVec) {
    // the row and c0 are 16-byte aligned and c0 + 8 <= V
    const uint4* p = reinterpret_cast<const uint4*>(row + c0);
    if constexpr (sizeof(T) == 2) {
      const uint4 w = __ldg(p);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) x[k] = __bfloat162float(h[k]);
    } else {
      const uint4 w0 = __ldg(p), w1 = __ldg(p + 1);
      const float* f0 = reinterpret_cast<const float*>(&w0);
      const float* f1 = reinterpret_cast<const float*>(&w1);
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = f0[k], x[k + 4] = f1[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      x[k] = c0 + k < V ? mmt::to_float(row[c0 + k]) : -INFINITY;
  }
}

// One block: columns [split * kChunk, +kChunk) of one row. partial holds, per
// (row, split), the greedy and the sampled pair: (value bits, index) each.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gumbel_argmax_kernel(const T* __restrict__ logits, const float* __restrict__ temps,
                     const int64_t* __restrict__ key, int key_stride, uint32_t k1,
                     uint32_t k2, int* __restrict__ partial, int V, int splits) {
  const int row = blockIdx.x / splits, split = blockIdx.x % splits;
  const T* x_row = logits + static_cast<size_t>(row) * V;
  // a row samples where t > 1e-6 (not at NaN), and there clamp(t, 1e-6) is t
  const float t = temps != nullptr ? temps[row] : 1.0f;
  const bool sample = temps == nullptr || t > kMinTemp;
  if (key != nullptr) {
    const int64_t* k = key + static_cast<size_t>(row) * key_stride;
    k1 = static_cast<uint32_t>(k[0]);
    k2 = static_cast<uint32_t>(k[1]);
  }
  // the flat counter under one key, the column under one key a row
  const uint32_t base = key_stride == 0 ? static_cast<uint32_t>(row) * static_cast<uint32_t>(V) : 0u;

  const int c0 = split * kChunk + threadIdx.x * kPerThread;
  Best greedy = empty_best(), sampled = empty_best();
  if (c0 < V) {
    float x[kPerThread];
    load8<T, kVec>(x_row, c0, V, x);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int c = c0 + k;
      if (!kVec && c >= V) break;
      greedy.take(x[k], c);
      if (sample) {
        const float scaled = temps != nullptr ? __fdiv_rn(x[k], t) : x[k];
        const float noise = gumbel_noise(threefry_bits(k1, k2, base + static_cast<uint32_t>(c)));
        sampled.take(__fadd_rn(noise, scaled), c);
      }
    }
  }
  greedy.warp_reduce();
  sampled.warp_reduce();
  __shared__ Best warp_best[2][kThreads / mmt::kWarpSize];
  const int lane = threadIdx.x % mmt::kWarpSize, warp = threadIdx.x / mmt::kWarpSize;
  if (lane == 0) warp_best[0][warp] = greedy, warp_best[1][warp] = sampled;
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kThreads / mmt::kWarpSize;
    Best g = lane < kWarps ? warp_best[0][lane] : empty_best();
    Best s = lane < kWarps ? warp_best[1][lane] : empty_best();
    g.warp_reduce();
    s.warp_reduce();
    if (lane == 0) {
      int* out = partial + static_cast<size_t>(blockIdx.x) * 4;
      out[0] = __float_as_int(g.v), out[1] = g.i, out[2] = __float_as_int(s.v), out[3] = s.i;
    }
  }
}

// One warp a row: the row's splits reduced, the token chosen.
__global__ void __launch_bounds__(mmt::kWarpSize)
gumbel_argmax_reduce_kernel(const int* __restrict__ partial, const float* __restrict__ temps,
                            int* __restrict__ tokens, int splits) {
  const int row = blockIdx.x, lane = threadIdx.x;
  Best g = empty_best(), s = empty_best();
  for (int j = lane; j < splits; j += mmt::kWarpSize) {
    const int* p = partial + (static_cast<size_t>(row) * splits + j) * 4;
    g.take(__int_as_float(p[0]), p[1]);
    s.take(__int_as_float(p[2]), p[3]);
  }
  g.warp_reduce();
  s.warp_reduce();
  if (lane == 0) tokens[row] = temps == nullptr || temps[row] > kMinTemp ? s.i : g.i;
}

template <typename T>
int launch(const void* logits, const float* temps, const int64_t* key, int key_stride,
           uint32_t k1, uint32_t k2, int* partial, int* tokens, int rows, int V, bool vec,
           cudaStream_t stream) {
  const int splits = (V + kChunk - 1) / kChunk;
  const dim3 grid(rows * splits);
  const T* x = static_cast<const T*>(logits);
  if (vec)
    gumbel_argmax_kernel<T, true><<<grid, kThreads, 0, stream>>>(x, temps, key, key_stride, k1,
                                                                  k2, partial, V, splits);
  else
    gumbel_argmax_kernel<T, false><<<grid, kThreads, 0, stream>>>(x, temps, key, key_stride, k1,
                                                                   k2, partial, V, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gumbel_argmax_reduce_kernel<<<rows, mmt::kWarpSize, 0, stream>>>(partial, temps, tokens, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits (rows, V) row-major; temps (rows,) float32, or NULL for the plain
// form (the logits already scaled: no greedy, no temperature); key: NULL for
// the host key (k1, k2), else int64 words on the device, one key (key_stride
// 0) or one a row (key_stride 2); partial: int32 scratch of rows * splits * 4,
// splits = ceil(V / 2048), which the caller states; tokens (rows,) int32.
extern "C" int mmt_gumbel_argmax(const void* logits, const void* temps, const void* key,
                                 int key_stride, int k1, int k2, void* partial, void* tokens,
                                 int rows, int V, int splits, int dtype, void* stream) {
  if (rows < 1 || V < 1 || splits != (V + kChunk - 1) / kChunk ||
      static_cast<long long>(rows) * splits > 0x7fffffffLL ||
      (key_stride != 0 && key_stride != 2) || (key == nullptr && key_stride != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = V % kPerThread == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  MMT_DISPATCH_DTYPE(dtype, return launch<scalar_t>(
                                logits, static_cast<const float*>(temps),
                                static_cast<const int64_t*>(key), key_stride,
                                static_cast<uint32_t>(k1), static_cast<uint32_t>(k2),
                                static_cast<int*>(partial), static_cast<int*>(tokens), rows, V,
                                vec, static_cast<cudaStream_t>(stream)));
}
