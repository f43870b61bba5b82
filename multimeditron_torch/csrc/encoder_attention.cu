// K3: non-causal encoder attention for the ViT towers, in model layout.
//
// Replaces the Pallas kernel `_kernel` of multimeditron_tpu/ops/encoder_attention.py
// (reached through `encoder_attention`): softmax(Q K^T * scale) V per head,
// with q, k, v and o all in the projections' (B, S, H*Dh) layout and keys at
// positions >= kv_len masked out. Query rows >= kv_len are computed with the
// same mask; the caller drops them.
//
// What bounds it on the H100: CLIP ViT-L/14 has S = 257, Dh = 64, H = 16.
// One head's K and V are 2 x 257 x 64 values (66 KB in bf16), and every query
// row reads all of them, so the kernel is bound by how often K/V are read,
// not by device memory: 2*S*S*Dh*2 FLOPs per (image, head) against 4*S*Dh*2
// bytes of q/k/v/o traffic.
//
// The design: one block of 8 warps per (query tile of 64 rows, head,
// image). The block copies the head's K and V (rows < kv_len) into shared
// memory once, with a padded row stride so that 32 lanes reading 32
// different key rows at the same column hit 32 different banks. Each warp
// then takes two query rows at a time: lane j scores keys j, j+32, ...
// against both rows (each K value read from shared memory serves two rows,
// two columns per bf16 load), the warp reduces max and sum for an exact
// softmax in float, and lane d accumulates output columns d, d+1 over all
// keys for both rows. S = 257 is not a multiple of any tile: the last query
// tile is ragged and masked by a bound check, and the caller's tensors are
// never padded. The (S, S) scores never leave the SM. A first version with
// one row per warp and one column per load ran 0.51 ms for the ViT-L/14
// encode batch in bf16, slower than the plain PyTorch twin (0.37 ms).
// Tensor cores (mma/wgmma) and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / mmt::kWarpSize;
constexpr int kQueryTile = 64;
constexpr int kRows = 2;  // query rows a warp scores together
constexpr int kCopyBatch = 8;  // loads in flight per thread while staging K/V

// Row stride (in elements) of K/V in shared memory: an odd number of 32-bit
// words, so that lanes reading the same column of consecutive rows fall in
// different banks.
template <typename T>
__host__ __device__ int padded_row(int dh) {
  int ld = dh;
  while ((ld * static_cast<int>(sizeof(T))) % 4 != 0 ||
         ((ld * static_cast<int>(sizeof(T))) / 4) % 2 == 0) {
    ++ld;
  }
  return ld;
}

template <typename T>
size_t shared_bytes(int kv_len, int dh) {
  const size_t kv = mmt::align16(2 * size_t(kv_len) * padded_row<T>(dh) * sizeof(T));
  return kv + kWarps * kRows * (size_t(dh) + size_t(kv_len)) * sizeof(float);
}

// Two consecutive values (an even offset) as floats: one 4-byte shared load
// for bf16 (rows have an even stride), two for float.
__device__ __forceinline__ float2 load_pair(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         int S, int H, int dh, int kv_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = padded_row<T>(dh);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + size_t(kv_len) * ld;
  float* qs = reinterpret_cast<float*>(smem + mmt::align16(2 * size_t(kv_len) * ld * sizeof(T)));
  float* ps = qs + kWarps * kRows * dh;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const size_t row = size_t(H) * dh;  // elements per token in (B, S, H*Dh)
  const size_t head0 = size_t(b) * S * row + size_t(h) * dh;

  // Each thread issues a batch of loads before storing any, so they overlap.
  const int n = kv_len * dh;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kCopyBatch) {
    T kr[kCopyBatch], vr[kCopyBatch];
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx < n) {
        const size_t src = head0 + (idx / dh) * row + idx % dh;
        kr[u] = k[src];
        vr[u] = v[src];
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx < n) {
        ks[(idx / dh) * ld + idx % dh] = kr[u];
        vs[(idx / dh) * ld + idx % dh] = vr[u];
      }
    }
  }
  __syncthreads();

  // Each warp takes kRows query rows at a time, so every K and V value read
  // from shared memory serves kRows rows. A second row past S (the ragged
  // last tile) repeats the first and is not written.
  float* q0 = qs + warp * kRows * dh;
  float* q1 = q0 + dh;
  float* p0 = ps + size_t(warp) * kRows * kv_len;
  float* p1 = p0 + kv_len;
  for (int r = warp * kRows; r < kQueryTile; r += kWarps * kRows) {
    const int qi0 = tile * kQueryTile + r;
    if (qi0 >= S) break;
    const int qi1 = qi0 + 1 < S ? qi0 + 1 : qi0;
    for (int d = lane; d < dh; d += mmt::kWarpSize) {
      q0[d] = mmt::to_float(q[head0 + qi0 * row + d]);
      q1[d] = mmt::to_float(q[head0 + qi1 * row + d]);
    }
    __syncwarp();

    float m0 = -INFINITY, m1 = -INFINITY;
    for (int j = lane; j < kv_len; j += mmt::kWarpSize) {
      const T* kj = ks + j * ld;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < dh; d += 2) {
        const float2 kk = load_pair(kj + d);
        const float2 a = *reinterpret_cast<const float2*>(q0 + d);
        const float2 c = *reinterpret_cast<const float2*>(q1 + d);
        s0 = fmaf(a.y, kk.y, fmaf(a.x, kk.x, s0));
        s1 = fmaf(c.y, kk.y, fmaf(c.x, kk.x, s1));
      }
      s0 *= scale;
      s1 *= scale;
      p0[j] = s0;
      p1[j] = s1;
      m0 = fmaxf(m0, s0);
      m1 = fmaxf(m1, s1);
    }
    m0 = mmt::warp_max(m0);
    m1 = mmt::warp_max(m1);
    float l0 = 0.f, l1 = 0.f;
    for (int j = lane; j < kv_len; j += mmt::kWarpSize) {
      const float e0 = expf(p0[j] - m0), e1 = expf(p1[j] - m1);
      p0[j] = e0;
      p1[j] = e1;
      l0 += e0;
      l1 += e1;
    }
    l0 = mmt::warp_sum(l0);
    l1 = mmt::warp_sum(l1);
    __syncwarp();

    // Lane owns column pairs (d, d+1): one shared load of V per key feeds
    // four accumulators.
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    for (int d = 2 * lane; d < dh; d += 2 * mmt::kWarpSize) {
      float a0x = 0.f, a0y = 0.f, a1x = 0.f, a1y = 0.f;
      for (int j = 0; j < kv_len; ++j) {
        const float2 vv = load_pair(vs + j * ld + d);
        const float w0 = p0[j], w1 = p1[j];
        a0x = fmaf(w0, vv.x, a0x);
        a0y = fmaf(w0, vv.y, a0y);
        a1x = fmaf(w1, vv.x, a1x);
        a1y = fmaf(w1, vv.y, a1y);
      }
      T* o0 = o + head0 + qi0 * row + d;
      o0[0] = mmt::from_float<T>(a0x * inv0);
      o0[1] = mmt::from_float<T>(a0y * inv0);
      if (qi1 != qi0) {
        T* o1 = o + head0 + qi1 * row + d;
        o1[0] = mmt::from_float<T>(a1x * inv1);
        o1[1] = mmt::from_float<T>(a1y * inv1);
      }
    }
    __syncwarp();  // q0 / q1 / p0 / p1 are rewritten by the next rows
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int dh, int kv_len, float scale, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(kv_len, dh);
  cudaError_t err = cudaFuncSetAttribute(encoder_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kQueryTile - 1) / kQueryTile, H, B);
  encoder_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, dh, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmt_encoder_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int H, int dh, int kv_len, float scale,
                                     int dtype, void* stream) {
  if (dh % 2 != 0 || kv_len < 1 || kv_len > S) return static_cast<int>(cudaErrorInvalidValue);
  MMT_DISPATCH_DTYPE(dtype, return launch<scalar_t>(q, k, v, o, B, S, H, dh, kv_len, scale,
                                                     static_cast<cudaStream_t>(stream)));
}

extern "C" const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
