// K10: encoder attention over statically quantised int8 q, k, v, with both
// products on the int8 tensor cores.
//
// Replaces `_kernel_i8` in multimeditron_tpu/ops/encoder_attention.py (:170,
// via `encoder_attention_int8` :207). Per (image, head), with qk_scale =
// sq sk sm_scale and pv_scale = sv / 127:
//   s = f32(q8 . k8) * qk_scale, keys at or past kv_len masked,
//   p = exp(s - max_row(s)) (f32, natural exp), l = f32 sum of p,
//   pq = round_half_even(p * 127) as int8 (p <= 1, so pq lies in [0, 127]),
//   o = f32(pq . v8) * pv_scale / l (a true division), bf16 or float32.
// The row max is exact without an online softmax: qk_scale > 0 and rounding
// is monotone, so max(round(acc * qk_scale)) = round(max(acc) * qk_scale);
// a first pass takes each row's int32 maximum. `expf` is not XLA's `exp`, so
// a p code can land one apart from the reference's (o then moves by at most
// |v8| pv_scale / l <= sv per such key).
//
// What bounds it on the H100: operations. At the ViT-L/14 encode shape
// (256 images, S = 257, 16 heads of 64) the two products are 2 x 2 S^2 dh
// int8 operations per head, 0.14 TOPS in all (0.07 ms at 1,979 TOPS), the
// first pass half as many again, against 0.27 GB read and written (0.08 ms);
// the natural exp of every score runs on the SFU.
//
// The design follows K7g's attention (vit_int8_attention.cu): one block of 6
// warps per (head, image) stages the head's k8 rows in shared memory, each
// warp takes 16-query tiles and walks the keys 32 at a time on mma.sync
// m16n8k32. P.V is int8 as well, so p goes from the score accumulators to
// the A operand of the next mma.sync in registers. An int8 A fragment holds
// keys 4t .. 4t + 3 of its row where the score accumulator holds keys 2t,
// 2t + 1, 8 + 2t, 9 + 2t: instead of a shuffle, v is staged transposed
// (dh rows of keys, since 8-bit ldmatrix cannot transpose) with the keys of
// each 32-key chunk in that same order, so logical k 4t + i of the product
// is the physical key the accumulator gave this thread. Rows past kv_len are
// zero in shared memory.
#include "int8_mma.cuh"

namespace {

using namespace mmt::i8;

constexpr int kDh = 64;
constexpr int kWarps = 6;
constexpr int kThreads = kWarps * mmt::kWarpSize;
constexpr int kChunk = 32;  // keys per step: one k-step of m16n8k32

__host__ __device__ __forceinline__ int padded_keys(int kv_len) {
  return (kv_len + kChunk - 1) / kChunk * kChunk;
}

size_t shared_bytes(int kv_len) {
  const int rows = padded_keys(kv_len);
  return mmt::align16(size_t(rows) * kLd) + size_t(kDh) * (rows + 16);
}

// The physical key (within a 32-key chunk) at logical position L of the P.V
// product: the accumulator order of mma.m16n8k32's C fragment (see above).
__device__ __forceinline__ int key_at(int L) {
  const int r = L & 15, t = r >> 2, e = r & 3;
  return (L & 16) + 8 * (e >> 1) + 2 * t + (e & 1);
}

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return uint32_t(b0 & 0xff) | (uint32_t(b1 & 0xff) << 8) | (uint32_t(b2 & 0xff) << 16) |
         (uint32_t(b3 & 0xff) << 24);
}

template <typename TO>
__global__ void __launch_bounds__(kThreads)
encoder_attention_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                              const int8_t* __restrict__ v8, TO* __restrict__ o, int S, int H,
                              int kv_len, float qk_scale, float pv_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = padded_keys(kv_len);
  const int ld_vt = rows + 16;  // transposed v row stride (bytes): ldmatrix rows fall in 8 banks
  int8_t* ks = reinterpret_cast<int8_t*>(smem);
  int8_t* vt = reinterpret_cast<int8_t*>(smem + mmt::align16(size_t(rows) * kLd));
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * kDh;
  const size_t base = size_t(b) * S * D + size_t(h) * kDh;

  stage_keys<kThreads>(ks, k8 + base, rows, kv_len, D);
  // vt[d][L] = v8[key_at(L)][d], four keys a thread at a time (neighbouring
  // threads read neighbouring d of one key)
  for (int e = threadIdx.x; e < kDh * (rows / 4); e += kThreads) {
    const int d = e % kDh, L = (e / kDh) * 4;
    int x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = (L & ~31) + key_at((L + i) & 31);
      x[i] = key < kv_len ? v8[base + size_t(key) * D + d] : 0;
    }
    *reinterpret_cast<uint32_t*>(vt + d * ld_vt + L) = pack4(x[0], x[1], x[2], x[3]);
  }
  __syncthreads();

  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int g = lane >> 2, t = lane & 3;
  for (int r0 = 16 * warp; r0 < S; r0 += 16 * kWarps) {
    const int ra = r0 + g, rb = r0 + g + 8;
    uint32_t qa[2][4];
    load_queries(qa, q8 + base, ra, rb, S, D, t);
    float m0, m1;  // pass 1: each row's maximum score
    row_max<kChunk>(m0, m1, qa, ks, rows, kv_len, qk_scale, lane);

    // pass 2: p, its int8 code, and P.V
    int acc[kDh / 8][4];
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    float l0 = 0.f, l1 = 0.f;
    for (int k0 = 0; k0 < rows; k0 += kChunk) {
      int sc[kChunk / 8][4];
      key_scores<kChunk>(sc, qa, ks, k0, lane);
      int pq[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const float s = __fmul_rn(static_cast<float>(sc[j][e]), qk_scale);
          const float p = key < kv_len ? expf(__fsub_rn(s, e < 2 ? m0 : m1)) : 0.f;
          pq[j][e] = static_cast<int>(rintf(__fmul_rn(p, 127.f)));
          if (e < 2) {
            l0 = __fadd_rn(l0, p);
          } else {
            l1 = __fadd_rn(l1, p);
          }
        }
      // A fragment: logical keys 4t .. 4t + 3 (and 16 + 4t ..) of rows g, g + 8
      const uint32_t pa_frag[4] = {pack4(pq[0][0], pq[0][1], pq[1][0], pq[1][1]),
                                   pack4(pq[0][2], pq[0][3], pq[1][2], pq[1][3]),
                                   pack4(pq[2][0], pq[2][1], pq[3][0], pq[3][1]),
                                   pack4(pq[2][2], pq[2][3], pq[3][2], pq[3][3])};
#pragma unroll
      for (int n = 0; n < kDh / 16; ++n) {
        uint32_t vb[4];
        ldmatrix_x4(vb, vt + (16 * n + (lane & 7) + ((lane >> 4) << 3)) * ld_vt + k0 +
                            ((lane >> 3) & 1) * 16);
        mma_s8(acc[2 * n], pa_frag, vb[0], vb[1]);
        mma_s8(acc[2 * n + 1], pa_frag, vb[2], vb[3]);
      }
    }
    l0 = l0 + __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 = l0 + __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 = l1 + __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 = l1 + __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (ra < S) {
        store2(o + base + size_t(ra) * D + d,
               __fdiv_rn(__fmul_rn(static_cast<float>(acc[j][0]), pv_scale), l0),
               __fdiv_rn(__fmul_rn(static_cast<float>(acc[j][1]), pv_scale), l0));
      }
      if (rb < S) {
        store2(o + base + size_t(rb) * D + d,
               __fdiv_rn(__fmul_rn(static_cast<float>(acc[j][2]), pv_scale), l1),
               __fdiv_rn(__fmul_rn(static_cast<float>(acc[j][3]), pv_scale), l1));
      }
    }
  }
}

template <typename TO>
int launch(const void* q8, const void* k8, const void* v8, void* o, int B, int S, int H,
           int kv_len, float qk_scale, float pv_scale, cudaStream_t stream) {
  const size_t smem = shared_bytes(kv_len);
  auto kernel = encoder_attention_int8_kernel<TO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<TO*>(o), S, H, kv_len, qk_scale, pv_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q8, k8, v8 (B, S, H * 64) int8 -> o (B, S, H * 64): out_code 0 float32,
// 1 bf16. Keys at or past kv_len are masked.
extern "C" int mmt_encoder_attention_int8(const void* q8, const void* k8, const void* v8, void* o,
                                          int B, int S, int H, int dh, int kv_len,
                                          float qk_scale, float pv_scale, int out_code,
                                          void* stream) {
  if (dh != kDh || B < 1 || kv_len < 1 || kv_len > S) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case 0:
      return launch<float>(q8, k8, v8, o, B, S, H, kv_len, qk_scale, pv_scale, st);
    case 1:
      return launch<__nv_bfloat16>(q8, k8, v8, o, B, S, H, kv_len, qk_scale, pv_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
