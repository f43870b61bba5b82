// K7g, attention half: int8 QK^T with a static stabiliser, bf16 P.V, int8
// output. vit_int8_gemm.cu's QKV projection feeds it.
//
// Replaces the attention of `_qkv_attn_kernel` in
// multimeditron_tpu/ops/vit_int8_fused.py (:217, via `qkv_attn_int8` :767)
// in the configuration `vit_forward_int8_fused` runs by default ((L, 8)
// calibration: static_smax, fuse_l, int8_o):
//   s = f32(q8 . k8) * a - shift,  a = sq sk sm_scale log2(e), shift = smax log2(e)
//   p = bf16(exp2(s)) (0 for keys at or past kv_len)
//   l = sum of the bf16-rounded p (the Pallas kernel's ones column), floored at 1e-30
//   o8 = quant((p . v in f32) * (1 / bf16(l)), 1 / s1)
// The reciprocal of bf16(l) is what `pl.reciprocal(approx=True)` computes in
// the Pallas kernel's interpret mode, which the CPU parity tests run. A row
// whose true maximum sits far below the calibrated shift underflows to all
// zero p and comes out 0 through the floor, not NaN.
//
// Why two kernels: the Pallas kernel keeps q, k, v in VMEM for G images at a
// time. On the H100 one block per (image, head) would have to keep a
// 257 x 1024 int8 activation and three 64 x 1024 weight slices for a
// projection of 257 x 192 outputs, more than a block's shared memory, or
// re-read the activation 48 times. The projection is instead one tiled GEMM
// over all rows (vit_int8_gemm.cu), and q8, k8 (int8) and v (bf16) make one
// round trip through device memory: 4 bytes per element, 0.54 GB at the
// ViT-L/14 encode shape (0.16 ms), against the 0.21 ms the projection's
// operations take at the int8 peak.
//
// What bounds this half on the H100: operations. Per (image, head) the
// scores are 2 S^2 dh int8 and P.V 2 S^2 dh bf16 operations (S = 257,
// dh = 64), 0.07 GFLOP per image; exp2 over S^2 values per head runs on the
// SFU. The design: one block of 6 warps per (head, image) stages the head's
// k8 and v rows in shared memory once (rows past kv_len zeroed, so 0 * v is
// never 0 * garbage); each warp takes 16-query tiles (17 of them at S = 257,
// at most 3 per warp) and walks the keys 32 at a time: int8 scores on
// mma.sync m16n8k32, p rounded to bf16 in registers and reused as the A
// operand of mma.sync m16n8k16 (FlashAttention-2's register reuse), v
// through ldmatrix.trans. The static stabiliser needs no running max and no
// rescaling. The (S, S) scores never leave registers.
#include "flash.cuh"
#include "int8_mma.cuh"

namespace {

using mmt::flash::mma::accum_to_a;
using mmt::flash::mma::load_b_kn;
using mmt::flash::mma::mma_bf16;
using mmt::flash::mma::quad_sum;

constexpr int kDh = 64;
constexpr int kWarps = 6;
constexpr int kThreads = kWarps * mmt::kWarpSize;
constexpr int kChunk = 32;                 // keys per step
constexpr int kLdK = mmt::i8::kLd;         // int8 key row stride (bytes), as int8_mma.cuh
constexpr int kLdV = mmt::flash::mma::Dims<kDh>::kLd;  // bf16 value row stride (elements)

size_t shared_bytes(int kv_len) {
  const size_t rows = (kv_len + kChunk - 1) / kChunk * kChunk;
  return mmt::align16(rows * kLdK) + rows * kLdV * sizeof(__nv_bfloat16);
}

__global__ void __launch_bounds__(kThreads)
int8_attention_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                      const __nv_bfloat16* __restrict__ v, int8_t* __restrict__ o, int S, int H,
                      int kv_len, float a, float shift, float inv_s1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = (kv_len + kChunk - 1) / kChunk * kChunk;
  int8_t* ks = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + mmt::align16(size_t(rows) * kLdK));
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * kDh;
  const size_t base = size_t(b) * S * D + size_t(h) * kDh;

  for (int e = threadIdx.x; e < rows * (kDh / 16); e += kThreads) {
    const int r = e / (kDh / 16), c = (e % (kDh / 16)) * 16;
    const uint4 val = r < kv_len ? *reinterpret_cast<const uint4*>(k8 + base + size_t(r) * D + c)
                                 : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(ks + r * kLdK + c) = val;
  }
  for (int e = threadIdx.x; e < rows * (kDh / 8); e += kThreads) {
    const int r = e / (kDh / 8), c = (e % (kDh / 8)) * 8;
    const uint4 val = r < kv_len ? *reinterpret_cast<const uint4*>(v + base + size_t(r) * D + c)
                                 : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(vs + r * kLdV + c) = val;
  }
  __syncthreads();

  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int g = lane >> 2, t = lane & 3;
  for (int r0 = 16 * warp; r0 < S; r0 += 16 * kWarps) {
    // q fragments straight from device memory; rows past S repeat row S - 1
    const int ra = r0 + g, rb = r0 + g + 8;
    const int8_t* pa = q8 + base + size_t(min(ra, S - 1)) * D + 4 * t;
    const int8_t* pb = q8 + base + size_t(min(rb, S - 1)) * D + 4 * t;
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(pa + 32 * kk);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(pb + 32 * kk);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(pa + 32 * kk + 16);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(pb + 32 * kk + 16);
    }
    float acc[kDh / 8][4];
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float l0 = 0.f, l1 = 0.f;

    for (int k0 = 0; k0 < rows; k0 += kChunk) {
      int sc[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0;
#pragma unroll
      for (int j = 0; j < kChunk / 8; j += 2)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t kb[4];
          mmt::i8::load_b2(kb, ks, k0 + 8 * j, 32 * kk, lane);
          mmt::i8::mma_s8(sc[j], qa[kk], kb[0], kb[1]);
          mmt::i8::mma_s8(sc[j + 1], qa[kk], kb[2], kb[3]);
        }
      float p[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const float s = fmaf(static_cast<float>(sc[j][e]), a, -shift);
          p[j][e] = key < kv_len ? mmt::i8::bf16_round(exp2f(s)) : 0.f;
          if (e < 2) {
            l0 = __fadd_rn(l0, p[j][e]);
          } else {
            l1 = __fadd_rn(l1, p[j][e]);
          }
        }
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t pa_frag[4];
        accum_to_a(pa_frag, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < kDh / 16; ++n) {
          uint32_t vb[4];
          load_b_kn<kDh>(vb, vs, k0 + 16 * kk, 16 * n, lane);
          mma_bf16(acc[2 * n], pa_frag, vb[0], vb[1]);
          mma_bf16(acc[2 * n + 1], pa_frag, vb[2], vb[3]);
        }
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = __fdiv_rn(1.f, mmt::i8::bf16_round(fmaxf(l0, 1e-30f)));
    const float inv1 = __fdiv_rn(1.f, mmt::i8::bf16_round(fmaxf(l1, 1e-30f)));
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (ra < S) {
        char2 q;
        q.x = mmt::i8::quant(__fmul_rn(acc[j][0], inv0), inv_s1);
        q.y = mmt::i8::quant(__fmul_rn(acc[j][1], inv0), inv_s1);
        *reinterpret_cast<char2*>(o + base + size_t(ra) * D + d) = q;
      }
      if (rb < S) {
        char2 q;
        q.x = mmt::i8::quant(__fmul_rn(acc[j][2], inv1), inv_s1);
        q.y = mmt::i8::quant(__fmul_rn(acc[j][3], inv1), inv_s1);
        *reinterpret_cast<char2*>(o + base + size_t(rb) * D + d) = q;
      }
    }
  }
}

}  // namespace

// q8, k8 (B, S, H * 64) int8, v (B, S, H * 64) bf16 -> o (B, S, H * 64) int8.
// a, shift and inv_s1 as in the header; keys at or past kv_len are masked.
extern "C" int mmt_int8_attention(const void* q8, const void* k8, const void* v, void* o, int B,
                                  int S, int H, int dh, int kv_len, float a, float shift,
                                  float inv_s1, void* stream) {
  if (dh != kDh || B < 1 || kv_len < 1 || kv_len > S) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(kv_len);
  cudaError_t err = cudaFuncSetAttribute(int8_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_attention_kernel<<<dim3(H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const __nv_bfloat16*>(v), static_cast<int8_t*>(o), S, H, kv_len, a, shift,
      inv_s1);
  return static_cast<int>(cudaGetLastError());
}
