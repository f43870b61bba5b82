// K7g, attention half: int8 QK^T, bf16 P.V, in the three consume paths of
// the Pallas kernel. vit_int8_gemm.cu's QKV projection feeds it.
//
// Replaces the attention of `_qkv_attn_kernel` in
// multimeditron_tpu/ops/vit_int8_fused.py (:217, via `qkv_attn_int8` :767),
// with a = sq sk sm_scale log2(e) and keys at or past kv_len masked:
//
// - kFused, the `fuse_l` path ((L, 8) calibration: static_smax; :390-415),
//   shift = smax log2(e):
//     s = f32(q8 . k8) * a - shift (one fmaf), p = bf16(exp2(s)),
//     l = sum of the bf16-rounded p (the Pallas kernel's ones column);
// - kStatic, static_smax without fuse_l (:446-469, m = sc[3]):
//     s = f32(q8 . k8) * a, p = exp2(s - shift), l = f32 sum of p;
// - kRowMax, the (L, 7) calibration (static_smax=False, :446-469):
//     s as kStatic, p = exp2(s - max_row(s)), l = f32 sum of p;
//
// then o = (bf16(p) . v in f32) * (1 / bf16(max(l, 1e-30))), written as
// float32 or bf16, or (kFused only, `int8_o`) quantised by 1 / s1 to int8.
// The reciprocal of bf16(l) is what `pl.reciprocal(approx=True)` computes in
// the Pallas kernel's interpret mode, which the CPU parity tests run. A row
// whose true maximum sits far below a static shift underflows to all zero p
// and comes out 0 through the floor, not NaN. The path is a template
// parameter: no branch per element.
//
// The row max needs no online softmax (int8_mma.cuh `row_max`): a first
// pass of int8 scores takes each row's int32 maximum, exact after the scale
// because rounding is monotone; the second pass is kStatic's with that
// row's stabiliser, the same p as the reference's, bit for bit.
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
// through ldmatrix.trans. The stabiliser is known before the second pass, so
// nothing is rescaled. The (S, S) scores never leave registers.
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

enum Mode { kFused = 0, kStatic = 1, kRowMax = 2 };

template <int kMode, typename TO>
__global__ void __launch_bounds__(kThreads)
int8_attention_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                      const __nv_bfloat16* __restrict__ v, TO* __restrict__ o, int S, int H,
                      int kv_len, float a, float shift, float inv_s1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = (kv_len + kChunk - 1) / kChunk * kChunk;
  int8_t* ks = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + mmt::align16(size_t(rows) * kLdK));
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * kDh;
  const size_t base = size_t(b) * S * D + size_t(h) * kDh;

  mmt::i8::stage_keys<kThreads>(ks, k8 + base, rows, kv_len, D);
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
    const int ra = r0 + g, rb = r0 + g + 8;
    uint32_t qa[2][4];
    mmt::i8::load_queries(qa, q8 + base, ra, rb, S, D, t);
    // the stabiliser of rows ra (m0) and rb (m1)
    float m0 = shift, m1 = shift;
    if constexpr (kMode == kRowMax) {
      mmt::i8::row_max<kChunk>(m0, m1, qa, ks, rows, kv_len, a, lane);
    }
    float acc[kDh / 8][4];
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float l0 = 0.f, l1 = 0.f;

    for (int k0 = 0; k0 < rows; k0 += kChunk) {
      int sc[kChunk / 8][4];
      mmt::i8::key_scores<kChunk>(sc, qa, ks, k0, lane);
      float p[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const float sf = static_cast<float>(sc[j][e]);
          float pe;
          if constexpr (kMode == kFused) {
            pe = mmt::i8::bf16_round(exp2f(fmaf(sf, a, -shift)));
          } else {
            pe = exp2f(__fsub_rn(__fmul_rn(sf, a), e < 2 ? m0 : m1));
          }
          p[j][e] = key < kv_len ? pe : 0.f;
          if (e < 2) {
            l0 = __fadd_rn(l0, p[j][e]);
          } else {
            l1 = __fadd_rn(l1, p[j][e]);
          }
        }
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t pa_frag[4];
        accum_to_a(pa_frag, p[2 * kk], p[2 * kk + 1]);  // bf16(p), round to nearest
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
        mmt::i8::store2(o + base + size_t(ra) * D + d, __fmul_rn(acc[j][0], inv0),
               __fmul_rn(acc[j][1], inv0), inv_s1);
      }
      if (rb < S) {
        mmt::i8::store2(o + base + size_t(rb) * D + d, __fmul_rn(acc[j][2], inv1),
               __fmul_rn(acc[j][3], inv1), inv_s1);
      }
    }
  }
}

template <int kMode, typename TO>
int launch(const void* q8, const void* k8, const void* v, void* o, int B, int S, int H,
           int kv_len, float a, float shift, float inv_s1, cudaStream_t stream) {
  const size_t smem = shared_bytes(kv_len);
  auto kernel = int8_attention_kernel<kMode, TO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const __nv_bfloat16*>(v), static_cast<TO*>(o), S, H, kv_len, a, shift, inv_s1);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_out(int out_code, const void* q8, const void* k8, const void* v, void* o, int B, int S,
               int H, int kv_len, float a, float shift, float inv_s1, cudaStream_t stream) {
  switch (out_code) {
    case 0:
      return launch<kMode, float>(q8, k8, v, o, B, S, H, kv_len, a, shift, inv_s1, stream);
    case 1:
      return launch<kMode, __nv_bfloat16>(q8, k8, v, o, B, S, H, kv_len, a, shift, inv_s1,
                                          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q8, k8 (B, S, H * 64) int8, v (B, S, H * 64) bf16 -> o (B, S, H * 64).
// mode: 0 kFused, 1 kStatic, 2 kRowMax; out_code: 0 float32, 1 bf16, 2 int8
// (kFused only). a, shift and inv_s1 as in the header (shift unused by
// kRowMax, inv_s1 by float outputs); keys at or past kv_len are masked.
extern "C" int mmt_int8_attention(const void* q8, const void* k8, const void* v, void* o, int B,
                                  int S, int H, int dh, int kv_len, float a, float shift,
                                  float inv_s1, int mode, int out_code, void* stream) {
  if (dh != kDh || B < 1 || kv_len < 1 || kv_len > S) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFused:
      if (out_code == 2) {
        return launch<kFused, int8_t>(q8, k8, v, o, B, S, H, kv_len, a, shift, inv_s1, st);
      }
      return launch_out<kFused>(out_code, q8, k8, v, o, B, S, H, kv_len, a, shift, inv_s1, st);
    case kStatic:
      return launch_out<kStatic>(out_code, q8, k8, v, o, B, S, H, kv_len, a, shift, inv_s1, st);
    case kRowMax:
      return launch_out<kRowMax>(out_code, q8, k8, v, o, B, S, H, kv_len, a, shift, inv_s1, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
