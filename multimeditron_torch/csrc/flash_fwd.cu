// K1: flash attention forward (training path and no-cache LLM attention).
//
// Replaces the Pallas kernel `_fwd_kernel` of
// multimeditron_tpu/ops/flash_attention.py (reached through `_fwd`):
// causal or full online-softmax attention with grouped-query heads, an
// optional kv padding mask and end-aligned causal offset. Scores live in the
// base-2 domain (scale * log2 e, exp2); it writes o and the base-2 logsumexp
// lse = m + log2(l) that the backward kernels (flash_bwd.cu) read, or
// kMaskValue and an all-zero output row for a query with no valid key.
//
// What bounds it on the H100: arithmetic. At the training shape (B=4, H=32,
// Hkv=8, S=4096, D=128, causal) a call is 0.55 TFLOP against 0.27 GB of
// q/k/v/o traffic. bf16 runs the two products on the tensor cores with
// mma.sync (ceiling 989 TFLOP/s; wgmma, TMA and warp specialisation, which
// reach it, are later work). float32 runs on the CUDA cores (ceiling 67
// TFLOP/s): TF32 would break the float32 tolerances.
//
// The design: one block per (64-query tile, head, batch row) keeps the query
// tile and walks the 64-key tiles in order, carrying the running max m, sum l
// and the 64 x D accumulator in registers. This takes the place of the TPU
// grid's sequential kv dimension and its VMEM scratch. Causal tiles past the
// diagonal are skipped by the loop bound, and query tiles run longest first.
// p is rounded to the input dtype before the PV product, as the Pallas kernel
// does. A row whose running max is still -inf (all keys so far masked) uses 0
// as its reference, so exp2 of a masked score is an exact 0 and no NaN
// appears. The float32 version computes a 4 x 4 block of scores per thread
// from 16-byte shared loads (16 loads per 64 FMAs) and stages p in shared
// memory; the bf16 version keeps p in registers (see flash_fwd_mma_kernel).
#include "flash.cuh"

namespace {

using namespace mmt::flash;

template <int D>
size_t fwd_shared_bytes() {
  return (3 * size_t(Dims<D>::kTileFloats) + kTile * kLdP) * sizeof(float) + kTile * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const int* __restrict__ kv_mask, float* __restrict__ o, float* __restrict__ lse,
                 int H, int Hkv, int Sq, int Skv, int causal, int offset, float scale_log2) {
  using Dm = Dims<D>;
  constexpr int kLd = Dm::kLd, kG = Dm::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + Dm::kTileFloats;
  float* vs = ks + Dm::kTileFloats;
  float* ps = vs + Dm::kTileFloats;
  int* kval = reinterpret_cast<int*>(ps + kTile * kLdP);

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int q0 = iq * kTile;
  const size_t qrow0 = (size_t(b) * H + h) * Sq;
  const float* kh = k + (size_t(b) * Hkv + hk) * Skv * D;
  const float* vh = v + (size_t(b) * Hkv + hk) * Skv * D;
  const int* mask_row = kv_mask == nullptr ? nullptr : kv_mask + size_t(b) * Skv;

  load_tile<D>(qs, q + qrow0 * D, q0, Sq);

  float acc[kRows][4 * kG];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = kv_tiles(min(q0 + kTile, Sq) - 1, Skv, causal, offset);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D>(ks, kh, k0, Skv);
    load_tile<D>(vs, vh, k0, Skv);
    load_key_valid(kval, mask_row, k0, Skv);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[kRows], kb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = load4(qs + (ty + kTY * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) kb[j] = load4(ks + (tx + kTX * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dot4(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long qpos = static_cast<long long>(q0 + ty + kTY * i) + offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = tx + kTX * j;
        const bool ok = kval[kj] && (!causal || qpos >= k0 + kj);
        s[i][j] = ok ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_ref);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = exp2f(s[i][j] - m_ref);
        sum += p;
        ps[(ty + kTY * i) * kLdP + tx + kTX * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = load4(ps + (ty + kTY * i) * kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vb[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) vb[g] = load4(vs + (j + jj) * kLd + 4 * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float w = lane(pa[i], jj);
#pragma unroll
          for (int g = 0; g < kG; ++g) axpy4(&acc[i][4 * g], w, vb[g]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kTY * i;
    if (qi >= Sq) continue;
    const bool any = l[i] > 0.f;
    const float inv = any ? 1.f / l[i] : 0.f;
    float* orow = o + (qrow0 + qi) * D;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float* a = &acc[i][4 * g];
      store4(orow + 4 * tx + 64 * g, make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv));
    }
    if (tx == 0) lse[qrow0 + qi] = any ? m[i] + log2f(l[i]) : kMaskValue;
  }
}

// bf16 forward on the tensor cores: 4 warps, each owning 16 of the tile's 64
// query rows. Q's A fragments stay in registers; S = Q K^T and O += P V are
// mma.sync m16n8k16 products with f32 accumulators, and P goes from the S
// accumulators straight into A fragments (rounded to bf16, as the Pallas
// kernel casts p) without a trip through shared memory.
template <int D>
size_t fwd_mma_shared_bytes() {
  return 3 * size_t(mma::Dims<D>::kTileElems) * sizeof(__nv_bfloat16) + kTile * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_mask,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Hkv,
                     int Sq, int Skv, int causal, int offset, float scale_log2) {
  using Dm = mma::Dims<D>;
  constexpr int kKS = Dm::kKSteps, kNT = Dm::kNTiles;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + Dm::kTileElems;
  __nv_bfloat16* vs = ks + Dm::kTileElems;
  int* kval = reinterpret_cast<int*>(vs + Dm::kTileElems);

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = iq * kTile;
  const size_t qrow0 = (size_t(b) * H + h) * Sq;
  const __nv_bfloat16* kh = k + (size_t(b) * Hkv + hk) * Skv * D;
  const __nv_bfloat16* vh = v + (size_t(b) * Hkv + hk) * Skv * D;
  const int* mask_row = kv_mask == nullptr ? nullptr : kv_mask + size_t(b) * Skv;

  mma::load_tile<D>(qs, q + qrow0 * D, q0, Sq);
  __syncthreads();
  uint32_t qa[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) mma::load_a<D>(qa[kk], qs, warp * 16, kk * 16, lane);

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  const int n_tiles = kv_tiles(min(q0 + kTile, Sq) - 1, Skv, causal, offset);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K and V are no longer read
    mma::load_tile<D>(ks, kh, k0, Skv);
    mma::load_tile<D>(vs, vh, k0, Skv);
    load_key_valid(kval, mask_row, k0, Skv);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        mma::load_b_nk<D>(kb, ks, np * 16, kk * 16, lane);
        mma::mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
        mma::mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * t4 + (e & 1);
        const long long qpos = static_cast<long long>(row0 + 8 * (e >> 1)) + offset;
        const bool ok = kval[kj] && (!causal || qpos >= k0 + kj);
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float m_ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mma::quad_max(mx[r]));
      m_ref[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_ref[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_ref[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + mma::quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys per k-step
      uint32_t pa[4];
      mma::accum_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        mma::load_b_kn<D>(vb, vs, kk * 16, dp * 16, lane);
        mma::mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma::mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const bool any = l[r] > 0.f;
    const float inv = any ? 1.f / l[r] : 0.f;
    __nv_bfloat16* orow = o + (qrow0 + qi) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          mma::pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t4 == 0) lse[qrow0 + qi] = any ? m[r] + log2f(l[r]) : kMaskValue;
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const int* kv_mask, void* o,
               float* lse, int B, int H, int Hkv, int Sq, int Skv, int causal, int offset,
               float sm_scale, cudaStream_t stream) {
  const size_t smem = fwd_mma_shared_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_fwd_mma_kernel<D><<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_mask, static_cast<__nv_bfloat16*>(o), lse, H, Hkv,
      Sq, Skv, causal, offset, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* kv_mask, void* o, float* lse,
           int B, int H, int Hkv, int Sq, int Skv, int causal, int offset, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = fwd_shared_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), kv_mask,
      static_cast<float*>(o), lse, H, Hkv, Sq, Skv, causal, offset, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmt_flash_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                             void* o, void* lse, int B, int H, int Hkv, int Sq, int Skv, int D,
                             int causal, int offset, float sm_scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* mask = static_cast<const int*>(kv_mask);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    MMT_DISPATCH_HEAD_DIM(D, return launch_mma<kD>(q, k, v, mask, o, lse_f, B, H, Hkv, Sq, Skv,
                                                   causal, offset, sm_scale, st));
  if (dtype == 0)
    MMT_DISPATCH_HEAD_DIM(D, return launch<kD>(q, k, v, mask, o, lse_f, B, H, Hkv, Sq,
                                                       Skv, causal, offset, sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
