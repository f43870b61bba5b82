// K2a and K2b: flash attention backward, as two kernels.
//
// Replace the Pallas kernels `_dq_kernel` (K2a) and `_dkv_kernel` (K2b) of
// multimeditron_tpu/ops/flash_attention.py (reached through `_flash_bwd`).
// Both recompute the probabilities from the forward's saved base-2 logsumexp,
// p = exp2(s * scale * log2 e - lse), with masked entries set to exactly 0 so
// that masked keys get zero dk and dv, and take di = rowsum(o * dout), which
// the wrapper computes as a plain tensor op beforehand (as the JAX wrapper
// does outside Pallas). With ds = p * (dp - di) * scale and dp = dout v^T:
//   K2a: dq = ds k
//   K2b: dv = p^T dout and dk = ds^T q, summed over the q heads of the kv
//        head's group and over every query tile.
// p and ds are rounded to the input dtype before those products, as the
// Pallas kernels cast them.
//
// What bounds them on the H100: arithmetic, as for the forward (flash_fwd.cu):
// seven 64 x 64 x D products per pair of tiles; bf16 runs them on the tensor
// cores with mma.sync, float32 on the CUDA cores.
//
// The design: no atomics, and every sum is taken in a fixed order, so both
// kernels are deterministic. K2a is one block per (64-query tile, head, batch
// row) that walks the key tiles up to the causal bound with dq in registers.
// K2b is one block per (64-key tile, kv head, batch row); it keeps K and V in
// shared memory and loops over the group's q heads and, for each, the query
// tiles from the first one that can see the key tile (the Pallas kernel's
// `first_valid` remap becomes the loop start), accumulating dk and dv in
// registers. This is the JAX grid (B, Hkv, nk, G, nq) with its two sequential
// dimensions turned into loops inside the block.
#include "flash.cuh"

namespace {

using namespace mmt::flash;

template <int D>
size_t dq_shared_bytes() {
  return (4 * size_t(Dims<D>::kTileFloats) + kTile * kLdP) * sizeof(float) + kTile * sizeof(int);
}

template <int D>
size_t dkv_shared_bytes() {
  return (4 * size_t(Dims<D>::kTileFloats) + 2 * kTile * kLdP + 2 * kTile) * sizeof(float) +
         kTile * sizeof(int);
}

// s = A B^T and t = C E^T for one thread's 4 x 4 block of a 64 x 64 tile:
// rows ty + 16 i of A and C, rows tx + 16 j of B and E (all 64 x D in shared).
template <int D>
__device__ __forceinline__ void two_score_blocks(const float* a, const float* bm, const float* c,
                                                 const float* e, int tx, int ty,
                                                 float (&s)[kRows][kCols],
                                                 float (&t)[kRows][kCols]) {
  constexpr int kLd = Dims<D>::kLd;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 ra[kRows], rc[kRows], rb[kCols], re[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      ra[i] = load4(a + (ty + kTY * i) * kLd + d);
      rc[i] = load4(c + (ty + kTY * i) * kLd + d);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      rb[j] = load4(bm + (tx + kTX * j) * kLd + d);
      re[j] = load4(e + (tx + kTX * j) * kLd + d);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = dot4(ra[i], rb[j], s[i][j]);
        t[i][j] = dot4(rc[i], re[j], t[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// K2a: dq
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, const int* __restrict__ kv_mask,
                    float* __restrict__ dq, int H, int Hkv, int Sq, int Skv, int causal, int offset,
                    float sm_scale, float scale_log2) {
  using Dm = Dims<D>;
  constexpr int kLd = Dm::kLd, kG = Dm::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + Dm::kTileFloats;
  float* ks = dos + Dm::kTileFloats;
  float* vs = ks + Dm::kTileFloats;
  float* dss = vs + Dm::kTileFloats;
  int* kval = reinterpret_cast<int*>(dss + kTile * kLdP);

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int q0 = iq * kTile;
  const size_t qrow0 = (size_t(b) * H + h) * Sq;
  const float* kh = k + (size_t(b) * Hkv + hk) * Skv * D;
  const float* vh = v + (size_t(b) * Hkv + hk) * Skv * D;
  const int* mask_row = kv_mask == nullptr ? nullptr : kv_mask + size_t(b) * Skv;

  load_tile<D>(qs, q + qrow0 * D, q0, Sq);
  load_tile<D>(dos, dout + qrow0 * D, q0, Sq);

  float lse_r[kRows], di_r[kRows], acc[kRows][4 * kG];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kTY * i;
    lse_r[i] = qi < Sq ? lse[qrow0 + qi] : 0.f;
    di_r[i] = qi < Sq ? di[qrow0 + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = kv_tiles(min(q0 + kTile, Sq) - 1, Skv, causal, offset);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<D>(ks, kh, k0, Skv);
    load_tile<D>(vs, vh, k0, Skv);
    load_key_valid(kval, mask_row, k0, Skv);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    two_score_blocks<D>(qs, ks, dos, vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kTY * i;
      const long long qpos = static_cast<long long>(qi) + offset;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = tx + kTX * j;
        const bool ok = qi < Sq && kval[kj] && (!causal || qpos >= k0 + kj);
        const float p = ok ? exp2f(s[i][j] * scale_log2 - lse_r[i]) : 0.f;
        dss[(ty + kTY * i) * kLdP + kj] = p * (dp[i][j] - di_r[i]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 da[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) da[i] = load4(dss + (ty + kTY * i) * kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 kb[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) kb[g] = load4(ks + (j + jj) * kLd + 4 * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float w = lane(da[i], jj);
#pragma unroll
          for (int g = 0; g < kG; ++g) axpy4(&acc[i][4 * g], w, kb[g]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kTY * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float* a = &acc[i][4 * g];
      store4(dq + (qrow0 + qi) * D + 4 * tx + 64 * g, make_float4(a[0], a[1], a[2], a[3]));
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: dk, dv
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, const int* __restrict__ kv_mask,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                     int causal, int offset, float sm_scale, float scale_log2) {
  using Dm = Dims<D>;
  constexpr int kLd = Dm::kLd, kG = Dm::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + Dm::kTileFloats;
  float* qs = vs + Dm::kTileFloats;
  float* dos = qs + Dm::kTileFloats;
  float* pts = dos + Dm::kTileFloats;  // p^T: 64 keys x 64 queries
  float* dsts = pts + kTile * kLdP;    // ds^T
  float* lse_s = dsts + kTile * kLdP;
  float* di_s = lse_s + kTile;
  int* kval = reinterpret_cast<int*>(di_s + kTile);

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int k0 = ik * kTile;
  const size_t krow0 = (size_t(b) * Hkv + hk) * Skv;
  const int* mask_row = kv_mask == nullptr ? nullptr : kv_mask + size_t(b) * Skv;

  load_tile<D>(ks, k + krow0 * D, k0, Skv);
  load_tile<D>(vs, v + krow0 * D, k0, Skv);
  load_key_valid(kval, mask_row, k0, Skv);

  float dk_acc[kRows][4 * kG], dv_acc[kRows][4 * kG];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // first query tile with a row that may see key k0 (causal), else 0
  const int nq = (Sq + kTile - 1) / kTile;
  int iq0 = 0;
  if (causal) {
    const long long first = static_cast<long long>(k0) - offset;
    iq0 = first <= 0 ? 0 : mmt::clamp_int(first / kTile, 0, nq);
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t qrow0 = (size_t(b) * H + h) * Sq;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are no longer read
      load_tile<D>(qs, q + qrow0 * D, q0, Sq);
      load_tile<D>(dos, dout + qrow0 * D, q0, Sq);
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < Sq ? lse[qrow0 + qi] : 0.f;
        di_s[threadIdx.x] = qi < Sq ? di[qrow0 + qi] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T and dp^T = V dO^T: rows are keys, columns queries
      float st[kRows][kCols], dpt[kRows][kCols];
      two_score_blocks<D>(ks, qs, vs, dos, tx, ty, st, dpt);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kr = ty + kTY * i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int qc = tx + kTX * j;
          const int qi = q0 + qc;
          const bool ok = qi < Sq && kval[kr] &&
                          (!causal || static_cast<long long>(qi) + offset >= k0 + kr);
          const float p = ok ? exp2f(st[i][j] * scale_log2 - lse_s[qc]) : 0.f;
          pts[kr * kLdP + qc] = p;
          dsts[kr * kLdP + qc] = p * (dpt[i][j] - di_s[qc]) * sm_scale;
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int j = 0; j < kTile; j += 4) {
        float4 pa[kRows], da[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pa[i] = load4(pts + (ty + kTY * i) * kLdP + j);
          da[i] = load4(dsts + (ty + kTY * i) * kLdP + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float4 ob[kG], qb[kG];
#pragma unroll
          for (int gg = 0; gg < kG; ++gg) {
            ob[gg] = load4(dos + (j + jj) * kLd + 4 * tx + 64 * gg);
            qb[gg] = load4(qs + (j + jj) * kLd + 4 * tx + 64 * gg);
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float wp = lane(pa[i], jj), wd = lane(da[i], jj);
#pragma unroll
            for (int gg = 0; gg < kG; ++gg) {
              axpy4(&dv_acc[i][4 * gg], wp, ob[gg]);
              axpy4(&dk_acc[i][4 * gg], wd, qb[gg]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty + kTY * i;
    if (key >= Skv) continue;
#pragma unroll
    for (int gg = 0; gg < kG; ++gg) {
      const float* a = &dk_acc[i][4 * gg];
      const float* c = &dv_acc[i][4 * gg];
      store4(dk + (krow0 + key) * D + 4 * tx + 64 * gg, make_float4(a[0], a[1], a[2], a[3]));
      store4(dv + (krow0 + key) * D + 4 * tx + 64 * gg, make_float4(c[0], c[1], c[2], c[3]));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores. Both kernels run 4 warps, each owning 16
// rows of the block's 64-row tile, and take every product as mma.sync
// m16n8k16 with f32 accumulators; p and ds go from accumulators straight into
// bf16 A fragments. The 64 columns of a score tile are taken in two halves of
// 32, which keeps the two score accumulators and the two 16 x D gradient
// accumulators of K2b within the register file.
// ---------------------------------------------------------------------------
template <int D>
size_t bwd_mma_shared_bytes() {
  return 4 * size_t(mma::Dims<D>::kTileElems) * sizeof(__nv_bfloat16) +
         2 * kTile * sizeof(float) + kTile * sizeof(int);
}

// K2a: warp rows are queries; per key tile, dq += ds k.
template <int D>
__global__ void __launch_bounds__(mma::kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        const int* __restrict__ kv_mask, __nv_bfloat16* __restrict__ dq, int H,
                        int Hkv, int Sq, int Skv, int causal, int offset, float sm_scale,
                        float scale_log2) {
  using Dm = mma::Dims<D>;
  constexpr int kKS = Dm::kKSteps, kNT = Dm::kNTiles;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + Dm::kTileElems;
  __nv_bfloat16* ks = dos + Dm::kTileElems;
  __nv_bfloat16* vs = ks + Dm::kTileElems;
  int* kval = reinterpret_cast<int*>(vs + Dm::kTileElems);

  const int iq = gridDim.x - 1 - blockIdx.x;
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
  mma::load_tile<D>(dos, dout + qrow0 * D, q0, Sq);
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    lse_r[r] = qi < Sq ? lse[qrow0 + qi] : 0.f;
    di_r[r] = qi < Sq ? di[qrow0 + qi] : 0.f;
  }
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = kv_tiles(min(q0 + kTile, Sq) - 1, Skv, causal, offset);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    mma::load_tile<D>(ks, kh, k0, Skv);
    mma::load_tile<D>(vs, vh, k0, Skv);
    load_key_valid(kval, mask_row, k0, Skv);
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;  // first key of this half within the tile
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t qa[4], oa[4];
        mma::load_a<D>(qa, qs, warp * 16, kk * 16, lane);
        mma::load_a<D>(oa, dos, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4], vb[4];
          mma::load_b_nk<D>(kb, ks, c0 + np * 16, kk * 16, lane);
          mma::load_b_nk<D>(vb, vs, c0 + np * 16, kk * 16, lane);
          mma::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
          mma::mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
          mma::mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = c0 + 8 * j + 2 * t4 + (e & 1);
          const int qi = row0 + 8 * (e >> 1);
          const bool ok = qi < Sq && kval[kj] &&
                          (!causal || static_cast<long long>(qi) + offset >= k0 + kj);
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_r[e >> 1]) : 0.f;
          s[j][e] = p * (dp[j][e] - di_r[e >> 1]) * sm_scale;  // ds
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // 16 keys per k-step
        uint32_t da[4];
        mma::accum_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dpi = 0; dpi < D / 16; ++dpi) {
          uint32_t kb[4];
          mma::load_b_kn<D>(kb, ks, c0 + kk * 16, dpi * 16, lane);
          mma::mma_bf16(acc[2 * dpi], da, kb[0], kb[1]);
          mma::mma_bf16(acc[2 * dpi + 1], da, kb[2], kb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* out = dq + (qrow0 + qi) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n) = mma::pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// K2b: warp rows are keys; per query tile, dv += p^T dout and dk += ds^T q.
template <int D>
__global__ void __launch_bounds__(mma::kThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ di, const int* __restrict__ kv_mask,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                         int Hkv, int Sq, int Skv, int causal, int offset, float sm_scale,
                         float scale_log2) {
  using Dm = mma::Dims<D>;
  constexpr int kKS = Dm::kKSteps, kNT = Dm::kNTiles;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + Dm::kTileElems;
  __nv_bfloat16* qs = vs + Dm::kTileElems;
  __nv_bfloat16* dos = qs + Dm::kTileElems;
  float* lse_s = reinterpret_cast<float*>(dos + Dm::kTileElems);
  float* di_s = lse_s + kTile;
  int* kval = reinterpret_cast<int*>(di_s + kTile);

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = ik * kTile;
  const size_t krow0 = (size_t(b) * Hkv + hk) * Skv;
  const int* mask_row = kv_mask == nullptr ? nullptr : kv_mask + size_t(b) * Skv;

  mma::load_tile<D>(ks, k + krow0 * D, k0, Skv);
  mma::load_tile<D>(vs, v + krow0 * D, k0, Skv);
  load_key_valid(kval, mask_row, k0, Skv);
  const int key0 = warp * 16 + g;  // this thread's key rows in the tile: key0 and key0 + 8

  float dk_acc[kNT][4], dv_acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int nq = (Sq + kTile - 1) / kTile;
  int iq0 = 0;
  if (causal) {
    const long long first = static_cast<long long>(k0) - offset;
    iq0 = first <= 0 ? 0 : mmt::clamp_int(first / kTile, 0, nq);
  }

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const size_t qrow0 = (size_t(b) * H + h) * Sq;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();  // the previous tile's Q and dO are no longer read
      mma::load_tile<D>(qs, q + qrow0 * D, q0, Sq);
      mma::load_tile<D>(dos, dout + qrow0 * D, q0, Sq);
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < Sq ? lse[qrow0 + qi] : 0.f;
        di_s[threadIdx.x] = qi < Sq ? di[qrow0 + qi] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = 32 * half;  // first query of this half within the tile
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          uint32_t ka[4], va[4];
          mma::load_a<D>(ka, ks, warp * 16, kk * 16, lane);
          mma::load_a<D>(va, vs, warp * 16, kk * 16, lane);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t qb[4], ob[4];
            mma::load_b_nk<D>(qb, qs, c0 + np * 16, kk * 16, lane);
            mma::load_b_nk<D>(ob, dos, c0 + np * 16, kk * 16, lane);
            mma::mma_bf16(st[2 * np], ka, qb[0], qb[1]);
            mma::mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
            mma::mma_bf16(dpt[2 * np], va, ob[0], ob[1]);
            mma::mma_bf16(dpt[2 * np + 1], va, ob[2], ob[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c0 + 8 * j + 2 * t4 + (e & 1);
            const int kr = key0 + 8 * (e >> 1);
            const int qi = q0 + qc;
            const bool ok = qi < Sq && kval[kr] &&
                            (!causal || static_cast<long long>(qi) + offset >= k0 + kr);
            const float p = ok ? exp2f(st[j][e] * scale_log2 - lse_s[qc]) : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - di_s[qc]) * sm_scale;  // ds^T
          }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // 16 queries per k-step
          uint32_t pa[4], da[4];
          mma::accum_to_a(pa, st[2 * kk], st[2 * kk + 1]);
          mma::accum_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int dpi = 0; dpi < D / 16; ++dpi) {
            uint32_t ob[4], qb[4];
            mma::load_b_kn<D>(ob, dos, c0 + kk * 16, dpi * 16, lane);
            mma::load_b_kn<D>(qb, qs, c0 + kk * 16, dpi * 16, lane);
            mma::mma_bf16(dv_acc[2 * dpi], pa, ob[0], ob[1]);
            mma::mma_bf16(dv_acc[2 * dpi + 1], pa, ob[2], ob[3]);
            mma::mma_bf16(dk_acc[2 * dpi], da, qb[0], qb[1]);
            mma::mma_bf16(dk_acc[2 * dpi + 1], da, qb[2], qb[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + key0 + 8 * r;
    if (key >= Skv) continue;
    __nv_bfloat16* dkr = dk + (krow0 + key) * D + 2 * t4;
    __nv_bfloat16* dvr = dv + (krow0 + key) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * n) =
          mma::pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvr + 8 * n) =
          mma::pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* di, const int* kv_mask, void* dq, int B, int H, int Hkv, int Sq,
              int Skv, int causal, int offset, float sm_scale, cudaStream_t stream) {
  const size_t smem = dq_shared_bytes<D>();
  cudaError_t err = allow_shared(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, kv_mask, static_cast<float*>(dq), H, Hkv, Sq, Skv,
      causal, offset, sm_scale, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, const int* kv_mask, void* dk, void* dv, int B, int H, int Hkv,
               int Sq, int Skv, int causal, int offset, float sm_scale, cudaStream_t stream) {
  const size_t smem = dkv_shared_bytes<D>();
  cudaError_t err = allow_shared(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + kTile - 1) / kTile, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, kv_mask, static_cast<float*>(dk), static_cast<float*>(dv),
      H, Hkv, Sq, Skv, causal, offset, sm_scale, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* di, const int* kv_mask, void* dq, int B, int H,
                  int Hkv, int Sq, int Skv, int causal, int offset, float sm_scale,
                  cudaStream_t stream) {
  const size_t smem = bwd_mma_shared_bytes<D>();
  cudaError_t err = allow_shared(flash_bwd_dq_mma_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  using bf16 = __nv_bfloat16;
  flash_bwd_dq_mma_kernel<D><<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, di, kv_mask, static_cast<bf16*>(dq), H, Hkv, Sq, Skv,
      causal, offset, sm_scale, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, const int* kv_mask, void* dk, void* dv,
                   int B, int H, int Hkv, int Sq, int Skv, int causal, int offset,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = bwd_mma_shared_bytes<D>();
  cudaError_t err = allow_shared(flash_bwd_dkv_mma_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + kTile - 1) / kTile, Hkv, B);
  using bf16 = __nv_bfloat16;
  flash_bwd_dkv_mma_kernel<D><<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, di, kv_mask, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Hkv, Sq, Skv, causal, offset, sm_scale, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int Hkv, int Sq, int Skv) {
  return B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0;
}

}  // namespace

extern "C" int mmt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, const void* kv_mask, void* dq,
                                int B, int H, int Hkv, int Sq, int Skv, int D, int causal,
                                int offset, float sm_scale, int dtype, void* stream) {
  if (bad_shape(B, H, Hkv, Sq, Skv)) return static_cast<int>(cudaErrorInvalidValue);
  const float* lse_f = static_cast<const float*>(lse);
  const float* di_f = static_cast<const float*>(di);
  const int* mask = static_cast<const int*>(kv_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    MMT_DISPATCH_HEAD_DIM(D, return launch_dq_mma<kD>(q, k, v, dout, lse_f, di_f, mask, dq, B, H,
                                                      Hkv, Sq, Skv, causal, offset, sm_scale, st));
  if (dtype == 0)
    MMT_DISPATCH_HEAD_DIM(D, return launch_dq<kD>(q, k, v, dout, lse_f, di_f, mask, dq, B,
                                                          H, Hkv, Sq, Skv, causal, offset,
                                                          sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mmt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* di, const void* kv_mask, void* dk,
                                 void* dv, int B, int H, int Hkv, int Sq, int Skv, int D,
                                 int causal, int offset, float sm_scale, int dtype, void* stream) {
  if (bad_shape(B, H, Hkv, Sq, Skv)) return static_cast<int>(cudaErrorInvalidValue);
  const float* lse_f = static_cast<const float*>(lse);
  const float* di_f = static_cast<const float*>(di);
  const int* mask = static_cast<const int*>(kv_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    MMT_DISPATCH_HEAD_DIM(D, return launch_dkv_mma<kD>(q, k, v, dout, lse_f, di_f, mask, dk, dv, B,
                                                       H, Hkv, Sq, Skv, causal, offset, sm_scale,
                                                       st));
  if (dtype == 0)
    MMT_DISPATCH_HEAD_DIM(D, return launch_dkv<kD>(q, k, v, dout, lse_f, di_f, mask, dk,
                                                           dv, B, H, Hkv, Sq, Skv, causal, offset,
                                                           sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
