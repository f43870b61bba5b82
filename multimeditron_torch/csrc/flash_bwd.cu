// K2a and K2b: flash attention backward, as two kernels.
//
// Replace the Pallas kernels `_dq_kernel` (K2a) and `_dkv_kernel` (K2b) of
// multimeditron_tpu/ops/flash_attention.py (reached through `_flash_bwd`).
// Both recompute the probabilities from the forward's saved base-2 logsumexp,
// p = exp2(s * scale * log2 e - lse), with masked entries set to exactly 0 (by
// the key mask, by causal position and for query rows past Sq) so that masked
// keys get zero dk and dv and a row with no valid key (lse = kMaskValue) gets
// zero dq, and take di = rowsum(o * dout), which the wrapper computes as a
// plain tensor op beforehand (as the JAX wrapper does outside Pallas). With
// ds = p * (dp - di) * scale and dp = dout v^T:
//   K2a: dq = ds k
//   K2b: dv = p^T dout and dk = ds^T q, summed over the q heads of the kv
//        head's group and over every query tile.
// p and ds are rounded to the input dtype before those products, as the
// Pallas kernels cast them. No atomics: every sum is taken in a fixed order,
// so both kernels are deterministic.
//
// What bounds them on the H100: arithmetic. Over the (query, key) pairs the
// masks leave, K2a does 6 H D FLOP a pair (s, dp, dq) and K2b 8 H D (s, dp,
// dv, dk): at the training shape (B = 1, H = 32, Hkv = 8, S = 4096, D = 128,
// causal, keys from 3500 masked) 0.204 and 0.272 ms at the bf16 tensor-core
// peak. Two kernels each, chosen by dtype in the C entry points:
//
// - bf16: flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel, on wgmma
//   with every tile brought in by TMA (3-D maps over (B*H, S, D) or
//   (B*Hkv, S, D), 64-row boxes in the 128-byte swizzle, rows past S read as
//   zeros), in K1's warp-specialised shape (flash_fwd.cu): a block of three
//   warpgroups, whose first warp loads and folds the key mask into bits by
//   ballot while warpgroups 1 and 2 compute. The ring of full / empty
//   mbarriers, the mask folding and the K/V producer loop are shared with K1
//   (flash_tma.cuh).
//   K2b is one block per (64-key tile, kv head, batch row), the key tiles
//   with the most causal work first. K and V come in once; then, for each q
//   head of the group and each 64-row query tile from the first that can see
//   the block's keys (the Pallas kernel's `first_valid` remap becomes the
//   loop start), Q, dO, lse and di come through a 3-stage ring. The two
//   consumer warpgroups split the work by gradient: warpgroup 1 computes
//   S^T = K Q^T (wgmma, both operands in shared memory, K-major), p^T on its
//   accumulators and dV += P^T dO, and hands p^T (f32) to warpgroup 2
//   through a double-buffered shared tile; warpgroup 2 computes
//   dP^T = V dO^T, ds^T and dK += dS^T Q. P^T and dS^T are bf16 A fragments
//   in registers; Q and dO are read MN-major (the descriptor's transpose).
//   Each warpgroup keeps one 64 x D f32 gradient in registers, stored once.
//   Why the split: a warpgroup holding dK, dV, S^T and dP^T at D = 128
//   needs about 236 registers a thread (ptxas, one consumer warpgroup beside
//   a producer warp). Under the 232 that setmaxnreg gives each consumer of a
//   384-thread block it spilled (912 bytes) with every wgmma serialized
//   (note C7512): 1.79 ms at the training shape, against 0.61 ms for that
//   single warpgroup at 236 registers and 0.53 ms for this split
//   (kernel_ab.py, PERF.md). Both kernels keep the producer at 40 and the
//   consumers at 232 registers: without setmaxnreg ptxas keeps them within
//   168 (K2b at D = 128 took 159) and K2b and K2a ran 0.73 and 0.37 ms.
//   A block whose keys are all masked stores exact zeros without a product.
//   K2a is one block per (128-query tile, head, batch row), longest rows
//   first; each consumer warpgroup owns 64 queries: Q and dO come in once,
//   K and V in 64-key tiles through the ring up to the causal bound;
//   S = Q K^T and dP = dO V^T, ds, then dQ += dS K (K MN-major), dQ in
//   registers. A key tile whose keys are all masked or that no row of a
//   warpgroup sees skips that warpgroup's products. Scores take exp2 on the
//   special-function unit (ex2.approx, as K1) with the scale folded into one
//   FMA; a warp whose rows all see every key of a tile skips the mask.
// - float32: flash_bwd_dq_kernel and flash_bwd_dkv_kernel on the CUDA cores
//   (TF32 would break the float32 tolerances), 64-row tiles staged in shared
//   memory: K2a one block per (64-query tile, head, batch row) walking the
//   key tiles, K2b one block per (64-key tile, kv head, batch row) looping
//   over the group's q heads and their query tiles (the JAX grid
//   (B, Hkv, nk, G, nq) with its two sequential dimensions turned into loops
//   inside the block).
//
// Measured (chip_smoke.py phase 3 at the training shape, device time,
// NVIDIA H100 80GB HBM3 at 700 W): K2a 0.3431 ms (588 TFLOP/s useful), K2b
// 0.5324 ms (506), against 1.9878 and 2.7855 ms for the mma.sync kernels
// they replace and 2.3420 ms for SDPA's whole backward with the same mask.
#include "flash_tma.cuh"

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
// bf16 on wgmma + TMA (see the note at the top). Both kernels are blocks of
// three warpgroups: warpgroup 0 loads (its first warp issues every TMA copy
// and folds the key mask; the others leave at once), warpgroups 1 and 2
// compute. All tiles are 64-row boxes of 64 columns in the 128-byte swizzle
// (8 KB).
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kThreads = 3 * 128;
constexpr int kConsumerWarps = 8;
constexpr int kBox = 64 * 128;  // one 64 x 64 bf16 box
constexpr int kRing = 3;        // stages in flight

// K2b: K and V of the block's 64 keys, a ring of (Q, dO) stages of 64 query
// rows with their lse and di, and two f32 p^T tiles.
template <int D>
struct DkvSmem {
  static constexpr int kTile = D / 64 * kBox;  // 64 rows x D
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;  // stage s: Q at kQ + s * kStage, dO after it
  static constexpr int kStage = 2 * kTile;
  static constexpr int kP = kQ + kRing * kStage;     // 2 x 64 x 64 floats
  static constexpr int kRows = kP + 2 * 64 * 64 * 4;  // stage s: lse[64], di[64]
  // full[], empty[], kv_full, p_full[2], p_empty[2]
  static constexpr int kBars = kRows + kRing * 128 * 4;
  static constexpr int kBits = kBars + (2 * kRing + 5) * 8;  // 2 words: the block's keys
  static constexpr int kBytes = kBits + 8 + 1024;           // + room to align to 1024
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// K2a: Q and dO of the block's 128 queries, then a ring of (K, V) stages of
// 64 keys with their key bits.
template <int D>
struct DqSmem {
  static constexpr int kTile = D / 64 * kBox;
  static constexpr int kQ = 0;  // consumer c's 64 rows at kQ + c * kTile
  static constexpr int kO = kQ + 2 * kTile;
  static constexpr int kK = kO + 2 * kTile;  // stage s at kK + s * kTile
  static constexpr int kV = kK + kRing * kTile;
  static constexpr int kBars = kV + kRing * kTile;  // full[], empty[], q_full
  static constexpr int kBits = kBars + (2 * kRing + 1) * 8;  // 2 words a stage
  static constexpr int kBytes = kBits + kRing * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// Descriptors of k-step kk (16 columns of D) of a 64-row tile read K-major,
// and of k-step kk (16 rows) of a 64-row tile read MN-major (its D columns
// are the product's N).
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return mmt::hopper::desc_sw128(tile + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return mmt::hopper::desc_sw128(tile + kk * 2048, kBox, 1024);
}

// X (64 x 64, f32) = A B^T over D, both 64-row tiles K-major; one wgmma group.
template <int D>
__device__ __forceinline__ void scores(float (&x)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mmt::hopper::wgmma_m64n64_ss(x, k_major(a, kk), k_major(b, kk), kk > 0);
  mmt::hopper::wgmma_commit();
}

// acc (64 x D) += A B: A (64 x 64) from registers, B a 64-row tile MN-major.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 128) {
      mmt::hopper::wgmma_m64n128_rs(acc, a[kk], mn_major(b, kk));
    } else {
      mmt::hopper::wgmma_m64n64_rs(acc, a[kk], mn_major(b, kk));
    }
  }
}

// A fragments of a 64 x 64 accumulator, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = mma::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Rows row0 and row0 + 8 of a 64 x D accumulator (d[4n + 2r ..] holds row
// row0 + 8r, columns 8n + 2t, + 1) into a bf16 (n_rows, D) matrix.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2],
                                           int row0, int n_rows, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* p = out + size_t(row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + 8 * n) =
          mma::pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

}  // namespace wg

// K2b: one block per (64-key tile, kv head, batch row). Per stage (q head h
// of the group, 64 queries) warpgroup 1 computes S^T = K Q^T, p^T on its
// accumulators and dV += P^T dO, and hands p^T (f32) to warpgroup 2 through
// a double-buffered shared tile; warpgroup 2 computes dP^T = V dO^T, ds^T
// and dK += dS^T Q. P^T, dS^T are bf16 A fragments from registers; Q and dO
// are read MN-major. Each warpgroup keeps one 64 x D gradient in registers:
// both in one warpgroup would not fit its 168 registers.
template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           const int* __restrict__ kv_mask, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                           int causal, int offset, float sm_scale, float scale_log2) {
  using namespace mmt::hopper;
  using Sm = wg::DkvSmem<D>;
  constexpr int kTile = Sm::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  uint64_t* empty = full + wg::kRing;
  uint64_t* kv_full = empty + wg::kRing;
  uint64_t* p_full = kv_full + 1;  // [2]: p^T of a step written
  uint64_t* p_empty = p_full + 2;  // [2]: p^T of a step read
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(smem + Sm::kBits);
  float* row_vals = reinterpret_cast<float*>(smem + Sm::kRows);
  float* p_tiles = reinterpret_cast<float*>(smem + Sm::kP);
  const Ring ring{full, empty, wg::kRing};

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * 64;  // key tiles with the most causal work first
  const int group = H / Hkv;
  const int nq = (Sq + 63) / 64;
  // the first query tile with a row that may see key k0 (causal), else 0
  int iq0 = 0;
  if (causal) {
    const long long first = static_cast<long long>(k0) - offset;
    iq0 = first <= 0 ? 0 : mmt::clamp_int(first / 64, 0, nq);
  }
  const int per_head = nq - iq0, n_steps = group * per_head;
  const int lane = threadIdx.x % mmt::kWarpSize;

  if (threadIdx.x == 0) {
    ring.init(mmt::kWarpSize, wg::kConsumerWarps);
    mbar_init(kv_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&p_full[i], 128);
      mbar_init(&p_empty[i], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= mmt::kWarpSize) return;
    const int* mask_row = kv_mask == nullptr ? nullptr : kv_mask + size_t(b) * Skv;
    uint32_t bits[2];
    fold_key_bits(bits, mask_row, k0, Skv, lane);
    if (lane == 0) {
      key_bits[0] = bits[0];
      key_bits[1] = bits[1];
      mbar_arrive_expect_tx(kv_full, 2 * kTile);
      for (int box = 0; box < D / 64; ++box) {
        tma_load_3d(smem + Sm::kK + box * wg::kBox, &k_map, kv_full, box * 64, k0, b * Hkv + hk);
        tma_load_3d(smem + Sm::kV + box * wg::kBox, &v_map, kv_full, box * 64, k0, b * Hkv + hk);
      }
    }
    if ((bits[0] | bits[1]) == 0) return;  // no valid key: zeros
    for (int t = 0; t < n_steps; ++t) {
      const int h = hk * group + t / per_head, q0 = (iq0 + t % per_head) * 64;
      const int s = ring.stage(t);
      const size_t row0 = (size_t(b) * H + h) * Sq;
      ring.wait_empty(t);
      float* rv = row_vals + 128 * s;
      for (int i = lane; i < 64; i += mmt::kWarpSize) {
        const int qi = q0 + i;
        rv[i] = qi < Sq ? lse[row0 + qi] : 0.f;
        rv[64 + i] = qi < Sq ? di[row0 + qi] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        for (int box = 0; box < D / 64; ++box) {
          unsigned char* st = smem + Sm::kQ + s * Sm::kStage + box * wg::kBox;
          tma_load_3d(st, &q_map, &full[s], box * 64, q0, b * H + h);
          tma_load_3d(st + kTile, &do_map, &full[s], box * 64, q0, b * H + h);
        }
      } else {
        mbar_arrive(&full[s]);  // after this lane's lse and di
      }
    }
    return;
  }

  // Consumers: warp w of a warpgroup owns keys k0 + 16w .., this thread key0
  // and key0 + 8 (accumulator rows) and queries 8j + 2t, + 1 of a stage
  // (columns). Warpgroup 1 (role 0) takes dV, warpgroup 2 dK.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int role = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / mmt::kWarpSize, g = lane / 4, t4 = lane % 4;
  const int key0 = k0 + 16 * warp + g;
  const uint32_t k_addr = smem_u32(smem + Sm::kK), v_addr = smem_u32(smem + Sm::kV);

  float acc[D / 2];  // dV (role 0) or dK (role 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(kv_full, 0);
  const uint32_t w0 = key_bits[0], w1 = key_bits[1];
  // this thread's two keys, and the 16 keys of its warp, valid?
  const uint32_t wb = (warp < 2 ? w0 : w1) >> (16 * (warp & 1));
  const bool key_ok[2] = {((wb >> g) & 1u) != 0u, ((wb >> (g + 8)) & 1u) != 0u};
  const bool warp_keys_ok = (wb & 0xffffu) == 0xffffu;

  // n_p counts the steps that ran: both warpgroups skip the same ones
  for (int t = 0, n_p = 0; (w0 | w1) != 0 && t < n_steps; ++t) {
    const int q0 = (iq0 + t % per_head) * 64;
    const int s = ring.stage(t);
    ring.wait_full(t);
    // skip a stage none of whose queries sees a key of the block
    if (!causal || static_cast<long long>(min(q0 + 63, Sq - 1)) + offset >= k0) {
      const uint32_t q_addr = smem_u32(smem + Sm::kQ + s * Sm::kStage);
      const uint32_t o_addr = q_addr + kTile;
      const float* rv = row_vals + 128 * s;
      const int pb = n_p & 1, p_par = (n_p >> 1) & 1;
      // p^T of this step, float4 i of thread tid at [i][tid]: conflict-free
      float4* pt = reinterpret_cast<float4*>(p_tiles + pb * 128 * 32) + tid;
      float x[32];
      uint32_t a[4][4];
      wgmma_fence();
      if (role == 0) {
        wg::scores<D>(x, k_addr, q_addr);
        // p^T = exp2(s^T * scale_log2 - lse), then 0 where masked (a select:
        // the exponent of a row with no valid key overflows); a warp whose
        // 16 keys are valid and seen by every query of the tile skips the mask
        const bool whole = warp_keys_ok && q0 + 64 <= Sq &&
                           (!causal || static_cast<long long>(q0) + offset >= k0 + 16 * warp + 15);
        wgmma_wait<0>();
        fence_regs(x);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& y = x[4 * j + e];
            y = mma::exp2_approx(fmaf(y, scale_log2, -rv[8 * j + 2 * t4 + (e & 1)]));
          }
        if (!whole) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = q0 + 8 * j + 2 * t4 + (e & 1);
              const bool ok = key_ok[e >> 1] && qi < Sq &&
                              (!causal || static_cast<long long>(qi) + offset >= key0 + 8 * (e >> 1));
              if (!ok) x[4 * j + e] = 0.f;
            }
        }
        wg::to_a(a, x);
        wgmma_fence();
        wg::accumulate<D>(acc, a, o_addr);  // dV += P^T dO
        wgmma_commit();
        mbar_wait(&p_empty[pb], p_par ^ 1);  // the p^T tile of two steps back is read
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pt[128 * i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
        mbar_arrive(&p_full[pb]);
      } else {
        wg::scores<D>(x, v_addr, o_addr);
        wgmma_wait<0>();
        fence_regs(x);
        mbar_wait(&p_full[pb], p_par);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 p = pt[128 * i];
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)  // ds^T = p^T (dp^T - di) scale
            x[4 * i + e] = pv[e] * (x[4 * i + e] - rv[64 + 8 * i + 2 * t4 + (e & 1)]) * sm_scale;
        }
        mbar_arrive(&p_empty[pb]);
        wg::to_a(a, x);
        wgmma_fence();
        wg::accumulate<D>(acc, a, q_addr);  // dK += dS^T Q
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a);
      ++n_p;
    }
    ring.release(t, lane);
  }

  const size_t krow0 = (size_t(b) * Hkv + hk) * Skv;
  wg::store_rows<D>((role == 0 ? dv : dk) + krow0 * D, acc, key0, Skv, t4);
}

// K2a: one block per (128-query tile, head, batch row); warpgroup c owns
// queries q0 + 64 (c - 1) ... Per 64-key stage: S = Q K^T and dP = dO V^T,
// ds on the accumulators, then dQ += dS K with dS from registers and K read
// MN-major. dQ stays in registers.
template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          const int* __restrict__ kv_mask, __nv_bfloat16* __restrict__ dq, int H,
                          int Hkv, int Sq, int Skv, int causal, int offset, float sm_scale,
                          float scale_log2) {
  using namespace mmt::hopper;
  using Sm = wg::DqSmem<D>;
  constexpr int kTile = Sm::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  uint64_t* empty = full + wg::kRing;
  uint64_t* q_full = empty + wg::kRing;
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(smem + Sm::kBits);
  const Ring ring{full, empty, wg::kRing};

  const int iq = gridDim.z - 1 - blockIdx.z;  // the longest causal rows start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = iq * 128;
  const int n_tiles = kv_tiles(min(q0 + 128, Sq) - 1, Skv, causal, offset, 64);
  const int lane = threadIdx.x % mmt::kWarpSize;

  if (threadIdx.x == 0) {
    ring.init(1, wg::kConsumerWarps);
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= mmt::kWarpSize) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 4 * kTile);
      for (int half = 0; half < 2; ++half)
        for (int box = 0; box < D / 64; ++box) {
          const int at = half * kTile + box * wg::kBox;
          tma_load_3d(smem + Sm::kQ + at, &q_map, q_full, box * 64, q0 + 64 * half, b * H + h);
          tma_load_3d(smem + Sm::kO + at, &do_map, q_full, box * 64, q0 + 64 * half, b * H + h);
        }
    }
    const int* mask_row = kv_mask == nullptr ? nullptr : kv_mask + size_t(b) * Skv;
    produce_kv_tiles<D, 64>(ring, n_tiles, &k_map, &v_map, smem + Sm::kK, smem + Sm::kV,
                            key_bits, mask_row, Skv, b * Hkv + hk, lane);
    return;
  }

  // Consumers: warpgroup c owns queries q0 + 64c ..; warp w of it rows
  // 16w .., this thread row0 and row0 + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x / mmt::kWarpSize) % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int wg_row = q0 + 64 * c, warp_row = wg_row + 16 * warp, row0 = warp_row + g;
  const size_t qrow0 = (size_t(b) * H + h) * Sq;
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    lse_r[r] = qi < Sq ? lse[qrow0 + qi] : 0.f;
    di_r[r] = qi < Sq ? di[qrow0 + qi] : 0.f;
  }
  const uint32_t q_addr = smem_u32(smem + Sm::kQ + c * kTile);
  const uint32_t o_addr = smem_u32(smem + Sm::kO + c * kTile);
  // the last key this warpgroup's rows may see; none when all its rows are padding
  const long long wg_last = wg_row >= Sq ? -1
                            : causal    ? static_cast<long long>(min(wg_row + 63, Sq - 1)) + offset
                                        : Skv;
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = ring.stage(t), k0 = t * 64;
    ring.wait_full(t);
    const uint32_t b0 = key_bits[2 * s], b1 = key_bits[2 * s + 1];
    // skip a tile whose keys are all masked or that no row of this warpgroup sees
    if ((b0 | b1) != 0 && wg_last >= k0) {
      const uint32_t k_addr = smem_u32(smem + Sm::kK + s * kTile);
      const uint32_t v_addr = smem_u32(smem + Sm::kV + s * kTile);
      float sc[32], dp[32];
      wgmma_fence();
      wg::scores<D>(sc, q_addr, k_addr);
      wg::scores<D>(dp, o_addr, v_addr);

      // p = exp2(s * scale_log2 - lse), then 0 where masked (a select: the
      // exponent of a row with no valid key overflows); a warp whose 16 rows
      // exist and see every key of the tile skips the mask
      const bool whole = (b0 & b1) == 0xffffffffu && warp_row + 16 <= Sq &&
                         (!causal || static_cast<long long>(warp_row) + offset >= k0 + 63);
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = mma::exp2_approx(fmaf(sc[i], scale_log2, -lse_r[(i >> 1) & 1]));
      if (!whole) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t4 + (e & 1), qi = row0 + 8 * (e >> 1);
            const bool ok = (((j < 4 ? b0 : b1) >> (col & 31)) & 1u) != 0u && qi < Sq &&
                            (!causal || static_cast<long long>(qi) + offset >= k0 + col);
            if (!ok) sc[4 * j + e] = 0.f;
          }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - di_r[(i >> 1) & 1]) * sm_scale;  // ds
      uint32_t da[4][4];
      wg::to_a(da, dp);
      wgmma_fence();
      wg::accumulate<D>(dq_acc, da, k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(da);
    }
    ring.release(t, lane);
  }
  wg::store_rows<D>(dq + qrow0 * D, dq_acc, row0, Sq, t4);
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
int make_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
              const void* dout, int B, int H, int Hkv, int Sq, int Skv) {
  int err = mmt::hopper::make_bf16_map(&maps[0], q, B * H, Sq, D, 64);
  if (err == 0) err = mmt::hopper::make_bf16_map(&maps[1], k, B * Hkv, Skv, D, 64);
  if (err == 0) err = mmt::hopper::make_bf16_map(&maps[2], v, B * Hkv, Skv, D, 64);
  if (err == 0) err = mmt::hopper::make_bf16_map(&maps[3], dout, B * H, Sq, D, 64);
  return err;
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* di, const int* kv_mask, void* dq, int B, int H,
                    int Hkv, int Sq, int Skv, int causal, int offset, float sm_scale,
                    cudaStream_t stream) {
  CUtensorMap maps[4];
  const int err = make_maps<D>(maps, q, k, v, dout, B, H, Hkv, Sq, Skv);
  if (err != 0) return err;
  const int smem = wg::DqSmem<D>::kBytes;
  const cudaError_t e = allow_shared(flash_bwd_dq_wgmma_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (Sq + 127) / 128);
  flash_bwd_dq_wgmma_kernel<D><<<grid, wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, kv_mask, static_cast<__nv_bfloat16*>(dq), H,
      Hkv, Sq, Skv, causal, offset, sm_scale, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, const int* kv_mask, void* dk, void* dv,
                     int B, int H, int Hkv, int Sq, int Skv, int causal, int offset,
                     float sm_scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  const int err = make_maps<D>(maps, q, k, v, dout, B, H, Hkv, Sq, Skv);
  if (err != 0) return err;
  const int smem = wg::DkvSmem<D>::kBytes;
  const cudaError_t e = allow_shared(flash_bwd_dkv_wgmma_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(Hkv, B, (Skv + 63) / 64);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, kv_mask, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Hkv, Sq, Skv, causal, offset, sm_scale,
      sm_scale * kLog2e);
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
    MMT_DISPATCH_HEAD_DIM(D, return launch_dq_wgmma<kD>(q, k, v, dout, lse_f, di_f, mask, dq, B, H,
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
    MMT_DISPATCH_HEAD_DIM(D, return launch_dkv_wgmma<kD>(q, k, v, dout, lse_f, di_f, mask, dk, dv, B,
                                                       H, Hkv, Sq, Skv, causal, offset, sm_scale,
                                                       st));
  if (dtype == 0)
    MMT_DISPATCH_HEAD_DIM(D, return launch_dkv<kD>(q, k, v, dout, lse_f, di_f, mask, dk,
                                                           dv, B, H, Hkv, Sq, Skv, causal, offset,
                                                           sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
