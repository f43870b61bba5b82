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
// What bounds it on the H100: arithmetic. At the training shape (H=32,
// Hkv=8, S=4096, D=128, causal, per batch row) a call is 0.135 TFLOP against
// 0.08 GB of q/k/v/o traffic: 0.136 ms at the bf16 tensor-core peak. Three
// kernels, chosen by dtype and query rows in mmt_flash_fwd, all counted as
// K1:
//
// - bf16 with Sq >= 64: flash_fwd_wgmma_kernel. One block of three
//   warpgroups per (128-query tile, head, batch row). Warpgroup 0 loads: its
//   first warp brings the block's Q and then each 128-key K and V tile in by
//   TMA (3-D tensor maps over (B*H, S, D), 128-byte swizzle, rows past S read
//   as zeros) into a 3-stage ring of shared-memory tiles guarded by full and
//   empty mbarriers, together with the tile's valid keys as 128 bits (key <
//   Skv and not masked; the producer loop and the ring are flash_tma.cuh's,
//   shared with K2a); it gives registers up with setmaxnreg. Warpgroups 1
//   and 2 each own 64 query rows: S = Q K^T is one wgmma m64n128k16 chain
//   with both operands in shared memory; the softmax runs on S's registers
//   (a tile where every key is valid and every row of the warp sees every key
//   skips the mask); P, rounded to bf16 as the Pallas kernel casts p, goes
//   from S's registers into wgmma A fragments, and O += P V reads V from
//   shared memory in MN-major form (the descriptor's transpose). Tile t's P V
//   and tile t + 1's Q K^T are queued back to back. ptxas serializes the
//   wgmma chains (note C7515: it interleaves the softmax's exp2 with the P V
//   products and reuses the A-fragment registers); a version that avoids
//   that (P packed as each exp2 lands, no overlap of tiles) measured slower.
//   Query tiles run longest first (the tile index is the slowest grid axis).
// - bf16 with Sq < 64 (the decode form, Sq = 1 in slab decode and
//   generate): flash_fwd_mma_kernel, 4 warps per 64-query tile on mma.sync
//   m16n8k16 with P kept in registers; a 128-row tile would idle 127 rows.
// - float32: flash_fwd_kernel on the CUDA cores (TF32 would break the
//   float32 tolerances), a 4 x 4 block of scores per thread from 16-byte
//   shared loads, p staged in shared memory.
//
// Each walks its key tiles in order, carrying the running max m, sum l and
// the O accumulator in registers: this takes the place of the TPU grid's
// sequential kv dimension and its VMEM scratch. Causal tiles past the
// diagonal are skipped by the loop bound. A row whose running max is still
// -inf (all keys so far masked) uses 0 as its reference, so exp2 of a masked
// score is an exact 0 and no NaN appears.
//
// Measured (chip_smoke.py phase 3, B=1 of the training shape, keys from
// 3500 masked, NVIDIA H100 80GB HBM3 at 700 W): the wgmma kernel 0.454 ms
// on the device, 296 TFLOP/s, against SDPA's 0.852 with the same mask; the
// mma.sync kernel it replaced at this shape took 1.0010 ms.
#include "flash_tma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 forward on wgmma + TMA (see the note at the top)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kRows = 128;         // query rows a block: 64 for each consumer warpgroup
constexpr int kKeys = 128;         // keys a K/V tile
constexpr int kStages = 3;         // K/V tiles in flight
constexpr int kThreads = 3 * 128;  // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumerWarps = 8;
constexpr int kBoxBytes = kKeys * 128;  // one 64-column box of a K or V tile

template <int D>
struct Smem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kQWg = 64 * D * 2;  // one consumer's query rows, in boxes of 8 KB
  static constexpr int kTileBytes = kKeys * D * 2;
  static constexpr int kK = 2 * kQWg;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;  // full[], empty[], q_full
  static constexpr int kBits = kBars + (2 * kStages + 1) * 8;  // 4 words of key bits a stage
  static constexpr int kBytes = kBits + kStages * 16 + 1024;  // + room to align to 1024
  static_assert(kBytes <= 232448, "shared memory of one block");
};

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const int* __restrict__ kv_mask,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Hkv,
                       int Sq, int Skv, int causal, int offset, float scale_log2) {
  using namespace mmt::hopper;
  using Sm = wg::Smem<D>;
  constexpr int kN = wg::kKeys, kWords = kN / 32;  // keys a tile, words of key bits
  static_assert(kN == 128, "S is one m64n128 product");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  uint64_t* empty = full + wg::kStages;
  uint64_t* q_full = empty + wg::kStages;
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(smem + Sm::kBits);

  const int iq = gridDim.z - 1 - blockIdx.z;  // the longest causal rows start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = iq * wg::kRows;
  const int n_tiles = kv_tiles(min(q0 + wg::kRows, Sq) - 1, Skv, causal, offset, wg::kKeys);
  const int lane = threadIdx.x % mmt::kWarpSize;

  const Ring ring{full, empty, wg::kStages};
  if (threadIdx.x == 0) {
    ring.init(1, wg::kConsumerWarps);
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one warp keeps the ring full; it needs few registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x >= mmt::kWarpSize) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * Sm::kQWg);
      for (int w = 0; w < 2; ++w)
        for (int box = 0; box < Sm::kBoxes; ++box)
          tma_load_3d(smem + w * Sm::kQWg + box * 8192, &q_map, q_full, box * 64, q0 + 64 * w,
                      b * H + h);
    }
    const int* mask_row = kv_mask == nullptr ? nullptr : kv_mask + size_t(b) * Skv;
    produce_kv_tiles<D, wg::kKeys>(ring, n_tiles, &k_map, &v_map, smem + Sm::kK, smem + Sm::kV,
                                   key_bits, mask_row, Skv, b * Hkv + hk, lane);
    return;
  }

  // Consumers: warpgroup c owns query rows q0 + 64c .. + 63; warp w of it
  // rows 16w .. 16w + 15, this thread rows row0 and row0 + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x / mmt::kWarpSize) % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int warp_row = q0 + 64 * c + 16 * warp, row0 = warp_row + g;
  const uint32_t q_addr = smem_u32(smem + c * Sm::kQWg);

  float acc[D / 2];  // O: D / 8 accumulator tiles of 8 columns
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[kN / 2];  // S of one tile; each tile's first product overwrites it
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
  uint32_t pa[kN / 16][4];  // P of one tile as wgmma A fragments
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  // S = Q K^T for tile t, both operands K-major in shared memory, 16 columns
  // of D a step; committed as one wgmma group.
  auto start_qk = [&](int t) {
    const int s = ring.stage(t);
    ring.wait_full(t);
    const uint32_t k_addr = smem_u32(smem + Sm::kK + s * Sm::kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t qd = desc_sw128(q_addr + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024);
      const uint64_t kd = desc_sw128(k_addr + (kk / 4) * wg::kBoxBytes + (kk % 4) * 32, 16, 1024);
      wgmma_m64n128_ss(sc, qd, kd, kk > 0);
    }
    wgmma_commit();
  };

  // Tile t's P V and tile t + 1's Q K^T are queued back to back, so the
  // tensor cores run one while this warpgroup waits for the other.
  if (n_tiles > 0) start_qk(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = ring.stage(t), k0 = t * wg::kKeys;
    wgmma_wait<0>();  // S of tile t, and O += P V of tile t - 1
    fence_regs(sc);
    fence_regs(acc);
    fence_regs(pa);  // read by tile t - 1's P V until here
    if (t > 0) ring.release(t - 1, lane);

    // Masked scores; a tile where every key is valid and (causal) every row
    // of this warp sees every key needs no mask. The scale folds into the
    // exponent: p = exp2(s * scale_log2 - m), m the running max in base 2.
    uint32_t tb[kWords], all = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < kWords; ++i) all &= tb[i] = key_bits[kWords * s + i];
    const bool whole = all == 0xffffffffu &&
                       (!causal || static_cast<long long>(warp_row) + offset >= k0 + kN - 1);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[4 * j + e];
        if (!whole) {
          const int col = 8 * j + 2 * t4 + (e & 1);  // word j / 4 of the key bits
          const long long qpos = static_cast<long long>(row0 + 8 * (e >> 1)) + offset;
          if (!((tb[j >> 2] >> (col & 31)) & 1u) || (causal && qpos < k0 + col)) x = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mma::quad_max(mx[r]) * scale_log2);
      m_ref[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = mma::exp2_approx(m[r] - m_ref[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      sc[i] = mma::exp2_approx(fmaf(sc[i], scale_log2, -m_ref[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + mma::quad_sum(sum[r]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: P (rounded to bf16) from registers, V MN-major in shared
    // memory, 16 keys a step.
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      pa[kk][0] = mma::pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = mma::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = mma::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = mma::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    const uint32_t v_addr = smem_u32(smem + Sm::kV + s * Sm::kTileBytes);
    fence_regs(acc);  // the rescale lands before the fence, not inside the wgmma stage
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint64_t vd = desc_sw128(v_addr + kk * 2048, wg::kBoxBytes, 1024);
      if constexpr (D == 128) {
        wgmma_m64n128_rs(acc, pa[kk], vd);
      } else {
        wgmma_m64n64_rs(acc, pa[kk], vd);
      }
    }
    wgmma_commit();
    if (t + 1 < n_tiles) start_qk(t + 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const size_t qrow0 = (size_t(b) * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const bool any = l[r] > 0.f;
    const float inv = any ? 1.f / l[r] : 0.f;
    __nv_bfloat16* orow = o + (qrow0 + qi) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          mma::pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    if (t4 == 0) lse[qrow0 + qi] = any ? m[r] + log2f(l[r]) : kMaskValue;
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const int* kv_mask, void* o,
                 float* lse, int B, int H, int Hkv, int Sq, int Skv, int causal, int offset,
                 float sm_scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = mmt::hopper::make_bf16_map(&q_map, q, B * H, Sq, D, 64);
  if (err == 0) err = mmt::hopper::make_bf16_map(&k_map, k, B * Hkv, Skv, D, wg::kKeys);
  if (err == 0) err = mmt::hopper::make_bf16_map(&v_map, v, B * Hkv, Skv, D, wg::kKeys);
  if (err != 0) return err;
  const int smem = wg::Smem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (Sq + wg::kRows - 1) / wg::kRows);
  flash_fwd_wgmma_kernel<D><<<grid, wg::kThreads, smem, stream>>>(
      q_map, k_map, v_map, kv_mask, static_cast<__nv_bfloat16*>(o), lse, H, Hkv, Sq, Skv, causal,
      offset, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 with at least this many query rows runs on wgmma + TMA (128-row
// tiles); fewer rows (the decode form) on mma.sync (64-row tiles).
constexpr int kWgmmaMinRows = 64;

extern "C" int mmt_flash_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                             void* o, void* lse, int B, int H, int Hkv, int Sq, int Skv, int D,
                             int causal, int offset, float sm_scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* mask = static_cast<const int*>(kv_mask);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && Sq >= kWgmmaMinRows)
    MMT_DISPATCH_HEAD_DIM(D, return launch_wgmma<kD>(q, k, v, mask, o, lse_f, B, H, Hkv, Sq, Skv,
                                                     causal, offset, sm_scale, st));
  if (dtype == 1)
    MMT_DISPATCH_HEAD_DIM(D, return launch_mma<kD>(q, k, v, mask, o, lse_f, B, H, Hkv, Sq, Skv,
                                                   causal, offset, sm_scale, st));
  if (dtype == 0)
    MMT_DISPATCH_HEAD_DIM(D, return launch<kD>(q, k, v, mask, o, lse_f, B, H, Hkv, Sq,
                                                       Skv, causal, offset, sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
