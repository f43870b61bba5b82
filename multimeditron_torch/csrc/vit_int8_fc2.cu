// K7e: the fused W8A8 ViT tower's fc2 with the residual and the next
// layer's LayerNorm, on int8 wgmma + TMA: x'' = acc * (ws * s3) + b + x_res,
// written in x_res's dtype, and xq = quant(LN(x''), 1 / s0_next) int8.
//
// Replaces `_fc2_ln_kernel` (multimeditron_tpu/ops/vit_int8_fused.py:166,
// reached through `fc2_res_ln_quant` :639), and, for K7c with an int8 o, the
// same body after the attention output projection, `_oproj_ln_kernel`
// (:128, reached through `oproj_ln_quant` :556), at K = D. K7c with a float o
// keeps `res_ln_quant_kernel` in vit_int8_rowln.cu (TMA cannot quantise as
// it loads), and so does K7f's tail.
//
// What bounds it on the H100: operations. At the ViT-L/14 encode shape
// (M = 65,792, K = 4096, D = 1024) a call is 5.5e11 int8 operations, 0.2789
// ms at 1,979 TOPS, against 0.61 GB of device-memory traffic (0.18 ms); K7c
// at K = 1024 is bound by bytes (1.4e11 operations, 0.07 ms, against 0.40
// GB, 0.12 ms: bytes that the epilogue below moves). The LayerNorm needs a
// whole row of x'', so a block that owns full rows (as vit_int8_rowln.cu's
// res_ln_quant_kernel does: 32 rows x all D columns) re-reads the whole 4 MB weight
// from L2 for every 32 rows: 8.4 GB a call.
//
// The design: a row block of BM = 128 rows (64 where there are too few row
// blocks to fill the card) is one thread-block cluster of D / 256 blocks
// (D = 1024: 4; 768: 3; 256: 1; D = 128: one block of 128 columns). Block r
// owns columns [256 r, 256 r + 256) and loads only that slice of the weight,
// so the weight is read M / 128 times (2.1 GB of L2 reads at the encode
// shape, with 1.1 GB of activations, each block reading its row block's).
// Each block: warpgroup 0 loads (one warp keeps a ring of four 48 KB stages
// of 128 bytes of K full by TMA; setmaxnreg gives its registers up), one or
// two consumer warpgroups multiply (wgmma m64n256k32 or m64n128k32, s8 x s8
// -> s32, 64 rows each; a 64-row block's third warpgroup idles). The
// accumulators then go to the spent ring in shared memory, and the epilogue
// runs one warp a row: x'' (written, and kept in shared memory), its row
// sums, the LayerNorm and the int8 row, with contiguous global accesses. The
// LayerNorm is taken across the cluster through distributed shared memory:
// each block writes its rows' partial sums, the cluster barrier passes,
// every block reads all D / 256 partials in rank order (the same mean in
// every block), then the same for the sum of (x'' - mean)^2. (A ring that
// multicast the activation tile to the whole cluster read 0.8 GB less from
// L2 and measured slower: every stage waited for all four blocks.)
//
// Rounding follows the Pallas body op for op (int8_mma.cuh): fmaf(acc,
// ws * s, b), then the residual with __fadd_rn; the LayerNorm of the f32
// x'' (not of the stored bf16); 1 / sqrt by __frcp_rn (the same bits as
// __fdiv_rn(1, x)); the int8 rounding by quant2 (int8_wgmma.cuh: the same
// values as quant). Only the LayerNorm's sums run in another order than the
// reference's, in a fixed one: two runs are bitwise equal. TMA reads zeros
// past M and K, so any M >= 1 and K % 64 == 0 run.
#include "int8_wgmma.cuh"

namespace {

using namespace mmt::i8w;

// kBN columns a block, kC blocks a cluster (D = kBN kC), kWG consumer
// warpgroups (BM = 64 kWG rows).
template <int kBN, int kC, int kWG>
struct Plan {
  static constexpr int kD = kBN * kC;
  static constexpr int kBM = 64 * kWG;
  // Three warpgroups whatever kWG: with one consumer the third idles, so
  // that ptxas starts every thread at 168 registers, below the consumers'
  // setmaxnreg budget (m64n256k32 alone needs 128 accumulators).
  static constexpr int kThreads = 3 * 128;
  using RingT = Ring<kBN, kBM>;  // the weight slice, then the row block's activations
  static constexpr int kStages = 196608 / RingT::kStageBytes;
  static constexpr int kRed = kStages * RingT::kStageBytes;  // row sums, then squares
  // the epilogue's rows of accumulators, then of x'', over the spent ring
  // (a stride of kBN + 8 words: the accumulators' 8-byte stores do not
  // conflict)
  static constexpr int kLdX = kBN + 8;
  static_assert(kBM * kLdX * 4 <= kRed, "the epilogue's rows fit the ring");
  static constexpr int kBars = kRed + 2 * kBM * 4;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // + room to align to 1024
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// Four consecutive values as float (16 bytes of float, 8 of bf16), and back.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ float at(float4 v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// The sum of a warp's 32 values, the same bits in every lane (a butterfly:
// each step adds the same two partial sums in every lane, in either order).
__device__ __forceinline__ float warp_total(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// x / D rounded to nearest: a multiplication where D is a power of two (the
// same bits, without the division's slow-path branch).
template <int D>
__device__ __forceinline__ float divide_by(float x) {
  if constexpr ((D & (D - 1)) == 0) {
    return __fmul_rn(x, 1.f / D);
  } else {
    return __fdiv_rn(x, float(D));
  }
}

// The cluster's total of the partials at red[row] in every block, in rank
// order.
template <int kC>
__device__ __forceinline__ float cluster_total(const float* red) {
  if constexpr (kC == 1) {
    return *red;
  } else {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kC; ++r) total = __fadd_rn(total, ld_cluster_f32(map_rank(red, r)));
    return total;
  }
}

template <int kBN, int kC, int kWG, typename T>
__global__ void __launch_bounds__(Plan<kBN, kC, kWG>::kThreads, 1)
fc2_res_ln_quant_kernel(const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap w_map, const float* __restrict__ ws,
                        const float* __restrict__ bias, const T* __restrict__ xres,
                        const float* __restrict__ lnw, const float* __restrict__ lnb,
                        T* __restrict__ xout, int8_t* __restrict__ xq, int M, int K, float s,
                        float inv_s, float eps) {
  using P = Plan<kBN, kC, kWG>;
  constexpr int D = P::kD, kLdX = P::kLdX;
  constexpr int kWarps = 4 * kWG, kRowsPerWarp = P::kBM / kWarps, kCols = kBN / 32;
  constexpr int kConsumerBarrier = 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  float* red = reinterpret_cast<float*>(smem + P::kRed);
  int* xs = reinterpret_cast<int*>(smem);
  const typename P::RingT ring{smem, full, full + P::kStages, P::kStages};
  const int rank = kC == 1 ? 0 : cluster_rank();
  const int m0 = (blockIdx.x / kC) * P::kBM, n0 = rank * kBN;
  const int n_k = (K + kRowBytes - 1) / kRowBytes;
  const int lane = threadIdx.x % mmt::kWarpSize;
  if (threadIdx.x == 0) {
    ring.init(4 * kWG);
    mmt::hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128 || threadIdx.x >= 128 * (kWG + 1)) {  // the producer, or idle
    MMT_I8W_PRODUCER_REGS();
    if (threadIdx.x < mmt::kWarpSize) {
      for (int kb = 0; kb < n_k; ++kb) {
        ring.wait_empty(kb);
        if (lane == 0) ring.load(kb, &w_map, n0, &a_map, m0, kb * kRowBytes);
        __syncwarp();
      }
    }
    // the consumers' three cluster barriers: sums, squares, done reading
    cluster_sync();
    cluster_sync();
    cluster_sync();
    return;
  }

  MMT_I8W_CONSUMER_REGS();
  const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x / mmt::kWarpSize) % 4;
  {
    int acc[1][kBN / 2];
    mainloop<1, kBN>(acc, ring, 0, n_k, P::RingT::kYOffset + c * 64 * kRowBytes, 0, lane);
    // The accumulators go to the spent ring (both K loops are done with it),
    // so that the epilogue runs row by row: coalesced global accesses and
    // few registers.
    named_sync(kConsumerBarrier, 128 * kWG);
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(xs + (64 * c + 16 * warp + g + 8 * h) * kLdX + 8 * j + 2 * t4) =
            make_int2(acc[0][4 * j + 2 * h], acc[0][4 * j + 2 * h + 1]);
    named_sync(kConsumerBarrier, 128 * kWG);
  }

  // Warp w takes rows w, w + kWarps, ...; lane l columns n0 + 4 l + 128 k + e
  // (k < kBN / 128, e < 4), so a warp's access to a row is contiguous.
  const int w = threadIdx.x / mmt::kWarpSize - 4;
  float sc[kCols], bi[kCols];
#pragma unroll
  for (int k = 0; k < kCols / 4; ++k) {
    const float4 w4 = load4(ws + n0 + 4 * lane + 128 * k), b4 = load4(bias + n0 + 4 * lane + 128 * k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * k + e] = __fmul_rn(at(w4, e), s);
      bi[4 * k + e] = at(b4, e);
    }
  }

  // x'' = fmaf(acc, ws * s, b) + x_res: stored, written over the row's
  // accumulators, and summed for the mean. The warp's residual rows are all
  // read first. No branch on M: rows past it read a zero residual, store
  // nothing, and their sums are never read.
  float4 res[kRowsPerWarp][kCols / 4];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int row = m0 + w + kWarps * q;
#pragma unroll
    for (int k = 0; k < kCols / 4; ++k)
      res[q][k] = row < M ? load4(xres + size_t(row) * D + n0 + 4 * lane + 128 * k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int r = w + kWarps * q, row = m0 + r;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kCols / 4; ++k) {
      const int col = 4 * lane + 128 * k;
      int* at_x = xs + r * kLdX + col;
      const int4 a = *reinterpret_cast<const int4*>(at_x);
      float4 x;
      x.x = __fadd_rn(fmaf(static_cast<float>(a.x), sc[4 * k], bi[4 * k]), res[q][k].x);
      x.y = __fadd_rn(fmaf(static_cast<float>(a.y), sc[4 * k + 1], bi[4 * k + 1]), res[q][k].y);
      x.z = __fadd_rn(fmaf(static_cast<float>(a.z), sc[4 * k + 2], bi[4 * k + 2]), res[q][k].z);
      x.w = __fadd_rn(fmaf(static_cast<float>(a.w), sc[4 * k + 3], bi[4 * k + 3]), res[q][k].w);
      if (row < M) store4(xout + size_t(row) * D + n0 + col, x);
      *reinterpret_cast<float4*>(at_x) = x;
#pragma unroll
      for (int e = 0; e < 4; ++e) sum = __fadd_rn(sum, at(x, e));
    }
    sum = warp_total(sum);
    if (lane == 0) red[r] = sum;
  }
  cluster_sync();

  // The mean from every block's partial sums; the variance the same way.
  // Every row's sums are read before any division: a division's (and a
  // square root's) slow-path branch would otherwise wait on each row's
  // remote loads in turn.
  float mean[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) mean[q] = cluster_total<kC>(red + w + kWarps * q);
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) mean[q] = divide_by<D>(mean[q]);
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int r = w + kWarps * q;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kCols / 4; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(xs + r * kLdX + 4 * lane + 128 * k);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = __fsub_rn(at(x, e), mean[q]);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
    sq = warp_total(sq);
    if (lane == 0) red[P::kBM + r] = sq;
  }
  cluster_sync();
  float rstd[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) rstd[q] = cluster_total<kC>(red + P::kBM + w + kWarps * q);
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q)
    rstd[q] = __frcp_rn(sqrtf(__fadd_rn(divide_by<D>(rstd[q]), eps)));
  cluster_arrive();  // this block no longer reads its peers' sums

  float lw[kCols], lb[kCols];
#pragma unroll
  for (int k = 0; k < kCols / 4; ++k) {
    const float4 w4 = load4(lnw + n0 + 4 * lane + 128 * k), b4 = load4(lnb + n0 + 4 * lane + 128 * k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lw[4 * k + e] = at(w4, e);
      lb[4 * k + e] = at(b4, e);
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int r = w + kWarps * q, row = m0 + r;
#pragma unroll
    for (int k = 0; k < kCols / 4; ++k) {
      const int col = 4 * lane + 128 * k;
      const float4 x = *reinterpret_cast<const float4*>(xs + r * kLdX + col);
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = fmaf(__fmul_rn(__fsub_rn(at(x, e), mean[q]), rstd[q]), lw[4 * k + e], lb[4 * k + e]);
      if (row < M)
        *reinterpret_cast<uint32_t*>(xq + size_t(row) * D + n0 + col) =
            quant2(y[0], y[1], inv_s) | (uint32_t(quant2(y[2], y[3], inv_s)) << 16);
    }
  }
  cluster_wait();  // ... nor do its peers read its sums: it may leave
}

template <int kBN, int kC, int kWG, typename T>
int launch(const void* a, const void* w, const void* ws, const void* bias, const void* xres,
           const void* lnw, const void* lnb, void* xout, void* xq, int M, int K, float s,
           float inv_s, float eps, cudaStream_t stream) {
  using P = Plan<kBN, kC, kWG>;
  CUtensorMap a_map, w_map;
  int err = make_int8_map(&a_map, a, M, K, P::kBM);
  if (err == 0) err = make_int8_map(&w_map, w, P::kD, K, kBN);
  if (err != 0) return err;
  auto kernel = fc2_res_ln_quant_kernel<kBN, kC, kWG, T>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC * ((M + P::kBM - 1) / P::kBM));
  cfg.blockDim = dim3(P::kThreads);
  cfg.dynamicSmemBytes = P::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a_map, w_map, static_cast<const float*>(ws),
                         static_cast<const float*>(bias), static_cast<const T*>(xres),
                         static_cast<const float*>(lnw), static_cast<const float*>(lnb),
                         static_cast<T*>(xout), static_cast<int8_t*>(xq), M, K, s, inv_s, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// 128-row blocks when they fill the card at least once, else 64-row ones
// (the serving batch: M = 2,056 at D = 1024 is 68 clusters' blocks of 128
// rows on 132 SMs, 132 of 64).
template <int kBN, int kC, typename T>
int launch_rows(const void* a, const void* w, const void* ws, const void* bias, const void* xres,
                const void* lnw, const void* lnb, void* xout, void* xq, int M, int K, float s,
                float inv_s, float eps, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorNoDevice);
  return (M + 127) / 128 * kC >= sms
             ? launch<kBN, kC, 2, T>(a, w, ws, bias, xres, lnw, lnb, xout, xq, M, K, s, inv_s,
                                     eps, stream)
             : launch<kBN, kC, 1, T>(a, w, ws, bias, xres, lnw, lnb, xout, xq, M, K, s, inv_s,
                                     eps, stream);
}

}  // namespace

// hq (M, K) int8, w (D, K) int8, ws / bias / lnw / lnb (D,) float, xres (M, D)
// float or bf16 -> xout (M, D) in xres's dtype, xq (M, D) int8. D is 128,
// 256, 768 or 1024.
extern "C" int mmt_int8_fc2_res_ln_quant(const void* a, const void* w, const void* ws,
                                         const void* bias, const void* xres, const void* lnw,
                                         const void* lnb, void* xout, void* xq, int M, int K,
                                         int D, float s, float inv_s, float eps, int dtype,
                                         void* stream) {
  if (M < 1 || K < 64 || K % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MMT_DISPATCH_DTYPE(dtype, {
    switch (D) {
      case 128:
        return launch_rows<128, 1, scalar_t>(a, w, ws, bias, xres, lnw, lnb, xout, xq, M, K, s,
                                             inv_s, eps, st);
      case 256:
        return launch_rows<256, 1, scalar_t>(a, w, ws, bias, xres, lnw, lnb, xout, xq, M, K, s,
                                             inv_s, eps, st);
      case 768:
        return launch_rows<256, 3, scalar_t>(a, w, ws, bias, xres, lnw, lnb, xout, xq, M, K, s,
                                             inv_s, eps, st);
      case 1024:
        return launch_rows<256, 4, scalar_t>(a, w, ws, bias, xres, lnw, lnb, xout, xq, M, K, s,
                                             inv_s, eps, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}
