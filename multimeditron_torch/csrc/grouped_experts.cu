// The grouped-expert layer of a mixture-of-experts decoder: every token's
// top-k SiLU-gated experts, summed with the router's weights,
//   y[t] = sum_j w[t, j] * down_e(silu(gate_e x[t]) * up_e x[t]),  e = ids[t, j].
//
// It replaces no TPU kernel: the JAX package has no expert layer. It was added
// for Mellum2-12B-A2.5B (64 experts of width 896, top-8), whose decode step
// reads every expert that some token chose, and whose prefill multiplies
// hundreds of tokens by each expert.
//
// What bounds it on the H100: bytes at decode, bytes and then operations at
// prefill. A 128-slot decode step routes 1,024 assignments over 64 experts,
// ~16 tokens an expert: the ~790 MB of a layer's experts are read for
// 2 * 16 * 3 * D * F FLOPs an expert, ~16 FLOPs a byte, far below the ~295 at
// which the tensor cores would limit it. A 1,024-token prefill chunk gives
// ~128 tokens an expert: near the line.
//
// The design: four launches on one stream, no host synchronisation and a
// fixed grid, so the decode step's CUDA graph captures them:
// - route (one block): counts each expert's assignments, their offsets (an
//   exclusive scan) and the assignments sorted by expert (shared-memory
//   atomics; the order inside an expert varies from run to run, but each
//   output row depends on its own input row alone, so the result does not);
//   it adds the touched experts and the assignments to a device counter that
//   the caller reads back with what it reads anyway;
// - gate-up and down: one grouped GEMM kernel each, persistent blocks that
//   take (expert, 64-row tile, column tile) work items in turns. Every block
//   derives the items from the device counts (so the grid never depends on
//   the routing), with the row tiles of one column tile adjacent, so the
//   blocks that share a weight tile run together and find it in L2. A tile
//   is mma.sync m16n8k16 bf16 with f32 sums; K is staged in 64-column slices
//   through a three-stage cp.async ring (rows gathered by the sorted
//   assignments, rows past an expert's count zero-filled). Each of the four
//   warps owns a quarter of the tile's columns and skips the 16-row blocks
//   past the expert's count, so a decode tile (~16 rows) costs one block of
//   rows. Gate-up pairs 64 columns of gate with the same 64 of up and writes
//   silu(g) * u in bf16 (the dense MLP's rounding) in sorted order; down
//   multiplies each row by its routing weight in f32 and writes it to the
//   row of its assignment, in f32;
// - combine: each token's k rows summed in slot order, rounded to bf16 once.
#include <cstdint>

#include "flash.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace fm = mmt::flash::mma;

constexpr int kThreads = 128;
constexpr int kBM = 64;          // rows (assignments of one expert) a tile
constexpr int kBK = 64;          // K columns a stage
constexpr int kBRows = 128;      // weight rows a tile: 64 gate + 64 up, or 128 down
constexpr int kLd = kBK + 8;     // bf16 row stride of a staged slice (conflict-free ldmatrix)
constexpr int kStages = 3;
constexpr int kMaxExperts = 256;
constexpr int kRouteThreads = 1024;
constexpr int kSmemLimit = 232448;

constexpr size_t kStageA = size_t(kBM) * kLd * sizeof(bf16);
constexpr size_t kStageB = size_t(kBRows) * kLd * sizeof(bf16);
constexpr size_t kSmem = kStages * (kStageA + kStageB);

struct Args {
  const bf16* x;        // (N, D)
  const int* perm;      // (A): the assignment (t * k + j) of each sorted row
  const int* counts;    // (E)
  const int* offsets;   // (E + 1)
  const float* weights; // (A) routing weights
  const bf16* w0;       // gate (E, F, D) | down (E, D, F)
  const bf16* w1;       // up (E, F, D)   | unused
  bf16* h;              // (A, F), sorted rows
  float* ybuf;          // (A, D), rows of assignments
  int N, D, F, E, k;
};

__global__ void __launch_bounds__(kRouteThreads)
grouped_experts_route_kernel(const long long* __restrict__ ids, int A, int E, int* counts,
                             int* offsets, int* perm, long long* stats) {
  __shared__ int cnt[kMaxExperts], cur[kMaxExperts];
  for (int e = threadIdx.x; e < E; e += blockDim.x) cnt[e] = 0;
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x)
    atomicAdd(&cnt[mmt::clamp_int(ids[a], 0, E - 1)], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0, touched = 0;
    for (int e = 0; e < E; ++e) {
      cur[e] = acc;
      offsets[e] = acc;
      acc += cnt[e];
      touched += cnt[e] > 0;
    }
    offsets[E] = acc;
    if (stats != nullptr) {
      stats[0] += touched;
      stats[1] += A;
    }
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) counts[e] = cnt[e];
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x)
    perm[atomicAdd(&cur[mmt::clamp_int(ids[a], 0, E - 1)], 1)] = a;
}

// One K slice of a tile into a stage: rows [m0, m0 + rows) of the expert's
// sorted block (gathered token rows of x, or rows of h), zero past `rows`;
// the tile's 128 weight rows.
template <int kMode>
__device__ __forceinline__ void load_stage(const Args& a, bf16* sa, bf16* sb, int e, int off,
                                           int m0, int rows, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < kBM * (kBK / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const bool valid = r < rows;
    const bf16* src = a.x;
    if (valid) {
      src = kMode == 0 ? a.x + size_t(a.perm[off + m0 + r] / a.k) * a.D
                       : a.h + size_t(off + m0 + r) * a.F;
      src += k0 + col;
    }
    mmt::hopper::cp_async16(sa + r * kLd + col, src, valid);
  }
#pragma unroll
  for (int i = 0; i < kBRows * (kBK / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const bf16* src;
    if (kMode == 0) {
      const bf16* w = r < kBRows / 2 ? a.w0 : a.w1;
      src = w + (size_t(e) * a.F + n0 + (r % (kBRows / 2))) * a.D;
    } else {
      src = a.w0 + (size_t(e) * a.D + n0 + r) * a.F;
    }
    mmt::hopper::cp_async16(sb + r * kLd + col, src + k0 + col);
  }
}

// kMode 0: h = silu(x G^T) * (x U^T) over 64-column tiles of F; kMode 1:
// ybuf = w * (h D^T) over 128-column tiles of D.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
grouped_experts_gemm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = reinterpret_cast<bf16*>(smem + kStages * kStageA);
  __shared__ int tile_start[kMaxExperts + 1];
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int g = lane / 4, t = lane % 4;
  const int K = kMode == 0 ? a.D : a.F;
  const int n_cols = kMode == 0 ? a.F / (kBRows / 2) : a.D / kBRows;  // column tiles
  const int KT = K / kBK;

  if (threadIdx.x == 0) {
    int acc = 0;
    for (int e = 0; e < a.E; ++e) {
      tile_start[e] = acc;
      acc += (a.counts[e] + kBM - 1) / kBM * n_cols;
    }
    tile_start[a.E] = acc;
  }
  __syncthreads();
  const int total = tile_start[a.E];

  // this warp's two 16-row blocks of the staged weight rows
  const int b_lo = kMode == 0 ? 16 * warp : 32 * warp;
  const int b_hi = kMode == 0 ? kBRows / 2 + 16 * warp : 32 * warp + 16;

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int lo = 0, hi = a.E - 1;  // the expert: the last e with tile_start[e] <= tile
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
    }
    const int e = lo, n_e = a.counts[e], off = a.offsets[e];
    const int mt = (n_e + kBM - 1) / kBM, idx = tile - tile_start[e];
    const int m0 = (idx % mt) * kBM, rows = min(kBM, n_e - m0);
    const int n0 = (idx / mt) * (kMode == 0 ? kBRows / 2 : kBRows);
    const int m_blocks = (rows + 15) / 16;

    float acc[4][4][4];
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mb][j][c] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT)
        load_stage<kMode>(a, sa + s * (kStageA / sizeof(bf16)), sb + s * (kStageB / sizeof(bf16)),
                          e, off, m0, rows, n0, s * kBK);
      mmt::hopper::cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      mmt::hopper::cp_async_wait<kStages - 2>();
      __syncthreads();  // slice kt landed for all; slice kt - 1's stage is free
      const int nxt = kt + kStages - 1;
      if (nxt < KT) {
        const int s = nxt % kStages;
        load_stage<kMode>(a, sa + s * (kStageA / sizeof(bf16)), sb + s * (kStageB / sizeof(bf16)),
                          e, off, m0, rows, n0, nxt * kBK);
      }
      mmt::hopper::cp_async_commit();
      const bf16* A = sa + (kt % kStages) * (kStageA / sizeof(bf16));
      const bf16* B = sb + (kt % kStages) * (kStageB / sizeof(bf16));
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t blo[4], bhi[4];
        fm::ldmatrix_x4(blo, B + (b_lo + (lane & 7) + ((lane >> 4) << 3)) * kLd + 16 * kk +
                                 ((lane >> 3) & 1) * 8);
        fm::ldmatrix_x4(bhi, B + (b_hi + (lane & 7) + ((lane >> 4) << 3)) * kLd + 16 * kk +
                                 ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mb = 0; mb < 4; ++mb) {
          if (mb < m_blocks) {
            uint32_t af[4];
            fm::ldmatrix_x4(af, A + (16 * mb + (lane & 15)) * kLd + 16 * kk + (lane >> 4) * 8);
            fm::mma_bf16(acc[mb][0], af, blo[0], blo[1]);
            fm::mma_bf16(acc[mb][1], af, blo[2], blo[3]);
            fm::mma_bf16(acc[mb][2], af, bhi[0], bhi[1]);
            fm::mma_bf16(acc[mb][3], af, bhi[2], bhi[3]);
          }
        }
      }
    }
    mmt::hopper::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring before the next tile refills it

#pragma unroll
    for (int mb = 0; mb < 4; ++mb) {
      if (mb >= m_blocks) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mb + g + 8 * half;
        if (r >= rows) continue;
        if (kMode == 0) {
          bf16* out = a.h + size_t(off + m0 + r) * a.F + n0 + 16 * warp + 2 * t;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float gate = acc[mb][j][2 * half + c], up = acc[mb][2 + j][2 * half + c];
              v[c] = gate / (1.f + __expf(-gate)) * up;
            }
            *reinterpret_cast<uint32_t*>(out + 8 * j) = fm::pack_bf16(v[0], v[1]);
          }
        } else {
          const int asg = a.perm[off + m0 + r];
          const float w = a.weights[asg];
          float* out = a.ybuf + size_t(asg) * a.D + n0 + 32 * warp + 2 * t;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float2*>(out + 8 * j) =
                make_float2(acc[mb][j][2 * half] * w, acc[mb][j][2 * half + 1] * w);
        }
      }
    }
  }
}

// y[t] = bf16(sum_j ybuf[t * k + j]), four columns a thread.
__global__ void __launch_bounds__(256)
grouped_experts_combine_kernel(const float* __restrict__ ybuf, bf16* __restrict__ y, int N,
                               int D, int k) {
  const int t = blockIdx.y, c = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (t >= N || c >= D) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < k; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(ybuf + (size_t(t) * k + j) * D + c);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  uint2 out;
  out.x = fm::pack_bf16(s.x, s.y);
  out.y = fm::pack_bf16(s.z, s.w);
  *reinterpret_cast<uint2*>(y + size_t(t) * D + c) = out;
}

template <int kMode>
int launch_gemm(const Args& a, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(grouped_experts_gemm_kernel<kMode>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return static_cast<int>(cudaErrorNoDevice);
  }
  int per_sm = static_cast<int>(kSmemLimit / (kSmem + 2048));
  per_sm = per_sm < 1 ? 1 : per_sm;
  grouped_experts_gemm_kernel<kMode><<<sms * per_sm, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, D) bf16; ids (N, k) int64 in [0, E); weights (N, k) float32; w_gate
// and w_up (E, F, D), w_down (E, D, F) bf16; scratch: counts (E) and offsets
// (E + 1) and perm (N * k) int32, h (N * k, F) bf16, ybuf (N * k, D) float32;
// stats (2) int64 += (experts with a token, N * k), or NULL; y (N, D) bf16.
// D a multiple of 128, F of 64, 1 <= E <= 256, 1 <= k <= E.
extern "C" int mmt_grouped_experts(const void* x, const void* ids, const void* weights,
                                   const void* w_gate, const void* w_up, const void* w_down,
                                   void* counts, void* offsets, void* perm, void* h, void* ybuf,
                                   void* stats, void* y, int N, int D, int F, int E, int k,
                                   void* stream) {
  if (N < 1 || D < kBRows || D % kBRows != 0 || F < kBK || F % kBK != 0 || E < 1 ||
      E > kMaxExperts || k < 1 || k > E)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int A = N * k;
  grouped_experts_route_kernel<<<1, kRouteThreads, 0, s>>>(
      static_cast<const long long*>(ids), A, E, static_cast<int*>(counts),
      static_cast<int*>(offsets), static_cast<int*>(perm), static_cast<long long*>(stats));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  Args a{static_cast<const bf16*>(x), static_cast<const int*>(perm),
         static_cast<const int*>(counts), static_cast<const int*>(offsets),
         static_cast<const float*>(weights), static_cast<const bf16*>(w_gate),
         static_cast<const bf16*>(w_up), static_cast<bf16*>(h), static_cast<float*>(ybuf),
         N, D, F, E, k};
  if ((err = launch_gemm<0>(a, s)) != 0) return err;
  a.w0 = static_cast<const bf16*>(w_down);
  a.w1 = nullptr;
  if ((err = launch_gemm<1>(a, s)) != 0) return err;
  const dim3 grid((D / 4 + 255) / 256, N);
  grouped_experts_combine_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(ybuf),
                                                       static_cast<bf16*>(y), N, D, k);
  return static_cast<int>(cudaGetLastError());
}
