// The grouped-expert layer of a mixture-of-experts decoder: every token's
// top-k SiLU-gated experts, summed with the router's weights,
//   y[t] = sum_j w[t, j] * down_e(silu(gate_e x[t]) * up_e x[t]),  e = ids[t, j].
//
// It replaces no TPU kernel: the JAX package has no expert layer. It was added
// for Mellum2-12B-A2.5B (64 experts of width 896, top-8), whose decode step
// reads every expert that some token chose, and whose prefill multiplies
// hundreds of tokens by each expert.
//
// What bounds it on the H100: bytes. A 128-slot decode step routes 1,024
// assignments over the experts, 16-32 tokens an expert: each touched
// expert's 12.4 MB (3 x 2,304 x 896 bf16) is read for 2 * 3 * D * F FLOPs a
// token, 16-32 FLOPs a byte, far below the ~295 at which the tensor cores
// would limit it. A 1,024-token prefill chunk gives ~128 tokens an expert:
// still bytes (0.24 ms for all 64 experts against 0.10 ms of bf16 FLOPs).
// One SM streams only ~25 GB/s (measured: the time of a partial last wave
// of units is its busiest SM's bytes at that rate), so the card's 3.35 TB/s
// needs nearly every SM streaming until the end of the call.
//
// The design: three launches on one stream, no host synchronisation and a
// grid of one block an SM, so the decode step's CUDA graph captures them:
// - route (one block): counts each expert's assignments, their offsets (an
//   exclusive scan) and the assignments sorted by expert (shared-memory
//   atomics; the order inside an expert varies from run to run, but each
//   output column depends on its own token alone, so the result does not);
//   it zeroes the next launch's counters, and adds the touched experts and
//   the assignments to a device counter that the caller reads back with what
//   it reads anyway;
// - gate-up and down in one persistent launch, `grouped_experts_wgmma_kernel`,
//   that streams the expert weights. The product is taken transposed,
//   h^T = W x^T, so that 64 weight rows are wgmma's A and an expert's few
//   tokens its narrow N. A block of 288 threads, one an SM, takes work units
//   from a queue on the device (an atomic counter): every gate-up unit
//   (expert, 128 rows of F of gate and of up, token tile), then every down
//   unit (expert, 256 rows of D, token tile); token tiles fastest, so the
//   units that share a weight tile run together and the later ones find it
//   in L2. Taking units as they come keeps every SM streaming to the end and
//   lets the down units start while the last gate-up units run; a down unit
//   loads its rows of h once every gate-up tile of its expert has counted
//   itself done (a per-expert counter, release / acquire). Two consumer
//   warpgroups own 128 weight rows each as two m64 accumulators (gate-up: 64
//   rows of gate and the same 64 of up, so silu(g) * u is formed in
//   registers; down: 128 output columns), and one producer warp keeps a ring
//   of stages full and writes each stage's unit beside it. A stage is 64 K
//   values of the tile's 256 weight rows (two 128-row TMA boxes of a 3-D
//   tensor map over (expert, rows, K), 128-byte swizzle) and of its token
//   rows (x gathered by the sorted assignment, or h), copied by cp.async (8
//   lanes a 128-byte row, in the same swizzle) onto the stage's barrier with
//   the TMA bytes (cp.async.mbarrier.arrive). The ring runs on across units,
//   so one unit's epilogue overlaps the next unit's loads; it holds as many
//   stages as shared memory allows (6 at 16 or 32 tokens, 5 at 64: 160-192 KB
//   of weight in flight a block).
//   The token tile T (16, 32 or 64) is the host's, from the call's shape
//   (ops/grouped_experts.py `token_tile`); it sizes the ring's token rows and
//   the accumulators (128 at T = 64 would spill: ptxas gives a 288-thread
//   wgmma block 168 registers). Each unit runs wgmma at the narrowest width
//   of 16, 32 or 64 that holds its rows, so a tile's empty tail costs no
//   tensor work; columns past the rows are never stored.
//   The order of sums: a unit takes all of K, so every output value is one
//   float32 accumulator summed over K in order, and the result is the same
//   on every run. (K is not split: the cells' calls, 128 decode tokens or
//   a prefill chunk, give more work tiles than SMs, and splitting tiles that
//   fill the card was measured slower.)
// - epilogues: gate-up writes silu(g) * u rounded to bf16 (the dense MLP's
//   rounding) in sorted order; down multiplies each column (a token) by its
//   float32 routing weight and writes it to the float32 row of its
//   assignment;
// - combine: each token's k rows summed in slot order, rounded to bf16 once.
#include <cstdint>

#include "flash.cuh"
#include "int8_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mmt::hopper::smem_u32;
namespace fm = mmt::flash::mma;

constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kBK = 64;                    // K values a stage
constexpr int kRowBytes = 2 * kBK;         // a bf16 row of a stage: one 128-byte swizzle row
constexpr int kWRows = 256;                // weight rows a stage, 128 a consumer warpgroup
constexpr int kBoxRows = 128;              // weight rows a TMA box
constexpr int kBoxBytes = kBoxRows * kRowBytes;
constexpr int kWBytes = kWRows * kRowBytes;  // a stage's weight tile: 32 KB
constexpr int kATile = 64 * kRowBytes;       // one wgmma A operand: 64 rows
constexpr int kMaxExperts = 256;
constexpr int kRouteThreads = 1024;
constexpr int kSmemLimit = 232448;
constexpr int kMaxDevices = 64;
constexpr int kConsumerBarrier = 1;  // named barrier of the consumer warpgroups
constexpr int kMaxStages = 16;
// the plan in shared memory: the gate-up units, then all units
constexpr int kPlanInts = 2;
// counters (int32, zeroed by the route kernel): the unit queue, then each
// expert's finished gate-up tiles
constexpr int kQueue = 0, kReady = 1;

template <int kT>
struct Cfg {
  static_assert(kT == 16 || kT == 32 || kT == 64, "token tiles of 16, 32 or 64");
  static constexpr int kXBytes = kT * kRowBytes;  // a multiple of the 1024-byte swizzle atom
  static constexpr int kStageBytes = kWBytes + kXBytes;
  // alignment slack, the barriers, the token-tile starts and counts of
  // kMaxExperts experts, the plan and the stages' units
  static constexpr int kFixed =
      1024 + 2 * kMaxStages * 8 + (2 * kMaxExperts + 1 + kPlanInts + kMaxStages) * 4;
  static constexpr int kFit = (kSmemLimit - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kSmem = kRing + kFixed;
  static_assert(kStages >= 3 && kSmem <= kSmemLimit, "shared memory of one block");
};

struct Args {
  const bf16* x;         // (N, D)
  const int* perm;       // (A): the assignment (t * k + j) of each sorted row
  const int* counts;     // (E)
  const int* offsets;    // (E + 1)
  const float* weights;  // (A) routing weights
  bf16* h;               // (A, F), sorted rows: gate-up's output, down's input
  float* ybuf;           // (A, D), rows of assignments: down's output
  int* counters;         // 1 + E int32, zeroed by the route kernel
  int D, F, E, k;
};

__global__ void __launch_bounds__(kRouteThreads)
grouped_experts_route_kernel(const long long* __restrict__ ids, int A, int E, int* counts,
                             int* offsets, int* perm, int* counters, long long* stats) {
  __shared__ int cnt[kMaxExperts], cur[kMaxExperts];
  for (int e = threadIdx.x; e < E; e += blockDim.x) cnt[e] = 0;
  // the expert launch's queue and per-expert counts, zero before it starts
  for (int i = threadIdx.x; i < kReady + E; i += blockDim.x) counters[i] = 0;
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

// A work unit: GEMM `mode` (0 gate-up, 1 down), expert e, token tile at m0
// (rows of it), the tile of output rows at r0 (gate-up: 128 rows of F, of
// gate and of up; down: 256 rows of D), over all of K.
struct Unit {
  int mode, e, m0, rows, r0;
};

// The plan's shape: each GEMM's K chunks and output-row tiles.
struct Shape {
  int chunks[2], n_rt[2];
};

// Unit u of the plan: the gate-up units, then the down units; in each,
// experts in order, then row tiles, then token tiles (fastest, so the units
// that share a weight tile run together and the later ones find it in L2).
template <int kT>
__device__ __forceinline__ Unit unit_of(int u, const int* tstart, const int* cnt,
                                        const int* plan, int E, const Shape& sh) {
  const int mode = u >= plan[0];
  if (mode) u -= plan[0];
  const int n_rt = sh.n_rt[mode];
  int lo = 0, hi = E - 1;  // the last e with tstart[e] * n_rt <= u
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tstart[mid] * n_rt <= u) lo = mid; else hi = mid - 1;
  }
  const int e = lo, mt = tstart[e + 1] - tstart[e];
  const int idx = u - tstart[e] * n_rt;
  const int m = idx % mt, n = idx / mt;
  return Unit{mode, e, m * kT, min(kT, cnt[e] - m * kT), n * (mode == 0 ? kBoxRows : kWRows)};
}

template <int kN>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (kN == 16) {
    mmt::hopper::wgmma_m64n16_ss(d, a, b, accumulate);
  } else if constexpr (kN == 32) {
    mmt::hopper::wgmma_m64n32_ss(d, a, b, accumulate);
  } else {
    static_assert(kN == 64, "wgmma widths of 16, 32 or 64");
    mmt::hopper::wgmma_m64n64_ss(d, a, b, accumulate);
  }
}

// A consumer warp no longer reads stage s.
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  __syncwarp();
  if (lane == 0) mmt::hopper::mbar_arrive(&empty[s]);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Consumer warpgroup c's part of a unit of GEMM kMode whose token rows fit
// kN columns: the K loop over ring tiles t .. t + nk, then the epilogue.
// kMode 0: gate-up (accumulators 0 and 1: gate and up of rows r0 + 64 c ..);
// kMode 1: down (rows r0 + 128 c .. and + 64 ..).
template <int kMode, int kT, int kN>
__device__ __forceinline__ void run_unit(const Args& a, const Unit& un, int nk,
                                         unsigned char* smem, uint64_t* full, uint64_t* empty,
                                         int t, int c, int lane) {
  using C = Cfg<kT>;
  float acc[2][kN / 2];
  const uint32_t ring = smem_u32(smem);
  const uint32_t a0 = kMode == 0 ? c * kATile : c * 2 * kATile;
  const uint32_t a1 = kMode == 0 ? kBoxBytes + c * kATile : c * 2 * kATile + kATile;
  for (int i = 0; i < nk; ++i) {
    const int tt = t + i, s = tt % C::kStages;
    mmt::hopper::mbar_wait(&full[s], (tt / C::kStages) & 1);
    // the token rows came by cp.async (the generic proxy); wgmma reads
    // shared memory through the async proxy
    mmt::i8w::fence_proxy_async();
    mmt::hopper::wgmma_fence();
    const uint32_t st = ring + s * C::kStageBytes, xb = st + kWBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t bd = mmt::hopper::desc_sw128(xb + kk * 32, 16, 1024);
      const int accumulate = i > 0 || kk > 0;
      wgmma_ss<kN>(acc[0], mmt::hopper::desc_sw128(st + a0 + kk * 32, 16, 1024), bd, accumulate);
      wgmma_ss<kN>(acc[1], mmt::hopper::desc_sw128(st + a1 + kk * 32, 16, 1024), bd, accumulate);
    }
    mmt::hopper::wgmma_commit();
    if (i > 0) {
      mmt::hopper::wgmma_wait<1>();
      release(empty, (tt - 1) % C::kStages, lane);
    }
  }
  mmt::hopper::wgmma_wait<0>();
  mmt::hopper::fence_regs(acc[0]);
  mmt::hopper::fence_regs(acc[1]);
  release(empty, (t + nk - 1) % C::kStages, lane);

  // epilogue: d[4j + 2h + e2] is weight row 16 warp + g + 8 h of the
  // accumulator's 64, token column 8 j + 2 t4 + e2
  const int warp = (threadIdx.x / mmt::kWarpSize) % 4, g = lane / 4, t4 = lane % 4;
  const int off = a.offsets[un.e] + un.m0;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int tok = 8 * j + 2 * t4 + e2;
      if (tok >= un.rows) continue;
      if (kMode == 0) {
        bf16* out = a.h + size_t(off + tok) * a.F;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int f = un.r0 + 64 * c + 16 * warp + g + 8 * hh;
          const float gate = acc[0][4 * j + 2 * hh + e2], up = acc[1][4 * j + 2 * hh + e2];
          if (f < a.F) out[f] = __float2bfloat16_rn(gate / (1.f + __expf(-gate)) * up);
        }
      } else {
        const int asg = a.perm[off + tok];
        const float w = a.weights[asg];
        float* out = a.ybuf + size_t(asg) * a.D;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int d = un.r0 + 128 * c + 64 * i + 16 * warp + g + 8 * hh;
            if (d < a.D) out[d] = acc[i][4 * j + 2 * hh + e2] * w;
          }
      }
    }
  }
  if (kMode == 0) {
    // this gate-up tile's rows of h are written: count it for the expert's
    // down units (release: every thread's stores before thread 0's add)
    mmt::i8w::named_sync(kConsumerBarrier, kConsumers);
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(a.counters + kReady + un.e, 1);
    }
  }
}

template <int kT, int kMode>
__device__ __forceinline__ void run_unit_at_width(const Args& a, const Unit& un, int nk,
                                                  unsigned char* smem, uint64_t* full,
                                                  uint64_t* empty, int t, int c, int lane) {
  // the narrowest wgmma that holds the unit's rows
  if (kT >= 64 && un.rows > 32) {
    run_unit<kMode, kT, (kT >= 64 ? 64 : kT)>(a, un, nk, smem, full, empty, t, c, lane);
  } else if (kT >= 32 && un.rows > 16) {
    run_unit<kMode, kT, (kT >= 32 ? 32 : kT)>(a, un, nk, smem, full, empty, t, c, lane);
  } else {
    run_unit<kMode, kT, 16>(a, un, nk, smem, full, empty, t, c, lane);
  }
}

// Both GEMMs in one launch: h = silu(x G^T) * (x U^T) over 128-row tiles of
// F, then ybuf = w * (h D^T) over 256-row tiles of D. The blocks take units
// from a queue on the device, gate-up's first; a down unit's token rows are
// loaded once every gate-up tile of its expert has written its rows of h.
template <int kT>
__global__ void __launch_bounds__(kThreads, 1)
grouped_experts_wgmma_kernel(const __grid_constant__ CUtensorMap gate_map,
                             const __grid_constant__ CUtensorMap up_map,
                             const __grid_constant__ CUtensorMap down_map, const Args a) {
  using C = Cfg<kT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kRing);
  uint64_t* empty = full + C::kStages;
  int* tstart = reinterpret_cast<int*>(empty + C::kStages);  // kMaxExperts + 1
  int* cnt = tstart + kMaxExperts + 1;                          // kMaxExperts
  int* plan = cnt + kMaxExperts;                                // kPlanInts
  int* stage_unit = plan + kPlanInts;                           // kStages
  const int lane = threadIdx.x % mmt::kWarpSize;
  const Shape sh{{a.D / kBK, a.F / kBK},
                 {(a.F + kBoxRows - 1) / kBoxRows, (a.D + kWRows - 1) / kWRows}};

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mmt::hopper::mbar_init(&full[s], 1 + mmt::kWarpSize);  // TMA bytes + every producer lane
      mmt::hopper::mbar_init(&empty[s], kConsumers / mmt::kWarpSize);
    }
    mmt::hopper::fence_barrier_init();
  }
  if (threadIdx.x < mmt::kWarpSize) {
    // each expert's token tiles, their exclusive prefix (a warp scan over
    // runs of 8 experts a lane) and the plan
    constexpr int kRun = kMaxExperts / mmt::kWarpSize;
    int tiles[kRun], sum = 0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int e = lane * kRun + i, n = e < a.E ? a.counts[e] : 0;
      if (e < a.E) cnt[e] = n;
      tiles[i] = (n + kT - 1) / kT;
      sum += tiles[i];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < mmt::kWarpSize; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (lane * kRun + i < a.E) tstart[lane * kRun + i] = run;
      run += tiles[i];
    }
    if (lane == mmt::kWarpSize - 1) {
      tstart[a.E] = incl;
      plan[0] = incl * sh.n_rt[0];
      plan[1] = incl * (sh.n_rt[0] + sh.n_rt[1]);
    }
  }
  __syncthreads();
  const int units = plan[1];

  if (threadIdx.x >= kConsumers) {
    // the producer warp: lane 0 claims units from the queue (one ahead) and
    // loads each stage's weight tile by TMA; every lane gathers its token
    // rows (row lane / 8 + 4 i, 16-byte chunk lane % 8) by cp.async and
    // arrives once they have landed
    const int q = lane % 8;
    int t = 0, u = 0;
    if (lane == 0) u = atomicAdd(a.counters + kQueue, 1);
    u = __shfl_sync(0xffffffffu, u, 0);
    while (u < units) {
      int next = 0;
      if (lane == 0) next = atomicAdd(a.counters + kQueue, 1);
      const Unit un = unit_of<kT>(u, tstart, cnt, plan, a.E, sh);
      const int base = a.offsets[un.e] + un.m0;
      int row[kT / 4];
#pragma unroll
      for (int i = 0; i < kT / 4; ++i) {
        const int r = lane / 8 + 4 * i;
        row[i] = r < un.rows ? (un.mode == 0 ? a.perm[base + r] / a.k : base + r) : -1;
      }
      const bf16* src = un.mode == 0 ? a.x : a.h;
      const int K = un.mode == 0 ? a.D : a.F;
      const CUtensorMap* m0 = un.mode == 0 ? &gate_map : &down_map;
      const CUtensorMap* m1 = un.mode == 0 ? &up_map : &down_map;
      const int r1 = un.mode == 0 ? un.r0 : un.r0 + kBoxRows;
      if (un.mode == 1) {
        // the expert's rows of h: every gate-up tile of it has finished
        const int want = (tstart[un.e + 1] - tstart[un.e]) * sh.n_rt[0];
        if (lane == 0) {
          for (uint32_t polls = 0; load_acquire(a.counters + kReady + un.e) < want;) {
            if (++polls == (1u << 26)) __trap();
            __nanosleep(64);
          }
          __threadfence();
        }
        __syncwarp();
      }
      for (int kc = 0; kc < sh.chunks[un.mode]; ++kc, ++t) {
        const int s = t % C::kStages;
        mmt::hopper::mbar_wait(&empty[s], ((t / C::kStages) & 1) ^ 1);
        unsigned char* dst = smem + s * C::kStageBytes;
        if (lane == 0) {
          stage_unit[s] = u;
          mmt::hopper::mbar_arrive_expect_tx(&full[s], kWBytes);
          mmt::hopper::tma_load_3d(dst, m0, &full[s], kc * kBK, un.r0, un.e);
          mmt::hopper::tma_load_3d(dst + kBoxBytes, m1, &full[s], kc * kBK, r1, un.e);
        }
        unsigned char* xs = dst + kWBytes;
#pragma unroll
        for (int i = 0; i < kT / 4; ++i) {
          const int r = lane / 8 + 4 * i;
          if (row[i] >= 0)
            mmt::hopper::cp_async16(xs + r * kRowBytes + ((q ^ (r & 7)) << 4),
                                    src + size_t(row[i]) * K + kc * kBK + q * 8);
        }
        mmt::hopper::cp_async_arrive(&full[s]);
      }
      u = __shfl_sync(0xffffffffu, next, 0);
    }
    // no unit left: a stage that tells the consumers so
    const int s = t % C::kStages;
    mmt::hopper::mbar_wait(&empty[s], ((t / C::kStages) & 1) ^ 1);
    if (lane == 0) {
      stage_unit[s] = -1;
      mmt::hopper::mbar_arrive(&full[s]);
    }
    mmt::hopper::cp_async_arrive(&full[s]);
    mmt::hopper::cp_async_commit();
    mmt::hopper::cp_async_wait<0>();
    return;
  }

  const int c = threadIdx.x / 128;
  for (int t = 0;;) {
    // the unit of the next ring tile, written before that tile's arrival
    const int s = t % C::kStages;
    mmt::hopper::mbar_wait(&full[s], (t / C::kStages) & 1);
    const int u = stage_unit[s];
    if (u < 0) break;
    const Unit un = unit_of<kT>(u, tstart, cnt, plan, a.E, sh);
    const int nk = sh.chunks[un.mode];
    if (un.mode == 0) {
      run_unit_at_width<kT, 0>(a, un, nk, smem, full, empty, t, c, lane);
    } else {
      run_unit_at_width<kT, 1>(a, un, nk, smem, full, empty, t, c, lane);
    }
    t += nk;
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

// The number of SMs of device `dev`, queried once a process.
inline int sms_of(int dev) {
  static int sms[kMaxDevices] = {};
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    sms[dev] = n;
  }
  return sms[dev];
}

template <int kT>
int launch(const void* w_gate, const void* w_up, const void* w_down, const Args& a,
           cudaStream_t stream) {
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(grouped_experts_wgmma_kernel<kT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<kT>::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set[dev] = true;
  }
  const int sms = sms_of(dev);
  if (sms < 1) return static_cast<int>(cudaErrorNoDevice);
  CUtensorMap gate, up, down;
  int err = mmt::hopper::make_bf16_map(&gate, w_gate, a.E, a.F, a.D, kBoxRows);
  if (err == 0) err = mmt::hopper::make_bf16_map(&up, w_up, a.E, a.F, a.D, kBoxRows);
  if (err == 0) err = mmt::hopper::make_bf16_map(&down, w_down, a.E, a.D, a.F, kBoxRows);
  if (err != 0) return err;
  grouped_experts_wgmma_kernel<kT><<<sms, kThreads, Cfg<kT>::kSmem, stream>>>(gate, up, down, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, D) bf16; ids (N, k) int64 in [0, E); weights (N, k) float32; w_gate
// and w_up (E, F, D), w_down (E, D, F) bf16; scratch: counts (E) and offsets
// (E + 1), perm (N * k) and counters (1 + E) int32, h (N * k, F) bf16, ybuf
// (N * k, D) float32; stats (2) int64 += (experts with a token, N * k), or
// NULL; y (N, D) bf16. tile_n is the token tile (16, 32 or 64). D a multiple
// of 128, F of 64, 1 <= E <= 256, 1 <= k <= E.
extern "C" int mmt_grouped_experts(const void* x, const void* ids, const void* weights,
                                   const void* w_gate, const void* w_up, const void* w_down,
                                   void* counts, void* offsets, void* perm, void* h, void* ybuf,
                                   void* counters, void* stats, void* y, int N, int D, int F,
                                   int E, int k, int tile_n, void* stream) {
  if (N < 1 || D < 128 || D % 128 != 0 || F < kBK || F % kBK != 0 || E < 1 ||
      E > kMaxExperts || k < 1 || k > E || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int A = N * k;
  grouped_experts_route_kernel<<<1, kRouteThreads, 0, s>>>(
      static_cast<const long long*>(ids), A, E, static_cast<int*>(counts),
      static_cast<int*>(offsets), static_cast<int*>(perm), static_cast<int*>(counters),
      static_cast<long long*>(stats));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const Args a{static_cast<const bf16*>(x), static_cast<const int*>(perm),
               static_cast<const int*>(counts), static_cast<const int*>(offsets),
               static_cast<const float*>(weights), static_cast<bf16*>(h),
               static_cast<float*>(ybuf), static_cast<int*>(counters), D, F, E, k};
  switch (tile_n) {
    case 16: err = launch<16>(w_gate, w_up, w_down, a, s); break;
    case 32: err = launch<32>(w_gate, w_up, w_down, a, s); break;
    case 64: err = launch<64>(w_gate, w_up, w_down, a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const dim3 grid((D / 4 + 255) / 256, N);
  grouped_experts_combine_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(ybuf),
                                                       static_cast<bf16*>(y), N, D, k);
  return static_cast<int>(cudaGetLastError());
}
