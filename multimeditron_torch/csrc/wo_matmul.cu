// K9: the weight-only int8 matmul of the quantised Llama decoder,
// out = (x @ widen(w_q)) * w_s with float32 accumulation and one cast.
//
// Replaces multimeditron_tpu/ops/wo_matmul.py `_wo_kernel` (:31, reached
// through `wo_matmul_pallas` :47): widen the int8 weight to the activation's
// type, take the product with float32 accumulation, scale each column, cast
// once. x is (M, K) float32 or bf16, w_q (N, K) int8 with K contiguous (one
// row per output column), w_s (N,) float32, out (M, N) in x's type.
//
// What bounds it on the H100: bytes at decode and verify, operations at
// prefill. A Llama-3.1-8B decode step (M = 8) streams 7.50 GB of int8
// weights through its 129 calls: 2.24 ms at 3.35 TB/s; a W8A16 prefill of
// 8 x 512 rows (M = 4,096) is 5.72e13 bf16 operations: 57.8 ms at 989
// TFLOP/s.
//
// The design (bf16): the product is taken transposed, out^T = W x^T, so
// that the weight is wgmma's register operand A and the few tokens of a
// decode step are its narrow N. A block of 288 threads, one an SM, walks a
// persistent list of work units (token tile, 128-column tile, K split): two
// consumer warpgroups own 64 output columns each, one producer warp keeps a
// ring of stages full by TMA. A stage is 64 K values of the tile's tokens
// (bf16, 128-byte swizzle, K-major: wgmma's B straight from shared memory)
// and of its 128 weight rows (int8, 64-byte swizzle). A consumer thread
// reads its A fragments' bytes from the weight tile with 4-byte shared
// loads (conflict-free under the swizzle) and widens int8 -> bf16 in
// registers (exact: |w| <= 127) by byte permutes and one float32
// subtraction, not the conversion units (`widen2`); the fragments of two
// stages alternate, so that one stage's conversion overlaps the previous
// stage's wgmma. The token tile is 8, 16, 32 or 64 at decode and verify (one
// m64nNk16 a k-step, the k-steps of a stage spread over up to four
// independent accumulators: at small N one chain's latency, not the tensor
// cores, set the pace) and 128 or 256 at prefill; the ring holds as many
// stages as fit (16 at decode: 128 KB of weight in flight a block; 5 at 256
// tokens).
//
// K splits (decode and verify, where the column tiles alone cannot fill
// the card) are summed inside the same launch: every unit of a split tile
// writes its float32 accumulators to a workspace, and the last to arrive at
// the tile's counter (an atomic) sums the slices in split order, then
// scales, casts and stores; it resets the counter to 0, so the counters
// stay zeroed between calls. One launch a call, the same result on every
// run. The split count comes from the wrapper (ops/wo_matmul.py `split_k`).
// The epilogue multiplies each accumulator row (an output column) by its
// scale, casts once, transposes the tile through shared memory and stores
// 16-byte rows of tokens (element stores where N % 8 != 0). Tokens past M
// and columns past N read as zeros (TMA) and are never stored. Measured and
// dropped (NVIDIA H100 80GB HBM3, 700 W): two blocks an SM at decode (a
// slower decode step, and spills); a balanced (stream-K) schedule that gave
// every SM an equal run of all tiles' chunks (no faster at decode: the
// card's streaming rate, not the last round, bounds a call; and spills at
// 256 tokens); four wgmma groups in flight at decode instead of two (slower);
// at prefill a two-block cluster whose blocks multicast halves of the token
// tile (1.5x slower).
// float32 activations run on the CUDA cores: a 64 x 64 tile a block of 256
// threads, 4 x 4 outputs a thread.
#include <stdint.h>

#include "int8_wgmma.cuh"

namespace {

using mmt::hopper::smem_u32;

constexpr int kBK = 64;                 // K values a stage
constexpr int kBN = 128;                // output columns a block, 64 a consumer warpgroup
constexpr int kWRow = kBK;              // bytes of a weight row in a stage (int8)
constexpr int kXRow = 2 * kBK;          // bytes of a token row in a stage (bf16)
constexpr int kConsumers = 256;         // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kEpiRows = 64;            // tokens a pass of the transposing epilogue
constexpr int kEpiLd = 72;              // its bf16 row stride: 144 bytes, conflict-free
constexpr int kSmemLimit = 232448;
constexpr int kMaxDevices = 64;
constexpr float kBias = 8388736.f;      // 2^23 + 128

// Named barriers (0 is __syncthreads, which the early exit of the producer
// rules out): 1 + c is consumer warpgroup c's own, 3 both warpgroups'.
constexpr int kWgBarrier = 1, kConsumerBarrier = 3;

template <int kN>
struct Cfg {
  // independent accumulators a consumer thread keeps (k-step kk adds into
  // set kk % kAcc; the sets are summed in order at the end of a unit): at
  // small N a wgmma's latency, not its work, sets the pace of one chain
  static constexpr int kAcc = kN <= 16 ? 4 : (kN <= 64 ? 2 : 1);
  // split slices whose loads the last unit keeps in flight at once
  static constexpr int kSumGroup = kN <= 8 ? 4 : (kN <= 16 ? 2 : 1);
  static constexpr int kXBytes = kN * kXRow;           // a multiple of 1024
  static constexpr int kStageBytes = kXBytes + kBN * kWRow;
  static constexpr int kEpiPass = kN < kEpiRows ? kN : kEpiRows;
  static constexpr int kEpiBytes = 2 * kEpiPass * kEpiLd * 2;
  static constexpr int kFixed = kEpiBytes + 1024 + 512;  // alignment, barriers, flag
  static constexpr int kFit = (kSmemLimit - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 16 ? kFit : 16;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kSmem = kRing + kFixed;
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "shared memory of one block");
};

#define MMT_WO_D16(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7]), "+f"(d[i + 8]), "+f"(d[i + 9]), "+f"(d[i + 10]),         \
      "+f"(d[i + 11]), "+f"(d[i + 12]), "+f"(d[i + 13]), "+f"(d[i + 14]), "+f"(d[i + 15])

// D (64 x N, f32) (+)= A (64 x 16, registers: each warp's 16 rows as the
// mma.m16n8k16 A fragment) B (16 x N, shared, K-major); D is overwritten
// when `accumulate` is 0. d[4j + e] holds row 16w + g + 8 (e / 2), column
// 8j + 2t + e % 2.
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : MMT_WO_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : MMT_WO_D16(0), MMT_WO_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : MMT_WO_D16(0), MMT_WO_D16(16), MMT_WO_D16(32), MMT_WO_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : MMT_WO_D16(0), MMT_WO_D16(16), MMT_WO_D16(32), MMT_WO_D16(48), MMT_WO_D16(64), MMT_WO_D16(80), MMT_WO_D16(96), MMT_WO_D16(112)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef MMT_WO_D16

template <int kN>
__device__ __forceinline__ void wgmma_rs(float (&d)[kN / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (kN == 8) {
    wgmma_rs_n8(d, a, b, accumulate);
  } else if constexpr (kN == 16) {
    wgmma_rs_n16(d, a, b, accumulate);
  } else if constexpr (kN == 32) {
    wgmma_rs_n32(d, a, b, accumulate);
  } else if constexpr (kN == 64) {
    wgmma_rs_n64(d, a, b, accumulate);
  } else if constexpr (kN == 128) {
    wgmma_rs_n128(d, a, b, accumulate);
  } else {
    static_assert(kN == 256, "token tiles of 8, 16, 32, 64, 128 or 256");
    wgmma_rs_n256(d, a, b, accumulate);
  }
}

// Two int8 of `word` (bytes sel & 3 and sel & 3 + 1), widened to a bf16
// pair exactly without the conversion units: the byte, biased to u = b +
// 128, goes into the mantissa of 2^23 (0x4B0000uu = 2^23 + u); one
// subtraction of 2^23 + 128 leaves b as a float32 whose low 16 bits are
// zero (|b| <= 128), so its high half is b in bf16. `sel` is 0x7540 plus
// the first byte's index.
__device__ __forceinline__ uint32_t widen2(uint32_t word, uint32_t sel) {
  const uint32_t u = word ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel + 1)) - kBias;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// The A fragments of a stage's four k-steps: k-step kk's a0 / a2 are K
// values 16 kk + 2t, +1 / 16 kk + 2t + 8, +9 of weight row r (a1 / a3 of
// row r + 8). `w` points at the stage's weight tile + r * 64 + 4 (t / 2);
// in the 64-byte swizzle, 16-byte chunk kk of row r sits at chunk kk ^ sw,
// sw = (r / 2) % 4 (the same for row r + 8).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const unsigned char* w, int sw,
                                       uint32_t sel) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned char* p = w + ((kk ^ sw) << 4);
    const uint32_t lo0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t hi0 = *reinterpret_cast<const uint32_t*>(p + 8);
    const uint32_t lo1 = *reinterpret_cast<const uint32_t*>(p + 8 * kWRow);
    const uint32_t hi1 = *reinterpret_cast<const uint32_t*>(p + 8 * kWRow + 8);
    a[kk][0] = widen2(lo0, sel);
    a[kk][1] = widen2(lo1, sel);
    a[kk][2] = widen2(hi0, sel);
    a[kk][3] = widen2(hi1, sel);
  }
}

// A work unit: token tile m, column tile n, K split s (m fastest: the units
// in flight together share a weight tile, read from device memory once), and
// its K chunks [c0, c1).
struct Unit {
  int m0, n0, tile, split, c0, c1;
};

__device__ __forceinline__ Unit unit_of(int u, int kN, int m_tiles, int splits, int per,
                                        int n_k) {
  const int m = u % m_tiles, rest = u / m_tiles;
  const int s = rest % splits, n = rest / splits;
  const int c0 = s * per;
  return Unit{m * kN, n * kBN, n * m_tiles + m, s, c0, min(c0 + per, n_k)};
}

// A consumer warp no longer reads stage s.
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  __syncwarp();
  if (lane == 0) mmt::hopper::mbar_arrive(&empty[s]);
}

// Stage i of a unit (ring tile t) for a consumer warpgroup: wait for the
// tile, widen its weight rows into `a`, queue four wgmma over its tokens;
// then wait for the previous stage's group and release that stage.
template <int kN>
__device__ __forceinline__ void consume(float (&acc)[Cfg<kN>::kAcc][kN / 2], uint32_t (&a)[4][4],
                                        unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        int t, int i, int w_off, int sw, uint32_t sel,
                                        int lane) {
  using C = Cfg<kN>;
  const int s = t % C::kStages;
  mmt::hopper::mbar_wait(&full[s], (t / C::kStages) & 1);
  unsigned char* stage = smem + s * C::kStageBytes;
  load_a(a, stage + C::kXBytes + w_off, sw, sel);
  mmt::hopper::wgmma_fence();
  const uint32_t xb = smem_u32(stage);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    wgmma_rs<kN>(acc[kk % C::kAcc], a[kk], mmt::hopper::desc_sw128(xb + kk * 32, 16, 1024),
                 !(i == 0 && kk < C::kAcc));
  }
  mmt::hopper::wgmma_commit();
  if (i > 0) {
    mmt::hopper::wgmma_wait<1>();
    release(empty, (t - 1) % C::kStages, lane);
  }
}

// Consumer warpgroup c's 64 columns of a finished tile: scale each
// accumulator row (an output column), cast once, transpose through shared
// memory in passes of up to 64 tokens and store rows of tokens.
template <int kN>
__device__ __forceinline__ void epilogue(const float (&acc)[kN / 2], __nv_bfloat16* epi,
                                         const float* __restrict__ w_s,
                                         __nv_bfloat16* __restrict__ out, int M, int N, int m0,
                                         int n0, int c, int warp, int g, int t4) {
  using C = Cfg<kN>;
  const int col = n0 + 64 * c + 16 * warp + g;
  const float s_lo = col < N ? w_s[col] : 0.f, s_hi = col + 8 < N ? w_s[col + 8] : 0.f;
  const int wt = threadIdx.x % 128;
  const bool vec = N % 8 == 0;
#pragma unroll
  for (int p = 0; p < kN / C::kEpiPass; ++p) {
    mmt::i8w::named_sync(kWgBarrier + c, 128);  // the previous pass has been read
#pragma unroll
    for (int j = p * C::kEpiPass / 8; j < (p + 1) * C::kEpiPass / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * t4 + (e & 1) - p * C::kEpiPass;
        const float v = __fmul_rn(acc[4 * j + e], e < 2 ? s_lo : s_hi);
        epi[tok * kEpiLd + 16 * warp + g + 8 * (e >> 1)] = __float2bfloat16_rn(v);
      }
    }
    mmt::i8w::named_sync(kWgBarrier + c, 128);
    for (int i = wt; i < C::kEpiPass * 8; i += 128) {
      const int r = i / 8, q = i % 8;
      const int row = m0 + p * C::kEpiPass + r, c0 = n0 + 64 * c + 8 * q;
      if (row >= M || c0 >= N) continue;
      const __nv_bfloat16* src = epi + r * kEpiLd + 8 * q;
      __nv_bfloat16* dst = out + size_t(row) * N + c0;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && c0 + e < N; ++e) dst[e] = src[e];
      }
    }
  }
}

template <int kN>
__global__ void __launch_bounds__(kThreads, 1)
wo_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap w_map, const float* __restrict__ w_s,
                __nv_bfloat16* __restrict__ out, float* __restrict__ work,
                int* __restrict__ counters, int M, int N, int m_tiles, int n_tiles, int splits,
                int per, int n_k) {
  using C = Cfg<kN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* epi_all = reinterpret_cast<__nv_bfloat16*>(smem + C::kRing);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kRing + C::kEpiBytes);
  uint64_t* empty = full + C::kStages;
  int* last = reinterpret_cast<int*>(empty + C::kStages);
  const int lane = threadIdx.x % mmt::kWarpSize;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mmt::hopper::mbar_init(&full[s], 1);
      mmt::hopper::mbar_init(&empty[s], kConsumers / mmt::kWarpSize);
    }
    mmt::hopper::fence_barrier_init();
  }
  __syncthreads();
  const int units = m_tiles * n_tiles * splits;

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
      int t = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit un = unit_of(u, kN, m_tiles, splits, per, n_k);
        for (int kc = un.c0; kc < un.c1; ++kc, ++t) {
          const int s = t % C::kStages;
          mmt::hopper::mbar_wait(&empty[s], ((t / C::kStages) & 1) ^ 1);
          unsigned char* dst = smem + s * C::kStageBytes;
          mmt::hopper::mbar_arrive_expect_tx(&full[s], C::kStageBytes);
          mmt::i8w::tma_load_2d(dst, &x_map, &full[s], kc * kXRow, un.m0);
          mmt::i8w::tma_load_2d(dst + C::kXBytes, &w_map, &full[s], kc * kWRow, un.n0);
        }
      }
    }
    return;
  }

  const int c = threadIdx.x / 128, warp = (threadIdx.x / mmt::kWarpSize) % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int row = 64 * c + 16 * warp + g;  // the weight tile row of a0 / a2
  const int w_off = row * kWRow + 4 * (t4 >> 1), sw = (row >> 1) & 3;
  const uint32_t sel = 0x7540u | (2u * (t4 & 1));
  __nv_bfloat16* epi = epi_all + c * C::kEpiPass * kEpiLd;
  float accs[C::kAcc][kN / 2];
  float (&acc)[kN / 2] = accs[0];
  uint32_t a0[4][4], a1[4][4];
  int t = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un = unit_of(u, kN, m_tiles, splits, per, n_k);
    const int nk = un.c1 - un.c0;
    // even stages widen into a0, odd ones into a1
    int kb = 0;
    for (; kb + 1 < nk; kb += 2) {
      consume<kN>(accs, a0, smem, full, empty, t + kb, kb, w_off, sw, sel, lane);
      consume<kN>(accs, a1, smem, full, empty, t + kb + 1, kb + 1, w_off, sw, sel, lane);
    }
    if (kb < nk) consume<kN>(accs, a0, smem, full, empty, t + kb, kb, w_off, sw, sel, lane);
    mmt::hopper::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < C::kAcc; ++j) mmt::hopper::fence_regs(accs[j]);
#pragma unroll
    for (int j = 1; j < C::kAcc; ++j)
#pragma unroll
      for (int r = 0; r < kN / 2; ++r) acc[r] = __fadd_rn(acc[r], accs[j][r]);
    t += nk;
    release(empty, (t - 1) % C::kStages, lane);
    if (splits > 1) {
      // this split's slice, register-major: element r of consumer thread i
      // at r * 256 + i
      constexpr size_t kSlice = size_t(kN / 2) * kConsumers;
      float* tile_work = work + size_t(un.tile) * splits * kSlice;
      float* mine = tile_work + size_t(un.split) * kSlice;
#pragma unroll
      for (int r = 0; r < kN / 2; ++r) __stcg(mine + r * kConsumers + threadIdx.x, acc[r]);
      // the barrier orders every thread's slice before thread 0's fence and
      // arrival (release), and its fence after the count (acquire) before
      // every thread's reads
      mmt::i8w::named_sync(kConsumerBarrier, kConsumers);
      if (threadIdx.x == 0) {
        __threadfence();
        const bool is_last = atomicAdd(&counters[un.tile], 1) == splits - 1;
        if (is_last) __threadfence();
        *last = is_last;
      }
      mmt::i8w::named_sync(kConsumerBarrier, kConsumers);
      if (!*last) continue;
      // the slices summed in split order, kGroup slices' loads in flight at once
      constexpr int kGroup = C::kSumGroup;
#pragma unroll
      for (int r = 0; r < kN / 2; ++r) acc[r] = 0.f;
      if constexpr (kGroup == 1) {
        for (int j = 0; j < splits; ++j) {
          const float* slice = tile_work + size_t(j) * kSlice + threadIdx.x;
#pragma unroll
          for (int r = 0; r < kN / 2; ++r) acc[r] = __fadd_rn(acc[r], __ldcg(slice + r * kConsumers));
        }
      }
      for (int j0 = 0; kGroup > 1 && j0 < splits; j0 += kGroup) {
        float v[kGroup][kN / 2];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j0 + j < splits) {
            const float* slice = tile_work + size_t(j0 + j) * kSlice + threadIdx.x;
#pragma unroll
            for (int r = 0; r < kN / 2; ++r) v[j][r] = __ldcg(slice + r * kConsumers);
          }
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j0 + j < splits) {
#pragma unroll
            for (int r = 0; r < kN / 2; ++r) acc[r] = __fadd_rn(acc[r], v[j][r]);
          }
        }
      }
      if (threadIdx.x == 0) counters[un.tile] = 0;  // zeroed for the next call
    }
    epilogue<kN>(acc, epi, w_s, out, M, N, un.m0, un.n0, c, warp, g, t4);
  }
}

// float32 activations on the CUDA cores.
__device__ __forceinline__ float s8(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * byte)) & 0xffu));
}

constexpr int kFT = 64;   // rows and columns of a tile
constexpr int kFK = 32;   // K values a step
constexpr int kFLd = kFT + 4;

__global__ void __launch_bounds__(256)
wo_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ w_s, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float xs[kFK][kFLd];  // transposed: xs[k][row]
  __shared__ __align__(16) float wt[kFK][kFLd];  // wt[k][col]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kFT, n0 = blockIdx.y * kFT;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int v = threadIdx.x; v < kFT * kFK / 4; v += 256) {
      const int r = v / (kFK / 4), c = (v % (kFK / 4)) * 4;
      const float4 val = *reinterpret_cast<const float4*>(x + size_t(min(m0 + r, M - 1)) * K + k0 + c);
      xs[c][r] = val.x;
      xs[c + 1][r] = val.y;
      xs[c + 2][r] = val.z;
      xs[c + 3][r] = val.w;
    }
    if (threadIdx.x < kFT * kFK / 16) {
      const int r = threadIdx.x / (kFK / 16), c = (threadIdx.x % (kFK / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(w + size_t(min(n0 + r, N - 1)) * K + k0 + c);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int q = 0; q < 16; ++q) wt[c + q][r] = s8(words[q / 4], q % 4);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&wt[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col < N) out[size_t(row) * N + col] = __fmul_rn(acc[i][j], w_s[col]);
    }
  }
}

// The number of SMs of device `dev`, and whether kernel `kN`'s shared-memory
// attribute is set there: queried and set once a process.
inline int sms_of(int dev) {
  static int sms[kMaxDevices] = {};
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    sms[dev] = n;
  }
  return sms[dev];
}

template <int kN>
int launch_wgmma(const void* x, const void* w, const float* w_s, void* out, float* work,
                 int* counters, int M, int K, int N, int splits, int per, cudaStream_t stream) {
  using C = Cfg<kN>;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(wo_wgmma_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set[dev] = true;
  }
  const int sms = sms_of(dev);
  if (sms < 1) return static_cast<int>(cudaErrorNoDevice);
  // x as (M, 2 K) bytes in boxes of kN tokens x 128 bytes (64 bf16, the
  // 128-byte swizzle); w as (N, K) bytes in boxes of 128 rows x 64 bytes
  CUtensorMap x_map, w_map;
  int err = mmt::i8w::make_int8_map(&x_map, x, M, 2 * K, kN, kXRow);
  if (err == 0) err = mmt::i8w::make_int8_map(&w_map, w, N, K, kBN, kWRow);
  if (err != 0) return err;
  const int m_tiles = (M + kN - 1) / kN, n_tiles = (N + kBN - 1) / kBN;
  const int units = m_tiles * n_tiles * splits;
  wo_wgmma_kernel<kN><<<units < sms ? units : sms, kThreads, C::kSmem, stream>>>(
      x_map, w_map, w_s, static_cast<__nv_bfloat16*>(out), work, counters, M, N, m_tiles,
      n_tiles, splits, per, K / kBK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) float32 (dtype 0) or bf16 (dtype 1), w (N, K) int8, w_s (N,)
// float -> out (M, N) in x's type. K must be a multiple of 64. bf16 takes
// tokens in tiles of `tile_n` (8, 16, 32, 64, 128 or 256) and splits K
// into `splits` slices of `chunks_per_split` 64-value chunks (the last may
// be shorter, none empty); with splits > 1, `work` is float32 scratch of
// tiles * splits * tile_n * 128 values and `counters` one int32 zero a tile,
// left zero (tiles = ceil(M / tile_n) * ceil(N / 128)). float32 takes
// splits = 1 and ignores tile_n, work and counters.
extern "C" int mmt_wo_matmul(const void* x, const void* w, const void* w_s, void* out,
                             void* work, void* counters, int M, int K, int N, int tile_n,
                             int splits, int chunks_per_split, int dtype, void* stream) {
  const int chunks = K / kBK;
  if (M < 1 || N < 1 || K < kBK || K % kBK != 0 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks ||
      (splits > 1 && (work == nullptr || counters == nullptr)) || (dtype == 0 && splits != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ws = static_cast<const float*>(w_s);
  if (dtype == 0) {
    const dim3 grid((M + kFT - 1) / kFT, (N + kFT - 1) / kFT);
    wo_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                       static_cast<const int8_t*>(w), ws,
                                       static_cast<float*>(out), M, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  float* wk = static_cast<float*>(work);
  int* cnt = static_cast<int*>(counters);
  const int p = chunks_per_split;
  switch (tile_n) {
    case 8: return launch_wgmma<8>(x, w, ws, out, wk, cnt, M, K, N, splits, p, s);
    case 16: return launch_wgmma<16>(x, w, ws, out, wk, cnt, M, K, N, splits, p, s);
    case 32: return launch_wgmma<32>(x, w, ws, out, wk, cnt, M, K, N, splits, p, s);
    case 64: return launch_wgmma<64>(x, w, ws, out, wk, cnt, M, K, N, splits, p, s);
    case 128: return launch_wgmma<128>(x, w, ws, out, wk, cnt, M, K, N, splits, p, s);
    case 256: return launch_wgmma<256>(x, w, ws, out, wk, cnt, M, K, N, splits, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
