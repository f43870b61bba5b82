// Shared tile core of the W8A8 ViT kernels on mma.sync (K7c, K7f, K7g's
// attention, K10): int8 products on the tensor cores with mma.sync
// m16n8k32 (s8 x s8 -> s32). The wgmma kernels (K7b, K7d, K7e and K7g's
// projection, int8_wgmma.cuh) take its rounding helpers.
//
// Layout contract: every int8 operand is row-major with K contiguous. The
// activation A is (M, K); the weight B is (N, K), one row per output column,
// which is the "col" operand of mma.sync as it lies in memory (8-bit
// ldmatrix cannot transpose, so the port stores int8 weights this way). Both
// are staged in shared memory kBK bytes of K at a time, with a row stride of
// kLd = kBK + 16 bytes: the eight 16-byte rows that one ldmatrix phase reads
// start 20 words apart and fall in 32 different banks.
//
// Fragments come from ldmatrix.x4 (8-bit data read as b16 pairs, no
// transpose needed with K contiguous): one instruction for an A fragment,
// one for the B fragments of two 8-column tiles.
//
// Fragment layouts (PTX ISA, mma.m16n8k32 .s8): with g = lane / 4 and
// t = lane % 4, A register i holds 4 bytes of row g (i = 0, 2) or g + 8
// (i = 1, 3) at k = 4t (i < 2) or 16 + 4t; B register i holds 4 bytes of
// column g at k = 4t + 16 i; an accumulator holds rows g (c0, c1) and g + 8
// (c2, c3) at columns 2t, 2t + 1.
//
// Epilogues round where the Pallas reference rounds as XLA compiles it: a
// multiply feeding an add is one fmaf (XLA contracts a * b + c: the
// dequantise-and-bias, the LayerNorm's affine step, the score's shift), every
// other operation a round-to-nearest intrinsic (__fmul_rn, __fadd_rn) that
// nvcc may not contract. So an int8 quantisation boundary is not moved by a
// contraction the reference does not make, or the other way round.
#pragma once

#include <climits>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace mmt {
namespace i8 {

constexpr int kBK = 64;        // bytes of K per shared-memory stage
constexpr int kLd = kBK + 16;  // shared row stride in bytes

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// Rows [row0, row0 + kRows) x bytes [k0, k0 + kBK) of a row-major (n_rows, K)
// int8 matrix into a shared stage. Rows past n_rows copy row n_rows - 1: their
// products are computed and never stored, so the caller's tensor is not padded.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_stage(int8_t* dst, const int8_t* __restrict__ src, int row0,
                                           int n_rows, int K, int k0) {
  constexpr int kChunks = kRows * (kBK / 16);
#pragma unroll
  for (int e = threadIdx.x; e < kChunks; e += kThreads) {
    const int r = e / (kBK / 16), c = (e % (kBK / 16)) * 16;
    const int row = min(row0 + r, n_rows - 1);
    cp_async16(dst + r * kLd + c, src + size_t(row) * K + k0 + c);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment: rows r0 .. r0 + 15, bytes kb .. kb + 31 of a stage.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* tile, int r0, int kb,
                                       int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * kLd + kb + (lane >> 4) * 16);
}

// B fragments of two 8-column tiles, weight rows n0 .. n0 + 15, bytes
// kb .. kb + 31: b[0], b[1] serve tile n0 and b[2], b[3] tile n0 + 8.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const int8_t* tile, int n0, int kb,
                                        int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kb +
                     ((lane >> 3) & 1) * 16);
}

// acc[i][j] += A[wm0 + 16 i ..] . B[wn0 + 8 j ..] over one stage (NT even).
template <int MT, int NT>
__device__ __forceinline__ void stage_product(int (&acc)[MT][NT][4], const int8_t* As,
                                              const int8_t* Bs, int wm0, int wn0, int lane) {
  static_assert(NT % 2 == 0, "B fragments load two 8-column tiles at a time");
#pragma unroll
  for (int kb = 0; kb < kBK; kb += 32) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) load_a(a[i], As, wm0 + 16 * i, kb, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      load_b2(b, Bs, wn0 + 8 * j, kb, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_s8(acc[i][j], a[i], b[0], b[1]);
        mma_s8(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// An operand as int8 rows in device memory, `ld` bytes apart: a stage loader
// for gemm_accumulate (rows past n_rows repeat the last, as load_stage).
struct Int8Rows {
  const int8_t* __restrict__ p;
  int n_rows, ld;

  template <int kRows, int kThreads>
  __device__ __forceinline__ void load(int8_t* dst, int row0, int k0) const {
    load_stage<kRows, kThreads>(dst, p, row0, n_rows, ld, k0);
  }
};

// acc += the K loop of a (BM x BN) block tile: A rows m0.., B rows n0.., bytes
// [0, K) of each, through kStages shared stages (kStages - 1 stages are in
// flight while one multiplies; one barrier a step). Each operand comes from a
// loader with load<kRows, kThreads>(stage, row0, k0) (Int8Rows, or one that
// quantises or copies on the way in; a loader that stores with plain shared
// stores is covered by the same barrier as cp.async). smem holds
// kStages * (BM + BN) * kLd bytes. On return every thread has passed a barrier
// after the last read of shared memory and no copy is pending, so the caller
// may reuse it.
template <int BM, int BN, int MT, int NT, int kThreads, int kStages, class ALoad, class BLoad>
__device__ __forceinline__ void gemm_accumulate(int (&acc)[MT][NT][4], int8_t* smem,
                                                const ALoad& a, const BLoad& b, int K, int m0,
                                                int n0, int wm0, int wn0, int lane) {
  constexpr int kStage = (BM + BN) * kLd;
  const int nk = K / kBK;
  auto load = [&](int kt) {
    int8_t* dst = smem + (kt % kStages) * kStage;
    a.template load<BM, kThreads>(dst, m0, kt * kBK);
    b.template load<BN, kThreads>(dst + BM * kLd, n0, kt * kBK);
  };
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // ... for every thread, and stage kt - 1 is spent
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const int8_t* cur = smem + (kt % kStages) * kStage;
    stage_product<MT, NT>(acc, cur, cur + BM * kLd, wm0, wn0, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int MT, int NT>
__device__ __forceinline__ void zero(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// clip(round_half_even(h * inv_s), -127, 127)
__device__ __forceinline__ int8_t quant(float h, float inv_s) {
  const float r = rintf(__fmul_rn(h, inv_s));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// f32 rounded through bf16 (the Pallas approximate reciprocal in interpret
// mode is 1 / bf16(x), computed in f32).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The activations of the Pallas `_fc1_kernel` / `_mlp_fused_kernel`, in its
// order of operations (1 / x as __frcp_rn: IEEE round-to-nearest like
// __fdiv_rn(1, x), so the same bits, in fewer instructions). act: 0 quick_gelu_approx, 1 quick_gelu,
// 2 gelu_pytorch_tanh / gelu_new, 3 gelu.
__device__ __forceinline__ float activate(float g, int act) {
  switch (act) {
    case 0: {  // quick_gelu_approx: g / bf16(1 + 2^(-1.702 log2(e) g))
      const float e = exp2f(__fmul_rn(-2.4554396102104056f, g));
      return __fmul_rn(g, __frcp_rn(bf16_round(__fadd_rn(1.f, e))));
    }
    case 1: {  // quick_gelu: g * sigmoid(1.702 g)
      const float z = __fmul_rn(1.702f, g);
      return __fmul_rn(g, __frcp_rn(__fadd_rn(1.f, expf(-z))));
    }
    case 2: {  // gelu_pytorch_tanh / gelu_new: g * (0.5 (1 + tanh(c (g + 0.044715 g^3))))
      const float g3 = __fmul_rn(__fmul_rn(g, g), g);
      const float inner = __fmul_rn(0.7978845608028654f, fmaf(0.044715f, g3, g));
      return __fmul_rn(g, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
    }
    default:  // gelu: 0.5 g erfc(-g / sqrt(2))
      return __fmul_rn(__fmul_rn(0.5f, g), erfcf(__fmul_rn(-g, 0.7071067811865476f)));
  }
}

// ----------------------------------------------------------------------
// int8 attention over 64-byte heads (K7g's attention, K10): one block per
// (head, image) stages the head's keys, each warp walks 16-query tiles.
// ----------------------------------------------------------------------

// Key rows [0, rows) of one head (64 int8 values at k8 + r * ld) into a
// stage kLd apart; rows at or past kv_len are zero.
template <int kThreads>
__device__ __forceinline__ void stage_keys(int8_t* ks, const int8_t* __restrict__ k8, int rows,
                                           int kv_len, int ld) {
  for (int e = threadIdx.x; e < rows * 4; e += kThreads) {
    const int r = e / 4, c = (e % 4) * 16;
    const uint4 val = r < kv_len ? *reinterpret_cast<const uint4*>(k8 + size_t(r) * ld + c)
                                 : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(ks + r * kLd + c) = val;
  }
}

// A fragments of query rows ra and rb (64 int8 values at q8 + r * ld) for
// bytes 0-31 (qa[0]) and 32-63 (qa[1]), straight from device memory; rows
// past S repeat row S - 1.
__device__ __forceinline__ void load_queries(uint32_t (&qa)[2][4], const int8_t* __restrict__ q8,
                                             int ra, int rb, int S, int ld, int t) {
  const int8_t* pa = q8 + size_t(min(ra, S - 1)) * ld + 4 * t;
  const int8_t* pb = q8 + size_t(min(rb, S - 1)) * ld + 4 * t;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(pa + 32 * kk);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(pb + 32 * kk);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(pa + 32 * kk + 16);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(pb + 32 * kk + 16);
  }
}

// int32 scores of a 16-row query tile against key rows k0 .. k0 + kKeys - 1
// of a stage (64 bytes of K a row, kLd apart): qa holds the tile's A
// fragments for bytes 0-31 and 32-63; sc[j] is the 8-key tile k0 + 8 j.
template <int kKeys>
__device__ __forceinline__ void key_scores(int (&sc)[kKeys / 8][4], const uint32_t (&qa)[2][4],
                                           const int8_t* ks, int k0, int lane) {
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0;
#pragma unroll
  for (int j = 0; j < kKeys / 8; j += 2)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t kb[4];
      load_b2(kb, ks, k0 + 8 * j, 32 * kk, lane);
      mma_s8(sc[j], qa[kk], kb[0], kb[1]);
      mma_s8(sc[j + 1], qa[kk], kb[2], kb[3]);
    }
}

// The row maximum of s = round(acc * a) for the tile's rows g (m0) and
// g + 8 (m1) over keys below kv_len, with no online softmax: rounding is
// monotone, so max(round(acc * a)) = round(max(acc) * a) for a >= 0 (and
// the minimum acc for a < 0). One pass of int8 scores over the staged keys,
// the extremes reduced over the four lanes of a row.
template <int kKeys>
__device__ __forceinline__ void row_max(float& m0, float& m1, const uint32_t (&qa)[2][4],
                                        const int8_t* ks, int rows, int kv_len, float a,
                                        int lane) {
  const int t = lane & 3;
  int hi0 = INT_MIN, hi1 = INT_MIN, lo0 = INT_MAX, lo1 = INT_MAX;
  for (int k0 = 0; k0 < rows; k0 += kKeys) {
    int sc[kKeys / 8][4];
    key_scores<kKeys>(sc, qa, ks, k0, lane);
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + 8 * j + 2 * t + (e & 1) >= kv_len) continue;
        if (e < 2) {
          hi0 = max(hi0, sc[j][e]);
          lo0 = min(lo0, sc[j][e]);
        } else {
          hi1 = max(hi1, sc[j][e]);
          lo1 = min(lo1, sc[j][e]);
        }
      }
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    hi0 = max(hi0, __shfl_xor_sync(0xffffffffu, hi0, x));
    hi1 = max(hi1, __shfl_xor_sync(0xffffffffu, hi1, x));
    lo0 = min(lo0, __shfl_xor_sync(0xffffffffu, lo0, x));
    lo1 = min(lo1, __shfl_xor_sync(0xffffffffu, lo1, x));
  }
  m0 = __fmul_rn(static_cast<float>(a >= 0.f ? hi0 : lo0), a);
  m1 = __fmul_rn(static_cast<float>(a >= 0.f ? hi1 : lo1), a);
}

// Two adjacent outputs, stored as float32 or bf16, or quantised to int8 by
// inv_s.
__device__ __forceinline__ void store2(float* p, float x0, float x1, float = 1.f) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1, float = 1.f) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(int8_t* p, float x0, float x1, float inv_s) {
  char2 q;
  q.x = quant(x0, inv_s);
  q.y = quant(x1, inv_s);
  *reinterpret_cast<char2*>(p) = q;
}

}  // namespace i8
}  // namespace mmt
