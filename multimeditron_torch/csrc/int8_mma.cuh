// Shared tile core of the W8A8 ViT kernels (K7a/K7c/K7d/K7e/K7g): int8
// products on the tensor cores with mma.sync m16n8k32 (s8 x s8 -> s32).
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

#include <stdint.h>

#include "common.cuh"

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// The K loop of a (BM x BN) block tile: A rows m0.., B rows n0.., through
// kStages shared stages (cp.async: kStages - 1 stages are in flight while one
// multiplies; one barrier a step). smem holds kStages * (BM + BN) * kLd
// bytes. On return every thread has passed a barrier after the last read of
// shared memory and no copy is pending, so the caller may reuse it.
template <int BM, int BN, int MT, int NT, int kThreads, int kStages>
__device__ __forceinline__ void gemm_mainloop(int (&acc)[MT][NT][4], int8_t* smem,
                                              const int8_t* __restrict__ A,
                                              const int8_t* __restrict__ B, int M, int N, int K,
                                              int m0, int n0, int wm0, int wn0, int lane) {
  constexpr int kStage = (BM + BN) * kLd;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  const int nk = K / kBK;
  auto load = [&](int kt) {
    int8_t* dst = smem + (kt % kStages) * kStage;
    load_stage<BM, kThreads>(dst, A, m0, M, K, kt * kBK);
    load_stage<BN, kThreads>(dst + BM * kLd, B, n0, N, K, kt * kBK);
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

}  // namespace i8
}  // namespace mmt
