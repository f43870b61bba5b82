// Hopper (sm_90a) building blocks shared by the kernels that use them:
// mbarriers, cp.async with mbarrier completion, TMA tensor loads and their
// tensor maps, and warpgroup matrix multiplies (wgmma) on bf16 with f32
// accumulators.
//
// Tensor maps are encoded on the host with libcuda's cuTensorMapEncodeTiled,
// looked up at run time through the CUDA runtime's entry-point query
// (cudaGetDriverEntryPoint[ByVersion]): the kernel library links against the
// CUDA runtime only, not against libcuda.
//
// Shared-memory operands of wgmma are described by 64-bit matrix descriptors
// (PTX ISA, "Matrix Descriptor Format"). Every tile here is bf16 in the
// 128-byte swizzle that a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes:
// rows of 64 elements (128 bytes), 8 rows to a 1024-byte swizzle atom, tiles
// 1024-byte aligned. A tile wider than 64 elements is stored as column boxes
// of 64, one after the other.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "common.cuh"

namespace mmt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA, cp.async).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed. A wait that never
// ends is a fault (a lost arrival or a copy that cannot land): after 2^26
// polls, far beyond any tile's work, it traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity);) {
    if (++polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// ---------------------------------------------------------------------------
// cp.async (also the int8 tile core's, int8_mma.cuh): 16 bytes into shared
// memory, or with `valid` false 16 zero bytes without reading the source;
// commit groups and waits; an mbarrier arrival once this thread's copies
// have landed.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The barrier counts this arrival (no pending-count increment): initialise it
// with the number of threads that call this.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// One box of a 3-D tensor map into shared memory; coordinates innermost
// first. Completion adds the box's bytes to `bar`'s transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// libcuda's cuTensorMapEncodeTiled through the runtime's entry-point query,
// or nullptr where libcuda does not offer it.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn)
               : nullptr;
  }();
  return encode;
}

// A (n, rows, cols) row-major bf16 tensor as a 3-D map whose boxes are
// `box_rows` rows of 64 columns in the 128-byte swizzle. Rows past `rows` of
// a slice read as zeros (never the next slice's rows). Returns 0 or a CUDA
// error code.
inline int make_bf16_map(CUtensorMap* map, const void* base, int n, int rows, int cols,
                         int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(n)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2, cuuint64_t(rows) * cols * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled bf16 operand at shared address `addr`.
// K-major (the product's depth along the 128-byte rows): `sbo` is the step
// between 8-row groups (1024), `lbo` unused. MN-major: `lbo` is the step
// between 64-column boxes along M or N, `sbo` between 8-row groups along the
// depth (1024).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place around asynchronous wgmma: no access to them is
// moved across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define MMT_WGMMA_D16(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7]), "+f"(d[i + 8]), "+f"(d[i + 9]), "+f"(d[i + 10]),         \
      "+f"(d[i + 11]), "+f"(d[i + 12]), "+f"(d[i + 13]), "+f"(d[i + 14]), "+f"(d[i + 15])

// D (64 x 128, f32) (+)= A (64 x 16, shared, K-major) B (16 x 128, shared,
// K-major); D is overwritten when `accumulate` is 0. Accumulator layout, per
// warp w of the warpgroup, g = lane / 4, t = lane % 4: d[4j + e] holds row
// 16w + g + 8 (e / 2), column 8j + 2t + e % 2.
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : MMT_WGMMA_D16(0), MMT_WGMMA_D16(16), MMT_WGMMA_D16(32), MMT_WGMMA_D16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

// As above with N = 16 and 32 (the grouped-expert kernel's narrow token
// tiles); j < 2 and j < 4.
__device__ __forceinline__ void wgmma_m64n16_ss(float (&d)[8], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : MMT_WGMMA_D16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// As above with N = 64 (the backward's 64-wide score tiles); d[4j + e] holds
// row 16w + g + 8 (e / 2), column 8j + 2t + e % 2, j < 8.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : MMT_WGMMA_D16(0), MMT_WGMMA_D16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128) += A (64 x 16, registers: the mma.m16n8k16 A fragment of each
// warp's 16 rows) B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : MMT_WGMMA_D16(0), MMT_WGMMA_D16(16), MMT_WGMMA_D16(32), MMT_WGMMA_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// As above with N = 64.
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : MMT_WGMMA_D16(0), MMT_WGMMA_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef MMT_WGMMA_D16

}  // namespace hopper
}  // namespace mmt
