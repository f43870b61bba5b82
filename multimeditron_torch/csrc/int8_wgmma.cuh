// Int8 products on Hopper's warpgroup tensor cores, for the redesigned K7d
// (vit_int8_fc1.cu), K7e and K7c (vit_int8_fc2.cu) and the QKV projection
// of K7b and K7g (vit_int8_gemm.cu): wgmma with s8 x s8 -> s32,
// operands brought in by TMA through a ring of shared-memory stages that a
// producer warp keeps full for the consumer warpgroups, TMA stores, the
// cluster primitives K7e's LayerNorm uses, and an int8 quantiser without
// conversion instructions.
//
// Layout: both operands are int8 rows with K contiguous, as int8_mma.cuh
// keeps them: the activation A is (M, K), the weight B is (N, K). wgmma
// takes .s8 operands only K-major, which this is. A stage holds 128 bytes of
// K of every row of a tile, written by TMA in the 128-byte swizzle: rows of
// 128 bytes, 8 rows to a 1024-byte atom, every tile 1024-byte aligned, so
// hopper::desc_sw128 describes it and one wgmma's 32 bytes of K start 32
// bytes further into the row (the bf16 kernels' 16 elements). TMA reads
// zeros past the last row and past K, so any M >= 1 and any K that is a
// multiple of 64 run.
//
// Accumulators: m64nNk32 leaves warp w of the warpgroup, g = lane / 4,
// t = lane % 4, d[4j + e] = row 16w + g + 8 (e / 2), column 8j + 2t + e % 2.
#pragma once

#include "hopper.cuh"
#include "int8_mma.cuh"

namespace mmt {
namespace i8w {

using hopper::smem_u32;

constexpr int kRowBytes = 128;  // bytes of K a stage, one swizzled row

// ---------------------------------------------------------------------------
// TMA for int8 (rows, K) matrices
// ---------------------------------------------------------------------------
// A row-major (rows, K) int8 matrix as a 2-D map whose boxes are `box_rows`
// rows of `box_bytes` (128 or 64) bytes in the swizzle of that width; rows
// past `rows` and bytes past K read as zeros. Returns 0 or a CUDA error
// code.
inline int make_int8_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows,
                         int box_bytes = kRowBytes) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = hopper::tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K)};
  const cuuint32_t box[2] = {cuuint32_t(box_bytes), cuuint32_t(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_bytes == kRowBytes ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// One box (k0 bytes in, row r0) into this block's shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int k0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(r0)
      : "memory");
}

// One (128 B, rows) box from this block's shared memory at (c0, r0) of the
// map's tensor; the parts of the box past the tensor are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(r0)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk stores have read their shared memory (kRead) or are
// done.
template <bool kRead>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (kRead) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}
// Makes this thread's shared-memory stores visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over `threads` threads (a multiple of 32); arrive
// counts without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Clusters
// ---------------------------------------------------------------------------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every block of the cluster arrives, then waits for all.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The shared::cluster address of `p`'s offset in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// wgmma, s8 x s8 -> s32, both operands K-major in shared memory
// ---------------------------------------------------------------------------
#define MMT_S8_D16(i)                                                                            \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]),   \
      "+r"(d[i + 6]), "+r"(d[i + 7]), "+r"(d[i + 8]), "+r"(d[i + 9]), "+r"(d[i + 10]),           \
      "+r"(d[i + 11]), "+r"(d[i + 12]), "+r"(d[i + 13]), "+r"(d[i + 14]), "+r"(d[i + 15])

// D (64 x 128) (+)= A (64 x 32) B (32 x 128)^T; D is overwritten when
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n128(int (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : MMT_S8_D16(0), MMT_S8_D16(16), MMT_S8_D16(32), MMT_S8_D16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 256) (+)= A (64 x 32) B (32 x 256)^T.
__device__ __forceinline__ void wgmma_m64n256(int (&d)[128], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : MMT_S8_D16(0), MMT_S8_D16(16), MMT_S8_D16(32), MMT_S8_D16(48), MMT_S8_D16(64),
        MMT_S8_D16(80), MMT_S8_D16(96), MMT_S8_D16(112)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64) (+)= A (64 x 32) B (32 x 64)^T.
__device__ __forceinline__ void wgmma_m64n64(int (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : MMT_S8_D16(0), MMT_S8_D16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef MMT_S8_D16

template <int kN>
__device__ __forceinline__ void wgmma_s8(int (&d)[kN / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  static_assert(kN == 64 || kN == 128 || kN == 256, "m64n64k32, m64n128k32 or m64n256k32");
  if constexpr (kN == 64) {
    wgmma_m64n64(d, a, b, accumulate);
  } else if constexpr (kN == 128) {
    wgmma_m64n128(d, a, b, accumulate);
  } else {
    wgmma_m64n256(d, a, b, accumulate);
  }
}

// Pins the accumulators in place around asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---------------------------------------------------------------------------
// The ring of stages
// ---------------------------------------------------------------------------
// Stage s holds an X tile of kXRows rows followed by a Y tile of kYRows
// rows, 128 bytes of K each. Tile t of the K loops uses stage t % stages in
// phase (t / stages) & 1. full[s] completes when the stage has landed (one
// arrival, the producer's, with the stage's bytes); empty[s] when every
// consumer warp that reads it is done with it.
template <int kXRows, int kYRows>
struct Ring {
  static_assert(kXRows <= 256 && kYRows <= 256, "one TMA box a tile");
  static constexpr int kStageBytes = (kXRows + kYRows) * kRowBytes;
  static constexpr int kYOffset = kXRows * kRowBytes;

  unsigned char* stages_base;
  uint64_t* full;
  uint64_t* empty;
  int stages;

  __device__ __forceinline__ int stage(int t) const { return t % stages; }
  __device__ __forceinline__ int parity(int t) const { return (t / stages) & 1; }
  __device__ __forceinline__ unsigned char* tile(int t) const {
    return stages_base + stage(t) * kStageBytes;
  }

  // One thread, followed by a barrier.
  __device__ __forceinline__ void init(int consumer_warps) const {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], consumer_warps);
    }
  }
  __device__ __forceinline__ void wait_full(int t) const {
    hopper::mbar_wait(&full[stage(t)], parity(t));
  }
  __device__ __forceinline__ void wait_empty(int t) const {
    hopper::mbar_wait(&empty[stage(t)], parity(t) ^ 1);
  }

  // Producer, one lane: K bytes [k0, k0 + 128) of X rows x_row0 .. and of Y
  // rows y_row0 .. into tile t's stage (the caller waited for it to be free).
  __device__ __forceinline__ void load(int t, const CUtensorMap* x_map, int x_row0,
                                       const CUtensorMap* y_map, int y_row0, int k0) const {
    const int s = stage(t);
    unsigned char* dst = stages_base + s * kStageBytes;
    hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
    tma_load_2d(dst, x_map, &full[s], k0, x_row0);
    tma_load_2d(dst + kYOffset, y_map, &full[s], k0, y_row0);
  }

  // A consumer warp no longer reads tile t's stage.
  __device__ __forceinline__ void release(int t, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage(t)]);
  }
};

// The K loop of one consumer warpgroup over n_k stages from ring tile t0:
// acc[mi] = A rows [64 mi, 64 mi + 64) of the stage at `a_off` times the kN
// weight rows at `b_off`. One wgmma group is
// kept in flight; a stage is released once the group that read it is done.
template <int kMI, int kN, class RingT>
__device__ __forceinline__ void mainloop(int (&acc)[kMI][kN / 2], const RingT& ring, int t0,
                                         int n_k, int a_off, int b_off, int lane) {
  for (int kb = 0; kb < n_k; ++kb) {
    const int t = t0 + kb;
    ring.wait_full(t);
    const uint32_t base = smem_u32(ring.tile(t));
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowBytes / 32; ++kk) {
      const uint64_t bd = hopper::desc_sw128(base + b_off + kk * 32, 16, 1024);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const uint64_t ad = hopper::desc_sw128(base + a_off + mi * 64 * kRowBytes + kk * 32, 16,
                                               1024);
        wgmma_s8<kN>(acc[mi], ad, bd, kb > 0 || kk > 0);
      }
    }
    hopper::wgmma_commit();
    if (kb > 0) {
      hopper::wgmma_wait<1>();
      ring.release(t - 1, lane);
    }
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) fence_acc(acc[mi]);
  ring.release(t0 + n_k - 1, lane);
}

// int8_mma.cuh's quant(h, inv_s) = clip(rint(h * inv_s), -127, 127), the
// same value, as the low byte of the result, in full-rate instructions (no
// rint, no float-to-int conversion, which run at a quarter of the FMA rate
// and bound the epilogues): clipping first changes nothing (rint and the
// clip commute on [-127, 127]; NaN clips to -127 either way), and adding
// 1.5 * 2^23 rounds the clipped value to the nearest integer, ties to even,
// whose two's complement is then the low byte of the sum's bits.
__device__ __forceinline__ uint32_t quant_bits(float h, float inv_s) {
  const float c = fminf(fmaxf(__fmul_rn(h, inv_s), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// Two quantised values as the bytes of a char2 (x0 first).
__device__ __forceinline__ uint16_t quant2(float x0, float x1, float inv_s) {
  return static_cast<uint16_t>((quant_bits(x0, inv_s) & 0xffu) |
                               ((quant_bits(x1, inv_s) & 0xffu) << 8));
}

// The register budgets of the warp-specialised kernels: the producer
// warpgroup gives registers up, the consumers take them. setmaxnreg needs
// the counts as immediates and draws on the block's registers at launch
// (168 x 384 = 64,512): 128 x 40 + 256 x 232 uses them all, and an increase
// beyond them never completes.
#define MMT_I8W_PRODUCER_REGS() asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n")
#define MMT_I8W_CONSUMER_REGS() asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n")

// The number of SMs of the current device (the persistent grids' width).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

}  // namespace i8w
}  // namespace mmt
