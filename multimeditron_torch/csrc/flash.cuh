// Shared pieces of the flash attention kernels (K1 forward, K2a dq, K2b dk/dv).
//
// Layout contract, shared with multimeditron_torch/ops/flash_attention.py:
// q, o, dout, dq are (B, H, Sq, D); k, v, dk, dv are (B, Hkv, Skv, D), all
// contiguous; lse and di are float (B, H, Sq); kv_mask is an optional int32
// (B, Skv), nonzero for a valid key. q head h reads kv head h / (H / Hkv).
// Causal masking keeps key j for query i when i + offset >= j (the wrapper
// passes offset = Skv - Sq for end alignment).
//
// The bf16 forward for Sq >= 64 (flash_fwd.cu, flash_fwd_wgmma_kernel) and
// the bf16 backward (flash_bwd.cu) work with wgmma and TMA (hopper.cuh,
// flash_tma.cuh). The other kernels work on 64-row tiles of queries and keys,
// in two versions:
//
// - float32 on the CUDA cores: 256 threads laid out 16 x 16; thread (tx, ty)
//   owns tile rows ty + 16 * i (i < 4) and tile columns tx + 16 * j (j < 4)
//   of a 64 x 64 score tile, and the float4 column groups 4 * tx + 64 * g of
//   a 64 x D accumulator. Tiles are staged in shared memory with a row stride
//   of D + 4 floats, so that the 16-byte loads of 8 neighbouring threads on 8
//   different rows hit 32 different banks.
// - bfloat16 on the tensor cores (namespace mma below; the forward's decode
//   form): 4 warps, each owning 16 rows of the tile, with mma.sync m16n8k16
//   products.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mmt {
namespace flash {

constexpr int kTile = 64;
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kTile / kTY;  // tile rows per thread
constexpr int kCols = kTile / kTX;  // score-tile columns per thread
constexpr int kLdP = kTile + 4;     // row stride of a 64 x 64 float tile in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // lse of a row with no valid key

template <int D>
struct Dims {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  static constexpr int kLd = D + 4;          // row stride of a 64 x D tile in shared memory
  static constexpr int kGroups = D / 64;     // float4 accumulator column groups per thread
  static constexpr int kTileFloats = kTile * kLd;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(float4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc[0..3] += w * v
__device__ __forceinline__ void axpy4(float* acc, float w, float4 v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
  acc[2] = fmaf(w, v.z, acc[2]);
  acc[3] = fmaf(w, v.w, acc[3]);
}

// Reductions over the 16 threads that share a tile row (tx is the low four
// bits of the lane).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + 64) of a row-major (n_rows, D) float matrix into shared
// memory; rows at or past n_rows read as zero, so the ragged edge of the
// caller's tensor is never padded.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int n_rows) {
  constexpr int kVec = D / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < kTile * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 4;
    const int row = row0 + r;
    const float4 val = row < n_rows ? load4(src + size_t(row) * D + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * Dims<D>::kLd + c, val);
  }
}

// 1 for the keys of [k0, k0 + 64) that exist and are not masked, else 0.
__device__ __forceinline__ void load_key_valid(int* dst, const int* __restrict__ mask_row,
                                               int k0, int Skv) {
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    dst[threadIdx.x] = key < Skv && (mask_row == nullptr || mask_row[key] != 0);
  }
}

// Number of `tile`-key tiles a query tile whose last row is q_last has to
// visit (all of them unless causal).
__host__ __device__ __forceinline__ int kv_tiles(int q_last, int Skv, int causal, int offset,
                                                 int tile = kTile) {
  const int end = causal ? clamp_int(static_cast<long long>(q_last) + offset + 1, 0, Skv) : Skv;
  return (end + tile - 1) / tile;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core pieces: mma.sync m16n8k16 (f32 accumulate) and ldmatrix.
// A bf16 tile is staged in shared memory as bf16 with a row stride of D + 8
// elements (an odd number of 16-byte groups), so the eight 16-byte rows that
// one ldmatrix phase reads fall in 32 different banks. Fragment layouts
// (PTX ISA, mma.m16n8k16): with g = lane / 4 and t = lane % 4, an
// accumulator holds rows g (c0, c1) and g + 8 (c2, c3) at columns 2t, 2t + 1.
// ---------------------------------------------------------------------------
namespace mma {

constexpr int kWarps = 4;  // each warp owns 16 rows of a 64-row tile
constexpr int kThreads = kWarps * kWarpSize;

template <int D>
struct Dims {
  static constexpr int kLd = D + 8;            // bf16 row stride in shared memory
  static constexpr int kTileElems = kTile * kLd;
  static constexpr int kKSteps = D / 16;       // k-steps of a product over D
  static constexpr int kNTiles = D / 8;        // 8-column accumulator tiles over D
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16, row-major) at rows row0.., columns col0.. of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int col0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * Dims<D>::kLd + col0 + (lane >> 4) * 8);
}

// B fragments of two 8-column n-tiles for a product X Y^T, where Y is stored
// row-major (n rows of the product's columns, k along the row): rows n0..n0+15
// of Y, columns k0..k0+15. b[0], b[1] serve n-tile n0, b[2], b[3] n-tile n0+8.
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                          int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * Dims<D>::kLd + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles for a product X Y, where Y is stored row-major
// (k rows, n along the row): rows k0..k0+15, columns n0..n0+15.
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0,
                                          int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Dims<D>::kLd + n0 +
                           (lane >> 4) * 8);
}

// A fragment of k-step kk (16 columns) from accumulators holding a 16 x N
// product as 8-column tiles: the FlashAttention-2 register reuse of P.
__device__ __forceinline__ void accum_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [row0, row0 + 64) of a row-major bf16 (n_rows, D) matrix into shared
// memory, 16 bytes per load; rows at or past n_rows read as zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kVec = D / 8;
#pragma unroll 4
  for (int e = threadIdx.x; e < kTile * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    const int row = row0 + r;
    const uint4 val = row < n_rows ? *reinterpret_cast<const uint4*>(src + size_t(row) * D + c)
                                   : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + r * Dims<D>::kLd + c) = val;
  }
}

// 2^x on the special-function unit, subnormal results flushed to zero (a p
// below 2^-126 adds nothing to a bf16 product or to l); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma

}  // namespace flash
}  // namespace mmt

// Runs the statement with `kD` bound to the head dim `d` (64 or 128); any
// other value returns cudaErrorInvalidValue from the enclosing function.
#define MMT_DISPATCH_HEAD_DIM(d, ...)                 \
  do {                                                \
    if ((d) == 64) {                                  \
      constexpr int kD = 64;                          \
      __VA_ARGS__;                                    \
    } else if ((d) == 128) {                          \
      constexpr int kD = 128;                         \
      __VA_ARGS__;                                    \
    } else {                                          \
      return static_cast<int>(cudaErrorInvalidValue); \
    }                                                 \
  } while (0)
