// The pieces the wgmma flash kernels share (K1's forward in flash_fwd.cu,
// K2a and K2b in flash_bwd.cu): a ring of shared-memory stages guarded by
// full and empty mbarriers, a tile's valid keys folded into bits, and the
// producer warp that streams K and V tiles through the ring by TMA.
//
// Every tile is bf16 in the 128-byte swizzle (hopper.cuh): a tile of `rows`
// rows and D columns is D / 64 boxes of `rows` x 64, one after the other.
#pragma once

#include "flash.cuh"
#include "hopper.cuh"

namespace mmt {
namespace flash {

// Tile t uses stage t % stages in phase (t / stages) & 1. full[s] completes
// when stage s has landed; empty[s] when every consumer warp is done with it.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;

  __device__ __forceinline__ int stage(int t) const { return t % stages; }
  __device__ __forceinline__ int parity(int t) const { return (t / stages) & 1; }

  // One thread: full[s] takes `arrivals` arrivals (and the bytes announced),
  // empty[s] one arrival from each of `consumer_warps` warps.
  __device__ __forceinline__ void init(int arrivals, int consumer_warps) const {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], arrivals);
      hopper::mbar_init(&empty[s], consumer_warps);
    }
  }
  __device__ __forceinline__ void wait_full(int t) const {
    hopper::mbar_wait(&full[stage(t)], parity(t));
  }
  __device__ __forceinline__ void wait_empty(int t) const {
    hopper::mbar_wait(&empty[stage(t)], parity(t) ^ 1);
  }
  // A consumer warp no longer reads stage t's tiles.
  __device__ __forceinline__ void release(int t, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage(t)]);
  }
};

// The keys of [k0, k0 + 32 * kWords) that exist and are not masked, as bits:
// bit j of word i is key k0 + 32 i + j. Called by a whole warp. (The int32
// mask cannot be a TMA box: its row stride Skv * 4 need not be a multiple of
// 16 bytes.)
template <int kWords>
__device__ __forceinline__ void fold_key_bits(uint32_t (&bits)[kWords],
                                              const int* __restrict__ mask_row, int k0,
                                              int Skv, int lane) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int key = k0 + 32 * i + lane;
    bits[i] = __ballot_sync(0xffffffffu, key < Skv && (mask_row == nullptr || mask_row[key] != 0));
  }
}

// The producer warp of K1 and K2a: K and V tiles of kRows keys, t < n_tiles,
// from the 3-D maps over (B * Hkv, Skv, D) of slice `slice` (rows past Skv
// read as zeros), into stage s of k_ring / v_ring (kRows * D * 2 bytes a
// stage), with the tile's key bits at key_bits[kRows / 32 * s ..]. One
// arrival a stage (lane 0, with the bytes of both tiles).
template <int D, int kRows>
__device__ __forceinline__ void produce_kv_tiles(const Ring& ring, int n_tiles,
                                                 const CUtensorMap* k_map,
                                                 const CUtensorMap* v_map, unsigned char* k_ring,
                                                 unsigned char* v_ring, uint32_t* key_bits,
                                                 const int* __restrict__ mask_row, int Skv,
                                                 int slice, int lane) {
  constexpr int kWords = kRows / 32, kBoxBytes = kRows * 128, kTileBytes = kRows * D * 2;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = ring.stage(t), k0 = t * kRows;
    uint32_t bits[kWords];
    fold_key_bits(bits, mask_row, k0, Skv, lane);
    ring.wait_empty(t);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) key_bits[kWords * s + i] = bits[i];
      hopper::mbar_arrive_expect_tx(&ring.full[s], 2 * kTileBytes);
      for (int box = 0; box < D / 64; ++box) {
        hopper::tma_load_3d(k_ring + s * kTileBytes + box * kBoxBytes, k_map, &ring.full[s],
                            box * 64, k0, slice);
        hopper::tma_load_3d(v_ring + s * kTileBytes + box * kBoxBytes, v_map, &ring.full[s],
                            box * 64, k0, slice);
      }
    }
    __syncwarp();
  }
}

}  // namespace flash
}  // namespace mmt
