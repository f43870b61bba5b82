// The merge pass of the split-key (flash-decoding) ring verify attention K6
// (K4 and K8 merge inside their own launch, ring_decode.cu): each block of
// the first pass left, for its split of one (slot, kv head)'s keys, a
// float32 record of `rows` maxima, `rows` sums and the `rows` x D
// unnormalised accumulator. One block per (kv head, slot) merges the splits
// and normalises:
//   o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,   M = max_s m_s.
// A split that saw no valid key for a row has m = -inf and weighs 0; a row
// with no valid key at all is written as zeros.
#pragma once

#include "common.cuh"

namespace mmt {
namespace {  // each kernel file gets its own copy

template <typename T>
__global__ void __launch_bounds__(128)
split_merge_kernel(const float* __restrict__ partial, T* __restrict__ o, int Hkv, int rows,
                   int D, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t stride = size_t(rows) * (D + 2);
  const float* base = partial + (size_t(b) * Hkv + h) * n_splits * stride;
  // the output rows of one (slot, kv head) are contiguous: query heads of
  // the kv head, then (for K6) the block rows of each
  const size_t o0 = (size_t(b) * Hkv + h) * rows * D;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    float m = -INFINITY;
    for (int s = 0; s < n_splits; ++s) m = fmaxf(m, base[s * stride + r]);
    float l = 0.f, a = 0.f;
    if (m > -INFINITY) {
      for (int s = 0; s < n_splits; ++s) {
        const float* part = base + s * stride;
        // 0 for a split that saw no key (max -inf)
        const float w = expf(part[r] - m);
        l = fmaf(part[rows + r], w, l);
        a = fmaf(part[2 * rows + i], w, a);
      }
    }
    o[o0 + i] = from_float<T>(l > 0.f ? a / l : 0.f);
  }
}

}  // namespace
}  // namespace mmt
