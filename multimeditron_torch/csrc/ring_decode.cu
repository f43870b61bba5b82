// K4: one decode step of paged + ring attention per serving slot.
//
// Replaces the Pallas kernel `_ring_decode_kernel` of
// multimeditron_tpu/ops/paged_attention.py (reached through
// `ring_decode_attention_pallas`). Slot b's query attends over
//   - its prompt/folded tokens in the page pool: positions < pages_len[b],
//     position i at page page_table[b, i / P], row i % P, of layer
//     `layer_index` of the pool (L, Hkv, n_pages, P, D);
//   - its in-chunk ring rows r <= lengths[b] - pages_len[b] of layer
//     `layer_index` of the ring (L, B, Hkv, T, D) (row lengths-pages_len holds
//     this step's own token).
//
// What bounds it on the H100: bytes. Each step reads every valid key and
// value row once (2 * N * D values per slot and kv head) and does 4 * group *
// N * D FLOPs on them: about `group` FLOPs per byte, far below the ~295 the
// card needs before compute matters. At Llama-3.1-8B widths (8 slots, 576
// tokens, 8 kv heads, D = 128, bf16) that is 19 MB per layer per step.
//
// The design (flash-decoding): the keys of each (slot, kv head) are cut
// into splits of 128; one block per (kv head, slot, split) serves all
// `group` query heads of its kv head together, so each K/V row is read once
// for the whole group (GQA without repeat), and the splits spread a decode
// step over the whole card (a first version with one block per (slot, kv
// head) ran 64 blocks and was bound by their latency: 239 us per call at
// the main path's shapes). A block copies a tile of 64 K and V rows into
// shared memory, every thread issuing a batch of 4-byte loads before storing
// any; each warp scores whole rows from shared memory (lanes split D, a
// shuffle reduction per head); one warp per head keeps an online softmax in
// float; each thread accumulates its output columns for every head. The
// block writes its partial (max, sum, accumulator) to a float32 scratch
// buffer, and a second kernel, one block per (kv head, slot), merges the
// splits and normalises. Keys past the valid range are never visited, so
// stale or uninitialised pool pages cannot poison a row (the Pallas kernel
// had to zero them because 0 * NaN = NaN). Every page index read from the
// table is clamped into the pool, and the valid counts are clamped to the
// table and the ring: inactive slots carry stale tables and lengths, and
// their output is garbage by contract but never reads out of bounds. A slot
// with no valid key writes zeros. Copies overlapped with compute (cp.async
// or TMA) and tensor-core dots are later work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / mmt::kWarpSize;
constexpr int kTile = 64;
constexpr int kMaxGroup = 16;
constexpr int kCopyBatch = 8;  // loads in flight per thread while staging a tile
constexpr int kSplitKeys = 2 * kTile;  // keys per split (per block)

template <typename T>
size_t shared_bytes(int group, int D) {
  return 2 * kTile * sizeof(void*)                 // K and V row pointers of the tile
         + 2 * size_t(kTile) * D * sizeof(T)       // the tile's K and V rows
         + 2 * size_t(group) * D * sizeof(float)   // query rows, accumulators
         + size_t(group) * kTile * sizeof(float)   // scores / probabilities
         + 3 * size_t(group) * sizeof(float);      // running max, sum, rescale
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                         const T* __restrict__ v_pages, const T* __restrict__ k_ring,
                         const T* __restrict__ v_ring, const int* __restrict__ page_table,
                         const int* __restrict__ pages_len, const int* __restrict__ lengths,
                         float* __restrict__ partial, int B, int H, int Hkv, int D,
                         int n_pages, int P, int pm, int T_ring, int layer, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T** kptr = reinterpret_cast<const T**>(smem);
  const T** vptr = kptr + kTile;
  T* ks = reinterpret_cast<T*>(vptr + kTile);
  T* vs = ks + kTile * D;
  const int group = H / Hkv;
  float* qs = reinterpret_cast<float*>(vs + kTile * D);
  float* acc = qs + group * D;
  float* sc = acc + group * D;
  float* m_s = sc + group * kTile;
  float* l_s = m_s + group;
  float* alpha_s = l_s + group;

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int n_page_keys = mmt::clamp_int(pages_len[b], 0, pm * P);
  const int n_ring_keys =
      mmt::clamp_int(static_cast<long long>(lengths[b]) - pages_len[b] + 1, 0, T_ring);
  const int n_keys = n_page_keys + n_ring_keys;
  const int words = D * static_cast<int>(sizeof(T)) / 4;  // 32-bit words per row

  const size_t q0 = (size_t(b) * H + size_t(h) * group) * D;
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    qs[i] = mmt::to_float(q[q0 + i]);
    acc[i] = 0.f;
  }
  if (threadIdx.x < group) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();

  const size_t page_head0 = (size_t(layer) * Hkv + h) * n_pages;          // in pages
  const size_t ring_head0 = ((size_t(layer) * B + b) * Hkv + h) * T_ring;  // in rows

  const int key_end = min(n_keys, (split + 1) * kSplitKeys);
  for (int t0 = split * kSplitKeys; t0 < key_end; t0 += kTile) {
    const int nt = min(kTile, key_end - t0);

    // Where the tile's rows live: pages first, then the ring.
    if (threadIdx.x < nt) {
      const int i = t0 + threadIdx.x;
      size_t row;
      if (i < n_page_keys) {
        const int page = mmt::clamp_int(page_table[size_t(b) * pm + i / P], 0, n_pages - 1);
        row = (page_head0 + page) * P + i % P;
        kptr[threadIdx.x] = k_pages + row * D;
        vptr[threadIdx.x] = v_pages + row * D;
      } else {
        row = ring_head0 + (i - n_page_keys);
        kptr[threadIdx.x] = k_ring + row * D;
        vptr[threadIdx.x] = v_ring + row * D;
      }
    }
    __syncthreads();

    // Stage the tile's K and V rows in shared memory: each thread issues a
    // batch of loads before it stores any of them, so the loads overlap.
    uint32_t* ks32 = reinterpret_cast<uint32_t*>(ks);
    uint32_t* vs32 = reinterpret_cast<uint32_t*>(vs);
    for (int w0 = threadIdx.x; w0 < nt * words; w0 += kThreads * kCopyBatch) {
      uint32_t kw[kCopyBatch], vw[kCopyBatch];
#pragma unroll
      for (int u = 0; u < kCopyBatch; ++u) {
        const int w = w0 + u * kThreads;
        if (w < nt * words) {
          const int j = w / words, c = w % words;
          kw[u] = reinterpret_cast<const uint32_t*>(kptr[j])[c];
          vw[u] = reinterpret_cast<const uint32_t*>(vptr[j])[c];
        }
      }
#pragma unroll
      for (int u = 0; u < kCopyBatch; ++u) {
        const int w = w0 + u * kThreads;
        if (w < nt * words) {
          ks32[w] = kw[u];
          vs32[w] = vw[u];
        }
      }
    }
    __syncthreads();

    // Scores: one warp per key row, lanes split the head dim.
    for (int j = warp; j < nt; j += kWarps) {
      const T* kr = ks + j * D;
      float part[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) part[g] = 0.f;
      for (int d = lane; d < D; d += mmt::kWarpSize) {
        const float kd = mmt::to_float(kr[d]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < group) part[g] = fmaf(qs[g * D + d], kd, part[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float s = mmt::warp_sum(part[g]);
          if (lane == 0) sc[g * kTile + j] = s * scale;
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per query head.
    for (int g = warp; g < group; g += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < nt; j += mmt::kWarpSize) mx = fmaxf(mx, sc[g * kTile + j]);
      mx = mmt::warp_max(mx);
      const float m_new = fmaxf(m_s[g], mx);
      float sum = 0.f;
      for (int j = lane; j < nt; j += mmt::kWarpSize) {
        const float p = expf(sc[g * kTile + j] - m_new);
        sc[g * kTile + j] = p;
        sum += p;
      }
      sum = mmt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_s[g] - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P V: each thread owns output columns d for every head of the group.
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float a[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) a[g] = g < group ? acc[g * D + d] * alpha_s[g] : 0.f;
      for (int j = 0; j < nt; ++j) {
        const float vd = mmt::to_float(vs[j * D + d]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < group) a[g] = fmaf(sc[g * kTile + j], vd, a[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) acc[g * D + d] = a[g];
    }
    __syncthreads();  // the next tile rewrites kptr / vptr / ks / vs / sc
  }

  // partial layout per (slot, kv head, split): max[group], sum[group], acc[group * D]
  float* part = partial + ((size_t(b) * Hkv + h) * gridDim.z + split) * group * (D + 2);
  for (int i = threadIdx.x; i < group * D; i += kThreads) part[2 * group + i] = acc[i];
  if (threadIdx.x < group) {
    part[threadIdx.x] = m_s[threadIdx.x];
    part[group + threadIdx.x] = l_s[threadIdx.x];
  }
}

// Merge the splits of one (kv head, slot): o = sum_s e^(m_s - M) acc_s / L.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_decode_combine_kernel(const float* __restrict__ partial, T* __restrict__ o, int H,
                           int Hkv, int D, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int group = H / Hkv;
  const size_t stride = size_t(group) * (D + 2);
  const float* base = partial + (size_t(b) * Hkv + h) * n_splits * stride;
  const size_t o0 = (size_t(b) * H + size_t(h) * group) * D;
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int g = i / D;
    float m = -INFINITY;
    for (int s = 0; s < n_splits; ++s) m = fmaxf(m, base[s * stride + g]);
    float l = 0.f, a = 0.f;
    if (m > -INFINITY) {
      for (int s = 0; s < n_splits; ++s) {
        const float* part = base + s * stride;
        const float w = expf(part[g] - m);  // 0 for an empty split (max -inf)
        l = fmaf(part[group + g], w, l);
        a = fmaf(part[2 * group + i], w, a);
      }
    }
    o[o0 + i] = mmt::from_float<T>(l > 0.f ? a / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_ring,
           const void* v_ring, const void* page_table, const void* pages_len,
           const void* lengths, void* partial, void* o, int B, int H, int Hkv, int D,
           int n_pages, int P, int pm, int T_ring, int layer, float scale, int n_splits,
           cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(H / Hkv, D);
  cudaError_t err = cudaFuncSetAttribute(ring_decode_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_decode_split_kernel<T><<<dim3(Hkv, B, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const T*>(k_ring),
      static_cast<const T*>(v_ring), static_cast<const int*>(page_table),
      static_cast<const int*>(pages_len), static_cast<const int*>(lengths),
      static_cast<float*>(partial), B, H, Hkv, D, n_pages, P, pm, T_ring, layer, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_decode_combine_kernel<T><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(o), H, Hkv, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `partial` is float32 scratch of B * Hkv * n_splits * (H / Hkv) * (D + 2)
// values; n_splits * 128 must cover pages_max * P + T keys.
extern "C" int mmt_ring_decode_attention(const void* q, const void* k_pages,
                                         const void* v_pages, const void* k_ring,
                                         const void* v_ring, const void* page_table,
                                         const void* pages_len, const void* lengths,
                                         void* partial, void* o, int B, int H, int Hkv, int D,
                                         int n_pages, int P, int pm, int T_ring, int layer,
                                         float scale, int n_splits, int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || D % 2 != 0 ||
      static_cast<long long>(n_splits) * kSplitKeys < static_cast<long long>(pm) * P + T_ring)
    return static_cast<int>(cudaErrorInvalidValue);
  MMT_DISPATCH_DTYPE(dtype, return launch<scalar_t>(q, k_pages, v_pages, k_ring, v_ring,
                                                     page_table, pages_len, lengths, partial,
                                                     o, B, H, Hkv, D, n_pages, P, pm, T_ring,
                                                     layer, scale, n_splits,
                                                     static_cast<cudaStream_t>(stream)));
}

// Keys per split of mmt_ring_decode_attention (sizes its scratch buffer).
extern "C" int mmt_ring_decode_split_keys() { return kSplitKeys; }
