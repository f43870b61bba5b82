// K6: the speculative verify block of paged + ring attention.
//
// Replaces the Pallas kernel `_ring_decode_kernel` with block_s > 1 of
// multimeditron_tpu/ops/paged_attention.py (reached through
// `ring_verify_attention_pallas`). q is (B, H, S, D): S = k + 1 query rows
// per head, the verify block of one speculative step. Query i of slot b sits
// at position lengths[b] + i and attends over
//   - its page-pool tokens: positions < pages_len[b], position p at page
//     page_table[b, p / P], row p % P, of layer `layer_index` of the pool
//     (L, Hkv, n_pages, P, D) — the same keys for every query row;
//   - its ring rows r <= g + i, g = lengths[b] - pages_len[b], of layer
//     `layer_index` of the ring (L, B, Hkv, T, D): the block's own K/V sit at
//     ring rows g .. g + S - 1, so the block is causal within itself.
//
// What bounds it on the H100: bytes. Each call reads every valid key and
// value row of every (slot, kv head) once and does 4 * group * S * N * D
// FLOPs on them: group * S FLOPs per byte (20 at Llama-3.1-8B widths with
// k = 4), far below the ~295 the card needs before compute matters. At 8
// slots, ~580 keys, 8 kv heads, D = 128 in bf16 a call reads ~19 MB: ~5.7 us
// at 3.35 TB/s.
//
// The design keeps K4's split-key scheme (flash-decoding): one block per (kv
// head, slot, split of 128 keys) serves all R = group * S query rows of its kv
// head, so each K/V row is read once for the whole group and block (GQA
// without repeat); a second kernel (split_merge.cuh) merges the splits. A
// block stages 64 K and V rows at a time in shared memory, rows padded to an
// odd number of 4-byte words. Scores are 4 x 4 (row, key) tiles per thread
// from the queries held transposed in float (one 16-byte load feeds 16
// FMAs); the per-row ring mask is applied as the scores are stored; one warp
// per row keeps the online softmax; each thread then owns output columns for
// all R rows and reads the probabilities four keys at a time. K4's safety
// rules hold: keys past the valid range are never visited, every page index
// is clamped into the pool, the valid counts are clamped to the table and the
// ring, a row with no valid key in a split weighs 0 in the merge, and a row
// with none at all is written as zeros. Tensor-core products and copies
// overlapped with compute (cp.async or TMA) are later work.
#include <cstdint>

#include "common.cuh"
#include "split_merge.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / mmt::kWarpSize;
constexpr int kTile = 64;
constexpr int kMaxRows = 64;
constexpr int kCopyBatch = 8;          // loads in flight per thread while staging a tile
constexpr int kSplitKeys = 2 * kTile;  // keys per split (per block)

// 32-bit words per staged K/V row: an odd count, so the rows four keys apart
// that one score tile reads do not all fall into one shared-memory bank.
template <typename T>
__host__ __device__ int row_words(int D) {
  const int words = D * static_cast<int>(sizeof(T)) / 4;
  return words | 1;
}

struct Layout {
  size_t kptr, vptr, ks, vs, qT, acc, sc, m, l, alpha, total;
};

template <typename T>
__host__ __device__ Layout layout(int rows, int D) {
  const int Rp = (rows + 3) & ~3;
  const size_t tile_bytes = size_t(kTile) * row_words<T>(D) * 4;
  Layout L;
  L.kptr = 0;
  L.vptr = L.kptr + kTile * sizeof(void*);
  L.ks = L.vptr + kTile * sizeof(void*);
  L.vs = mmt::align16(L.ks + tile_bytes);
  L.qT = mmt::align16(L.vs + tile_bytes);
  L.acc = mmt::align16(L.qT + size_t(D) * Rp * sizeof(float));
  L.sc = mmt::align16(L.acc + size_t(rows) * D * sizeof(float));
  L.m = mmt::align16(L.sc + size_t(Rp) * kTile * sizeof(float));
  L.l = L.m + rows * sizeof(float);
  L.alpha = L.l + rows * sizeof(float);
  L.total = L.alpha + rows * sizeof(float);
  return L;
}

template <typename T, int kRowsCap>
__global__ void __launch_bounds__(kThreads)
ring_verify_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                         const T* __restrict__ v_pages, const T* __restrict__ k_ring,
                         const T* __restrict__ v_ring, const int* __restrict__ page_table,
                         const int* __restrict__ pages_len, const int* __restrict__ lengths,
                         float* __restrict__ partial, int B, int H, int Hkv, int S, int D,
                         int n_pages, int P, int pm, int T_ring, int layer, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = H / Hkv;
  const int R = group * S, Rp = (R + 3) & ~3;
  const Layout lay = layout<T>(R, D);
  const T** kptr = reinterpret_cast<const T**>(smem + lay.kptr);
  const T** vptr = reinterpret_cast<const T**>(smem + lay.vptr);
  T* ks = reinterpret_cast<T*>(smem + lay.ks);
  T* vs = reinterpret_cast<T*>(smem + lay.vs);
  float* qT = reinterpret_cast<float*>(smem + lay.qT);    // (D, Rp): query rows, transposed
  float* acc = reinterpret_cast<float*>(smem + lay.acc);  // (R, D)
  float* sc = reinterpret_cast<float*>(smem + lay.sc);    // (Rp, kTile)
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* alpha_s = reinterpret_cast<float*>(smem + lay.alpha);

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const int words = D * static_cast<int>(sizeof(T)) / 4;  // 32-bit words per K/V row
  const int rw = row_words<T>(D);
  const int stride = rw * 4 / static_cast<int>(sizeof(T));  // staged row stride, elements
  const int n_page_keys = mmt::clamp_int(pages_len[b], 0, pm * P);
  // ring row of the block's first query; the last row sees ring rows <= g + S - 1
  const long long g = static_cast<long long>(lengths[b]) - pages_len[b];
  const int n_ring_keys = mmt::clamp_int(g + S, 0, T_ring);
  const int n_keys = n_page_keys + n_ring_keys;

  // the R rows of this kv head are contiguous in q: its query heads, each
  // with its S block rows (h-major, s-minor)
  const size_t q0 = (size_t(b) * Hkv + h) * R * D;
  for (int i = threadIdx.x; i < Rp * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qT[d * Rp + r] = r < R ? mmt::to_float(q[q0 + i]) : 0.f;
  }
  for (int i = threadIdx.x; i < R * D; i += kThreads) acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
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

    // Stage the tile's K and V rows: each thread issues a batch of 4-byte
    // loads before it stores any of them, so the loads overlap.
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
          const int j = w / words, c = w % words;
          ks32[j * rw + c] = kw[u];
          vs32[j * rw + c] = vw[u];
        }
      }
    }
    __syncthreads();

    // Scores in 4 x 4 (row, key) tiles; masked entries are stored as -inf.
    for (int tile = threadIdx.x; tile < (Rp / 4) * (kTile / 4); tile += kThreads) {
      const int j0 = (tile % (kTile / 4)) * 4, r0 = (tile / (kTile / 4)) * 4;
      if (j0 >= nt) continue;
      const T* kr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) kr[u] = ks + min(j0 + u, nt - 1) * stride;
      float s[4][4] = {};
      for (int d = 0; d < D; ++d) {
        const float4 qv = *reinterpret_cast<const float4*>(qT + d * Rp + r0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float kd = mmt::to_float(kr[u][d]);
          s[0][u] = fmaf(qv.x, kd, s[0][u]);
          s[1][u] = fmaf(qv.y, kd, s[1][u]);
          s[2][u] = fmaf(qv.z, kd, s[2][u]);
          s[3][u] = fmaf(qv.w, kd, s[3][u]);
        }
      }
#pragma unroll
      for (int ru = 0; ru < 4; ++ru) {
        const int r = r0 + ru;
        if (r >= R) continue;
        const long long last_ring_row = g + r % S;  // row r sees ring rows <= this
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j >= nt) continue;
          const int i = t0 + j;
          const bool valid = i < n_page_keys || i - n_page_keys <= last_ring_row;
          sc[r * kTile + j] = valid ? s[ru][u] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per row. A row that has seen no valid key
    // yet keeps max -inf and takes 0 as its exponent reference.
    for (int r = warp; r < R; r += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < nt; j += mmt::kWarpSize) mx = fmaxf(mx, sc[r * kTile + j]);
      mx = mmt::warp_max(mx);
      const float m_new = fmaxf(m_s[r], mx);
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < nt; j += mmt::kWarpSize) {
        const float p = expf(sc[r * kTile + j] - m_ref);
        sc[r * kTile + j] = p;
        sum += p;
      }
      sum = mmt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_s[r] - m_ref);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // P V: each thread owns output columns d for all R rows.
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float a[kRowsCap];
#pragma unroll
      for (int r = 0; r < kRowsCap; ++r) a[r] = r < R ? acc[r * D + d] * alpha_s[r] : 0.f;
      int j = 0;
      for (; j + 4 <= nt; j += 4) {
        const float v0 = mmt::to_float(vs[(j + 0) * stride + d]);
        const float v1 = mmt::to_float(vs[(j + 1) * stride + d]);
        const float v2 = mmt::to_float(vs[(j + 2) * stride + d]);
        const float v3 = mmt::to_float(vs[(j + 3) * stride + d]);
#pragma unroll
        for (int r = 0; r < kRowsCap; ++r) {
          if (r < R) {
            const float4 p = *reinterpret_cast<const float4*>(sc + r * kTile + j);
            a[r] = fmaf(p.x, v0, fmaf(p.y, v1, fmaf(p.z, v2, fmaf(p.w, v3, a[r]))));
          }
        }
      }
      for (; j < nt; ++j) {
        const float vd = mmt::to_float(vs[j * stride + d]);
#pragma unroll
        for (int r = 0; r < kRowsCap; ++r)
          if (r < R) a[r] = fmaf(sc[r * kTile + j], vd, a[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsCap; ++r)
        if (r < R) acc[r * D + d] = a[r];
    }
    __syncthreads();  // the next tile rewrites kptr / vptr / ks / vs / sc
  }

  // partial layout per (slot, kv head, split): max[R], sum[R], acc[R * D]
  float* part = partial + ((size_t(b) * Hkv + h) * gridDim.z + split) * R * (D + 2);
  for (int i = threadIdx.x; i < R * D; i += kThreads) part[2 * R + i] = acc[i];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    part[r] = m_s[r];
    part[R + r] = l_s[r];
  }
}

template <typename T, int kRowsCap>
int launch_split(const void* q, const void* k_pages, const void* v_pages, const void* k_ring,
                 const void* v_ring, const void* page_table, const void* pages_len,
                 const void* lengths, void* partial, int B, int H, int Hkv, int S, int D,
                 int n_pages, int P, int pm, int T_ring, int layer, float scale, int n_splits,
                 cudaStream_t stream) {
  const size_t smem = layout<T>(H / Hkv * S, D).total;
  cudaError_t err = cudaFuncSetAttribute(ring_verify_split_kernel<T, kRowsCap>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_verify_split_kernel<T, kRowsCap><<<dim3(Hkv, B, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const T*>(k_ring),
      static_cast<const T*>(v_ring), static_cast<const int*>(page_table),
      static_cast<const int*>(pages_len), static_cast<const int*>(lengths),
      static_cast<float*>(partial), B, H, Hkv, S, D, n_pages, P, pm, T_ring, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_ring,
           const void* v_ring, const void* page_table, const void* pages_len,
           const void* lengths, void* partial, void* o, int B, int H, int Hkv, int S, int D,
           int n_pages, int P, int pm, int T_ring, int layer, float scale, int n_splits,
           cudaStream_t stream) {
  const int rows = H / Hkv * S;
  // the row count fixes the P V accumulators each thread keeps in registers
  decltype(&launch_split<T, 16>) split =
      rows <= 16 ? &launch_split<T, 16>
                 : (rows <= 32 ? &launch_split<T, 32> : &launch_split<T, kMaxRows>);
  int err = split(q, k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths, partial,
                  B, H, Hkv, S, D, n_pages, P, pm, T_ring, layer, scale, n_splits, stream);
  if (err != 0) return err;
  mmt::split_merge_kernel<T><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(o), Hkv, rows, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `partial` is float32 scratch of B * Hkv * n_splits * (H / Hkv * S) * (D + 2)
// values; n_splits * 128 must cover pages_max * P + T keys.
extern "C" int mmt_ring_verify_attention(const void* q, const void* k_pages,
                                         const void* v_pages, const void* k_ring,
                                         const void* v_ring, const void* page_table,
                                         const void* pages_len, const void* lengths,
                                         void* partial, void* o, int B, int H, int Hkv, int S,
                                         int D, int n_pages, int P, int pm, int T_ring,
                                         int layer, float scale, int n_splits, int dtype,
                                         void* stream) {
  if (Hkv <= 0 || S <= 0 || H % Hkv != 0 || H / Hkv * S > kMaxRows || D % 2 != 0 ||
      static_cast<long long>(n_splits) * kSplitKeys < static_cast<long long>(pm) * P + T_ring)
    return static_cast<int>(cudaErrorInvalidValue);
  MMT_DISPATCH_DTYPE(dtype, return launch<scalar_t>(q, k_pages, v_pages, k_ring, v_ring,
                                                     page_table, pages_len, lengths, partial,
                                                     o, B, H, Hkv, S, D, n_pages, P, pm,
                                                     T_ring, layer, scale, n_splits,
                                                     static_cast<cudaStream_t>(stream)));
}

// Keys per split of mmt_ring_verify_attention (sizes its scratch buffer).
extern "C" int mmt_ring_verify_split_keys() { return kSplitKeys; }

// Most query rows per kv head (group * S) the kernel takes.
extern "C" int mmt_ring_verify_max_rows() { return kMaxRows; }
