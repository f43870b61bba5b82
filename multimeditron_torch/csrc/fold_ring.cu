// K5: fold the decode ring into the page pool at the end of a decode chunk.
//
// Replaces the Pallas kernel `_fold_kernel` of
// multimeditron_tpu/ops/paged_attention.py (reached through
// `fold_ring_into_pages_pallas`). For every (layer, slot, kv head), ring rows
// r < nrows = min(max(lengths[b] - pages_len[b], 0), rows) move to position
// pages_len[b] + r of the slot, i.e. page page_table[b, pos / P], row pos % P,
// in place in the pool. Rows at positions >= lengths[b] are not written.
//
// What bounds it on the H100: bytes, and few of them. A chunk of c steps
// moves at most 2 * L * B * Hkv * c * D values (8 slots x 8 steps at
// Llama-3.1-8B widths: 8.4 MB in bf16), against the 0.69 GB pool it lands in.
//
// The simple design: one block per (kv head, slot, layer) copies its rows
// element by element, neighbouring threads on neighbouring columns. On the
// TPU the fold read and rewrote whole pages because Mosaic cannot store a
// sub-tile row, so the Pallas kernel rolled the ring into a two-page window;
// on Hopper a row store is plain, so no page is read. Page indices read from
// the table are clamped into the pool.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_ring_kernel(T* __restrict__ k_pages, T* __restrict__ v_pages,
                 const T* __restrict__ k_ring, const T* __restrict__ v_ring,
                 const int* __restrict__ page_table, const int* __restrict__ pages_len,
                 const int* __restrict__ lengths, int B, int Hkv, int D, int n_pages, int P,
                 int pm, int T_ring, int rows) {
  const int h = blockIdx.x, b = blockIdx.y, layer = blockIdx.z;
  const int plen = pages_len[b];
  if (plen < 0) return;
  const int nrows = mmt::clamp_int(static_cast<long long>(lengths[b]) - plen, 0, rows);
  const size_t ring0 = ((size_t(layer) * B + b) * Hkv + h) * T_ring * D;
  const size_t page_head0 = (size_t(layer) * Hkv + h) * n_pages;
  for (int idx = threadIdx.x; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const long long pos = static_cast<long long>(plen) + r;
    const int slot_page = mmt::clamp_int(pos / P, 0, pm - 1);
    const int page = mmt::clamp_int(page_table[size_t(b) * pm + slot_page], 0, n_pages - 1);
    const size_t dst = ((page_head0 + page) * P + pos % P) * D + d;
    const size_t src = ring0 + size_t(r) * D + d;
    k_pages[dst] = k_ring[src];
    v_pages[dst] = v_ring[src];
  }
}

template <typename T>
int launch(void* k_pages, void* v_pages, const void* k_ring, const void* v_ring,
           const void* page_table, const void* pages_len, const void* lengths, int L, int B,
           int Hkv, int D, int n_pages, int P, int pm, int T_ring, int rows,
           cudaStream_t stream) {
  fold_ring_kernel<T><<<dim3(Hkv, B, L), kThreads, 0, stream>>>(
      static_cast<T*>(k_pages), static_cast<T*>(v_pages), static_cast<const T*>(k_ring),
      static_cast<const T*>(v_ring), static_cast<const int*>(page_table),
      static_cast<const int*>(pages_len), static_cast<const int*>(lengths), B, Hkv, D,
      n_pages, P, pm, T_ring, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmt_fold_ring_into_pages(void* k_pages, void* v_pages, const void* k_ring,
                                        const void* v_ring, const void* page_table,
                                        const void* pages_len, const void* lengths, int L,
                                        int B, int Hkv, int D, int n_pages, int P, int pm,
                                        int T_ring, int rows, int dtype, void* stream) {
  MMT_DISPATCH_DTYPE(dtype, return launch<scalar_t>(k_pages, v_pages, k_ring, v_ring,
                                                     page_table, pages_len, lengths, L, B, Hkv,
                                                     D, n_pages, P, pm, T_ring, rows,
                                                     static_cast<cudaStream_t>(stream)));
}
