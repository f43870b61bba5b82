// K4: one decode step of paged + ring attention per serving slot, and K8:
// one decode step of paged attention without a ring.
//
// K4 replaces the Pallas kernel `_ring_decode_kernel` of
// multimeditron_tpu/ops/paged_attention.py (reached through
// `ring_decode_attention_pallas`). Slot b's query attends over
//   - its prompt/folded tokens in the page pool: positions < pages_len[b],
//     position i at page page_table[b, i / P], row i % P, of layer
//     `layer_index` of the pool (L, Hkv, n_pages, P, D);
//   - its in-chunk ring rows r <= lengths[b] - pages_len[b] of layer
//     `layer_index` of the ring (L, B, Hkv, T, D) (row lengths-pages_len holds
//     this step's own token).
// K8 replaces `_paged_kernel` of the same file (reached through
// `paged_attention_pallas`): slot b's query attends over positions
// < lengths[b] of ONE layer's pool (Hkv, n_pages, P, D) through its page
// table, the step's own token included; a slot of length 0 gets zeros. It is
// K4 with no ring (the `kRing` template parameter below), so only the first
// ceil(lengths[b] / P) pages of a slot are read, as the Pallas kernel's
// clamped page index arranges.
//
// What bounds them on the H100: bytes. Each step reads every valid key and
// value row once (2 * N * D values per slot and kv head) and does 4 * group *
// N * D FLOPs on them: about `group` FLOPs per byte, far below the ~295 the
// card needs before compute matters. At Llama-3.1-8B widths (8 slots, 576
// tokens, 8 kv heads, D = 128, bf16) that is 19 MB per layer per step: 5.6 us.
//
// The design (flash-decoding, one launch):
// - Work items. Every block reads the slots' valid key counts and cuts each
//   (slot, kv head)'s keys into splits of L keys, L a multiple of 64 chosen
//   from the total so that the items number about as many as the blocks the
//   card holds; a persistent grid takes the items in turns. No block is
//   sized by pages_max, and no item is empty (a slot with no valid key is one
//   item that writes zeros). An item serves all `group` query heads of its
//   kv head, so each K/V row is read once for the group (GQA without repeat).
// - Bulk copies. Lane j of warp 0 brings the j-th run of rows of a tile
//   (rows of one page, or of the slot's ring) into a ring of 64-row stages
//   by TMA: 2-D tensor maps over the pool and the ring (rows of D values,
//   boxes of 128 bytes by min(P, 64) or 8 rows, the 128-byte swizzle that
//   keeps the tensor cores' shared loads conflict-free), completion on the
//   stage's mbarrier; a tile never mixes pages and ring rows. Loads of later
//   tiles overlap the current tile's compute. The maps are encoded on the
//   host and kept in a small cache keyed by the tensor (the pool and ring
//   live as long as the engine). A box may carry rows past a slot's valid
//   keys (the rest of its last page): they are masked out of the scores,
//   and the V rows of a partial tile are zeroed in shared memory before the
//   tensor cores read them (0 * NaN = NaN), so stale or poisoned pool rows
//   never reach an output. (One bulk copy a row, 256 bytes, measured 13.5 us
//   a 64-row tile: the copy engine's cost a request, not the bytes, bounded
//   it.)
// - bf16 on tensor cores (mma.sync m16n8k16): each warp takes 16 keys of
//   every tile; S^T = q K^T with the group's query heads padded to 16 rows as
//   the A operand (registers, loaded once an item) and keys as n; P stays in
//   registers as the A operand of O += P V (FlashAttention-2's register
//   reuse), V's B fragments by ldmatrix.trans. Each warp keeps its own online
//   softmax (max, sum, O) in the base-2 domain of the Pallas kernels
//   (sm_scale * log2 e folded into the scale, exp2); the four warps merge
//   in warp order at the end of the item.
// - float32 on the CUDA cores (TF32 would break the float32 tolerance): one
//   warp scores a key row (lanes split D, a shuffle reduction per head), one
//   warp per head keeps the online softmax, each thread accumulates output
//   columns for every head.
// - The merge, in the same launch. An item that is its (slot, kv head)'s
//   only split writes the output; otherwise it writes its (max, sum,
//   accumulator) record to a float32 workspace and arrives at the (slot, kv
//   head)'s counter (an atomic), and the last split to arrive merges the
//   records in split order, normalises, writes the output and resets the
//   counter to 0. The same inputs give the same bits on every run.
// Every page index read from the table is clamped into the pool, and the
// valid counts are clamped to the table and the ring: inactive slots carry
// stale tables and lengths, and their output is garbage by contract but
// never reads out of bounds.
#include <cstdint>

#include "flash.cuh"
#include "hopper.cuh"

namespace {

using mmt::hopper::smem_u32;
namespace fm = mmt::flash::mma;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / mmt::kWarpSize;
constexpr int kTile = 64;       // key rows a stage
constexpr int kBoxBytes = 128;  // bytes of a row a box holds (the swizzle's width)
constexpr int kRingBox = 8;     // ring rows a box
constexpr int kMaxGroup = 16;   // query heads per kv head (rows of the padded A operand)
constexpr int kMaxD = 128;
constexpr int kMaxSlots = 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;

template <typename T>
struct Cfg {
  // two stages: three bf16 blocks an SM at D = 128 (three stages, two blocks,
  // measured slower at phase 5's shape and K8's serving case)
  static constexpr int kStages = 2;
  static constexpr int kPerBox = kBoxBytes / sizeof(T);  // values of a row a box holds
};

// Shared memory, in bytes from a 1024-aligned base: the ring of stages (a K
// tile, then a V tile: D / kPerBox column boxes of 64 rows x 128 bytes each,
// in the 128-byte swizzle); the item's record (max, sum, alpha and the
// accumulator of each query head); float32 only: the query rows and a tile's
// scores; bf16 only: each warp's max and sum; the slots' valid key counts and
// item prefix; the stages' mbarriers. The bf16 merge of the warps'
// accumulators reuses the ring.
struct Layout {
  int boxes;  // column boxes of a row
  size_t tile, stage, rec, qs, sc, mw, plan, bars, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int D, int B) {
  constexpr bool f32 = sizeof(T) == 4;
  Layout s;
  s.boxes = (D + Cfg<T>::kPerBox - 1) / Cfg<T>::kPerBox;
  s.tile = size_t(s.boxes) * kTile * kBoxBytes;
  s.stage = 2 * s.tile;
  s.rec = Cfg<T>::kStages * s.stage;
  s.qs = s.rec + (3 * kMaxGroup + kMaxGroup * size_t(D)) * 4;
  s.sc = s.qs + (f32 ? kMaxGroup * size_t(D) * 4 : 0);
  s.mw = s.sc + (f32 ? kMaxGroup * kTile * 4 : 0);
  s.plan = s.mw + (f32 ? 0 : 2 * kWarps * kMaxGroup * 4);
  s.bars = mmt::align16(s.plan + (2 * size_t(B) + 1) * 4);
  s.total = s.bars + Cfg<T>::kStages * 8 + 1024;  // + room to align the base to 1024
  return s;
}

// Byte offset of value (r, d) in a staged tile: column box d / kPerBox,
// 16-byte chunk c of row r at chunk c ^ (r % 8).
template <typename T>
__device__ __forceinline__ int swz(int r, int d) {
  const int box = d / Cfg<T>::kPerBox, byte = (d % Cfg<T>::kPerBox) * int(sizeof(T));
  return box * (kTile * kBoxBytes) + r * kBoxBytes + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

// Orders this thread's generic shared-memory writes before later TMA copies
// into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(r0)
      : "memory");
}

struct Args {
  const void* q;
  const int* page_table;
  const int* pages_len;
  const int* lengths;
  float* work;
  int* counters;
  void* o;
  int B, H, Hkv, D, n_pages, P, pm, T_ring, layer, max_splits;
  float scale;  // sm_scale * log2 e
};

struct Maps {
  CUtensorMap k_pages, v_pages, k_ring, v_ring;
};

// Slot b's valid keys: pages, then (K4) ring rows.
template <bool kRing>
__device__ __forceinline__ void slot_keys(const Args& a, int b, int& n_page, int& n_keys) {
  n_page = mmt::clamp_int(a.pages_len[b], 0, a.pm * a.P);
  const int n_ring =
      kRing ? mmt::clamp_int(static_cast<long long>(a.lengths[b]) - a.pages_len[b] + 1, 0,
                             a.T_ring)
            : 0;
  n_keys = n_page + n_ring;
}

// Warp 0 brings keys [k0, k0 + rows) of (slot b, kv head h), all pages or
// all ring rows, into a stage: lane j issues box j of min(P, 64) page rows
// (or 8 ring rows), every column box of K and of V.
template <typename T>
__device__ __forceinline__ void issue_tile(const Args& a, const Maps& maps, int b, int h,
                                           int n_page, int k0, int rows, unsigned char* stage,
                                           size_t tile_bytes, int boxes, uint64_t* bar,
                                           int lane) {
  const bool ring = k0 >= n_page;
  const int box_rows = ring ? kRingBox : min(a.P, kTile);
  const int n_box = (rows + box_rows - 1) / box_rows;
  if (lane == 0)
    mmt::hopper::mbar_arrive_expect_tx(bar, 2u * n_box * boxes * box_rows * kBoxBytes);
  __syncwarp();
  if (lane >= n_box) return;
  const int i = k0 + lane * box_rows;  // the box's first key
  int row;
  if (ring) {
    row = ((a.layer * a.B + b) * a.Hkv + h) * a.T_ring + (i - n_page);
  } else {
    const int page = mmt::clamp_int(a.page_table[size_t(b) * a.pm + i / a.P], 0, a.n_pages - 1);
    row = ((a.layer * a.Hkv + h) * a.n_pages + page) * a.P + i % a.P;
  }
  const CUtensorMap* km = ring ? &maps.k_ring : &maps.k_pages;
  const CUtensorMap* vm = ring ? &maps.v_ring : &maps.v_pages;
  unsigned char* dst = stage + lane * box_rows * kBoxBytes;
  for (int c = 0; c < boxes; ++c) {
    tma_load_2d(dst + c * (kTile * kBoxBytes), km, bar, c * Cfg<T>::kPerBox, row);
    tma_load_2d(dst + tile_bytes + c * (kTile * kBoxBytes), vm, bar, c * Cfg<T>::kPerBox, row);
  }
}

// The tiles of an item, keys [k0, k1): 64-key tiles of its pages, then of
// its ring rows.
__device__ __forceinline__ int item_tiles(int k0, int k1, int n_page) {
  const int pe = min(k1, n_page), rs = max(k0, n_page);
  return (pe > k0 ? (pe - k0 + kTile - 1) / kTile : 0) +
         (k1 > rs ? (k1 - rs + kTile - 1) / kTile : 0);
}
__device__ __forceinline__ void tile_keys(int i, int k0, int k1, int n_page, int& t0,
                                          int& rows) {
  const int pe = min(k1, n_page), rs = max(k0, n_page);
  const int n_pt = pe > k0 ? (pe - k0 + kTile - 1) / kTile : 0;
  if (i < n_pt) {
    t0 = k0 + i * kTile;
    rows = min(kTile, pe - t0);
  } else {
    t0 = rs + (i - n_pt) * kTile;
    rows = min(kTile, k1 - t0);
  }
}

// ---------------------------------------------------------------------------
// bf16: a warp's 16 keys of a tile on the tensor cores
// ---------------------------------------------------------------------------
struct Bf16State {
  uint32_t qa[kMaxD / 16][4];  // q as A fragments: heads g (a0, a2) and g + 8 (a1, a3)
  float o[kMaxD / 8][4];       // O: heads g (0, 1) and g + 8 (2, 3), d = 8 j + 2 t (+1)
  float m[2], l[2];            // heads g and g + 8 (l: this thread's share)
};

__device__ __forceinline__ void bf16_begin(Bf16State& st, const __nv_bfloat16* q, int group,
                                           int D, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kMaxD / 16; ++kk) {
    if (kk < D / 16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int head = g + 8 * (e & 1), d = 16 * kk + 2 * t + 8 * (e >> 1);
        st.qa[kk][e] = head < group
                           ? *reinterpret_cast<const uint32_t*>(q + size_t(head) * D + d)
                           : 0u;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void bf16_tile(Bf16State& st, uint32_t ks, uint32_t vs, int rows,
                                          int D, float scale, int warp, int lane) {
  using T = __nv_bfloat16;
  const int t = lane % 4;
  const int key0 = 16 * warp;
  if (key0 >= rows) return;  // no valid key of this warp in the tile
  float c[2][4] = {};
  // B fragments of S^T = q K^T: keys key0.. as n (two 8-key n-tiles), d as k
  const int kr = key0 + (lane & 7) + ((lane >> 4) << 3), kd = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kMaxD / 16; ++kk) {
    if (kk < D / 16) {
      uint32_t bfr[4];
      ldsm_x4(bfr, ks + swz<T>(kr, 16 * kk + kd));
      fm::mma_bf16(c[0], st.qa[kk], bfr[0], bfr[1]);
      fm::mma_bf16(c[1], st.qa[kk], bfr[2], bfr[3]);
    }
  }
  // c[n][e]: head g + 8 (e / 2), key key0 + 8 n + 2 t + e % 2
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool valid = key0 + 8 * n + 2 * t + (e & 1) < rows;
      c[n][e] = valid ? c[n][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], c[n][e]);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(st.m[r], fm::quad_max(mx[r]));
    // a head that has seen no valid key keeps m = -inf: its p are 0 and
    // nothing is rescaled
    alpha[r] = m_new == -INFINITY ? 1.f : exp2f(st.m[r] - m_new);
    st.m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mr = st.m[e >> 1];
      const float p = mr == -INFINITY ? 0.f : exp2f(c[n][e] - mr);
      c[n][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j) {
    st.o[j][0] *= alpha[0];
    st.o[j][1] *= alpha[0];
    st.o[j][2] *= alpha[1];
    st.o[j][3] *= alpha[1];
  }
  uint32_t pa[4];
  fm::accum_to_a(pa, c[0], c[1]);  // p rounded to bf16, as the twin casts p to v's dtype
  // B fragments of O += P V: keys key0.. as k, d as n (two 8-column n-tiles)
  const int vr = key0 + (lane & 7) + ((lane >> 3) & 1) * 8, vd = (lane >> 4) * 8;
#pragma unroll
  for (int jj = 0; jj < kMaxD / 16; ++jj) {
    if (jj < D / 16) {
      uint32_t bfr[4];
      ldsm_x4_trans(bfr, vs + swz<T>(vr, 16 * jj + vd));
      fm::mma_bf16(st.o[2 * jj], pa, bfr[0], bfr[1]);
      fm::mma_bf16(st.o[2 * jj + 1], pa, bfr[2], bfr[3]);
    }
  }
}

// The four warps' (max, sum, O) into the item's record, in warp order.
__device__ __forceinline__ void bf16_end(Bf16State& st, float* rec_m, float* rec_l,
                                         float* rec_acc, float* mw, float* lw, float* scratch,
                                         int group, int D, int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = fm::quad_sum(st.l[r]);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mw[warp * kMaxGroup + g + 8 * r] = st.m[r];
      lw[warp * kMaxGroup + g + 8 * r] = st.l[r];
    }
  }
  __syncthreads();
  float factor[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int head = g + 8 * r;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kMaxGroup + head]);
    const float mine = mw[warp * kMaxGroup + head];
    factor[r] = mine == -INFINITY ? 0.f : exp2f(mine - mx);
  }
  // this warp's O, rescaled to the common max, into its scratch slice
  float* mine = scratch + size_t(warp) * kMaxGroup * D;
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j) {
    if (j < D / 8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int head = g + 8 * (e >> 1);
        if (head < group) mine[head * D + 8 * j + 2 * t + (e & 1)] = st.o[j][e] * factor[e >> 1];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += scratch[size_t(w) * kMaxGroup * D + i];
    rec_acc[i] = a;
  }
  if (threadIdx.x < group) {
    const int head = threadIdx.x;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kMaxGroup + head]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float m = mw[w * kMaxGroup + head];
      l += m == -INFINITY ? 0.f : lw[w * kMaxGroup + head] * exp2f(m - mx);
    }
    rec_m[head] = mx;
    rec_l[head] = l;
  }
  fence_proxy_async();  // the scratch lies in the ring, which TMA refills
}

// ---------------------------------------------------------------------------
// float32: a tile on the CUDA cores, every warp on every key
// ---------------------------------------------------------------------------
__device__ __forceinline__ void f32_tile(const unsigned char* ks, const unsigned char* vs,
                                         int rows, int group, int D, float scale,
                                         const float* qs, float* acc, float* sc, float* m_s,
                                         float* l_s, float* alpha_s, int warp, int lane) {
  auto at = [](const unsigned char* tile, int r, int d) {
    return *reinterpret_cast<const float*>(tile + swz<float>(r, d));
  };
  // scores: one warp per key row, lanes split the head dim
  for (int j = warp; j < rows; j += kWarps) {
    float part[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) part[g] = 0.f;
    for (int d = lane; d < D; d += mmt::kWarpSize) {
      const float kd = at(ks, j, d);
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
  // online softmax: one warp per query head
  for (int g = warp; g < group; g += kWarps) {
    float mx = -INFINITY;
    for (int j = lane; j < rows; j += mmt::kWarpSize) mx = fmaxf(mx, sc[g * kTile + j]);
    mx = mmt::warp_max(mx);
    const float m_new = fmaxf(m_s[g], mx);
    float sum = 0.f;
    for (int j = lane; j < rows; j += mmt::kWarpSize) {
      const float p = exp2f(sc[g * kTile + j] - m_new);
      sc[g * kTile + j] = p;
      sum += p;
    }
    sum = mmt::warp_sum(sum);
    if (lane == 0) {
      alpha_s[g] = exp2f(m_s[g] - m_new);
      l_s[g] = l_s[g] * alpha_s[g] + sum;
      m_s[g] = m_new;
    }
  }
  __syncthreads();
  // P V: each thread owns output columns d for every head of the group
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) o[g] = g < group ? acc[g * D + d] * alpha_s[g] : 0.f;
    for (int j = 0; j < rows; ++j) {
      const float vd = at(vs, j, d);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) o[g] = fmaf(sc[g * kTile + j], vd, o[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) acc[g * D + d] = o[g];
  }
}

template <typename T, bool kRing>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kStages = Cfg<T>::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout lay = layout<T>(a.D, a.B);
  const int D = a.D, group = a.H / a.Hkv;
  float* rec_m = reinterpret_cast<float*>(smem + lay.rec);
  float* rec_l = rec_m + kMaxGroup;
  float* rec_alpha = rec_l + kMaxGroup;
  float* rec_acc = rec_alpha + kMaxGroup;
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* mw = reinterpret_cast<float*>(smem + lay.mw);
  float* lw = mw + kWarps * kMaxGroup;
  int* n_keys_s = reinterpret_cast<int*>(smem + lay.plan);
  int* first_item = n_keys_s + a.B;  // B + 1 prefix sums
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  __shared__ int last_flag, split_len;
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;

  // The plan, the same in every block: each slot's valid keys, the split
  // length L (the least multiple of 64 from total keys / blocks up that
  // gives no more items than blocks) and the first item of each slot (Hkv x
  // its split count, at least one).
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mmt::hopper::mbar_init(&full[s], 1);
    mmt::hopper::fence_barrier_init();
  }
  for (int b = threadIdx.x; b < a.B; b += kThreads) {
    int n_page, n;
    slot_keys<kRing>(a, b, n_page, n);
    n_keys_s[b] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int b = 0; b < a.B; ++b) total += n_keys_s[b];
    const long long per = (total * a.Hkv + gridDim.x - 1) / gridDim.x;
    int len = static_cast<int>((per + kTile - 1) / kTile * kTile);
    len = len < kTile ? kTile : len;
    int items;
    for (;; len += kTile) {
      items = 0;
      for (int b = 0; b < a.B; ++b) {
        const int splits = (n_keys_s[b] + len - 1) / len;
        items += a.Hkv * (splits < 1 ? 1 : splits);
      }
      if (items <= static_cast<int>(gridDim.x) || items <= a.B * a.Hkv) break;
    }
    split_len = len;
    int acc = 0;
    for (int b = 0; b < a.B; ++b) {
      first_item[b] = acc;
      const int splits = (n_keys_s[b] + len - 1) / len;
      acc += a.Hkv * (splits < 1 ? 1 : splits);
    }
    first_item[a.B] = acc;
  }
  __syncthreads();
  const int L = split_len, items = first_item[a.B];

  int consumed = 0;  // tiles this block has taken from the ring
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int b = 0;
    while (first_item[b + 1] <= item) ++b;
    const int n = n_keys_s[b];
    const int splits_b = n > 0 ? (n + L - 1) / L : 1;
    const int r = item - first_item[b], h = r / splits_b, split = r % splits_b;
    int n_page, n_keys;
    slot_keys<kRing>(a, b, n_page, n_keys);
    const int k0 = split * L, k1 = min(k0 + L, n);
    const int n_tiles = k1 > k0 ? item_tiles(k0, k1, n_page) : 0;
    const T* q = static_cast<const T*>(a.q) + (size_t(b) * a.H + size_t(h) * group) * D;

    __syncthreads();  // the ring and the record are free (the previous item is done)
    if (warp == 0) {
      for (int i = 0; i < n_tiles && i < kStages; ++i) {
        const int tt = consumed + i;
        int t0, rows;
        tile_keys(i, k0, k1, n_page, t0, rows);
        issue_tile<T>(a, maps, b, h, n_page, t0, rows, smem + (tt % kStages) * lay.stage,
                      lay.tile, lay.boxes, &full[tt % kStages], lane);
      }
    }
    Bf16State st;
    if constexpr (kF32) {
      for (int i = threadIdx.x; i < group * D; i += kThreads) {
        qs[i] = mmt::to_float(q[i]);
        rec_acc[i] = 0.f;
      }
      if (threadIdx.x < group) {
        rec_m[threadIdx.x] = -INFINITY;
        rec_l[threadIdx.x] = 0.f;
      }
      __syncthreads();
    } else {
      bf16_begin(st, reinterpret_cast<const __nv_bfloat16*>(q), group, D, lane / 4, lane % 4);
    }

    for (int i = 0; i < n_tiles; ++i, ++consumed) {
      const int s = consumed % kStages;
      int t0, rows;
      tile_keys(i, k0, k1, n_page, t0, rows);
      unsigned char* ks = smem + s * lay.stage;
      unsigned char* vs = ks + lay.tile;
      mmt::hopper::mbar_wait(&full[s], (consumed / kStages) & 1);
      if constexpr (kF32) {
        f32_tile(ks, vs, rows, group, D, a.scale, qs, rec_acc, sc, rec_m, rec_l, rec_alpha, warp,
                 lane);
      } else {
        if (rows < kTile) {  // zero the V rows past the valid keys (0 * NaN = NaN)
          const int row_bytes = lay.boxes * kBoxBytes;
          for (int e = threadIdx.x; e < (kTile - rows) * row_bytes / 16; e += kThreads) {
            const int rr = rows + e / (row_bytes / 16), cc = e % (row_bytes / 16);
            *reinterpret_cast<uint4*>(vs + (cc / 8) * (kTile * kBoxBytes) + rr * kBoxBytes +
                                      (cc % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();
          __syncthreads();
        }
        bf16_tile(st, smem_u32(ks), smem_u32(vs), rows, D, a.scale, warp, lane);
      }
      __syncthreads();  // every warp is done with stage s
      if (warp == 0 && i + kStages < n_tiles) {
        int nt0, nrows;
        tile_keys(i + kStages, k0, k1, n_page, nt0, nrows);
        issue_tile<T>(a, maps, b, h, n_page, nt0, nrows, ks, lay.tile, lay.boxes, &full[s],
                      lane);
      }
    }
    if constexpr (!kF32) {
      bf16_end(st, rec_m, rec_l, rec_acc, mw, lw, reinterpret_cast<float*>(smem), group, D,
               warp, lane);
    }
    __syncthreads();  // the record is complete

    T* o = static_cast<T*>(a.o) + (size_t(b) * a.H + size_t(h) * group) * D;
    if (splits_b == 1) {
      for (int i = threadIdx.x; i < group * D; i += kThreads) {
        const float l = rec_l[i / D];
        o[i] = mmt::from_float<T>(l > 0.f ? rec_acc[i] / l : 0.f);
      }
      continue;
    }
    // record layout per (slot, kv head, split): max[group], sum[group], acc[group * D]
    const size_t stride = size_t(group) * (D + 2);
    float* base = a.work + (size_t(b) * a.Hkv + h) * a.max_splits * stride;
    float* part = base + split * stride;
    for (int i = threadIdx.x; i < group * D; i += kThreads) __stcg(part + 2 * group + i, rec_acc[i]);
    if (threadIdx.x < group) {
      __stcg(part + threadIdx.x, rec_m[threadIdx.x]);
      __stcg(part + group + threadIdx.x, rec_l[threadIdx.x]);
    }
    // the barrier orders every thread's record before thread 0's fence and
    // arrival (release), and its fence after the count (acquire) before
    // every thread's reads
    __syncthreads();
    int* counter = a.counters + size_t(b) * a.Hkv + h;
    if (threadIdx.x == 0) {
      __threadfence();
      const bool is_last = atomicAdd(counter, 1) == splits_b - 1;
      if (is_last) __threadfence();
      last_flag = is_last;
    }
    __syncthreads();
    if (!last_flag) continue;
    for (int i = threadIdx.x; i < group * D; i += kThreads) {
      const int row = i / D;
      float m = -INFINITY;
      for (int s = 0; s < splits_b; ++s) m = fmaxf(m, __ldcg(base + s * stride + row));
      float l = 0.f, acc = 0.f;
      if (m > -INFINITY) {
        for (int s = 0; s < splits_b; ++s) {
          const float* p = base + s * stride;
          const float w = exp2f(__ldcg(p + row) - m);  // 0 for a split that saw no key
          l = fmaf(__ldcg(p + group + row), w, l);
          acc = fmaf(__ldcg(p + 2 * group + i), w, acc);
        }
      }
      o[i] = mmt::from_float<T>(l > 0.f ? acc / l : 0.f);
    }
    if (threadIdx.x == 0) *counter = 0;  // zeroed for the next call
  }
}

// A (rows, D) row-major tensor as a 2-D map whose boxes are `box_rows` rows
// of 128 bytes in the 128-byte swizzle; values past D and rows past `rows`
// read as zeros. Maps are kept in a small cache keyed by the tensor: the
// pool and ring outlive many calls.
template <typename T>
int tensor_map(CUtensorMap* map, const void* base, long long rows, int D, int box_rows) {
  struct Entry {
    const void* base;
    long long rows;
    int D, box_rows, size;
    CUtensorMap map;
  };
  static Entry cache[16];
  static int next = 0;
  for (const Entry& e : cache) {
    if (e.base == base && e.rows == rows && e.D == D && e.box_rows == box_rows &&
        e.size == int(sizeof(T))) {
      *map = e.map;
      return 0;
    }
  }
  const PFN_cuTensorMapEncodeTiled_v12000 encode = mmt::hopper::tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cuuint64_t(D), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(D) * sizeof(T)};
  const cuuint32_t box[2] = {cuuint32_t(Cfg<T>::kPerBox), cuuint32_t(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
      const_cast<void*>(base), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  cache[next] = Entry{base, rows, D, box_rows, int(sizeof(T)), *map};
  next = (next + 1) % 16;
  return 0;
}

template <typename T, bool kRing>
int launch(const void* k_pages, const void* v_pages, const void* k_ring, const void* v_ring,
           int L, const Args& a, cudaStream_t stream) {
  Maps maps;
  const long long pool_rows = (long long)L * a.Hkv * a.n_pages * a.P;
  const int page_box = a.P < kTile ? a.P : kTile;
  int err = tensor_map<T>(&maps.k_pages, k_pages, pool_rows, a.D, page_box);
  if (err == 0) err = tensor_map<T>(&maps.v_pages, v_pages, pool_rows, a.D, page_box);
  if (kRing) {
    const long long ring_rows = (long long)L * a.B * a.Hkv * a.T_ring;
    if (err == 0) err = tensor_map<T>(&maps.k_ring, k_ring, ring_rows, a.D, kRingBox);
    if (err == 0) err = tensor_map<T>(&maps.v_ring, v_ring, ring_rows, a.D, kRingBox);
  } else {
    maps.k_ring = maps.k_pages;
    maps.v_ring = maps.v_pages;
  }
  if (err != 0) return err;
  static bool attr_set = false;  // the largest size, once a process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, kRing>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(layout<T>(kMaxD, kMaxSlots).total));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  // the persistent grid: as many blocks as the SMs hold at this size (<= 4 an SM)
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return static_cast<int>(cudaErrorNoDevice);
  }
  const size_t smem = layout<T>(a.D, a.B).total;
  int per_sm = static_cast<int>(kSmemLimit / (smem + 1024));
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  decode_kernel<T, kRing><<<sms * per_sm, kThreads, smem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

// P a multiple of 8 that divides 64 or that 64 divides: a 64-key tile is
// whole pages or part of one page.
bool bad_shape(int B, int H, int Hkv, int D, int P, int max_splits, int dtype) {
  return B < 1 || B > kMaxSlots || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || D < 1 ||
         D > kMaxD || D % (dtype == 1 ? 16 : 4) != 0 || P < 8 || P % 8 != 0 ||
         (P % kTile != 0 && kTile % P != 0) || max_splits < 1;
}

}  // namespace

// The pool is (L, Hkv, n_pages, P, D) and the ring (L, B, Hkv, T, D); `work`
// is float32 scratch of B * Hkv * max_splits * (H / Hkv) * (D + 2) values
// with max_splits >= ceil((pages_max * P + T) / 64); `counters` B * Hkv
// int32 zeros, left zero. bf16 takes D % 16 == 0, float32 D % 4 == 0,
// D <= 128; P a multiple of 8 that divides 64 or is a multiple of it.
extern "C" int mmt_ring_decode_attention(const void* q, const void* k_pages,
                                         const void* v_pages, const void* k_ring,
                                         const void* v_ring, const void* page_table,
                                         const void* pages_len, const void* lengths,
                                         void* work, void* counters, void* o, int L, int B,
                                         int H, int Hkv, int D, int n_pages, int P, int pm,
                                         int T_ring, int layer, float scale, int max_splits,
                                         int dtype, void* stream) {
  if (bad_shape(B, H, Hkv, D, P, max_splits, dtype) || L < 1 || layer < 0 || layer >= L ||
      T_ring < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, static_cast<const int*>(page_table), static_cast<const int*>(pages_len),
               static_cast<const int*>(lengths), static_cast<float*>(work),
               static_cast<int*>(counters), o, B, H, Hkv, D, n_pages, P, pm, T_ring, layer,
               max_splits, scale * kLog2e};
  MMT_DISPATCH_DTYPE(dtype, return launch<scalar_t, true>(k_pages, v_pages, k_ring, v_ring, L, a,
                                                          static_cast<cudaStream_t>(stream)));
}

// K8 on one layer's pool (Hkv, n_pages, P, D); work and counters as above,
// with max_splits >= ceil(pages_max * P / 64).
extern "C" int mmt_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                   const void* page_table, const void* lengths, void* work,
                                   void* counters, void* o, int B, int H, int Hkv, int D,
                                   int n_pages, int P, int pm, float scale, int max_splits,
                                   int dtype, void* stream) {
  if (bad_shape(B, H, Hkv, D, P, max_splits, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, static_cast<const int*>(page_table), static_cast<const int*>(lengths),
               static_cast<const int*>(lengths), static_cast<float*>(work),
               static_cast<int*>(counters), o, B, H, Hkv, D, n_pages, P, pm, 0, 0, max_splits,
               scale * kLog2e};
  MMT_DISPATCH_DTYPE(dtype, return launch<scalar_t, false>(k_pages, v_pages, nullptr, nullptr, 1,
                                                           a, static_cast<cudaStream_t>(stream)));
}

// The fewest keys a split of mmt_ring_decode_attention and mmt_paged_attention
// takes (sizes their workspace: max_splits).
extern "C" int mmt_ring_decode_split_keys() { return kTile; }
