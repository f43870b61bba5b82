// K3: non-causal encoder attention for the ViT towers, in model layout.
//
// Replaces the Pallas kernel `_kernel` of multimeditron_tpu/ops/encoder_attention.py
// (reached through `encoder_attention`): softmax(Q K^T * scale) V per head,
// with q, k, v and o all in the projections' (B, S, H*Dh) layout and keys at
// positions >= kv_len masked out. Query rows >= kv_len are computed with the
// same mask; the caller drops them.
//
// What bounds it on the H100: CLIP ViT-L/14 has S = 257, Dh = 64, H = 16.
// Per (image, head) the two products are 4*S*S*Dh = 16.9 MFLOP against
// 4*S*Dh*2 = 132 KB of q/k/v/o: 128 operations a byte, under the card's
// ~295 for bf16, so a kernel that reads each byte once is bound by device
// memory (0.0050 ms for the 8-image serving batch, 0.16 ms for an encode
// batch of 256). In practice the SM's work bounds it: with Dh = 64 each score
// costs as much on the special-function unit (exp2) as on the tensor cores,
// and staging K and V alone takes about a quarter of the time. On the CUDA
// cores (the first version of this kernel: 0.2420 ms on the device at the
// serving shape) the same work was bound by FMA throughput.
//
// bf16, the design: each (image, head) is one block of 8 warps that holds ALL
// of the head's keys: K and V (rows < kv_len, rounded up to 16 with zero
// rows, head dim padded to DP, a multiple of 16, with zero columns) are
// staged into shared memory once, by cp.async (by 4-byte loads for an even
// head dim that is not a multiple of 8), in 64-key chunks, each with an
// mbarrier that the copies arrive on, so the first query rows start on chunk
// 0 while later chunks land. The warps then take the head's query rows in m16
// slices (S = 257 is 17): each warp stages its next slice's rows into its
// own shared buffer by cp.async while the current slice computes, S = Q K^T
// and O += P V run on mma.sync m16n8k16 with f32 accumulators, and an online softmax in base 2 walks the keys in steps of
// 64 (16 for the ragged tail), with the scale folded into the exponent's FMA.
// P goes from the score accumulators into A fragments, rounded to bf16 as
// the plain twin rounds p before P V, without a trip through shared memory
// (flash.cuh's fragment helpers, shared with K1). When there are too few
// heads to fill the card (the 8-image serving batch has 128 for 132 SMs),
// 2 or 4 blocks share a head's slices and each stages its K and V (the second
// read comes from L2). Zero padding rows matter: a masked score gives p = 0,
// and 0 * NaN would be NaN if the padding held garbage. Shared memory per
// block is (2 * ceil16(S) + 8 * 16) * (DP + 8) * 2 bytes (97 KB at S = 257,
// DP = 64: two blocks an SM).
//
// float32 keeps the CUDA-core kernel below in exact float32 (TF32 would miss
// the float32 tolerance): one block of 8 warps per (64-row query tile, head,
// image) stages the head's K and V, each warp scores two query rows at a
// time (lane j takes keys j, j+32, ...), an exact softmax in float, and lane
// d accumulates output columns d, d+1 over all keys.
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at 700 W): bf16
// 0.0157 ms on the device at the serving shape (B = 8) against SDPA's
// 0.0175, and 0.330 ms at the encode shape (B = 256) against SDPA's 0.439.
#include <stdint.h>

#include "flash.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / mmt::kWarpSize;
constexpr int kQueryTile = 64;
constexpr int kRows = 2;  // query rows a warp scores together
constexpr int kCopyBatch = 8;  // loads in flight per thread while staging K/V

// Row stride (in floats) of K/V in shared memory: odd, so that lanes reading
// the same column of consecutive rows fall in different banks.
__host__ __device__ int padded_row(int dh) { return dh % 2 ? dh : dh + 1; }

size_t shared_bytes(int kv_len, int dh) {
  const size_t kv = mmt::align16(2 * size_t(kv_len) * padded_row(dh) * sizeof(float));
  return kv + kWarps * kRows * (size_t(dh) + size_t(kv_len)) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int S, int H, int dh, int kv_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = padded_row(dh);
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + size_t(kv_len) * ld;
  float* qs = reinterpret_cast<float*>(smem + mmt::align16(2 * size_t(kv_len) * ld * sizeof(float)));
  float* ps = qs + kWarps * kRows * dh;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const size_t row = size_t(H) * dh;  // elements per token in (B, S, H*Dh)
  const size_t head0 = size_t(b) * S * row + size_t(h) * dh;

  // Each thread issues a batch of loads before storing any, so they overlap.
  const int n = kv_len * dh;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kCopyBatch) {
    float kr[kCopyBatch], vr[kCopyBatch];
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx < n) {
        const size_t src = head0 + (idx / dh) * row + idx % dh;
        kr[u] = k[src];
        vr[u] = v[src];
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx < n) {
        ks[(idx / dh) * ld + idx % dh] = kr[u];
        vs[(idx / dh) * ld + idx % dh] = vr[u];
      }
    }
  }
  __syncthreads();

  // Each warp takes kRows query rows at a time, so every K and V value read
  // from shared memory serves kRows rows. A second row past S (the ragged
  // last tile) repeats the first and is not written.
  float* q0 = qs + warp * kRows * dh;
  float* q1 = q0 + dh;
  float* p0 = ps + size_t(warp) * kRows * kv_len;
  float* p1 = p0 + kv_len;
  for (int r = warp * kRows; r < kQueryTile; r += kWarps * kRows) {
    const int qi0 = tile * kQueryTile + r;
    if (qi0 >= S) break;
    const int qi1 = qi0 + 1 < S ? qi0 + 1 : qi0;
    for (int d = lane; d < dh; d += mmt::kWarpSize) {
      q0[d] = q[head0 + qi0 * row + d];
      q1[d] = q[head0 + qi1 * row + d];
    }
    __syncwarp();

    float m0 = -INFINITY, m1 = -INFINITY;
    for (int j = lane; j < kv_len; j += mmt::kWarpSize) {
      const float* kj = ks + j * ld;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < dh; d += 2) {
        const float2 a = *reinterpret_cast<const float2*>(q0 + d);
        const float2 c = *reinterpret_cast<const float2*>(q1 + d);
        s0 = fmaf(a.y, kj[d + 1], fmaf(a.x, kj[d], s0));
        s1 = fmaf(c.y, kj[d + 1], fmaf(c.x, kj[d], s1));
      }
      s0 *= scale;
      s1 *= scale;
      p0[j] = s0;
      p1[j] = s1;
      m0 = fmaxf(m0, s0);
      m1 = fmaxf(m1, s1);
    }
    m0 = mmt::warp_max(m0);
    m1 = mmt::warp_max(m1);
    float l0 = 0.f, l1 = 0.f;
    for (int j = lane; j < kv_len; j += mmt::kWarpSize) {
      const float e0 = expf(p0[j] - m0), e1 = expf(p1[j] - m1);
      p0[j] = e0;
      p1[j] = e1;
      l0 += e0;
      l1 += e1;
    }
    l0 = mmt::warp_sum(l0);
    l1 = mmt::warp_sum(l1);
    __syncwarp();

    // Lane owns column pairs (d, d+1): V's two values per key feed four
    // accumulators.
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    for (int d = 2 * lane; d < dh; d += 2 * mmt::kWarpSize) {
      float a0x = 0.f, a0y = 0.f, a1x = 0.f, a1y = 0.f;
      for (int j = 0; j < kv_len; ++j) {
        const float vx = vs[j * ld + d], vy = vs[j * ld + d + 1];
        const float w0 = p0[j], w1 = p1[j];
        a0x = fmaf(w0, vx, a0x);
        a0y = fmaf(w0, vy, a0y);
        a1x = fmaf(w1, vx, a1x);
        a1y = fmaf(w1, vy, a1y);
      }
      float* o0 = o + head0 + qi0 * row + d;
      o0[0] = a0x * inv0;
      o0[1] = a0y * inv0;
      if (qi1 != qi0) {
        float* o1 = o + head0 + qi1 * row + d;
        o1[0] = a1x * inv1;
        o1[1] = a1y * inv1;
      }
    }
    __syncwarp();  // q0 / q1 / p0 / p1 are rewritten by the next rows
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               int dh, int kv_len, float scale, cudaStream_t stream) {
  const size_t smem = shared_bytes(kv_len, dh);
  cudaError_t err = cudaFuncSetAttribute(encoder_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kQueryTile - 1) / kQueryTile, H, B);
  encoder_attention_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, dh, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (see the note at the top)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
namespace fm = mmt::flash::mma;

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * mmt::kWarpSize;
constexpr int kChunk = 64;  // keys a softmax step and an arrival barrier cover

__host__ __device__ int padded_keys(int kv_len) { return (kv_len + 15) & ~15; }

template <int DP>
size_t mma_shared_bytes(int kv_len) {
  const int keys = padded_keys(kv_len);
  const int chunks = (keys + kChunk - 1) / kChunk;
  return mmt::align16(chunks * sizeof(uint64_t)) +
         (2 * size_t(keys) + kMmaWarps * 16) * fm::Dims<DP>::kLd * sizeof(bf16);
}

// One 16-byte piece (8 columns) of a staged row; zeros where not `valid`.
// A head dim that is a multiple of 8 keeps every piece 16-byte aligned in
// device memory, and the piece goes by cp.async. Any other even head dim is
// read 4 bytes at a time, with zeros past the row's last `cols` columns, and
// stored at once.
__device__ __forceinline__ void stage_piece(bf16* dst, const bf16* src, bool valid, int cols,
                                            bool vec) {
  if (vec) {
    mmt::hopper::cp_async16(dst, src, valid);
    return;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (valid && 2 * i < cols) w[i] = reinterpret_cast<const uint32_t*>(src)[i];
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One warp's m16 query slice (rows past S and columns past dh as zeros) into
// its shared-memory buffer, the copies as one commit group.
template <int DP>
__device__ __forceinline__ void stage_q(bf16* qs, const bf16* q, size_t head0, size_t row, int S,
                                        int dh, bool vec, int slice, int lane) {
  constexpr int kVec = DP / 8;
  for (int e = lane; e < 16 * kVec; e += mmt::kWarpSize) {
    const int r = slice * 16 + e / kVec, col = (e % kVec) * 8;
    const bool valid = r < S && col < dh;
    stage_piece(qs + (e / kVec) * fm::Dims<DP>::kLd + col, q + (valid ? head0 + r * row + col : 0),
                valid, dh - col, vec);
  }
  mmt::hopper::cp_async_commit();
}

// One step of NT 8-key tiles at keys [k0, k0 + 8 NT) for one warp's m16 query
// slice: scores, the online softmax (running max m, sum l of this thread's
// two rows) and O += P V.
template <int DP, int NT>
__device__ __forceinline__ void attend(const uint32_t (&qa)[DP / 16][4], float (&acc)[DP / 8][4],
                                       float (&m)[2], float (&l)[2], const bf16* ks,
                                       const bf16* vs, int k0, int kv_len, float scale_log2,
                                       int lane) {
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t kb[4];
      fm::load_b_nk<DP>(kb, ks, k0 + np * 16, kk * 16, lane);
      fm::mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
      fm::mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
    }
  }

  // Only the step holding kv_len has masked keys. Key 0 is always valid, so
  // after the first step every row's running max is finite. The scale folds
  // into the exponent: p = exp2(s * scale_log2 - m), m the max in base 2.
  const bool ragged = k0 + 8 * NT > kv_len;
  const int t4 = lane % 4;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t4 + (e & 1);
      if (ragged && key >= kv_len) s[j][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], fm::quad_max(mx[r]) * scale_log2);
    alpha[r] = fm::exp2_approx(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = fm::exp2_approx(fmaf(s[j][e], scale_log2, -m[e >> 1]));
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + fm::quad_sum(sum[r]);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }

#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {  // 16 keys a k-step
    uint32_t pa[4];
    fm::accum_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t vb[4];
      fm::load_b_kn<DP>(vb, vs, k0 + kk * 16, dp * 16, lane);
      fm::mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
      fm::mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, DP <= 64 ? 2 : 1)
encoder_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H,
                             int dh, int kv_len, float scale_log2) {
  using namespace mmt::hopper;
  constexpr int kLd = fm::Dims<DP>::kLd, kVec = DP / 8;  // 16-byte pieces a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int keys = padded_keys(kv_len);
  const int chunks = (keys + kChunk - 1) / kChunk;
  uint64_t* ready = reinterpret_cast<uint64_t*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + mmt::align16(chunks * sizeof(uint64_t)));
  bf16* vs = ks + size_t(keys) * kLd;
  bf16* qs = vs + size_t(keys + threadIdx.x / mmt::kWarpSize * 16) * kLd;  // this warp's rows

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / mmt::kWarpSize, lane = threadIdx.x % mmt::kWarpSize;
  const size_t row = size_t(H) * dh;  // elements per token in (B, S, H*Dh)
  const size_t head0 = size_t(b) * S * row + size_t(h) * dh;
  const bool vec = dh % 8 == 0;
  // this block's share of the head's m16 query slices
  const int n_slices = (S + 15) / 16, per_block = (n_slices + gridDim.z - 1) / gridDim.z;
  const int first = blockIdx.z * per_block, last = min(first + per_block, n_slices);

  if (threadIdx.x < chunks) {
    mbar_init(&ready[threadIdx.x], kMmaThreads);
    fence_barrier_init();
  }
  __syncthreads();
  if (first + warp < last) stage_q<DP>(qs, q, head0, row, S, dh, vec, first + warp, lane);

  // Stage K and V chunk by chunk; every thread arrives on each chunk's
  // barrier once its own copies of that chunk have landed (at once where
  // they were plain stores).
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * kChunk, n = (min(r0 + kChunk, keys) - r0) * kVec;
    for (int e = threadIdx.x; e < n; e += kMmaThreads) {
      const int r = r0 + e / kVec, col = (e % kVec) * 8;
      const bool valid = r < kv_len && col < dh;
      const size_t src = valid ? head0 + r * row + col : 0;
      stage_piece(ks + r * kLd + col, k + src, valid, dh - col, vec);
      stage_piece(vs + r * kLd + col, v + src, valid, dh - col, vec);
    }
    if (vec) {
      cp_async_arrive(&ready[c]);
    } else {
      mbar_arrive(&ready[c]);
    }
  }
  cp_async_commit();

  const int g = lane / 4, t4 = lane % 4;
  for (int slice = first + warp; slice < last; slice += kMmaWarps) {
    const int rows[2] = {slice * 16 + g, slice * 16 + g + 8};
    // Q's A fragments from this warp's staged rows, then the next slice's
    // rows are staged while this one computes. The first slice waits for its
    // own rows only (K and V, committed after them, may still be landing).
    if (slice == first + warp) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    uint32_t qa[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) fm::load_a<DP>(qa[kk], qs, 0, kk * 16, lane);
    __syncwarp();
    if (slice + kMmaWarps < last) stage_q<DP>(qs, q, head0, row, S, dh, vec, slice + kMmaWarps, lane);

    float acc[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    int k0 = 0;
    for (; k0 + kChunk <= keys; k0 += kChunk) {
      mbar_wait(&ready[k0 / kChunk], 0);
      attend<DP, 8>(qa, acc, m, l, ks, vs, k0, kv_len, scale_log2, lane);
    }
    for (; k0 < keys; k0 += 16) {
      mbar_wait(&ready[k0 / kChunk], 0);
      attend<DP, 2>(qa, acc, m, l, ks, vs, k0, kv_len, scale_log2, lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= S) continue;
      const float inv = 1.f / l[r];
      bf16* orow = o + head0 + rows[r] * row + 2 * t4;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        if (8 * n + 2 * t4 < dh)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) =
              fm::pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
  cp_async_wait<0>();  // a warp without a query slice leaves no copy in flight
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               int dh, int kv_len, float scale, cudaStream_t stream) {
  const size_t smem = mma_shared_bytes<DP>(kv_len);
  cudaError_t err = cudaFuncSetAttribute(encoder_attention_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Too few heads to fill the card: up to 4 blocks share a head's slices.
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_sm = DP <= 64 ? 2 : 1, n_slices = (S + 15) / 16;
  int splits = 1;
  while (splits < 4 && 2 * splits <= n_slices && 2 * splits * B * H <= per_sm * sms) splits *= 2;
  encoder_attention_mma_kernel<DP><<<dim3(H, B, splits), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, H, dh, kv_len, scale * mmt::flash::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 takes any even head dim; bf16 any even head dim up to 128, padded
// with zero columns to the next of 16, 32, 64, 80, 128.
extern "C" int mmt_encoder_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int H, int dh, int kv_len, float scale,
                                     int dtype, void* stream) {
  if (kv_len < 1 || kv_len > S) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh % 2 == 0) return launch_f32(q, k, v, o, B, S, H, dh, kv_len, scale, st);
  if (dtype != 1 || dh % 2 != 0 || dh > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 16) return launch_mma<16>(q, k, v, o, B, S, H, dh, kv_len, scale, st);
  if (dh <= 32) return launch_mma<32>(q, k, v, o, B, S, H, dh, kv_len, scale, st);
  if (dh <= 64) return launch_mma<64>(q, k, v, o, B, S, H, dh, kv_len, scale, st);
  if (dh <= 80) return launch_mma<80>(q, k, v, o, B, S, H, dh, kv_len, scale, st);
  return launch_mma<128>(q, k, v, o, B, S, H, dh, kv_len, scale, st);
}

extern "C" const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
