// Ragged paged flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:_paged_attn_kernel
// (wrapper paged_attention_blocked).  It computes the same function: row s of a
// ragged batch holds q_lens[s] query tokens (left-aligned in q_max slots) that
// attend, causally, to the kv_lens[s] tokens of that sequence, which live in a
// pool of fixed-size pages in the fused head-interleaved [K0,V0,K1,V1,..] layout
// and are found through the row's page table.  Query i of row s sits at
// position kv_lens[s] - q_lens[s] + i.
//
// What bounds it on the H100: decode rows (q_len 1) read every KV page of their
// sequence once and do 4*hd operations per key, far below the card's
// operations-per-byte balance, so they are bound by HBM bytes.  Prefill rows of
// a large chunk reuse each staged key tile across all the tile's query rows and
// are bound by operations.
//
// Design (simple and right first; no wgmma, no TMA):
// * One thread block per (query-vector tile, kv head, sequence row).  The
//   G = H/Kv query heads of a kv head share its pages, so GQA needs no repeat
//   of K/V: a tile holds (row, g) query vectors of one kv head.
// * The Pallas grid walked pages sequentially with the accumulator in VMEM
//   scratch.  Here the page walk is a loop inside the block; the online
//   softmax state (m, l and the f32 accumulator) stays in registers.
// * The block reads page_table[s, j] itself (no scalar prefetch) and stages a
//   tile of 16 keys of K and V into shared memory, converted to f32.  The loop
//   stops at the tile's causal limit, which is never past kv_len, so pages past
//   ceil(kv_len/page_size), and pages no query row of the tile can see, are
//   never read.
// * Each query vector is owned by hd/16 consecutive lanes, 16 dims each
//   (dims part, part + hd/16, ...: conflict-free shared-memory reads); a dot
//   product is finished with xor shuffles inside that lane group.
// * Masked logits are -1e30; the output is acc / max(l, 1e-30).  Query rows
//   at or past q_lens[s] are written as zeros (the Pallas kernel left them as
//   garbage for the caller to discard; zeros keep NaNs out of the padded rows
//   the engine carries through the rest of the layer).
// * Inputs bf16 or fp32, f32 arithmetic, output in q's type.  hd in
//   {32, 64, 128, 256}; any page_size >= 1 (the pool uses powers of two).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // threads per block
constexpr int kDimsPerThread = 16; // head dims owned by one lane
constexpr int kKeyTile = 16;       // keys staged in shared memory per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,          // (S, q_max, H, HD)
                       const T* __restrict__ kv_pages,   // (P, page_size, 2*Kv, HD)
                       const int* __restrict__ page_table,  // (S, max_pages)
                       const int* __restrict__ q_lens,   // (S,)
                       const int* __restrict__ kv_lens,  // (S,)
                       T* __restrict__ out,              // (S, q_max, H, HD)
                       int q_max, int n_heads, int n_kv_heads, int num_pages,
                       int page_size, int max_pages, float scale) {
  constexpr int kLanesPerVec = HD / kDimsPerThread;  // lanes sharing one query vector
  constexpr int kVecs = kThreads / kLanesPerVec;     // query vectors per block
  static_assert(kLanesPerVec >= 1 && kLanesPerVec <= 32, "hd out of range");

  __shared__ float k_s[kKeyTile][HD];
  __shared__ float v_s[kKeyTile][HD];

  const int s = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = n_heads / n_kv_heads;
  const int tid = threadIdx.x;
  const int part = tid % kLanesPerVec;
  const int vec = blockIdx.x * kVecs + tid / kLanesPerVec;  // = row * G + g
  const int row = vec / G;
  const int g = vec % G;
  const int q_len = min(q_lens[s], q_max);
  const int kv_len = kv_lens[s];
  const bool active = row < q_len;

  // last real query row of this tile bounds the keys the whole block needs;
  // so does the page table's width (the Pallas grid never walks past it)
  const int first_row = (blockIdx.x * kVecs) / G;
  const int last_row = min((blockIdx.x * kVecs + kVecs - 1) / G, q_len - 1);
  const int key_limit =
      last_row >= first_row
          ? min(min(kv_len, kv_len - q_len + last_row + 1), max_pages * page_size)
          : 0;

  const int64_t q_off = (((int64_t)s * q_max + row) * n_heads + (int64_t)kvh * G + g) * HD;
  float qr[kDimsPerThread];
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    qr[i] = active ? to_float(q[q_off + part + i * kLanesPerVec]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;
  const int qpos = kv_len - q_len + row;

  const int64_t token_stride = (int64_t)2 * n_kv_heads * HD;
  const int64_t page_stride = (int64_t)page_size * token_stride;
  const int* pt = page_table + (int64_t)s * max_pages;

  for (int t0 = 0; t0 < key_limit; t0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kKeyTile * HD; idx += kThreads) {
      const int j = idx / HD;
      const int d = idx % HD;
      const int t = t0 + j;
      float kval = 0.f, vval = 0.f;
      if (t < key_limit) {
        const int page = min(max(pt[t / page_size], 0), num_pages - 1);
        const int64_t base = page * page_stride + (int64_t)(t % page_size) * token_stride +
                             (int64_t)(2 * kvh) * HD + d;
        kval = to_float(kv_pages[base]);
        vval = to_float(kv_pages[base + HD]);
      }
      k_s[j][d] = kval;
      v_s[j][d] = vval;
    }
    __syncthreads();

    float sc[kKeyTile];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeyTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        dot = fmaf(qr[i], k_s[j][part + i * kLanesPerVec], dot);
      }
#pragma unroll
      for (int off = kLanesPerVec / 2; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      const int kpos = t0 + j;
      sc[j] = (kpos <= qpos && kpos < kv_len) ? dot * scale : kNegInf;
      m_tile = fmaxf(m_tile, sc[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTile; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        acc[i] = fmaf(p, v_s[j][part + i * kLanesPerVec], acc[i]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (row < q_max) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      store(&out[q_off + part + i * kLanesPerVec], active ? acc[i] / denom : 0.f);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kv_pages, const int* page_table,
                   const int* q_lens, const int* kv_lens, void* out, int S, int q_max,
                   int n_heads, int n_kv_heads, int num_pages, int page_size,
                   int max_pages, float scale, cudaStream_t stream) {
  constexpr int kVecs = kThreads / (HD / kDimsPerThread);
  const int G = n_heads / n_kv_heads;
  const dim3 grid((q_max * G + kVecs - 1) / kVecs, n_kv_heads, S);
  paged_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_pages), page_table, q_lens,
      kv_lens, static_cast<T*>(out), q_max, n_heads, n_kv_heads, num_pages, page_size,
      max_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* kv_pages, const int* page_table,
                      const int* q_lens, const int* kv_lens, void* out, int S, int q_max,
                      int n_heads, int n_kv_heads, int num_pages, int page_size,
                      int max_pages, float scale, cudaStream_t stream) {
#define PAGED_ATTN_CASE(D)                                                              \
  case D:                                                                               \
    return launch<T, D>(q, kv_pages, page_table, q_lens, kv_lens, out, S, q_max,        \
                        n_heads, n_kv_heads, num_pages, page_size, max_pages, scale,    \
                        stream);
  switch (hd) {
    PAGED_ATTN_CASE(32)
    PAGED_ATTN_CASE(64)
    PAGED_ATTN_CASE(128)
    PAGED_ATTN_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_ATTN_CASE
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* kv_pages,
                                   const void* page_table, const void* q_lens,
                                   const void* kv_lens, void* out, int S, int q_max,
                                   int n_heads, int n_kv_heads, int hd, int num_pages,
                                   int page_size, int max_pages, float scale, int dtype,
                                   void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || page_size <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* ql = static_cast<const int*>(q_lens);
  const int* kl = static_cast<const int*>(kv_lens);
  if (dtype == 0) {
    return (int)launch_hd<float>(hd, q, kv_pages, pt, ql, kl, out, S, q_max, n_heads,
                                 n_kv_heads, num_pages, page_size, max_pages, scale, st);
  }
  if (dtype == 1) {
    return (int)launch_hd<__nv_bfloat16>(hd, q, kv_pages, pt, ql, kl, out, S, q_max,
                                         n_heads, n_kv_heads, num_pages, page_size,
                                         max_pages, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
