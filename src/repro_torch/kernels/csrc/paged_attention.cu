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
// operations-per-byte balance, so they are bound by HBM bytes: the design has to
// keep enough loads in flight.  Prefill rows of a large chunk reuse each key
// across all the tile's query vectors and are bound by operations.
//
// Design (CUDA cores; f32 arithmetic, as decode has no product to put on the
// tensor cores):
// * A block of 128 threads takes a tile of VT query vectors of one kv head and
//   one row: vector = (query row, g) for the G = H/Kv query heads of that kv
//   head, so every key of the row is read once for all of them (GQA needs no
//   repeat of K/V).  VT (1, 4 or 8, chosen by the host from q_max * G) is a
//   template parameter: the vectors' queries and accumulators sit in registers.
// * Inside the block every lane works: a group of LG lanes reads one key's K
//   and V rows with 16-byte loads (8 bf16 or 4 f32 each, EPL elements a lane),
//   dots them with the tile's query vectors and finishes each dot with xor
//   shuffles inside the group.  LG is a power of two, so groups tile the warp
//   and the xor shuffles stay inside a group.  At hd 96 a key's row is 12
//   (bf16) or 24 (f32) 16-byte words: the group is then 16 or 32 lanes of
//   which the first 12 or 24 load and the rest hold zeros (a quarter of the
//   lanes idle).  That keeps every load 16 bytes wide and every reduction a
//   power-of-two xor; 16 lanes of 6 elements would need 12-byte rows, split
//   into 8- and 4-byte loads.  An idle lane never reads: a head's K and V are
//   adjacent in the page, so a load past its 96 values would read V's.  The
//   4 warps x 32/LG groups take different keys, U keys per group per step,
//   all loads of a step issued before the math and the next step's page ids
//   fetched meanwhile.  Each group keeps its own
//   online softmax state (m, l, acc slice) in registers; at the end the groups
//   are merged with xor shuffles and the warps through shared memory.
// * Split keys (flash-decoding): the host cuts the page table's width,
//   max_pages * page_size, into n_split ranges of split_keys keys (a multiple
//   of page_size; the host never reads kv_lens, which would stall the stream
//   on every layer).  The first query tile of every (row, kv head) -- all of a
//   decode row's vectors -- is split: block (tile 0, split) writes an
//   unnormalised partial (m, l, acc) to the f32 workspace, and a split wholly
//   past its row's causal limit writes (m = -inf, l = 0) and exits.  The
//   second kernel merges each tile-0 vector's partials with log-sum-exp
//   weights, skipping empty ones, and writes zeros for rows at or past q_len.
//   Later tiles (a prefill row's queries) walk their whole range in one block
//   and write the output themselves: their number already fills the card.
//   Workspace: S * Kv * VT * n_split * (hd + 2) floats (acc, then (m, l)
//   pairs), allocated by the wrapper; the kernels allocate nothing.
// * The walk stops at the tile's causal limit, which is never past kv_len nor
//   the table's width, so pages past ceil(kv_len/page_size), and pages no query
//   vector of the tile can see, are never read.  Page ids are clamped to the pool.
// * Logits are kept in base 2 (scale * log2 e folded into the dot), masked ones
//   are -1e30 and the output is acc / max(l, 1e-30).  Query rows at or past
//   q_lens[s] are written as zeros (the Pallas kernel left them as garbage for
//   the caller to discard; zeros keep NaNs out of the padded rows the engine
//   carries through the rest of the layer).
// * Inputs bf16 or fp32, output in q's type.  hd in {32, 64, 96, 128, 256}; any
//   page_size >= 1.  q and the pages must be 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                 // threads per block
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;             // the masking value of the reference
constexpr float kLog2e = 1.4426950408889634f;

// a 16-byte word as floats
__device__ __forceinline__ void unpack(const uint4& w, float* f, const float*) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float* f, const __nv_bfloat16*) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// exp2(x - m) as a merge weight; 0 for an empty partial (m = -inf)
__device__ __forceinline__ float weight(float x, float m) {
  return x == -INFINITY ? 0.f : exp2f(x - m);
}

template <typename T, int HD, int VT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,             // (S, q_max, H, HD)
                       const T* __restrict__ kv_pages,      // (P, page_size, 2*Kv, HD)
                       const int* __restrict__ page_table,  // (S, max_pages)
                       const int* __restrict__ q_lens,      // (S,)
                       const int* __restrict__ kv_lens,     // (S,)
                       T* __restrict__ out,                 // (S, q_max, H, HD)
                       float* __restrict__ ws,              // workspace; null if n_split == 1
                       int S, int q_max, int n_heads, int n_kv_heads, int num_pages,
                       int page_size, int max_pages, int n_split, int split_keys,
                       float scale_log2) {
  constexpr int kWord = 16 / (int)sizeof(T);                 // elements per 16-byte load
  constexpr int EPL = HD / 32 > kWord ? HD / 32 : kWord;      // elements per lane
  constexpr int kWords = EPL / kWord;                         // loads per lane per row
  constexpr int kUsed = HD / EPL;                             // lanes that load a key's row
  constexpr int LG = kUsed <= 4 ? kUsed : kUsed <= 8 ? 8 : kUsed <= 16 ? 16 : 32;  // lanes per key
  constexpr int KG = 32 / LG;                                 // keys per warp at once
  constexpr int kSlots = kWarps * KG;                         // keys per block at once
  constexpr int U = VT <= 4 ? 4 : 2;                          // keys per lane group per step
  static_assert(HD % EPL == 0 && EPL % kWord == 0, "hd out of range");
  static_assert(LG >= 1 && LG <= 32 && 32 % LG == 0 && kUsed <= LG, "hd out of range");

  __shared__ float red_acc[kWarps][VT][HD];
  __shared__ float red_m[kWarps][VT];
  __shared__ float red_l[kWarps][VT];

  const int s = blockIdx.z;
  const int kvh = blockIdx.y;
  // blocks [0, n_split) split tile 0; block n_split - 1 + t walks tile t >= 1
  const bool partial = n_split > 1 && (int)blockIdx.x < n_split;
  const int tile = partial ? 0 : (int)blockIdx.x - n_split + 1;
  const int split = partial ? (int)blockIdx.x : 0;
  const int G = n_heads / n_kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LG;                  // this lane's slice of the head dims
  const bool used = kUsed == LG || sub < kUsed;   // an idle lane (hd 96) holds zeros
  const int slot = warp * KG + lane / LG;     // this lane group's key slot
  const int q_len = min(q_lens[s], q_max);
  const int kv_len = kv_lens[s];
  const int n_vec = q_max * G;                // query vectors of (row s, kv head)
  const int vec0 = tile * VT;

  // the tile's real rows bound the keys the whole block needs; so does the
  // page table's width (the Pallas grid never walks past it)
  const int first_row = vec0 / G;
  const int last_row = min(min((vec0 + VT - 1) / G, (n_vec - 1) / G), q_len - 1);
  const int key_limit =
      last_row >= first_row
          ? min(min(kv_len, kv_len - q_len + last_row + 1), max_pages * page_size)
          : 0;
  const int k_begin = partial ? split * split_keys : 0;
  const int k_end = partial ? min(k_begin + split_keys, key_limit) : key_limit;

  // vector i of the tile: its flat index in (S, q_max, H) and whether it is real
  auto vec_index = [&](int i) -> int64_t {
    const int vec = vec0 + i;
    return ((int64_t)s * q_max + vec / G) * n_heads + (int64_t)kvh * G + vec % G;
  };
  auto is_real = [&](int i) { return vec0 + i < n_vec && (vec0 + i) / G < q_len; };
  // partial of tile-0 vector i: (row s, kv head, i, split)
  const int64_t n_part = (int64_t)S * n_kv_heads * VT * n_split;
  auto part_index = [&](int i) {
    return (((int64_t)s * n_kv_heads + kvh) * VT + i) * n_split + split;
  };
  float* ws_acc = ws;
  float2* ws_ml = reinterpret_cast<float2*>(ws + n_part * HD);

  if (k_begin >= k_end) {
    // nothing to attend: an empty partial, or zeros for the whole tile
    for (int idx = tid; idx < VT * HD; idx += kThreads) {
      const int i = idx / HD, d = idx % HD;
      if (vec0 + i >= n_vec) continue;
      if (!partial) {
        store(&out[vec_index(i) * HD + d], 0.f);
      } else if (d == 0 && is_real(i)) {
        ws_ml[part_index(i)] = make_float2(-INFINITY, 0.f);
      }
    }
    return;
  }

  float qv[VT][EPL];
  float acc[VT][EPL];
  float m[VT], l[VT];
  int qpos[VT];
#pragma unroll
  for (int i = 0; i < VT; ++i) {
    const bool real = is_real(i);
    const T* qp = q + (real ? vec_index(i) : 0) * HD + (used ? sub * EPL : 0);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint4 word = real && used ? *reinterpret_cast<const uint4*>(qp + w * kWord)
                                      : make_uint4(0, 0, 0, 0);
      unpack(word, &qv[i][w * kWord], q);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qv[i][e] *= scale_log2;
      acc[i][e] = 0.f;
    }
    m[i] = -INFINITY;
    l[i] = 0.f;
    // a padding vector masks every key: it never stops the others, and its
    // result is never written
    qpos[i] = real ? kv_len - q_len + (vec0 + i) / G : -1;
  }

  const int64_t token_stride = (int64_t)2 * n_kv_heads * HD;
  const int64_t page_stride = (int64_t)page_size * token_stride;
  const T* kv_head = kv_pages + (int64_t)(2 * kvh) * HD + (used ? sub * EPL : 0);
  const int* pt = page_table + (int64_t)s * max_pages;

  auto page_of = [&](int key) {
    return key < k_end ? min(max(pt[key / page_size], 0), num_pages - 1) : 0;
  };
  int page[U];
#pragma unroll
  for (int u = 0; u < U; ++u) page[u] = page_of(k_begin + u * kSlots + slot);

  for (int k0 = k_begin; k0 < k_end; k0 += U * kSlots) {
    // this step's K and V rows, all loads in flight together
    uint4 kw[U][kWords], vw[U][kWords];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = k0 + u * kSlots + slot;
      const T* row = kv_head + page[u] * page_stride + (int64_t)(key % page_size) * token_stride;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        if (used && key < k_end) {
          kw[u][w] = __ldg(reinterpret_cast<const uint4*>(row + w * kWord));
          vw[u][w] = __ldg(reinterpret_cast<const uint4*>(row + HD + w * kWord));
        } else {
          kw[u][w] = vw[u][w] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    // the next step's page ids while the rows are in flight
#pragma unroll
    for (int u = 0; u < U; ++u) page[u] = page_of(k0 + (U + u) * kSlots + slot);

    // base-2 logits of every (vector, key): -1e30 masked, -inf not a key
    float x[VT][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
#pragma unroll
      for (int w = 0; w < kWords; ++w) unpack(kw[u][w], &kf[w * kWord], q);
      const int key = k0 + u * kSlots + slot;
#pragma unroll
      for (int i = 0; i < VT; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qv[i][e], kf[e], dot);
#pragma unroll
        for (int off = LG / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        x[i][u] = key >= k_end ? -INFINITY : (key <= qpos[i] ? dot : kNegInf);
      }
    }
    float vf[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int w = 0; w < kWords; ++w) unpack(vw[u][w], &vf[u][w * kWord], q);

    // online softmax, one rescale per step
#pragma unroll
    for (int i = 0; i < VT; ++i) {
      float mx = x[i][0];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, x[i][u]);
      const float m_new = fmaxf(m[i], mx);
      if (m_new == -INFINITY) continue;        // this group had no key this step
      const float alpha = weight(m[i], m_new);
      float p[U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = weight(x[i][u], m_new);
        psum += p[u];
      }
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[i][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[i][e] = a;
      }
    }
  }

  // merge the lane groups of a warp: lanes with the same slice, LG apart
#pragma unroll
  for (int off = LG; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < VT; ++i) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mm = fmaxf(m[i], m_o);
      const float wa = weight(m[i], mm), wb = weight(m_o, mm);
      l[i] = l[i] * wa + l_o * wb;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[i][e], off);
        acc[i][e] = acc[i][e] * wa + a_o * wb;
      }
      m[i] = mm;
    }
  }
  // then the warps, through shared memory
  if (lane < LG && used) {
#pragma unroll
    for (int i = 0; i < VT; ++i) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) red_acc[warp][i][sub * EPL + e] = acc[i][e];
      if (sub == 0) {
        red_m[warp][i] = m[i];
        red_l[warp][i] = l[i];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < VT * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    if (vec0 + i >= n_vec) continue;
    const int64_t vi = vec_index(i);
    if (!is_real(i)) {
      if (!partial) store(&out[vi * HD + d], 0.f);
      continue;
    }
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w][i]);
    float sum_l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = weight(red_m[w][i], mm);
      sum_l += wt * red_l[w][i];
      a += wt * red_acc[w][i][d];
    }
    if (!partial) {
      store(&out[vi * HD + d], a / fmaxf(sum_l, 1e-30f));
    } else {
      ws_acc[part_index(i) * HD + d] = a;
      if (d == 0) ws_ml[part_index(i)] = make_float2(mm, sum_l);
    }
  }
}

// One warp per tile-0 vector (row s, kv head, i): the log-sum-exp merge of
// its n_split partials into the output, or zeros for a row at or past q_len.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ ws, const int* __restrict__ q_lens,
                             T* __restrict__ out, int S, int q_max, int n_heads,
                             int n_kv_heads, int hd, int vt, int n_split) {
  const int64_t n_vt = (int64_t)S * n_kv_heads * vt;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_vt) return;
  const int G = n_heads / n_kv_heads;
  const int i = (int)(w % vt);
  const int kvh = (int)(w / vt % n_kv_heads);
  const int s = (int)(w / ((int64_t)vt * n_kv_heads));
  if (i >= q_max * G) return;                 // tile 0 is shorter than vt
  const int row = i / G;
  T* o = out + (((int64_t)s * q_max + row) * n_heads + (int64_t)kvh * G + i % G) * hd;
  if (row >= min(q_lens[s], q_max)) {
    for (int d = lane; d < hd; d += 32) store(&o[d], 0.f);
    return;
  }
  const float* acc = ws + w * n_split * hd;
  const float2* ml = reinterpret_cast<const float2*>(ws + n_vt * n_split * hd) + w * n_split;
  float mm = -INFINITY;
  for (int j = lane; j < n_split; j += 32) mm = fmaxf(mm, ml[j].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
  float sum_l = 0.f;
  for (int j = lane; j < n_split; j += 32) sum_l += weight(ml[j].x, mm) * ml[j].y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum_l += __shfl_xor_sync(0xffffffffu, sum_l, off);
  const float inv = 1.f / fmaxf(sum_l, 1e-30f);
  for (int d = lane; d < hd; d += 32) {
    float a = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float2 p = ml[j];
      if (p.x != -INFINITY) a += exp2f(p.x - mm) * acc[(int64_t)j * hd + d];
    }
    store(&o[d], a * inv);
  }
}

template <typename T, int HD, int VT>
cudaError_t launch(const void* q, const void* kv_pages, const int* page_table,
                   const int* q_lens, const int* kv_lens, void* out, float* ws, int S,
                   int q_max, int n_heads, int n_kv_heads, int num_pages, int page_size,
                   int max_pages, int n_split, int split_keys, float scale,
                   cudaStream_t stream) {
  const int G = n_heads / n_kv_heads;
  const int n_tiles = (q_max * G + VT - 1) / VT;
  const dim3 grid(n_tiles - 1 + n_split, n_kv_heads, S);
  paged_attention_kernel<T, HD, VT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_pages), page_table, q_lens, kv_lens,
      static_cast<T*>(out), ws, S, q_max, n_heads, n_kv_heads, num_pages, page_size, max_pages,
      n_split, split_keys, scale * kLog2e);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  const int64_t n_vt = (int64_t)S * n_kv_heads * VT;
  paged_attention_merge_kernel<T><<<(unsigned)((n_vt + kWarps - 1) / kWarps), kThreads, 0,
                                    stream>>>(ws, q_lens, static_cast<T*>(out), S, q_max,
                                              n_heads, n_kv_heads, HD, VT, n_split);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_vt(int vt, const void* q, const void* kv_pages, const int* page_table,
                      const int* q_lens, const int* kv_lens, void* out, float* ws, int S,
                      int q_max, int n_heads, int n_kv_heads, int num_pages, int page_size,
                      int max_pages, int n_split, int split_keys, float scale,
                      cudaStream_t stream) {
#define PAGED_ATTN_VT(V)                                                                    \
  case V:                                                                                   \
    return launch<T, HD, V>(q, kv_pages, page_table, q_lens, kv_lens, out, ws, S, q_max,    \
                            n_heads, n_kv_heads, num_pages, page_size, max_pages, n_split,  \
                            split_keys, scale, stream);
  switch (vt) {
    PAGED_ATTN_VT(1)
    PAGED_ATTN_VT(4)
    PAGED_ATTN_VT(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_ATTN_VT
}

template <typename T>
cudaError_t launch_hd(int hd, int vt, const void* q, const void* kv_pages,
                      const int* page_table, const int* q_lens, const int* kv_lens, void* out,
                      float* ws, int S, int q_max, int n_heads, int n_kv_heads, int num_pages,
                      int page_size, int max_pages, int n_split, int split_keys, float scale,
                      cudaStream_t stream) {
#define PAGED_ATTN_CASE(D)                                                                  \
  case D:                                                                                   \
    return launch_vt<T, D>(vt, q, kv_pages, page_table, q_lens, kv_lens, out, ws, S, q_max, \
                           n_heads, n_kv_heads, num_pages, page_size, max_pages, n_split,   \
                           split_keys, scale, stream);
  switch (hd) {
    PAGED_ATTN_CASE(32)
    PAGED_ATTN_CASE(64)
    PAGED_ATTN_CASE(96)
    PAGED_ATTN_CASE(128)
    PAGED_ATTN_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_ATTN_CASE
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// vt query vectors a tile (1, 4 or 8); tile 0 of each (row, kv head) in n_split
// key ranges of split_keys keys; ws holds S * n_kv_heads * vt * n_split *
// (hd + 2) floats when n_split > 1 (null otherwise).  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* kv_pages,
                                   const void* page_table, const void* q_lens,
                                   const void* kv_lens, void* out, void* ws, int S, int q_max,
                                   int n_heads, int n_kv_heads, int hd, int num_pages,
                                   int page_size, int max_pages, int vt, int n_split,
                                   int split_keys, float scale, int dtype, void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || page_size <= 0 || q_max <= 0 ||
      n_split <= 0 || (n_split > 1 && (ws == nullptr || split_keys <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* ql = static_cast<const int*>(q_lens);
  const int* kl = static_cast<const int*>(kv_lens);
  float* w = static_cast<float*>(ws);
  if (dtype == 0) {
    return (int)launch_hd<float>(hd, vt, q, kv_pages, pt, ql, kl, out, w, S, q_max, n_heads,
                                 n_kv_heads, num_pages, page_size, max_pages, n_split,
                                 split_keys, scale, st);
  }
  if (dtype == 1) {
    return (int)launch_hd<__nv_bfloat16>(hd, vt, q, kv_pages, pt, ql, kl, out, w, S, q_max,
                                         n_heads, n_kv_heads, num_pages, page_size, max_pages,
                                         n_split, split_keys, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
