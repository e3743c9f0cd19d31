// Flash attention over one chunk of queries for Hopper (sm_90a), CUDA C++.
//
// Replaces two TPU kernels of src/repro/kernels/chunked_attention.py:
//   * _computed_attn_kernel (wrapper computed_attention): the causal /
//     sliding-window predicate is computed from positions, fully masked kv
//     blocks are skipped;
//   * _masked_attn_kernel (wrapper masked_attention): an explicit bool mask
//     (Nm, Sq, Skv), Nm in {1, N*group}, nothing skipped.
// Both compute, per flat query head n and query row a,
//   out[n, a] = softmax_j(where(live(a, j), scale * q[n, a] . k[n/group, j], -1e30)) @ v[n/group]
// with an online softmax in f32, and finish with acc / max(l, 1e-30), so a row
// whose visited keys are all masked gets the mean of those keys' V, as the
// Pallas kernels give.
//
// What bounds it on the H100: at the compiler's shapes (a chunk of queries
// against 8192 keys, hd 64) each staged K/V tile is reused by 64 query rows,
// so the work is 4*hd operations per live (query, key) pair against a few
// bytes per pair: operations bound.  The masked kernel also reads one mask
// byte per pair, which is still below the card's operations-per-byte balance.
//
// Design (simple and right first; CUDA-core FMAs, no wgmma, no TMA):
// * One thread block of 128 threads per (64-query tile, flat head n).  The
//   Pallas grid walked kv blocks in order with the accumulator in VMEM
//   scratch; here the kv walk is a loop inside the block.  Each thread owns
//   4 query rows; m, l and its 4 x hd/8 slice of the f32 accumulator stay in
//   registers.
// * GQA is native: head n reads kv head n / group; K and V are never repeated.
// * computed: the band bounds the loop.  It runs from the first kv tile the
//   window can reach to the last tile the causal limit q_offset + q_tile_end
//   can reach (the tiles the Pallas kernel did not skip); tiles outside are
//   never read.  The per-element predicate (kpos <= qpos, qpos - kpos < window)
//   is applied only in tiles the band cuts.  Positions come from blockIdx and
//   q_offset; no mask exists in memory.
// * masked: every kv tile; the mask bytes of the tile are read beside K and V.
// * Per kv tile of 64 keys: Q (once), K and V are staged in shared memory as
//   f32 (Q and K transposed so a thread reads 4 rows / 8 keys as float4),
//   each thread computes a 4 x 8 block of logits, the row max and sum are
//   reduced over the 8 lanes that share a row with xor shuffles, P goes
//   through shared memory, and each thread accumulates its 4 x hd/8 block of
//   P @ V.
// * Ragged edges: Sq and Skv need not be multiples of 64.  Query rows past Sq
//   are computed on zeros and not stored; keys past Skv get -inf (weight 0).
// * Inputs bf16 or fp32, f32 arithmetic, output in q's type.  hd in
//   {32, 64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;            // query rows per block
constexpr int kBKV = 64;           // keys per staged tile
constexpr int kPad = 4;            // row padding of the transposed tiles (floats)
constexpr int kRows = 4;           // query rows per thread
constexpr int kCols = 8;           // keys per thread in the logits block
constexpr float kNegInf = -1e30f;  // the masking value of the reference

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__host__ __device__ constexpr int smem_floats(int hd) {
  return hd * (kBQ + kPad) + hd * (kBKV + kPad) + kBKV * hd + kBKV * (kBQ + kPad);
}

// floor(a / b) for b > 0 and any sign of a
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename T, int HD, bool MASKED>
__global__ void __launch_bounds__(kThreads)
chunk_attention_kernel(const T* __restrict__ q,             // (N*group, Sq, HD)
                       const T* __restrict__ k,             // (N, Skv, HD)
                       const T* __restrict__ v,             // (N, Skv, HD)
                       const uint8_t* __restrict__ mask,    // (Nm, Sq, Skv) or null
                       T* __restrict__ out,                 // (N*group, Sq, HD)
                       int group, int Sq, int Skv, int q_offset, int causal,
                       int window, int mask_heads, float scale) {
  constexpr int kQP = kBQ + kPad;
  constexpr int kKP = kBKV + kPad;
  constexpr int kAccCols = HD / 8;   // accumulator columns per thread
  static_assert(HD % 32 == 0, "hd must be a multiple of 32");

  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                    // [HD][kQP]   q tile, transposed
  float* kT = qT + HD * kQP;           // [HD][kKP]   k tile, transposed
  float* vS = kT + HD * kKP;           // [kBKV][HD]  v tile
  float* pT = vS + kBKV * HD;          // [kBKV][kQP] probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 7;              // key / column group
  const int ty = tid >> 3;             // row group: rows ty*4 .. ty*4+3
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int q_end = min(q0 + kBQ, Sq);

  const T* qn = q + (size_t)n * Sq * HD;
  const T* kn = k + (size_t)(n / group) * Skv * HD;
  const T* vn = v + (size_t)(n / group) * Skv * HD;
  const uint8_t* mn = MASKED ? mask + (size_t)(mask_heads == 1 ? 0 : n) * Sq * Skv : nullptr;

  // stage the query tile (zeros past Sq)
  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    qT[d * kQP + r] = (q0 + r < Sq) ? to_float(qn[(size_t)(q0 + r) * HD + d]) : 0.f;
  }

  // the kv tiles this block visits
  const int n_tiles = (Skv + kBKV - 1) / kBKV;
  int t_lo = 0, t_hi = n_tiles;
  if (!MASKED) {
    if (causal) {
      const long long last = (long long)q_offset + q_end - 1;   // largest query position
      t_hi = last < 0 ? 0 : (int)min((long long)n_tiles, last / kBKV + 1);
    }
    if (window > 0) {
      const long long first = (long long)q_offset + q0 - (window - 1);
      t_lo = (int)max(0LL, floor_div(first, kBKV));
    }
  }

  float m[kRows], l[kRows], acc[kRows][kAccCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();  // previous tile's pT / vS reads are done (and qT is staged)
    for (int e = tid; e < kBKV * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const bool in = k0 + c < Skv;
      const size_t off = (size_t)(k0 + c) * HD + d;
      kT[d * kKP + c] = in ? to_float(kn[off]) : 0.f;
      vS[c * HD + d] = in ? to_float(vn[off]) : 0.f;
    }
    __syncthreads();

    // logits of rows ty*4+i, keys tx*8+j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * kQP + ty * kRows]);
      const float4 b0 = *reinterpret_cast<const float4*>(&kT[d * kKP + tx * kCols]);
      const float4 b1 = *reinterpret_cast<const float4*>(&kT[d * kKP + tx * kCols + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // scale, mask, online softmax
    const bool edge = k0 + kBKV > Skv;
    bool cut = MASKED;
    if (!MASKED) {
      // does the band cut this tile for some (row, key)?
      const long long q_first = (long long)q_offset + q0;
      const long long q_last = (long long)q_offset + q_end - 1;
      if (causal && (long long)(k0 + kBKV - 1) > q_first) cut = true;
      if (window > 0 && q_last - k0 >= window) cut = true;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      const long long qpos = (long long)q_offset + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx * kCols + j;
        float x = s[i][j] * scale;
        if (cut) {
          bool live;
          if (MASKED) {
            live = row < Sq && kpos < Skv && mn[(size_t)row * Skv + kpos] != 0;
          } else {
            live = true;
            if (causal) live = live && (long long)kpos <= qpos;
            if (window > 0) live = live && qpos - kpos < window;
          }
          if (!live) x = kNegInf;
        }
        if (edge && kpos >= Skv) x = -INFINITY;   // not a key: weight 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      *reinterpret_cast<float4*>(&pT[(tx * kCols + j) * kQP + ty * kRows]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc[rows ty*4+i][cols 4*tx + 32*c4 + u] += P @ V
#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&pT[c * kQP + ty * kRows]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c4 = 0; c4 < HD / 32; ++c4) {
        const float4 w = *reinterpret_cast<const float4*>(&vS[c * HD + 32 * c4 + 4 * tx]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[i][4 * c4 + u] = fmaf(pv[i], wv[u], acc[i][4 * c4 + u]);
      }
    }
  }

  T* on = out + (size_t)n * Sq * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c4 = 0; c4 < HD / 32; ++c4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        store(&on[(size_t)row * HD + 32 * c4 + 4 * tx + u], acc[i][4 * c4 + u] * inv);
  }
}

template <typename T, int HD, bool MASKED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int n_q_heads, int group, int Sq, int Skv, int q_offset, int causal,
                   int window, int mask_heads, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats(HD) * (int)sizeof(float);
  static bool configured = false;   // the attribute is per function, set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(chunk_attention_kernel<T, HD, MASKED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, n_q_heads);
  chunk_attention_kernel<T, HD, MASKED><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), group, Sq, Skv, q_offset,
      causal, window, mask_heads, scale);
  return cudaGetLastError();
}

template <typename T, bool MASKED>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const void* mask,
                      void* out, int n_q_heads, int group, int Sq, int Skv, int q_offset,
                      int causal, int window, int mask_heads, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32, MASKED>(q, k, v, mask, out, n_q_heads, group, Sq, Skv, q_offset,
                                   causal, window, mask_heads, scale, stream);
    case 64:
      return launch<T, 64, MASKED>(q, k, v, mask, out, n_q_heads, group, Sq, Skv, q_offset,
                                   causal, window, mask_heads, scale, stream);
    case 128:
      return launch<T, 128, MASKED>(q, k, v, mask, out, n_q_heads, group, Sq, Skv, q_offset,
                                    causal, window, mask_heads, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool MASKED>
int dispatch(int dtype, int hd, const void* q, const void* k, const void* v, const void* mask,
             void* out, int n_q_heads, int group, int Sq, int Skv, int q_offset, int causal,
             int window, int mask_heads, float scale, void* stream) {
  if (group <= 0 || n_q_heads % group != 0 || Sq <= 0 || Skv <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_hd<float, MASKED>(hd, q, k, v, mask, out, n_q_heads, group, Sq, Skv,
                                         q_offset, causal, window, mask_heads, scale, st);
  }
  if (dtype == 1) {
    return (int)launch_hd<__nv_bfloat16, MASKED>(hd, q, k, v, mask, out, n_q_heads, group,
                                                 Sq, Skv, q_offset, causal, window,
                                                 mask_heads, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (n_q_heads, Sq, hd); k, v: (n_q_heads / group, Skv, hd); out like q.
// Query row a of every head sits at position q_offset + a; window <= 0 means
// no window.  Returns the CUDA error of the launch (0 on success).
extern "C" int computed_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                      int n_q_heads, int group, int Sq, int Skv, int hd,
                                      int q_offset, int causal, int window, float scale,
                                      int dtype, void* stream) {
  return dispatch<false>(dtype, hd, q, k, v, nullptr, out, n_q_heads, group, Sq, Skv,
                         q_offset, causal, window, 1, scale, stream);
}

// As above with an explicit bool mask (mask_heads, Sq, Skv), mask_heads in
// {1, n_q_heads}; nonzero = attend.
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int n_q_heads, int group,
                                    int Sq, int Skv, int hd, int mask_heads, float scale,
                                    int dtype, void* stream) {
  if (mask_heads != 1 && mask_heads != n_q_heads) return (int)cudaErrorInvalidValue;
  return dispatch<true>(dtype, hd, q, k, v, mask, out, n_q_heads, group, Sq, Skv, 0, 0, 0,
                        mask_heads, scale, stream);
}
