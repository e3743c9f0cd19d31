// Flash attention over one chunk of queries for Hopper (sm_90a), CUDA C++.
//
// Replaces two TPU kernels of src/repro/kernels/chunked_attention.py:
//   * _computed_attn_kernel (wrapper computed_attention): the causal /
//     sliding-window predicate is computed from positions, fully masked kv
//     blocks are skipped;
//   * _masked_attn_kernel (wrapper masked_attention): an explicit bool mask
//     (Nm, Sq, Skv), Nm in {1, N*group}; the Pallas kernel visits every kv
//     block.
// Both compute, per flat query head n and query row a,
//   out[n, a] = softmax_j(where(live(a, j), scale * q[n, a] . k[n/group, j], -1e30)) @ v[n/group]
// with an online softmax in f32, and finish with acc / max(l, 1e-30), so a row
// whose visited keys are all masked gets the mean of those keys' V, as the
// Pallas kernels give.
//
// What bounds it on the H100: at the compiler's shapes (a chunk of queries
// against 8192 keys, hd 64 or 128) each staged K/V tile is reused by 64 query
// rows, so the work is 4*hd operations per live (query, key) pair against a
// few bytes per pair: operations bound, and in bf16 only the tensor cores
// reach that bound.  A bool mask adds a byte per (query, key) pair and
// mask head, read once; its dead pairs need no operation at all.
//
// Routing (in dispatch() below, by dtype; not a fallback):
//   * bf16, both entry points -> chunk_attention_wgmma_kernel<hd, masked>:
//     both products on the tensor cores (wgmma), K/V tiles in a two-stage
//     cp.async ring, P kept in registers.  hd 32, 64, 80, 96, 128, 256;
//     anything else is refused (chunked_attention.py cuda_refusal, which
//     kernel dispatch also asks).  A mask is first classified by tiles
//     (below).
//   * f32, both entry points -> chunk_attention_kernel: CUDA-core f32 FMAs.
//     f32 stays off the TF32 tensor cores because TF32 keeps about three
//     decimal digits, short of the 1e-4 that the f32 checks hold the kernel
//     to.  The f32 masked kernel reads the mask beside K and V and visits
//     every tile.  The same head dims.
//
// Shared by both kernels (the plain version's band_tiles() assumes them):
// * One block per (64-query tile, flat head n); the kv walk is a
//   loop inside the block, in tiles of 64 keys (kBQ, kBKV).
// * GQA is native: head n reads kv head n / group; K and V are never repeated.
// * computed: the band bounds the loop.  It runs from the first kv tile the
//   window can reach to the last tile the causal limit q_offset + q_tile_end
//   can reach (the tiles the Pallas kernel did not skip); tiles outside are
//   never read.  The per-element predicate (kpos <= qpos, qpos - kpos < window)
//   is applied only in tiles the band cuts.  Positions come from blockIdx and
//   q_offset; no mask exists in memory.
// * Ragged edges: Sq and Skv need not be multiples of 64.  Query rows past Sq
//   are computed on zeros and not stored; keys past Skv get -inf (weight 0).
// * Output in q's type.
//
// chunk_attention_kernel (CUDA cores): Q (once), K and V are staged in shared
// memory as f32 (Q and K transposed so a thread reads 4 rows / 8 keys as
// float4); each thread owns 4 query rows and computes a 4 x 8 block of logits,
// the row max and sum are reduced over the 8 lanes that share a row with xor
// shuffles, P goes through shared memory, and each thread accumulates its
// 4 x hd/8 block of P @ V, read from V as float4 (hd a multiple of 32) or
// float2 (hd 80).  128 threads.  Shared memory is (2 (64 + 4) + 64) hd +
// 64 (64 + 4) f32: 222,208 B at hd 256, one block an SM under the 232,448 B
// a block may use.
//
// chunk_attention_wgmma_kernel (tensor cores, bf16):
// * The block is one warpgroup (two at hd 256); 64 query rows are exactly
//   wgmma's M.
// * Q, K and V tiles stay bf16 in shared memory in the layout wgmma's
//   descriptors read: rows of the widest swizzle atom (128, 64 or 32 bytes)
//   that divides a row of 2*hd bytes, 16-byte chunks XOR-swizzled by the
//   row, column blocks of 64 rows.  The same layout serves K as the K-major
//   B of S = Q K^T and V as the MN-major (transposed) B of O = P V.
//   hd 80 (160-byte rows) takes five 32-byte column blocks and hd 96 three
//   64-byte ones, so every tile holds exactly its hd columns: no pad
//   columns are copied, stored or multiplied (a tile padded to 128 columns
//   would cost 60% / 33% more shared memory, copies and P V products).  The
//   narrower swizzle atoms may cost wgmma shared-memory bank conflicts that
//   the 128-byte one avoids; they are not measured apart, and the times in
//   PERF.md include them.
// * S = Q K^T: hd/16 wgmma m64n64k16 with both operands in shared memory.
//   The f32 S accumulator (32 values a thread: rows g and g+8 of its warp's
//   16, two columns of each 8) is masked, scaled and exponentiated in
//   registers and packed to bf16: that accumulator layout is the register-A
//   layout of the next product, so P never touches shared memory.
// * O += P V: wgmma m64n{hd}k16 with A (P) in registers and V transposed.
//   At hd 256 the accumulator would be 128 f32 a thread beside S and P, more
//   than a thread's 255 registers hold, so the block has two warpgroups:
//   each computes the same S = Q K^T (the Q K^T products are done twice,
//   a third more tensor-core work at hd 256) and its own half of O, 128
//   columns, with m64n128k16.  Keeping S apart costs no shared memory and
//   no barrier beyond those of the K/V ring.
//   P goes in as two bf16 operands, hi = bf16(p) and lo = bf16(p - hi), so
//   the weights carry about 2^-17 of rounding where bf16 alone carries 2^-9:
//   a row with few live keys would otherwise stray by a unit in the last
//   place of the bf16 output beyond the output's own rounding.  l is summed
//   from the same hi + lo that multiplies V.  8 products of P V a tile where
//   bf16 alone needs 4, beside hd/16 of Q K^T.
// * The two products overlap the softmax: iteration t issues S(t) = Q K(t)^T
//   and O += P(t-1) V(t-1) together, waits for S(t) alone, and masks and
//   exponentiates it while P V runs; only then rescales O and packs P(t).
// * K and V tiles come in through two-stage cp.async rings (16-byte copies,
//   zero-filled past Skv), K one tile ahead of V: the copies of K(t+1) and
//   V(t) are in flight while iteration t computes.  Shared memory is 5 tiles
//   (Q, 2 x K, 2 x V) plus 1 KB of alignment slack: 82,944 B at hd 128, so
//   two blocks fit on an SM; 164,864 B at hd 256, one block.
// * Query tiles are issued from the last to the first: under a causal band
//   the last tiles see the most keys, so the long blocks start first.
//
// The bool mask on the tensor cores (masked = true).  The CUDA-core kernel
// visited every tile and read the mask bytes of each (the gpt-paper chunk:
// 403 M pairs a head where the causal band holds 302 M, and 12 heads
// re-reading one 33.5 MB mask).  Here a pre-pass reads the mask once:
// * mask_classify_kernel, one block per (kv tile, query tile, mask head):
//   packs the tile into 64 rows of 64 bits and classes it dead (no live
//   entry), full (every in-range entry live) or partial; marks the rows
//   that have a live key somewhere.
// * mask_list_kernel, one warp per (query tile, mask head): the kv tiles to
//   visit, in order, each with its class.  Dead tiles are dropped: for a
//   row with a live key that is exact, since exp(-1e30 - m) is 0 in f32 once
//   the row has seen a live key, and a masked entry seen before the first
//   live key is wiped by the rescale exp(-1e30 - m_new) = 0.  A query tile
//   that holds a row with no live key at all keeps every kv tile (its dead
//   ones masked whole), so that row still averages every V.
// * The main kernel then walks its list: a full tile needs no mask, a
//   partial one 16 bytes of bits a thread (two rows, loaded while the
//   products run), a dead one in a kept list masks everything.  All 12
//   gpt-paper heads share one list and one set of bits (Nm = 1).
// The pre-pass's workspace (bits, lists, classes; about an eighth of the
// mask) is allocated by the wrapper and charged by kernel dispatch
// (chunked_attention.py masked_workspace_bytes).

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


__host__ __device__ constexpr int smem_floats(int hd) {
  return hd * (kBQ + kPad) + hd * (kBKV + kPad) + kBKV * hd + kBKV * (kBQ + kPad);
}

// a vector of 4 or 2 floats from shared memory, as one float4 or float2
__device__ __forceinline__ void load_vec(const float* p, float (&w)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  w[0] = t.x;
  w[1] = t.y;
  w[2] = t.z;
  w[3] = t.w;
}
__device__ __forceinline__ void load_vec(const float* p, float (&w)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  w[0] = t.x;
  w[1] = t.y;
}

// floor(a / b) for b > 0 and any sign of a
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <int HD, bool MASKED>
__global__ void __launch_bounds__(kThreads)
chunk_attention_kernel(const float* __restrict__ q,         // (N*group, Sq, HD)
                       const float* __restrict__ k,         // (N, Skv, HD)
                       const float* __restrict__ v,         // (N, Skv, HD)
                       const uint8_t* __restrict__ mask,    // (Nm, Sq, Skv) or null
                       float* __restrict__ out,             // (N*group, Sq, HD)
                       int group, int Sq, int Skv, int q_offset, int causal,
                       int window, int mask_heads, float scale) {
  constexpr int kQP = kBQ + kPad;
  constexpr int kKP = kBKV + kPad;
  constexpr int kAccCols = HD / 8;   // accumulator columns per thread
  // V and the output in vectors of kVec floats: thread tx owns columns
  // 8 kVec cv + kVec tx + u of each of the kAccCols / kVec column groups cv
  constexpr int kVec = HD % 32 == 0 ? 4 : 2;
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");

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

  const float* qn = q + (size_t)n * Sq * HD;
  const float* kn = k + (size_t)(n / group) * Skv * HD;
  const float* vn = v + (size_t)(n / group) * Skv * HD;
  const uint8_t* mn = MASKED ? mask + (size_t)(mask_heads == 1 ? 0 : n) * Sq * Skv : nullptr;

  // stage the query tile (zeros past Sq)
  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    qT[d * kQP + r] = (q0 + r < Sq) ? qn[(size_t)(q0 + r) * HD + d] : 0.f;
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
      kT[d * kKP + c] = in ? kn[off] : 0.f;
      vS[c * HD + d] = in ? vn[off] : 0.f;
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

    // acc[rows ty*4+i][cols kVec*tx + 8*kVec*cv + u] += P @ V
#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&pT[c * kQP + ty * kRows]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int cv = 0; cv < kAccCols / kVec; ++cv) {
        float wv[kVec];
        load_vec(&vS[c * HD + 8 * kVec * cv + kVec * tx], wv);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int u = 0; u < kVec; ++u)
            acc[i][kVec * cv + u] = fmaf(pv[i], wv[u], acc[i][kVec * cv + u]);
      }
    }
  }

  float* on = out + (size_t)n * Sq * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cv = 0; cv < kAccCols / kVec; ++cv)
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        on[(size_t)row * HD + 8 * kVec * cv + kVec * tx + u] = acc[i][kVec * cv + u] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 computed-mask kernel on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// this thread's shared-memory writes (generic proxy) become visible to wgmma
// (async proxy); a barrier after it covers the other threads' writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// The compiler sees a wgmma as one instruction that reads and writes its
// registers at issue; the hardware reads A and writes D until the wait.
// Pinning the registers after the wait keeps the compiler from reading D
// early or reusing A's registers while the product is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}
template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(x[i][j]) :: "memory");
}

// D(64 x 64) (+)= A(64 x 16, K-major in smem) * B(64 x 16, K-major in smem)
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D(64 x 32) (+)= A(64 x 16, registers) * B(16 x 32, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 64) (+)= A(64 x 16, registers) * B(16 x 64, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 128) (+)= A(64 x 16, registers) * B(16 x 128, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 80) (+)= A(64 x 16, registers) * B(16 x 80, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_m64n80(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 96) (+)= A(64 x 16, registers) * B(16 x 96, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_m64n96(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// A tile of 64 rows x HD bf16 in shared memory, laid out for wgmma: rows of
// kRowBytes bytes (one swizzle atom wide: the widest of 128, 64 and 32 that
// divides 2 HD), 8-row groups kRowBytes * 8 apart, 2 HD / kRowBytes column
// blocks of 64 rows each, and the 16-byte chunk c of row r stored at chunk
// c ^ (address bits 7..) -- CUDA's 128-, 64- or 32-byte swizzle.  Tiles and
// column blocks start 1024-byte aligned, so the swizzle of an offset is the
// swizzle of its address.
//   hd:          32   64   80   96  128  256
//   kRowBytes:   64  128   32   64  128  128
//   blocks:       1    1    5    3    2    4
template <int HD>
struct Tile {
  static constexpr int kRowBytes = (2 * HD) % 128 == 0 ? 128 : (2 * HD) % 64 == 0 ? 64 : 32;
  static constexpr int kBlockBytes = 64 * kRowBytes;         // one column block
  static constexpr int kBytes = 64 * HD * 2;
  static constexpr uint32_t kSwizzle = kRowBytes / 16 - 1;   // 7, 3 or 1
  // descriptor layout type: B128 1, B64 2, B32 3
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  static_assert(kBlockBytes % 1024 == 0 && kBytes % 1024 == 0, "1024-byte aligned blocks");

  // byte offset of chunk ch (bf16 elements 8 ch .. 8 ch + 7) of row r
  __device__ static uint32_t offset(int r, int ch) {
    const int byte = ch * 16;
    const uint32_t off = (byte / kRowBytes) * kBlockBytes + r * kRowBytes + byte % kRowBytes;
    return off ^ (((off >> 7) & kSwizzle) << 4);
  }

  // wgmma matrix descriptor: start address, leading and stride byte offsets
  // (16-byte units), swizzle mode
  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
           ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (kLayout << 62);
  }
  // the tile as a K-major operand (rows = M or N, hd = K), k-step kk of 16
  // hd values: 32 bytes into the row, inside its column block
  __device__ static uint64_t k_major(uint32_t base, int kk) {
    return desc(base + (kk * 32 / kRowBytes) * kBlockBytes + (kk * 32) % kRowBytes, 16,
                8 * kRowBytes);
  }
  // the tile as an MN-major operand (rows = K, hd = N), k-step kk of 16 rows,
  // from hd column col (a column block's first); the next kRowBytes / 2 hd
  // values are one column block further on
  __device__ static uint64_t mn_major(uint32_t base, int kk, int col = 0) {
    return desc(base + (col * 2 / kRowBytes) * kBlockBytes + kk * 16 * kRowBytes, kBlockBytes,
                8 * kRowBytes);
  }

  // rows [0, 64) of a row-major (rows, HD) source, rows >= valid as zeros,
  // by NT threads
  template <int NT>
  __device__ static void load(uint32_t dst, const __nv_bfloat16* src, int valid, int tid) {
    constexpr int kChunks = HD / 8;   // 16-byte chunks a row
    static_assert(64 * kChunks % NT == 0, "whole copies a thread");
#pragma unroll
    for (int i = 0; i < 64 * kChunks / NT; ++i) {
      const int e = tid + i * NT;
      const int r = e / kChunks, ch = e % kChunks;
      const bool in = r < valid;
      cp_async_16(dst + offset(r, ch), src + (size_t)(in ? r : 0) * HD + ch * 8, in ? 16 : 0);
    }
  }
};

// O(64 x N) += P V, N output columns
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (N == 32) {
    wgmma_rs_m64n32(o, a, desc_v, 1);
  } else if constexpr (N == 64) {
    wgmma_rs_m64n64(o, a, desc_v, 1);
  } else if constexpr (N == 80) {
    wgmma_rs_m64n80(o, a, desc_v, 1);
  } else if constexpr (N == 96) {
    wgmma_rs_m64n96(o, a, desc_v, 1);
  } else {
    static_assert(N == 128, "P V width");
    wgmma_rs_m64n128(o, a, desc_v, 1);
  }
}

// The bf16 kernel's shape at head dim HD: warpgroups a block, each owning
// kN = HD / kWG output columns.
template <int HD>
struct WgmmaShape {
  static constexpr int kWG = HD > 128 ? 2 : 1;
  static constexpr int kN = HD / kWG;
  static constexpr int kThreads = 128 * kWG;
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 b) {
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Two probabilities (keys c, c + 1 of one row) as bf16 hi + lo register
// operands, p ~= hi + lo to about 2^-17; their sum, as the products will
// see it, goes into the row's l.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo,
                                           float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  const float2 rf = __bfloat1622float2(r);
  sum += (hf.x + rf.x) + (hf.y + rf.y);
  hi = bits(h);
  lo = bits(r);
}

// Tile classes of a bool mask, per (mask head, query tile, kv tile): no
// live entry, every in-range entry live, or some of each.
constexpr int kDead = 0, kFull = 1, kPartial = 2;

// What mask_classify_kernel and mask_list_kernel leave for the bf16 masked
// kernel: per (mask head, query tile) the kv tiles to visit, each as
// (tile << 2) | class, and their count; per visited partial tile 64 rows of
// 64 bits (bit j of row r: key 64 t + j of row 64 qt + r is live).
struct MaskTiles {
  const int* list;                  // (heads, n_qt, n_kt)
  const int* count;                 // (heads, n_qt)
  const unsigned long long* bits;   // (heads, n_qt, n_kt, 64)
  int heads, n_qt, n_kt;
};

// One block of 256 threads per (kv tile, query tile, mask head): thread t
// reads keys 16 (t % 4) .. + 15 of tile row t / 4, packs them into bits,
// and the block votes the tile's class.  A row with a live key anywhere
// marks row_live (zeroed before).
__global__ void __launch_bounds__(256)
mask_classify_kernel(const uint8_t* __restrict__ mask, int Sq, int Skv, int n_qt, int n_kt,
                     uint8_t* __restrict__ cls, unsigned long long* __restrict__ bits,
                     uint8_t* __restrict__ row_live) {
  const int t = blockIdx.x, qt = blockIdx.y, hm = blockIdx.z;
  const int r = threadIdx.x >> 2, seg = threadIdx.x & 3;
  const int row = qt * kBQ + r, k0 = t * kBKV + seg * 16;
  const int n_in = row < Sq ? max(0, min(16, Skv - k0)) : 0;   // in-range keys
  uint32_t b = 0;
  if (n_in > 0) {
    const uint8_t* m = mask + ((size_t)hm * Sq + row) * Skv + k0;
    if (n_in == 16 && (reinterpret_cast<uintptr_t>(m) & 15) == 0) {
      const uint4 w = *reinterpret_cast<const uint4*>(m);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) b |= (uint32_t)(((words[e >> 2] >> (8 * (e & 3))) & 0xFF) != 0) << e;
    } else {
      for (int e = 0; e < n_in; ++e) b |= (uint32_t)(m[e] != 0) << e;
    }
  }
  const uint32_t in_range = n_in == 16 ? 0xFFFFu : (1u << n_in) - 1;
  const int any = __syncthreads_or(b != 0);
  const int all = __syncthreads_and(b == in_range);
  const size_t tile = ((size_t)hm * n_qt + qt) * n_kt + t;
  reinterpret_cast<uint16_t*>(bits + tile * 64 + r)[seg] = (uint16_t)b;
  if (b != 0) row_live[(size_t)hm * Sq + row] = 1;
  if (threadIdx.x == 0) cls[tile] = any ? (all ? kFull : kPartial) : kDead;
}

// One warp per (query tile, mask head): the kv tiles its blocks visit, in
// order.  Dead tiles are dropped, unless a row of the query tile has no
// live key at all: that row gets the mean of every V, as the reference
// gives, so such a tile keeps every kv tile (its dead ones masked whole).
__global__ void __launch_bounds__(32)
mask_list_kernel(const uint8_t* __restrict__ cls, const uint8_t* __restrict__ row_live, int Sq,
                 int n_qt, int n_kt, int* __restrict__ list, int* __restrict__ count) {
  const int qt = blockIdx.x, hm = blockIdx.y, lane = threadIdx.x;
  bool empty_row = false;
  for (int r = lane; r < kBQ; r += 32) {
    const int row = qt * kBQ + r;
    empty_row |= row < Sq && row_live[(size_t)hm * Sq + row] == 0;
  }
  const bool keep_all = __any_sync(0xffffffffu, empty_row);
  const size_t base = ((size_t)hm * n_qt + qt) * n_kt;
  int n = 0;
  for (int t0 = 0; t0 < n_kt; t0 += 32) {
    const int t = t0 + lane;
    const int c = t < n_kt ? cls[base + t] : kDead;
    const bool keep = t < n_kt && (keep_all || c != kDead);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) list[base + n + __popc(ballot & ((1u << lane) - 1))] = (t << 2) | c;
    n += __popc(ballot);
  }
  if (lane == 0) count[(size_t)hm * n_qt + qt] = n;
}

template <int HD, bool MASKED>
__global__ void __launch_bounds__(WgmmaShape<HD>::kThreads)
chunk_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,   // (N*group, Sq, HD)
                             const __nv_bfloat16* __restrict__ k,   // (N, Skv, HD)
                             const __nv_bfloat16* __restrict__ v,   // (N, Skv, HD)
                             __nv_bfloat16* __restrict__ out,       // (N*group, Sq, HD)
                             int group, int Sq, int Skv, int q_offset, int causal, int window,
                             float scale_log2, MaskTiles mt) {
  static_assert(kBQ == 64 && kBKV == 64, "one wgmma M of query rows, 64-key tiles");
  using Tl = Tile<HD>;
  constexpr int NT = WgmmaShape<HD>::kThreads;
  constexpr int kN = WgmmaShape<HD>::kN;        // this warpgroup's output columns
  extern __shared__ uint8_t smem_raw[];
  // Q, K0, V0, K1, V1, from a 1024-byte aligned base
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;

  const int tid = threadIdx.x;
  // warpgroup (output columns wg kN ..) and warp in it; constants for one
  // warpgroup, so its descriptor and address arithmetic folds as before
  constexpr bool kOneWG = WgmmaShape<HD>::kWG == 1;
  const int wg = kOneWG ? 0 : tid >> 7;
  const int warp = kOneWG ? tid >> 5 : (tid >> 5) & 3, lane = tid & 31;
  const int n = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kBQ;
  const int q_end = min(q0 + kBQ, Sq);
  const __nv_bfloat16* qn = q + (size_t)n * Sq * HD;
  const __nv_bfloat16* kn = k + (size_t)(n / group) * Skv * HD;
  const __nv_bfloat16* vn = v + (size_t)(n / group) * Skv * HD;

  // the kv tiles this block visits: the listed ones (masked), or the band's
  // contiguous range [t_lo, t_hi) (computed)
  int t_lo = 0, n_visit;
  const int* visit = nullptr;
  const unsigned long long* tile_bits = nullptr;
  if constexpr (MASKED) {
    const size_t at = (size_t)(mt.heads == 1 ? 0 : n) * mt.n_qt + qt;
    visit = mt.list + at * mt.n_kt;
    tile_bits = mt.bits + at * mt.n_kt * 64;
    n_visit = mt.count[at];
  } else {
    const int n_tiles = (Skv + kBKV - 1) / kBKV;
    int t_hi = n_tiles;
    if (causal) {
      const long long last = (long long)q_offset + q_end - 1;
      t_hi = last < 0 ? 0 : (int)min((long long)n_tiles, last / kBKV + 1);
    }
    if (window > 0) {
      t_lo = (int)max(0LL, floor_div((long long)q_offset + q0 - (window - 1), kBKV));
    }
    n_visit = max(0, t_hi - t_lo);
  }
  auto tile_of = [&](int i) { return MASKED ? visit[i] >> 2 : t_lo + i; };

  // this thread's accumulator rows and columns (wgmma's D layout): rows
  // r_lo and r_lo + 8; columns 8 j + c0, 8 j + c0 + 1 of each 8-column chunk j
  const int r_lo = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float o[kN / 2];
  float s[32];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max of the base-2 logits
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums

  // Shared memory: Q, then K slots 0 and 1, then V slots 0 and 1.  Iteration
  // it computes S = Q K(it)^T and, beside it on the tensor cores, O +=
  // P(it-1) V(it-1): so K runs one tile ahead of V, and the copies issued in
  // iteration it (K(it+1), V(it)) overwrite the slots of K(it-1) and V(it-2),
  // both consumed before the barrier that ends iteration it-1.
  auto k_slot = [&](int i) { return base + (1 + (i & 1)) * Tl::kBytes; };
  auto v_slot = [&](int i) { return base + (3 + (i & 1)) * Tl::kBytes; };
  if (n_visit > 0) {
    const int t0 = tile_of(0);
    Tl::template load<NT>(sQ, qn + (size_t)q0 * HD, Sq - q0, tid);
    Tl::template load<NT>(k_slot(0), kn + (size_t)t0 * kBKV * HD, Skv - t0 * kBKV, tid);
  }
  cp_async_commit();

  uint32_t p_hi[4][4] = {}, p_lo[4][4] = {};   // P of the previous tile, as A fragments
  for (int it = 0; it < n_visit; ++it) {
    const int entry = MASKED ? visit[it] : 0;
    const int k0 = tile_of(it) * kBKV;
    if (it + 1 < n_visit) {
      const int k1 = tile_of(it + 1) * kBKV;
      Tl::template load<NT>(k_slot(it + 1), kn + (size_t)k1 * HD, Skv - k1, tid);
    }
    // a partial tile's mask bits of this thread's two rows, read while the
    // products run
    unsigned long long row_bits[2] = {0ull, 0ull};
    if (MASKED && (entry & 3) == kPartial) {
      const unsigned long long* tb = tile_bits + (size_t)(entry >> 2) * 64;
      row_bits[0] = tb[r_lo];
      row_bits[1] = tb[r_lo + 8];
    }
    Tl::template load<NT>(v_slot(it), vn + (size_t)k0 * HD, Skv - k0, tid);
    cp_async_commit();
    cp_async_wait<1>();       // Q, K(it) and V(it-1) have landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K(it)^T, and O += P(it-1) V(it-1) as P_hi V + P_lo V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_m64n64(s, Tl::k_major(sQ, kk), Tl::k_major(k_slot(it), kk), kk > 0);
    }
    wgmma_commit();
    if (it > 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<kN>(o, p_hi[kk], Tl::mn_major(v_slot(it - 1), kk, wg * kN));
        wgmma_pv<kN>(o, p_lo[kk], Tl::mn_major(v_slot(it - 1), kk, wg * kN));
      }
      wgmma_commit();
      wgmma_wait<1>();        // S is done; P V may still run
    } else {
      wgmma_wait<0>();
    }
    pin(s);

    // scale to base 2, mask, online softmax (while P V runs)
    const bool cut = MASKED ? (entry & 3) != kFull
                            : (causal && (long long)(k0 + kBKV - 1) > (long long)q_offset + q0) ||
                                  (window > 0 && (long long)q_offset + q_end - 1 - k0 >= window);
    const bool edge = k0 + kBKV > Skv;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;                      // 0: row r_lo, 1: row r_lo + 8
      const int col = 8 * (i >> 2) + c0 + (i & 1);
      const int kpos = k0 + col;
      float x = s[i] * scale_log2;
      if (cut) {
        bool live;
        if constexpr (MASKED) {
          live = (row_bits[r] >> col) & 1;             // a dead tile's bits are all 0
        } else {
          const long long qpos = (long long)q_offset + q0 + r_lo + 8 * r;
          live = true;
          if (causal) live = live && (long long)kpos <= qpos;
          if (window > 0) live = live && qpos - kpos < window;
        }
        if (!live) x = kNegInf;
      }
      if (edge && kpos >= Skv) x = -INFINITY;          // not a key: weight 0
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = exp2f(s[i] - m[(i >> 1) & 1]);

    // once P(it-1) V(it-1) is in O: rescale O, and P(it) takes P(it-1)'s
    // registers; A fragment kk (keys 16 kk .. 16 kk + 15) is S values 8 kk .. 8 kk + 7
    wgmma_wait<0>();
    pin(o);
    pin(p_hi);
    pin(p_lo);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = 8 * kk + 2 * h;
        split_bf16(s[i], s[i + 1], p_hi[kk][h], p_lo[kk][h], l[h & 1]);
      }
    __syncthreads();          // K(it) and V(it-1) are free for the next copies
  }
  cp_async_wait<0>();
  if (n_visit > 0) {          // the last tile's P V
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<kN>(o, p_hi[kk], Tl::mn_major(v_slot(n_visit - 1), kk, wg * kN));
      wgmma_pv<kN>(o, p_lo[kk], Tl::mn_major(v_slot(n_visit - 1), kk, wg * kN));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
    pin(p_hi);
    pin(p_lo);
  }

  __nv_bfloat16* on = out + (size_t)n * Sq * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = q0 + r_lo + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(&on[(size_t)row * HD + wg * kN + 8 * j + c0]) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int HD, bool MASKED>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int n_q_heads,
                         int group, int Sq, int Skv, int q_offset, int causal, int window,
                         float scale, MaskTiles mt, cudaStream_t stream) {
  constexpr int bytes = 5 * Tile<HD>::kBytes + 1024;   // + alignment slack
  static bool configured = false;   // the attribute is per function, set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(chunk_attention_wgmma_kernel<HD, MASKED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, n_q_heads);
  chunk_attention_wgmma_kernel<HD, MASKED><<<grid, WgmmaShape<HD>::kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), group, Sq, Skv,
      q_offset, causal, window, scale * 1.4426950408889634f, mt);
  return cudaGetLastError();
}

// Workspace of the bf16 masked kernel, in this order: tile bits, visit
// lists, their counts, tile classes, row_live.  The wrapper allocates it
// (kernels/chunked_attention.py masked_workspace_bytes, the same sum).
size_t mask_workspace_bytes(int heads, int Sq, int Skv) {
  const size_t tiles = (size_t)heads * ((Sq + kBQ - 1) / kBQ) * ((Skv + kBKV - 1) / kBKV);
  return tiles * (64 * 8 + 4 + 1) + (size_t)heads * ((Sq + kBQ - 1) / kBQ) * 4 +
         (size_t)heads * Sq;
}

// classify the mask's tiles and list each query tile's visits
cudaError_t prepare_mask(const void* mask, int heads, int Sq, int Skv, void* workspace,
                         MaskTiles* mt, cudaStream_t stream) {
  const int n_qt = (Sq + kBQ - 1) / kBQ, n_kt = (Skv + kBKV - 1) / kBKV;
  const size_t tiles = (size_t)heads * n_qt * n_kt;
  uint8_t* ws = static_cast<uint8_t*>(workspace);
  auto* bits = reinterpret_cast<unsigned long long*>(ws);
  int* list = reinterpret_cast<int*>(ws + tiles * 64 * 8);
  int* count = list + tiles;
  uint8_t* cls = reinterpret_cast<uint8_t*>(count + (size_t)heads * n_qt);
  uint8_t* row_live = cls + tiles;
  cudaError_t e = cudaMemsetAsync(row_live, 0, (size_t)heads * Sq, stream);
  if (e != cudaSuccess) return e;
  mask_classify_kernel<<<dim3(n_kt, n_qt, heads), 256, 0, stream>>>(
      static_cast<const uint8_t*>(mask), Sq, Skv, n_qt, n_kt, cls, bits, row_live);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mask_list_kernel<<<dim3(n_qt, heads), 32, 0, stream>>>(cls, row_live, Sq, n_qt, n_kt, list,
                                                         count);
  *mt = MaskTiles{list, count, bits, heads, n_qt, n_kt};
  return cudaGetLastError();
}

template <int HD, bool MASKED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int n_q_heads, int group, int Sq, int Skv, int q_offset, int causal,
                   int window, int mask_heads, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats(HD) * (int)sizeof(float);
  static bool configured = false;   // the attribute is per function, set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(chunk_attention_kernel<HD, MASKED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, n_q_heads);
  chunk_attention_kernel<HD, MASKED><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), group, Sq, Skv, q_offset,
      causal, window, mask_heads, scale);
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const void* mask,
                      void* out, int n_q_heads, int group, int Sq, int Skv, int q_offset,
                      int causal, int window, int mask_heads, float scale,
                      cudaStream_t stream) {
#define CHUNK_ATTN_F32(D)                                                                 \
  case D:                                                                                 \
    return launch<D, MASKED>(q, k, v, mask, out, n_q_heads, group, Sq, Skv, q_offset,     \
                             causal, window, mask_heads, scale, stream);
  switch (hd) {
    CHUNK_ATTN_F32(32)
    CHUNK_ATTN_F32(64)
    CHUNK_ATTN_F32(80)
    CHUNK_ATTN_F32(96)
    CHUNK_ATTN_F32(128)
    CHUNK_ATTN_F32(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef CHUNK_ATTN_F32
}

template <bool MASKED>
int dispatch(int dtype, int hd, const void* q, const void* k, const void* v, const void* mask,
             void* out, int n_q_heads, int group, int Sq, int Skv, int q_offset, int causal,
             int window, int mask_heads, float scale, void* workspace, size_t workspace_bytes,
             void* stream) {
  if (group <= 0 || n_q_heads % group != 0 || Sq <= 0 || Skv <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_hd<MASKED>(hd, q, k, v, mask, out, n_q_heads, group, Sq, Skv,
                                  q_offset, causal, window, mask_heads, scale, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // bf16: the tensor-core kernel; a mask is classified by tiles first
  MaskTiles mt{};
  if (MASKED) {
    if (workspace == nullptr || workspace_bytes < mask_workspace_bytes(mask_heads, Sq, Skv)) {
      return (int)cudaErrorInvalidValue;
    }
    const cudaError_t e = prepare_mask(mask, mask_heads, Sq, Skv, workspace, &mt, st);
    if (e != cudaSuccess) return (int)e;
  }
#define CHUNK_ATTN_BF16(D)                                                                \
  case D:                                                                                 \
    return (int)launch_wgmma<D, MASKED>(q, k, v, out, n_q_heads, group, Sq, Skv, q_offset, \
                                        causal, window, scale, mt, st);
  switch (hd) {
    CHUNK_ATTN_BF16(32)
    CHUNK_ATTN_BF16(64)
    CHUNK_ATTN_BF16(80)
    CHUNK_ATTN_BF16(96)
    CHUNK_ATTN_BF16(128)
    CHUNK_ATTN_BF16(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CHUNK_ATTN_BF16
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
                         q_offset, causal, window, 1, scale, nullptr, 0, stream);
}

// As above with an explicit bool mask (mask_heads, Sq, Skv), mask_heads in
// {1, n_q_heads}; nonzero = attend.  bf16 needs a workspace of
// mask_workspace_bytes(mask_heads, Sq, Skv) bytes, 8-byte aligned; f32
// takes none (null, 0).
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int n_q_heads, int group,
                                    int Sq, int Skv, int hd, int mask_heads, float scale,
                                    int dtype, void* workspace, size_t workspace_bytes,
                                    void* stream) {
  if (mask_heads != 1 && mask_heads != n_q_heads) return (int)cudaErrorInvalidValue;
  return dispatch<true>(dtype, hd, q, k, v, mask, out, n_q_heads, group, Sq, Skv, 0, 0, 0,
                        mask_heads, scale, workspace, workspace_bytes, stream);
}
