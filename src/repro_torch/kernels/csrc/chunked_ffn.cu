// Chunked SwiGLU FFN for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel _ffn_kernel of src/repro/kernels/chunked_ffn.py
// (pallas_call at :55, wrapper chunked_ffn at :43).  It computes
//   out = (silu(x @ wg) * (x @ wu)) @ wd
// for x (rows, d), wg / wu (d, f), wd (f, d): gate and up in f32, h =
// silu(g) * u in f32, h @ wd accumulated in f32, the output in x's type.
// No (rows, f) tensor ever reaches device memory: only a (64, BF) gate/up
// tile exists, on chip.  That is the property the AutoChunk planner charges
// for when it dispatches a SwiGLU chunk-loop body to this kernel.
//
// What bounds it on an H100 SXM (published peaks at its 700 W limit), at the
// chunk the compiler plans for minitron-4b's block at 8192 tokens and budget
// 0.04 (c = 4096 rows, d 3072, f 9216, bf16): 6*c*d*f = 696 GFLOP take
// 0.704 ms at 989 TFLOP/s (bf16 tensor cores), while the bytes,
// (3*d*f + 2*c*d) * 2 = 220 MB, take 0.066 ms at 3.35 TB/s: operations bound.
//
// Where Hopper differs from the TPU.  The Pallas kernel carries an f32
// (bs, d) accumulator in VMEM across its sequential f-grid: 1.5 MB at bs 128,
// d 3072, far beyond an SM's 228 KB of shared memory and 256 KB of registers.
// Of the two ways out (split the f-reduction across blocks, or tile d too and
// recompute gate/up once per d-tile), this kernel splits f: recomputing the
// gate/up tile for every d-tile of 64 would multiply two thirds of the work
// by 48.  So:
// * One thread block per (row tile of 64, f tile of BF).  It computes its
//   gate and up tiles over the whole d (the K loop), applies silu * mul on
//   chip, multiplies the (64, BF) h tile by its (BF, d) slice of wd, 64
//   columns of d at a time, and adds each (64, 64) partial into an f32
//   (rows, d) workspace with atomicAdd.  The order of the adds varies from
//   run to run, so the last bits of an f32 sum do too.
// * The workspace is zeroed first (cudaMemsetAsync); a last pass casts it to
//   the output type.  For f32 outputs the partials go straight into the
//   output and there is no workspace.  The workspace is c*d*4 bytes (50 MB at
//   c 4096), against the 302 MB of (c, f) tensors the unfused body holds at
//   the same chunk.
// * bf16 (the main path): tensor cores through mma.sync m16n8k16 (bf16 in,
//   f32 accumulate), operands staged by cp.async in a ring of 3 tiles and
//   read with ldmatrix.  Each of the 4 warps owns 16 rows; BF is 128.  The h
//   tile stays in registers: the accumulator fragments of gate/up are exactly
//   the A fragments of the down product.  h is kept in f32 precision by
//   splitting it into bf16 hi + lo parts (h - hi, rounded again), two
//   products each, so h is never rounded to bf16 as a whole; that costs a
//   third more tensor-core work than one product.  A thread's two adjacent
//   output columns go out as one float2 vector atomic (sm_90).  Blocks run in
//   groups of 16 row tiles, f tiles outer within a group, so the workspace
//   rows in flight stay in L2 while 72 f tiles add into them.
// * f32: CUDA-core f32 FMAs in shared-memory tiles (4 x 4 outputs a thread,
//   BF 64); tensor cores would round the inputs to tf32.
// * The fused w_in of a SwiGLU layer is read in place: wg and wu may point at
//   column offsets of one (d, 2f) weight, with a leading dimension of 2f.
// * Ragged edges: rows need not be a multiple of 64 (chunks of 17 occur);
//   rows past the end are loaded as zeros and never stored.  d must be a
//   multiple of 64 and f of BF (64 for f32, 128 for bf16); the wrapper raises
//   otherwise.  Pointers 16-byte aligned and leading dimensions multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core tiles
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;   // 16 x 16, each 4 x 4 outputs
constexpr int kSimtBM = 64;         // rows per block
constexpr int kSimtBF = 64;         // f columns per block
constexpr int kSimtBK = 16;         // d depth per staged tile
constexpr int kSimtBN = 64;         // d columns per down-product step

__global__ void __launch_bounds__(kSimtThreads)
ffn_simt_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                const float* __restrict__ wu, const float* __restrict__ wd,
                float* __restrict__ acc, int rows, int d, int ldx, int ldwg, int ldwu) {
  __shared__ float xs[kSimtBK][kSimtBM];
  __shared__ float gs[kSimtBK][kSimtBF];
  __shared__ float us[kSimtBK][kSimtBF];
  __shared__ float hs[kSimtBF][kSimtBM];   // h, transposed: hs[f][row]
  __shared__ float ds[kSimtBF][kSimtBN];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * kSimtBM;
  const int f0 = blockIdx.y * kSimtBF;

  float ag[4][4] = {}, au[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kSimtBK) {
    {  // x tile: 64 rows x 16, thread t loads row t/4, depth (t%4)*4 .. +4
      const int r = tid / 4, kk = (tid % 4) * 4;
      const bool live = row0 + r < rows;
      const float* src = x + (size_t)(row0 + r) * ldx + k0 + kk;
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[kk + e][r] = live ? src[e] : 0.0f;
    }
    {  // gate / up tiles: 16 x 64, thread t loads depth t/16, columns (t%16)*4 .. +4
      const int kk = tid / 16, cc = (tid % 16) * 4;
      const float* sg = wg + (size_t)(k0 + kk) * ldwg + f0 + cc;
      const float* su = wu + (size_t)(k0 + kk) * ldwu + f0 + cc;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gs[kk][cc + e] = sg[e];
        us[kk][cc + e] = su[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&gs[kk][tx * 4]);
      const float4 u = *reinterpret_cast<const float4*>(&us[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ag[i][j] = fmaf(av[i], gv[j], ag[i][j]);
          au[i][j] = fmaf(av[i], uv[j], au[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) hs[tx * 4 + j][ty * 4 + i] = silu_mul(ag[i][j], au[i][j]);
  }

  // down product: (64, BF) h tile times wd[f0 : f0 + BF, n0 : n0 + 64]
  for (int n0 = 0; n0 < d; n0 += kSimtBN) {
    for (int e = tid; e < kSimtBF * kSimtBN; e += kSimtThreads) {
      const int kk = e / kSimtBN, cc = e % kSimtBN;
      ds[kk][cc] = wd[(size_t)(f0 + kk) * d + n0 + cc];
    }
    __syncthreads();
    float o[4][4] = {};
#pragma unroll 8
    for (int kk = 0; kk < kSimtBF; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ds[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(av[i], bv[j], o[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(acc + (size_t)r * d + n0 + tx * 4 + j, o[i][j]);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kStages = 3;          // cp.async ring depth: tiles in flight
constexpr int kWarps = 4;           // 16 rows each
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kMmaBM = 16 * kWarps;
constexpr int kMmaBF = 128;         // f columns per block: 16 n8 tiles per warp
constexpr int kMmaBK = 32;          // d depth per staged tile (two k16 steps)
constexpr int kMmaBN = 64;          // d columns per down-product step
constexpr int kPad = 8;             // bf16 row padding: rows 16 bytes apart mod 128
constexpr int kNT = kMmaBF / 8;     // n8 tiles of gate / up per warp
constexpr int kKS = kMmaBF / 16;    // k16 steps of the down product
constexpr int kGroup = 16;          // row tiles that walk the f tiles together

constexpr int kXsLd = kMmaBK + kPad;    // 40
constexpr int kWsLd = kMmaBF + kPad;    // 136
constexpr int kDsLd = kMmaBN + kPad;    // 72
constexpr int kXsElems = kMmaBM * kXsLd;
constexpr int kWsElems = kMmaBK * kWsLd;
constexpr int kStageA = kXsElems + 2 * kWsElems;  // x, gate, up tiles of one stage
constexpr int kStageB = kMmaBF * kDsLd;           // one wd tile
constexpr int kSmemA = kStages * kStageA;
constexpr int kSmemB = kStages * kStageB;
constexpr int kSmemBytes = 2 * (kSmemA > kSmemB ? kSmemA : kSmemB);  // dynamic
static_assert(kMmaBM * (kMmaBK / 8) % kMmaThreads == 0 &&
              kMmaBK * (kMmaBF / 8) % kMmaThreads == 0 &&
              kMmaBF * (kMmaBN / 8) % kMmaThreads == 0, "tile loads must split evenly");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros (rows past the end)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kMmaThreads)
ffn_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
               const __nv_bfloat16* __restrict__ wu, const __nv_bfloat16* __restrict__ wd,
               float* __restrict__ acc, int rows, int d, int ldx, int ldwg, int ldwu) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;       // mma fragment coordinates
  // block order: groups of kGroup row tiles, f tiles outer within a group,
  // so the blocks in flight add into a few MB of the workspace (it stays in
  // L2) and re-read the weights once per group
  const int n_rt = (rows + kMmaBM - 1) / kMmaBM, n_ft = gridDim.x / n_rt;
  const int grp = blockIdx.x / (kGroup * n_ft), in_grp = blockIdx.x % (kGroup * n_ft);
  const int grp_rows = min(kGroup, n_rt - grp * kGroup);
  const int row0 = (grp * kGroup + in_grp % grp_rows) * kMmaBM;
  const int f0 = (in_grp / grp_rows) * kMmaBF;

  // ---- gate and up tiles over the whole depth d ----------------------------
  auto load_a = [&](int stage, int k0) {
    __nv_bfloat16* xs = smem + stage * kStageA;
    __nv_bfloat16* gs = xs + kXsElems;
    __nv_bfloat16* us = gs + kWsElems;
    // x: BM rows x 32, in chunks of 8
#pragma unroll
    for (int i = 0; i < kMmaBM * (kMmaBK / 8) / kMmaThreads; ++i) {
      const int id = tid + i * kMmaThreads;
      const int r = id / (kMmaBK / 8), cc = (id % (kMmaBK / 8)) * 8;
      const bool live = row0 + r < rows;
      const __nv_bfloat16* src = live ? x + (size_t)(row0 + r) * ldx + k0 + cc : x;
      cp_async16(xs + r * kXsLd + cc, src, live ? 16 : 0);
    }
    // gate and up: 32 x BF each, in chunks of 8
#pragma unroll
    for (int i = 0; i < kMmaBK * (kMmaBF / 8) / kMmaThreads; ++i) {
      const int id = tid + i * kMmaThreads;
      const int kk = id / (kMmaBF / 8), cc = (id % (kMmaBF / 8)) * 8;
      cp_async16(gs + kk * kWsLd + cc, wg + (size_t)(k0 + kk) * ldwg + f0 + cc, 16);
      cp_async16(us + kk * kWsLd + cc, wu + (size_t)(k0 + kk) * ldwu + f0 + cc, 16);
    }
  };

  float ag[kNT][4], au[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ag[j][e] = au[j][e] = 0.0f;
  }

  // a ring of kStages tiles: tile kt is waited for, then tile kt + kStages - 1
  // is requested into the slot that tile kt - 1 left (every warp is past it
  // once the barrier is), and tile kt is computed; one group is committed
  // per step, empty at the end, so the wait count stays kStages - 2
  const int nk = d / kMmaBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_a(s, s * kMmaBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load_a(next % kStages, next * kMmaBK);
    cp_async_commit();
    const __nv_bfloat16* xs = smem + (kt % kStages) * kStageA;
    const __nv_bfloat16* gs = xs + kXsElems;
    const __nv_bfloat16* us = gs + kWsElems;
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, xs + (warp * 16 + lane % 16) * kXsLd + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        uint32_t b[4];
        const int off = (ks * 16 + lane % 16) * kWsLd + p * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(b, gs + off);
        mma_bf16(ag[2 * p], a, b[0], b[1]);
        mma_bf16(ag[2 * p + 1], a, b[2], b[3]);
        ldmatrix_x4_trans(b, us + off);
        mma_bf16(au[2 * p], a, b[0], b[1]);
        mma_bf16(au[2 * p + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // phase B reuses the ring's shared memory

  // ---- h = silu(g) * u in f32, as hi + lo bf16 A fragments -----------------
  // the accumulators of n8 tiles 2s and 2s+1 are the A fragment of k16 step s
  uint32_t hhi[kKS][4], hlo[kKS][4];
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 2 * s + q / 2;        // a0, a1 from tile 2s; a2, a3 from 2s+1
      const int e = (q % 2) * 2;          // a0/a2: row g; a1/a3: row g + 8
      const float h0 = silu_mul(ag[j][e], au[j][e]);
      const float h1 = silu_mul(ag[j][e + 1], au[j][e + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
      hhi[s][q] = *reinterpret_cast<const uint32_t*>(&hi);
      hlo[s][q] = pack_bf16(h0 - __low2float(hi), h1 - __high2float(hi));
    }
  }

  // ---- down product: h (64, BF) times wd[f0 : f0 + BF, :], 64 columns a step
  auto load_b = [&](int stage, int n0) {
    __nv_bfloat16* ds = smem + stage * kStageB;
    // BF x 64, in chunks of 8
#pragma unroll
    for (int i = 0; i < kMmaBF * (kMmaBN / 8) / kMmaThreads; ++i) {
      const int id = tid + i * kMmaThreads;
      const int kk = id / (kMmaBN / 8), cc = (id % (kMmaBN / 8)) * 8;
      cp_async16(ds + kk * kDsLd + cc, wd + (size_t)(f0 + kk) * d + n0 + cc, 16);
    }
  };
  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
  const int nn = d / kMmaBN;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nn) load_b(s, s * kMmaBN);
    cp_async_commit();
  }
  for (int nt = 0; nt < nn; ++nt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = nt + kStages - 1;
    if (next < nn) load_b(next % kStages, next * kMmaBN);
    cp_async_commit();
    const __nv_bfloat16* ds = smem + (nt % kStages) * kStageB;
    float o[kMmaBN / 8][4];
#pragma unroll
    for (int j = 0; j < kMmaBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
#pragma unroll
      for (int p = 0; p < kMmaBN / 16; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ds + (s * 16 + lane % 16) * kDsLd + p * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * p], hhi[s], b[0], b[1]);
        mma_bf16(o[2 * p], hlo[s], b[0], b[1]);
        mma_bf16(o[2 * p + 1], hhi[s], b[2], b[3]);
        mma_bf16(o[2 * p + 1], hlo[s], b[2], b[3]);
      }
    }
    const int n0 = nt * kMmaBN;
#pragma unroll
    for (int j = 0; j < kMmaBN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      // the two columns a thread holds are adjacent: one 8-byte vector atomic
      if (r_lo < rows) {
        atomicAdd(reinterpret_cast<float2*>(acc + (size_t)r_lo * d + col),
                  make_float2(o[j][0], o[j][1]));
      }
      if (r_hi < rows) {
        atomicAdd(reinterpret_cast<float2*>(acc + (size_t)r_hi * d + col),
                  make_float2(o[j][2], o[j][3]));
      }
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                 size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

}  // namespace

// x: (rows, d) with row stride ldx; wg, wu: (d, f) with row strides ldwg, ldwu
// (column views of one fused (d, 2f) weight are fine); wd: (f, d) contiguous;
// out: (rows, d) contiguous in x's type.  dtype 0 = f32 (workspace unused,
// may be null), 1 = bf16 (workspace: rows * d floats).  Launches on
// ``stream``, does not synchronize.  Returns the CUDA error (0 on success).
extern "C" int chunked_ffn_fwd(const void* x, const void* wg, const void* wu, const void* wd,
                               void* out, void* workspace, int rows, int d, int f, int ldx,
                               int ldwg, int ldwu, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || d % 64 != 0 || ldx % 8 != 0 || ldwg % 8 != 0 || ldwu % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    if (f % kSimtBF != 0) return (int)cudaErrorInvalidValue;
    float* acc = static_cast<float*>(out);
    cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)rows * d * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((rows + kSimtBM - 1) / kSimtBM, f / kSimtBF);
    ffn_simt_kernel<<<grid, kSimtThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wg),
        static_cast<const float*>(wu), static_cast<const float*>(wd), acc, rows, d, ldx, ldwg,
        ldwu);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    if (f % kMmaBF != 0 || workspace == nullptr) return (int)cudaErrorInvalidValue;
    static const cudaError_t smem_ok = cudaFuncSetAttribute(
        ffn_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (smem_ok != cudaSuccess) return (int)smem_ok;
    float* acc = static_cast<float*>(workspace);
    const size_t n = (size_t)rows * d;
    cudaError_t err = cudaMemsetAsync(acc, 0, n * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
    const int n_blocks = ((rows + kMmaBM - 1) / kMmaBM) * (f / kMmaBF);
    ffn_mma_kernel<<<n_blocks, kMmaThreads, kSmemBytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wg),
        static_cast<const __nv_bfloat16*>(wu), static_cast<const __nv_bfloat16*>(wd), acc,
        rows, d, ldx, ldwg, ldwu);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    cast_bf16_kernel<<<blocks, 256, 0, st>>>(acc, static_cast<__nv_bfloat16*>(out), n);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
