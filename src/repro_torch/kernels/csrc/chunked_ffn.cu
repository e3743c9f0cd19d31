// Chunked SwiGLU FFN for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel _ffn_kernel of src/repro/kernels/chunked_ffn.py
// (pallas_call at :55, wrapper chunked_ffn at :43).  It computes
//   out = (silu(x @ wg) * (x @ wu)) @ wd
// for x (rows, d), wg / wu (d, f), wd (f, d): gate and up in f32, h =
// silu(g) * u in f32, h @ wd accumulated in f32, the output in x's type.
// No (rows, f) tensor ever reaches device memory: h lives in shared memory,
// 128 rows x 256 columns at a time.  That is the property the AutoChunk
// planner charges for when it dispatches a SwiGLU chunk-loop body to this
// kernel.
//
// What bounds it on an H100 SXM (published peaks at its 700 W limit), at the
// chunk the compiler plans for minitron-4b's block at 8192 tokens and budget
// 0.04 (c = 4096 rows, d 3072, f 9216, bf16): 6*c*d*f = 696 GFLOP take
// 0.704 ms at 989 TFLOP/s (bf16 tensor cores), while the bytes,
// (3*d*f + 2*c*d) * 2 = 220 MB, take 0.066 ms at 3.35 TB/s: operations bound.
// Keeping h in f32 through bf16 hi + lo costs a third more tensor-core work
// (928 G operations: 0.94 ms).  What the design meets first is traffic
// between L2 and the SMs: the (rows, d) result cannot stay on chip (1.5 MB
// a tile of 128 rows in f32), so f is split across blocks and the partials
// meet in an f32 workspace in L2, and every block streams weight tiles.
//
// Where Hopper differs from the TPU.  The Pallas kernel carries an f32
// (bs, d) accumulator in VMEM across its sequential f-grid: 1.5 MB at bs 128,
// d 3072, far beyond an SM's 228 KB of shared memory and 256 KB of registers.
// Of the two ways out (split the f-reduction across blocks, or tile d too and
// recompute gate/up once per d-tile), this kernel splits f: recomputing the
// gate/up tile for every d-tile would multiply two thirds of the work by
// d / 256.
//
// bf16 (the main path), ffn_wgmma_kernel: all three products on wgmma.
// * A block is two consumer warpgroups (64 rows each) over one tile of 128
//   rows, so every weight stage serves 128 rows, and one producer warp that
//   issues every copy with TMA.  Blocks run in clusters of two on
//   neighbouring row tiles: each block copies half of every weight stage
//   from global memory and multicasts it into both, so a weight byte leaves
//   L2 once per 256 rows.
// * The work is units of (pair of row tiles, chunk of 256 f columns); one
//   cluster on every two SMs walks every n_clusters-th unit.  Units run in
//   groups of 4 pairs, chunk by chunk: the units in flight add into the
//   workspace of about 1024 rows (12.6 MB at d 3072), which stays in L2
//   while the group's 36 chunks add into it, and consecutive clusters read
//   a chunk's weights at about the same time.
// * Per unit: (A) gate and up, both in one wgmma m64n256k16 (the wg and wu
//   tiles lie side by side in a stage, so x is read once for both), over
//   the whole d in steps of 32 -- x K-major with the 64B swizzle, wg / wu
//   MN-major with the 128B swizzle and the transpose flag, as TMA writes
//   them; two 128-column passes per chunk.  h = silu(g) * u in f32 from the
//   accumulators, split into bf16 hi = bf16(h) and lo = bf16(h - hi) (h to
//   about 2^-17, never rounded to bf16 as a whole), stored K-major (128B
//   swizzle) into shared memory.  (B) the (128 x 192) partial of each d
//   tile = hi @ wd + lo @ wd over the chunk's 256 rows of wd, wgmma
//   m64n192k16 with A = h from shared memory, added into the f32 (rows, d)
//   workspace as float2 atomics: 36 adds an output element at minitron's
//   f, 1.8 GB of reductions at its chunk.
// * The ring: 4 stages of 24 KB (x, wg and wu of one step of d; or 64 rows x
//   192 columns of wd), each with a full mbarrier (TMA bytes) and an empty
//   one (one arrival from each consumer warpgroup of both blocks, since the
//   partner's multicast writes into this block's stage too).  The producer
//   runs up to 4 stages ahead, across the phases.  Shared memory: h hi and
//   lo 128 KB, the ring 96 KB: 230,400 bytes with alignment slack, one
//   block an SM.
// * The workspace is zeroed first (cudaMemsetAsync); a last pass casts it to
//   bf16.  The adds land in another order from run to run, so the last bits
//   of an f32 sum do too.  The workspace is c*d*4 bytes (50 MB at c 4096),
//   against the 302 MB of (c, f) tensors the unfused body holds at the same
//   chunk (chunked_ffn.py workspace_bytes, which kernel dispatch charges).
// * f32: CUDA-core f32 FMAs in shared-memory tiles (4 x 4 outputs a thread,
//   BF 64), partials straight into the output; tensor cores would round the
//   inputs to tf32.
// * The fused w_in of a SwiGLU layer is read in place: wg and wu may point at
//   column offsets of one (d, 2f) weight, with a leading dimension of 2f.
// * Ragged edges: rows need not be a multiple of 128 (chunks of 17 occur);
//   rows past the end (and a pair's second tile past the last one) are
//   loaded as zeros by TMA and never stored; d need not be a multiple of
//   192 (the last output tile is zero-filled past d and not stored there).
//   d must be a multiple of 64 and f of 128 (64 for f32), pointers 16-byte
//   aligned, leading dimensions multiples of 8 (chunked_ffn.py
//   cuda_refusal, which kernel dispatch also asks).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
// bf16: wgmma tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 256;     // two consumer warpgroups (and one producer warp)
constexpr int kBM = 128;            // rows per block: 64 per warpgroup
constexpr int kFT = 128;            // f columns of one gate / up product
constexpr int kFC = 256;            // f columns of h staged in shared memory
constexpr int kBK = 32;             // d depth of one gate / up stage
constexpr int kDN = 192;            // d columns of one down-product accumulator
constexpr int kBF = 64;             // f rows of one down-product stage
constexpr int kStages = 4;          // ring stages of 24 KB, shared by both phases

// shared memory, from a 1024-byte aligned base: h as bf16 hi and lo, then
// the ring that the two phases take in turn
constexpr int kHBlock = kBM * 128;                  // 64 f columns of h: 16 KB
constexpr int kHBytes = (kFC / 64) * kHBlock;       // one of hi, lo: 64 KB
constexpr int kXBytes = kBM * kBK * 2;              // 8 KB, rows of 64 B
constexpr int kWBlock = kBK * 128;                  // 64 f columns of wg: 4 KB
constexpr int kWBytes = (kFT / 64) * kWBlock;       // 8 KB
constexpr int kStageABytes = kXBytes + 2 * kWBytes; // 24 KB: x, wg, wu
constexpr int kDBlock = kBF * 128;                  // 64 d columns of wd: 8 KB
constexpr int kStageBBytes = (kDN / 64) * kDBlock;  // 24 KB: wd
constexpr int kStageBytes = kStageABytes;
static_assert(kStageABytes == kStageBBytes, "both phases use the same ring stages");
constexpr int kWgSmemBytes = 2 * kHBytes + kStages * kStageBytes + 1024;   // + alignment slack
static_assert(kWgSmemBytes <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared-memory writes of the generic proxy become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// the compiler sees a wgmma as done at issue: pin the accumulator after
// the wait so that nothing reads it early
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}

// wgmma matrix descriptor: start address, leading and stride byte offsets,
// swizzle (1: 128-byte, 2: 64-byte)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}
// a byte offset inside a 1024-aligned tile of 128-byte rows, with its
// 16-byte chunk XOR-swizzled by the row as wgmma's 128B mode (and TMA's)
// reads and writes it
__device__ __forceinline__ uint32_t swz128(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

// D(64 x 192) (+)= A(64 x 16, K-major in smem) * B(16 x 192, MN-major in smem)
__device__ __forceinline__ void wgmma_m64n192(float (&d)[96], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));   // scale-d: accumulate
}

// D(64 x 256) (+)= A(64 x 16, K-major in smem) * B(16 x 256, MN-major in smem)
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));   // scale-d: accumulate
}


// ---- mbarriers, clusters and TMA --------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// arrive on the barrier at the same offset in cluster block `rank`
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile("{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
               "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
               :: "r"(bar), "r"(rank) : "memory");
}
// wait for the phase of the given parity to complete; a wait that never
// ends traps (a launch error) where it would hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}
// the 128 threads of one warpgroup (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}
// one box of a 2D tensor map into shared memory, completing on `bar`; with
// a multicast mask, into the same offsets of every block of the mask
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3}], [%4];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, uint32_t bar, uint16_t mask) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
                  "h"(mask)
               : "memory");
}

// The walk every thread of a block follows, one ring stage per step: per f
// chunk, (A) gate / up stages over d for each f tile, then (B) wd stages for
// each d tile.  The producer issues the stages' copies in this order and the
// consumers compute them in the same order.
//
// The work is split into units of (pair of row tiles, f chunk); a cluster
// takes every n_clusters-th unit.  Units run in groups of kGroupPairs pairs,
// chunk by chunk, so the units in flight at once add into the workspace of
// a few pairs (kGroupPairs x 256 rows: 12.6 MB at d 3072, which stays in
// L2 while its 36 chunks add into it) and each chunk's weights are read by
// consecutive clusters at about the same time.
constexpr int kGroupPairs = 4;

struct Walk {
  int d, f, n_pairs, n_ch;
  __device__ int n_units() const { return n_pairs * n_ch; }
  // (pair, chunk) of unit u
  __device__ int2 unit(int u) const {
    const int g = u / (kGroupPairs * n_ch), r = u - g * kGroupPairs * n_ch;
    const int pairs = min(kGroupPairs, n_pairs - g * kGroupPairs);
    return make_int2(g * kGroupPairs + r % pairs, r / pairs);
  }
  __device__ int n_ft(int ch) const { return min(kFC, f - ch * kFC) / kFT; }
  __device__ int nk() const { return d / kBK; }
  __device__ int n_dt() const { return (d + kDN - 1) / kDN; }
};

// Clusters of two blocks, each cluster walking units of (pair of 128-row
// tiles, f chunk); a block is two consumer warpgroups (64 rows each) and
// one producer warp.  Per unit, a chunk of kFC f columns: (A) gate and up over the whole d for each kFT
// of it, h = silu(g) * u in f32 split into bf16 hi + lo and kept in shared
// memory; (B) h (128 x kFC) times wd's rows of the chunk, kDN columns of d
// at a time, each (128, kDN) f32 partial added into the workspace.  The two
// blocks of a cluster share every weight stage: each copies half of it from
// global memory and multicasts it into both.
__global__ void __launch_bounds__(kWgThreads + 32, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_wg,
                 const __grid_constant__ CUtensorMap tm_wu,
                 const __grid_constant__ CUtensorMap tm_wd, float* __restrict__ acc_out,
                 int rows, int d, int f) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages], empty_bar[kStages];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sHhi = base, sHlo = base + kHBytes, sRing = base + 2 * kHBytes;

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / 2, n_clusters = gridDim.x / 2;
  const Walk walk{d, f, ((rows + kBM - 1) / kBM + 1) / 2, (f + kFC - 1) / kFC};
  auto full = [&](int st) { return smem_addr(&full_bar[st]); };
  auto empty = [&](int st) { return smem_addr(&empty_bar[st]); };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);                  // the local producer's expect_tx
      mbar_init(empty(st), 4);                 // 2 warpgroups x 2 blocks
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (tid >= kWgThreads) {
    // ---- producer warp: one lane issues every copy ---------------------------
    if (tid == kWgThreads) {
      int step = 0;
      auto acquire = [&](int bytes) {
        const int st = step % kStages;
        mbar_wait(empty(st), ((step / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), bytes);
        return st;
      };
      for (int u = cluster; u < walk.n_units(); u += n_clusters) {
        const int2 pc = walk.unit(u);
        const int ch = pc.y, fc0 = ch * kFC, row0 = (2 * pc.x + rank) * kBM;
        for (int ft = 0; ft < walk.n_ft(ch); ++ft) {
          const int f0 = fc0 + ft * kFT;
          const CUtensorMap* w = rank == 0 ? &tm_wg : &tm_wu;   // this block's half
          const uint32_t w_off = kXBytes + rank * kWBytes;
          for (int k = 0; k < walk.nk(); ++k, ++step) {
            const int st = acquire(kStageABytes);
            const uint32_t dst = sRing + st * kStageBytes;
            tma_load(dst, &tm_x, k * kBK, row0, full(st));
            tma_load_multicast(dst + w_off, w, f0, k * kBK, full(st), 3);
            tma_load_multicast(dst + w_off + kWBlock, w, f0 + 64, k * kBK, full(st), 3);
          }
        }
        const int nkb = walk.n_ft(ch) * kFT / kBF;
        for (int dt = 0; dt < walk.n_dt(); ++dt) {
          for (int kb = 0; kb < nkb; ++kb, ++step) {
            const int st = acquire(kStageBBytes);
            const uint32_t dst = sRing + st * kStageBytes;
            for (int b = 3 * rank; b < 3 * rank + 3; ++b) {   // this block's half:
              const int cb = b >> 1, rh = b & 1;              // 32 rows of a 64-column block
              tma_load_multicast(dst + cb * kDBlock + rh * (kDBlock / 2), &tm_wd,
                                 dt * kDN + cb * 64, fc0 + kb * kBF + rh * (kBF / 2), full(st), 3);
            }
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups -------------------------------------------
    const int wgi = tid >> 7;                        // rows 64 wgi .. 64 wgi + 63
    const int wtid = tid & 127;
    const int r_lo = ((wtid >> 5) << 4) + ((wtid & 31) >> 2);   // rows r_lo, r_lo + 8
    const int c0 = 2 * (tid & 3);                     // columns 8 j + c0, + 1
    int step = 0, held = -1;                          // the stage still being read
    auto wait_full = [&]() {
      const int st = step % kStages;
      mbar_wait(full(st), (step / kStages) & 1);
      return sRing + st * kStageBytes;
    };
    // the warpgroup is done with stage `st`: tell both blocks' producers
    auto release = [&](int st) {
      if (st >= 0 && wtid == 0) {
        mbar_arrive_cluster(empty(st), 0);
        mbar_arrive_cluster(empty(st), 1);
      }
    };
    // gu: gate in columns 0..127, up in 128..255 (wg and wu tiles lie side by
    // side in a stage, so one n256 product reads x once for both)
    float gu[kFT], o[kDN / 2];

    for (int u = cluster; u < walk.n_units(); u += n_clusters) {
      const int2 pc = walk.unit(u);
      const int ch = pc.y, row0 = (2 * pc.x + rank) * kBM;
      // ---- (A) gate and up, h into shared memory ----------------------------
      for (int ft = 0; ft < walk.n_ft(ch); ++ft) {
#pragma unroll
        for (int i = 0; i < kFT; ++i) gu[i] = 0.f;   // (gu dead in between)
        for (int k = 0; k < walk.nk(); ++k, ++step) {
          const uint32_t st = wait_full();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            wgmma_m64n256(gu, desc(st + wgi * 64 * 64 + kk * 32, 16, 512, 2),
                          desc(st + kXBytes + kk * 16 * 128, kWBlock, 1024, 1));
          }
          wgmma_commit();
          wgmma_wait<1>();
          release(held);
          held = step % kStages;
        }
        wgmma_wait<0>();
        release(held);
        held = -1;
        pin(gu);
        // h in f32, as bf16 hi + lo: h ~= hi + lo to about 2^-17
#pragma unroll
        for (int j = 0; j < kFT / 8; ++j) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float h0 = silu_mul(gu[4 * j + 2 * hr], gu[kFT / 2 + 4 * j + 2 * hr]);
            const float h1 = silu_mul(gu[4 * j + 2 * hr + 1], gu[kFT / 2 + 4 * j + 2 * hr + 1]);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(h0 - __low2float(hi),
                                                            h1 - __high2float(hi));
            const int col = ft * kFT + 8 * j + c0;     // f column within the chunk
            const int row = wgi * 64 + r_lo + 8 * hr;
            const uint32_t off = swz128((col >> 6) * kHBlock + row * 128 + (col & 63) * 2);
            asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(sHhi + off),
                         "r"(*reinterpret_cast<const uint32_t*>(&hi)) : "memory");
            asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(sHlo + off),
                         "r"(*reinterpret_cast<const uint32_t*>(&lo)) : "memory");
          }
        }
      }
      // each warpgroup reads back only the 64 rows of h it wrote
      fence_proxy_async();
      wg_sync(wgi);

      // ---- (B) h times wd's rows of the chunk, kDN columns at a time ----------
      const int nkb = walk.n_ft(ch) * kFT / kBF;
      for (int dt = 0; dt < walk.n_dt(); ++dt) {
#pragma unroll
        for (int i = 0; i < kDN / 2; ++i) o[i] = 0.f;
        for (int kb = 0; kb < nkb; ++kb, ++step) {
          const uint32_t st = wait_full();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBF / 16; ++kk) {
            const int fk = kb * (kBF / 16) + kk;      // k16 step of h within the chunk
            const uint32_t ha = (fk >> 2) * kHBlock + wgi * 64 * 128 + (fk & 3) * 32;
            const uint64_t db = desc(st + kk * 16 * 128, kDBlock, 1024, 1);
            wgmma_m64n192(o, desc(sHhi + ha, 16, 1024, 1), db);
            wgmma_m64n192(o, desc(sHlo + ha, 16, 1024, 1), db);
          }
          wgmma_commit();
          wgmma_wait<1>();
          release(held);
          held = step % kStages;
        }
        // the d tile is summed: add it into the workspace
        wgmma_wait<0>();
        release(held);
        held = -1;
        pin(o);
        const int n0 = dt * kDN;
#pragma unroll
        for (int j = 0; j < kDN / 8; ++j) {
          const int col = n0 + 8 * j + c0;
          if (col >= d) continue;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = row0 + wgi * 64 + r_lo + 8 * hr;
            if (row < rows) {
              atomicAdd(reinterpret_cast<float2*>(acc_out + (size_t)row * d + col),
                        make_float2(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]));
            }
          }
        }
      }
      wg_sync(wgi);                                   // h is read: the next chunk may write it
    }
  }
  cluster_sync();      // no block leaves while its partner may still copy or arrive into it
}

__global__ void cast_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                 size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

// A TMA descriptor of a row-major bf16 matrix (outer x inner, leading
// dimension ld elements) read in boxes of box_outer x box_inner, zeros
// past its edges.  cuTensorMapEncodeTiled is looked up at first use.
bool bf16_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer, uint64_t ld,
              uint32_t box_inner, uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return false;
    }
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
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
    if (f % kFT != 0 || workspace == nullptr) return (int)cudaErrorInvalidValue;
    static const cudaError_t smem_ok = cudaFuncSetAttribute(
        ffn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
    if (smem_ok != cudaSuccess) return (int)smem_ok;
    static int n_sm = 0;
    if (n_sm == 0) {
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
    }
    CUtensorMap tm_x, tm_wg, tm_wu, tm_wd;
    cudaError_t err = cudaErrorInvalidValue;
    if (!bf16_map(&tm_x, x, d, rows, ldx, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_64B) ||
        !bf16_map(&tm_wg, wg, f, d, ldwg, 64, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !bf16_map(&tm_wu, wu, f, d, ldwu, 64, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !bf16_map(&tm_wd, wd, d, f, d, 64, kBF / 2, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return (int)err;
    }
    float* acc = static_cast<float*>(workspace);
    const size_t n = (size_t)rows * d;
    err = cudaMemsetAsync(acc, 0, n * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
    // clusters of two row tiles, one block an SM, each cluster walking every
    // n_clusters-th unit of (pair of row tiles, f chunk)
    const int n_units = ((rows + kBM - 1) / kBM + 1) / 2 * ((f + kFC - 1) / kFC);
    const int n_clusters = std::max(1, std::min(n_sm / 2, n_units));
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * n_clusters);
    cfg.blockDim = dim3(kWgThreads + 32);
    cfg.dynamicSmemBytes = kWgSmemBytes;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 2;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, ffn_wgmma_kernel, tm_x, tm_wg, tm_wu, tm_wd, acc, rows, d, f);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    cast_bf16_kernel<<<blocks, 256, 0, st>>>(acc, static_cast<__nv_bfloat16*>(out), n);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
