// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel _ssd_kernel of src/repro/kernels/ssd_scan.py
// (pallas_call at :78, wrapper ssd_scan at :58).  For x (b, s, h, p),
// dt (b, s, h) f32 after softplus, A (h,) f32 < 0 and B, C (b, s, n), per
// (b, h) and for the chunks of Q rows in order:
//   a_cum  = cumsum(A * dt)                                   (Q,)
//   S[i,j] = (C_i . B_j) * exp(a_cum[i] - a_cum[j]) * dt[j]    for j <= i, else 0
//   y      = S x + exp(a_cum) * (C state^T)                    (Q, p)
//   state  = exp(a_end) * state + (x * w)^T B,  w[j] = dt[j] exp(a_end - a_cum[j])
// f32 inside, y in x's type, and the final f32 (p, n) state written once at
// the end (the Pallas kernel carries it in VMEM scratch and drops it; the
// SSM block returns it).  The Q x Q score tile never reaches device memory:
// that is the property the Pallas kernel exists for.
//
// What bounds it on an H100 SXM (published peaks at its 700 W limit), at
// mamba2-1.3b's shape (b 1, s 8192, h 64, p 64, n 128, Q 128), per launch:
// 4,096 (h, chunk) pairs x (2Q^2 n + 2Q^2 p + 4Q n p) = 42.9 GFLOP, 0.043 ms
// at 989 TFLOP/s; x and y in bf16 (67.1 MB each), dt in f32 (2.1 MB), B and
// C in bf16 (2.1 MB each), the state (2.1 MB): about 143 MB, 0.043 ms at
// 3.35 TB/s.  C B^T is the same for every head (one B and one C a sequence),
// so 17.2 of those GFLOP are per-head recompute: a lever for a later PR.
//
// Where Hopper differs from the TPU.  The Pallas grid (b, h, chunk) runs in
// order on one core and carries the state in scratch from one chunk to the
// next.  Here a thread block walks the chunks of one (b, h) in a loop with
// the state on chip throughout; blocks run in parallel over (b, h).  Two
// kernels, routed by dtype in ssd_scan_fwd:
//
// ssd_scan_mma_kernel (bf16 x, B, C; the SSM block's path).  Run on bf16,
// the CUDA-core kernel below took 4.05 ms at mamba2's shape on an H100
// (1.1% of the bound): 64 blocks for 132 SMs, every product an f32 FMA,
// and each chunk's loads synchronous.  This design:
// * Tensor cores, mma.sync m16n8k16 bf16 with f32 accumulators (HMMA).
//   wgmma wants 64-row tiles per warpgroup; here each warp owns one 16-row
//   tile of the chunk, so the causal S x product skips the blocks above
//   the diagonal 16 x 16 block by block, and the score block goes from the
//   C B^T accumulator straight into the A operand of S x in registers.
//   The four products: C B^T (bf16 operands, exact); S x with
//   S = C B^T o L o dt in f32 entering as bf16 hi + lo (two products,
//   S ~= hi + lo to about 2^-16 |S|); C state^T with the f32 state as
//   hi + lo; and the state update (x o w)^T B with x o w as hi + lo.  A
//   bf16 operand alone would put a relative error of 2^-9 on each term,
//   the size of y's own bf16 rounding; hi + lo keeps the f32 sum far below
//   half a unit of it.  L is 2^x on the special-function unit (see
//   s_block); exp(a_cum), w and exp(a_end), which reach the f32 state, use
//   expf.
// * The state stays in f32 registers: warp w owns state rows 16 (w / 4)
//   .. +15 (of the block's p columns) and state columns 32 (w % 4) .. +31.
//   Each chunk scales it by exp(a_end) and accumulates (x o w)^T B into it
//   on the tensor cores, then writes it to shared memory once as hi + lo
//   for the next chunk's C state^T.  Nothing is staged in device memory:
//   no workspace grows with s.
// * Loads overlap compute: one thread asks the Tensor Memory Accelerator
//   for chunk c + 1's C and B (boxes of q rows x 64 columns, 128-byte
//   swizzle) and x (q x 32, 64-byte swizzle) into the other of two stages,
//   completing on that stage's mbarrier, while chunk c computes; dt comes
//   by cp.async.  TMA reads x, B and C in place through their strides
//   (16-byte aligned, which the wrapper checks) and writes zeros past s,
//   n and p, so a ragged last chunk needs no code.  Copies issued per
//   thread (cp.async, 18 a thread a chunk) stalled the issuing warps, and
//   bulk copies of single rows (384 a chunk) kept one warp issuing for
//   longer than the chunk computed; five boxes a chunk cost one thread
//   five instructions.
// * The card is filled by splitting each head's p columns over blocks of
//   32 (grid h x ceil(p / 32) x b: 128 blocks at mamba2's b 1).  Each block
//   recomputes its head's C B^T (as the flops() count says) rather than
//   sharing it across a cluster: it needs no cross-block synchronisation.
// * Balance: the causal S x work of the 16-row tile m is its 16-column
//   blocks 0..m.  Warp w owns tile w; for the tiles 4..7 the owner does
//   blocks 0..3 and warp 7 - m the rest (its partial y is added in through
//   shared memory), so no warp does more than 5 of the 36 blocks.  C B^T's
//   two k halves, and the hi and lo products, accumulate in separate
//   registers so that the dependent chains of mma are short.
// * Shared memory 198,656 B with the alignment slack (one block an SM): two
//   stages (C and B 32 KB each, x 8 KB, dt), the state and x o w as hi + lo
//   (rows padded by 16 bytes so that ldmatrix's eight rows fall in distinct
//   banks), a_cum in two bases, exp(a_cum), w and the helpers' partial y.
//
// ssd_scan_kernel<float> (f32 inputs, kept as it was for the f32 limit,
// which bf16 or TF32 products would not hold): one block per (h, b) walks
// its chunks with the state in shared memory:
// * 256 threads, CUDA-core f32 FMAs on register tiles (each thread 8 x 8
//   outputs of S, 8 x 4 of y, 4 x 8 of the state update; its rows are
//   tr + 16 a and its columns tc + 16 b, so a warp reads two rows of the
//   left operand (broadcast) and 16 consecutive columns of the right one).
// * Shared memory (201,472 B of the 232,448 a block may opt into): B as
//   Q x (n + 1) floats, C and later S in one Q x 132 buffer (S is written
//   over C once every product that reads C is done), x as Q x p, the state
//   as p x (n + 1), and dt, a_cum, exp(a_cum) and w.  The odd and padded row
//   strides keep the transposed reads free of bank conflicts.  All five f32
//   tiles of 128 x 128 would be 256 KB: reusing the C buffer for S is what
//   makes it fit.
// * Overflow: exp(a_cum[i] - a_cum[j]) is computed only where j <= i; for
//   j > i the exponent is positive and can overflow to inf, and inf * 0 is
//   NaN, so a multiply by a 0/1 mask would not do.
// * Fixed tiles of Q <= 128, p <= 64, n <= 128 rows and columns; smaller
//   shapes (the reduced configs' 16) and the rows past the end of a ragged
//   last chunk are loaded as zeros with dt = 0, which are identities for
//   the state, exactly the dt = 0 padding of the plain version.  Rows past
//   the end are never stored.
// * x, B and C are read in place through their strides (unit stride in the
//   last dim): in the SSM block they are column slices of the conv output,
//   whose row stride is d_inner + 2n.
// * Occupancy: at b 1 the grid is h = 64 blocks for 132 SMs, one block an
//   SM (the shared memory admits one), 8 warps each.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;                 // max rows a chunk
constexpr int kP = 64;                  // max head dim
constexpr int kN = 128;                 // max state dim
constexpr int kLdB = kN + 1;            // B tile row stride (floats)
constexpr int kLdCS = 132;              // C / S tile row stride
constexpr int kLdSt = kN + 1;           // state row stride
constexpr int kSmemFloats = kQ * kLdB + kQ * kLdCS + kQ * kP + kP * kLdSt + 4 * kQ;
constexpr int kSmemBytes = kSmemFloats * 4;

// the CUDA-core kernel is instantiated for f32 only (bf16 runs
// ssd_scan_mma_kernel)
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state,
                int s, int h, int p, int n, int q,
                long long xs_b, long long xs_s, long long xs_h,
                long long dts_b, long long dts_s, long long dts_h,
                long long bs_b, long long bs_s, long long cs_b, long long cs_s) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                       // (kQ, kLdB): B[j][n]
  float* CS = Bs + kQ * kLdB;             // (kQ, kLdCS): C[i][n], then S[i][j]
  float* Xs = CS + kQ * kLdCS;            // (kQ, kP): x[j][p]
  float* St = Xs + kQ * kP;               // (kP, kLdSt): state[p][n]
  float* dts = St + kP * kLdSt;           // (kQ,)
  float* acum = dts + kQ;                 // (kQ,)
  float* ea = acum + kQ;                  // exp(a_cum)
  float* wv = ea + kQ;                    // dt * exp(a_end - a_cum)

  const int hi = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const float Ah = A[hi];

  for (int e = tid; e < kP * kLdSt; e += kThreads) St[e] = 0.f;

  const T* xb = x + bi * xs_b + hi * xs_h;
  const float* dtb = dt + bi * dts_b + hi * dts_h;
  const T* Bb = Bm + bi * bs_b;
  const T* Cb = Cm + bi * cs_b;
  const int n_chunks = (s + q - 1) / q;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * q;
    // ---- stage the chunk; rows past q or s and columns past n or p are 0
    for (int e = tid; e < kQ * kN; e += kThreads) {
      const int r = e / kN, col = e % kN;
      const bool ok = r < q && t0 + r < s && col < n;
      const long long t = t0 + r;
      Bs[r * kLdB + col] = ok ? to_f(Bb[t * bs_s + col]) : 0.f;
      CS[r * kLdCS + col] = ok ? to_f(Cb[t * cs_s + col]) : 0.f;
    }
    for (int e = tid; e < kQ * kP; e += kThreads) {
      const int r = e / kP, col = e % kP;
      const bool ok = r < q && t0 + r < s && col < p;
      Xs[e] = ok ? to_f(xb[(long long)(t0 + r) * xs_s + col]) : 0.f;
    }
    if (tid < kQ) {
      const bool ok = tid < q && t0 + tid < s;
      dts[tid] = ok ? dtb[(long long)(t0 + tid) * dts_s] : 0.f;
    }
    __syncthreads();

    // ---- a_cum: warp 0, 4 rows a lane, then a shuffle scan of lane sums
    if (tid < 32) {
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += Ah * dts[tid * 4 + k];
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acum[tid * 4 + k] = v[k] + excl;
    }
    __syncthreads();
    const float a_end = acum[kQ - 1];     // rows past the end add a = 0
    if (tid < kQ) {
      ea[tid] = expf(acum[tid]);
      wv[tid] = dts[tid] * expf(a_end - acum[tid]);
    }
    __syncthreads();

    // ---- y = exp(a_cum) * (C state^T): rows tr + 16a, head dims tc + 16b
    float accy[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) accy[a][b] = 0.f;
    for (int k = 0; k < kN; ++k) {
      float ar[8], br[4];
#pragma unroll
      for (int a = 0; a < 8; ++a) ar[a] = CS[(tr + 16 * a) * kLdCS + k];
#pragma unroll
      for (int b = 0; b < 4; ++b) br[b] = St[(tc + 16 * b) * kLdSt + k];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) accy[a][b] += ar[a] * br[b];
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float e = ea[tr + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) accy[a][b] *= e;
    }

    // ---- S = (C B^T) * L * dt: rows tr + 16a, columns tc + 16b
    float accs[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) accs[a][b] = 0.f;
    for (int k = 0; k < kN; ++k) {
      float ar[8], br[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) ar[a] = CS[(tr + 16 * a) * kLdCS + k];
#pragma unroll
      for (int b = 0; b < 8; ++b) br[b] = Bs[(tc + 16 * b) * kLdB + k];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) accs[a][b] += ar[a] * br[b];
    }
    __syncthreads();                      // every read of C (and the state) is done
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = tr + 16 * a;
      const float ai = acum[i];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int j = tc + 16 * b;
        // the exponent is computed only where it is <= 0 (no overflow)
        CS[i * kLdCS + j] = j <= i ? accs[a][b] * expf(ai - acum[j]) * dts[j] : 0.f;
      }
    }
    __syncthreads();

    // ---- y += S x, then store the chunk's real rows
    for (int k = 0; k < kQ; ++k) {
      float ar[8], br[4];
#pragma unroll
      for (int a = 0; a < 8; ++a) ar[a] = CS[(tr + 16 * a) * kLdCS + k];
#pragma unroll
      for (int b = 0; b < 4; ++b) br[b] = Xs[k * kP + tc + 16 * b];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) accy[a][b] += ar[a] * br[b];
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = tr + 16 * a;
      if (i < q && t0 + i < s) {
        T* yrow = y + (((long long)bi * s + t0 + i) * h + hi) * p;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = tc + 16 * b;
          if (col < p) yrow[col] = from_f<T>(accy[a][b]);
        }
      }
    }

    // ---- state = exp(a_end) state + (x w)^T B: head dims tr + 16a, state tc + 16b
    float acct[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acct[a][b] = 0.f;
    for (int k = 0; k < kQ; ++k) {
      const float w = wv[k];
      float ar[4], br[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) ar[a] = Xs[k * kP + tr + 16 * a] * w;
#pragma unroll
      for (int b = 0; b < 8; ++b) br[b] = Bs[k * kLdB + tc + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acct[a][b] += ar[a] * br[b];
    }
    const float e_end = expf(a_end);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        float* sp = St + (tr + 16 * a) * kLdSt + tc + 16 * b;
        *sp = e_end * *sp + acct[a][b];
      }
    __syncthreads();                      // before the next chunk overwrites the tiles
  }

  float* stb = state + ((long long)bi * h + hi) * p * n;
  for (int e = tid; e < p * n; e += kThreads) stb[e] = St[(e / n) * kLdSt + e % n];
}

// ---------------------------------------------------------------------------
// bf16 kernel on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kPB = 32;                 // head-dim columns a block takes
constexpr int kLdS = kN + 8;            // state tile row stride (bf16, padded)
constexpr int kLdX = kPB + 8;           // x o w tile row stride (bf16, padded)
// a stage, each tile at a 1024-byte boundary (TMA's 128-byte swizzle):
// C and B as two boxes of kQ rows x 64 columns each, x as kQ x kPB, dt
constexpr int kHalf = kQ * 64 * 2;      // one 64-column box of C or B
constexpr int kOffB = 2 * kHalf, kOffX = 4 * kHalf, kOffDt = kOffX + kQ * kPB * 2;
constexpr int kStageBytes = (kOffDt + kQ * 4 + 1023) / 1024 * 1024;
constexpr int kMmaSmemBytes = 1024                  // room to align the base
                              + 2 * kStageBytes     // C, B, x, dt: two stages
                              + 2 * kPB * kLdS * 2  // the state as hi + lo
                              + 2 * kQ * kLdX * 2   // x o w as hi + lo
                              + 4 * kQ * 4          // a_cum, a_cum log2(e), exp(a_cum), w
                              + 4 * 16 * 32 * 4;    // the helpers' partial y

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
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
// one TMA box of a 3D (C, B) or 4D (x) tensor map into shared memory,
// completing on the mbarrier at `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3, %4}], [%5];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
                  "r"(bar)
               : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
                  "r"(c3), "r"(bar)
               : "memory");
}
// 2^x on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d += a b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), bf16; d f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two f32 values (columns c, c + 1 of one row) as bf16 hi + lo pairs,
// a ~= hi + lo to about 2^-16 |a|
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// Shared-memory byte addresses of element (r, c) of a bf16 tile, c a
// multiple of 8 (a 16-byte piece):
// * Sw128: C or B as TMA writes them with the 128-byte swizzle, two boxes of
//   kQ rows x 64 columns; piece c / 8 of a row sits at piece (c / 8) ^ (r % 8)
//   of its 128 bytes, so ldmatrix's eight rows fall in distinct banks;
// * Sw64: x as TMA writes it with the 64-byte swizzle, kQ rows x 32 columns;
// * Padded: a tile with row stride ld (the state and x o w).
struct Sw128 {
  uint32_t base;
  __device__ __forceinline__ uint32_t operator()(int r, int c) const {
    return base + ((c >> 6) * kHalf) + (r << 7) + ((((c & 63) >> 3) ^ (r & 7)) << 4);
  }
};
struct Sw64 {
  uint32_t base;
  __device__ __forceinline__ uint32_t operator()(int r, int c) const {
    return base + (r << 6) + (((c >> 3) ^ ((r >> 1) & 3)) << 4);
  }
};
struct Padded {
  uint32_t base;
  int ld;
  __device__ __forceinline__ uint32_t operator()(int r, int c) const {
    return base + 2 * (r * ld + c);
  }
};

// ldmatrix lane addresses (lane l) of the 16 x 16 block at (row0, col0):
// * a_rows: the A operand of a 16-row tile (rows = m, columns = k);
// * b_rows: the B operands of two n8 tiles stored n-major (rows = n,
//   columns = k): registers 0, 1 are tile n0's, 2, 3 tile n0 + 8's;
// * b_cols (with .trans): the B operands of two n8 tiles stored k-major
//   (rows = k, columns = n), the same register order;
// * a_cols (with .trans): the A operand stored k-major (rows = k, columns = m).
template <class L>
__device__ __forceinline__ uint32_t a_rows(L t, int row0, int col0, int l) {
  return t(row0 + (l & 7) + 8 * ((l >> 3) & 1), col0 + 8 * (l >> 4));
}
template <class L>
__device__ __forceinline__ uint32_t b_rows(L t, int row0, int col0, int l) {
  return t(row0 + (l & 7) + 8 * (l >> 4), col0 + 8 * ((l >> 3) & 1));
}
template <class L>
__device__ __forceinline__ uint32_t b_cols(L t, int row0, int col0, int l) {
  return t(row0 + (l & 7) + 8 * ((l >> 3) & 1), col0 + 8 * (l >> 4));
}
template <class L>
__device__ __forceinline__ uint32_t a_cols(L t, int row0, int col0, int l) {
  return t(row0 + (l & 7) + 8 * (l >> 4), col0 + 8 * ((l >> 3) & 1));
}

// y (a 16-row tile mt by 32 head dims, f32 accumulators) += S x over the
// 16-column block kb, S = (C B^T) o L o dt computed here from the tile's C
// rows (cf, A operands) and the block's B rows.  S enters the product as
// bf16 hi + lo.  L = 2^(a_cum2[i] - a_cum2[j]) with a_cum2 = a_cum log2(e),
// computed only where j <= i (where the exponent is <= 0, no overflow); its
// relative error, about 2^-22 plus the rounding of a_cum2 (2^-24 |a_cum2|),
// stays far below half a unit of y's bf16.  The two k halves of C B^T
// accumulate apart.
__device__ __forceinline__ void s_block(float (&yacc)[4][4], const uint32_t (&cf)[8][4],
                                        Sw128 bt, Sw64 xt, const float* acum2,
                                        const float* dts, int mt, int kb, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  float sa[2][4], sb[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sa[a][b] = sb[a][b] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ks += 2) {
    uint32_t r[4], u[4];
    ldsm_x4(r, b_rows(bt, kb * 16, ks * 16, lane));
    ldsm_x4(u, b_rows(bt, kb * 16, ks * 16 + 16, lane));
    mma(sa[0], cf[ks], r[0], r[1]);
    mma(sa[1], cf[ks], r[2], r[3]);
    mma(sb[0], cf[ks + 1], u[0], u[1]);
    mma(sb[1], cf[ks + 1], u[2], u[3]);
  }
  const int i0 = mt * 16 + g;
  const float ai0 = acum2[i0], ai1 = acum2[i0 + 8];
  uint32_t ah[4], al[4];
#pragma unroll
  for (int jt = 0; jt < 2; ++jt) {
    const int j = kb * 16 + jt * 8 + 2 * t4;
    const float aj0 = acum2[j], aj1 = acum2[j + 1], d0 = dts[j], d1 = dts[j + 1];
    const float c00 = sa[jt][0] + sb[jt][0], c01 = sa[jt][1] + sb[jt][1];
    const float c10 = sa[jt][2] + sb[jt][2], c11 = sa[jt][3] + sb[jt][3];
    const float s00 = j <= i0 ? c00 * exp2_approx(ai0 - aj0) * d0 : 0.f;
    const float s01 = j + 1 <= i0 ? c01 * exp2_approx(ai0 - aj1) * d1 : 0.f;
    const float s10 = j <= i0 + 8 ? c10 * exp2_approx(ai1 - aj0) * d0 : 0.f;
    const float s11 = j + 1 <= i0 + 8 ? c11 * exp2_approx(ai1 - aj1) * d1 : 0.f;
    split2(s00, s01, ah[2 * jt], al[2 * jt]);           // row i0
    split2(s10, s11, ah[2 * jt + 1], al[2 * jt + 1]);   // row i0 + 8
  }
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t r[4];
    ldsm_x4_t(r, b_cols(xt, kb * 16, np * 16, lane));
    mma(yacc[2 * np], ah, r[0], r[1]);
    mma(yacc[2 * np + 1], ah, r[2], r[3]);
    mma(yacc[2 * np], al, r[0], r[1]);
    mma(yacc[2 * np + 1], al, r[2], r[3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_mma_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ dt,
                    const float* __restrict__ A, __nv_bfloat16* __restrict__ y,
                    float* __restrict__ state, int s, int h, int p, int n, int q, int n_split,
                    long long dts_b, long long dts_s, long long dts_h) {
  extern __shared__ unsigned char smem_dyn[];
  __shared__ __align__(8) uint64_t full[2];
  unsigned char* smem_raw = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  unsigned char* stage_base = smem_raw;                    // two stages
  __nv_bfloat16* st_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * kStageBytes);
  __nv_bfloat16* st_lo = st_hi + kPB * kLdS;               // state[p][n], hi and lo
  __nv_bfloat16* xw_hi = st_lo + kPB * kLdS;               // (x o w)[j][p], hi and lo
  __nv_bfloat16* xw_lo = xw_hi + kQ * kLdX;
  float* acum = reinterpret_cast<float*>(xw_lo + kQ * kLdX);
  float* acum2 = acum + kQ;                                // a_cum log2(e)
  float* ea = acum2 + kQ;                                  // exp(a_cum)
  float* wv = ea + kQ;                                     // dt exp(a_end - a_cum)
  float* part = wv + kQ;                                   // (4 helpers, 16, 32 lanes)

  const int hi = blockIdx.x / n_split;
  const int p0 = (blockIdx.x % n_split) * kPB;             // this block's head dims
  const int bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float Ah = A[hi];
  const float* dtb = dt + bi * dts_b + hi * dts_h;
  const int n_chunks = (s + q - 1) / q;

  // One chunk's C, B, x and dt into stage k.  Thread 0 asks TMA for five
  // boxes of q rows (C and B in two 64-column halves, x), completing on the
  // stage's mbarrier; TMA writes zeros past s, n and p, and rows past q
  // are never written (the zeros of the start).  Threads 0..127 copy dt,
  // 0 past q and s.
  const int halves = n > 64 ? 2 : 1;
  auto load_chunk = [&](int c, int k) {
    unsigned char* st = stage_base + k * kStageBytes;
    const uint32_t base = smem_addr(st);
    const int t0 = c * q;
    if (tid == 0) {
      const uint32_t bar = smem_addr(&full[k]);
      // the stage's last reads (chunk c - 2, generic proxy) come before
      // TMA's writes (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, q * (halves * 2 * 64 * 2 + kPB * 2));
      for (int hf = 0; hf < halves; ++hf) {
        tma_load_3d(base + hf * kHalf, &tm_c, hf * 64, t0, bi, bar);
        tma_load_3d(base + kOffB + hf * kHalf, &tm_b, hf * 64, t0, bi, bar);
      }
      tma_load_4d(base + kOffX, &tm_x, p0, hi, t0, bi, bar);
    }
    if (tid < kQ) {
      const bool ok = tid < q && t0 + tid < s;
      cp_async_4(base + kOffDt + 4 * tid, dtb + (ok ? (long long)(t0 + tid) * dts_s : 0),
                 ok ? 4 : 0);
    }
    cp_async_commit();
  };

  // zeros in both stages and the state, the stages' barriers
  for (int e = tid; e < (2 * kStageBytes + 2 * kPB * kLdS * 2) / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem_raw)[e] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the zeros (generic proxy) are in before TMA (async proxy) writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // warp w owns the chunk's 16-row tile w; the causal S x work of tile m
  // is its 16-column blocks kb <= m, so the owners of tiles 4..7 do blocks
  // 0..3 and warp 7 - m does blocks 4..m of tile m (its partial y meets
  // the owner's through shared memory): at most 5 blocks a warp.  Warp w's
  // tile of the state: rows 16 (w / 4) .. +15, columns 32 (w % 4) .. +31.
  const int mt = warp, helped = 7 - warp;   // helped: the tile warp w < 4 helps
  const int pm = warp >> 2, ng = warp & 3;
  float stacc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) stacc[a][b] = 0.f;
  const Padded sth{smem_addr(st_hi), kLdS}, stl{smem_addr(st_lo), kLdS};
  const Padded xwh{smem_addr(xw_hi), kLdX}, xwl{smem_addr(xw_lo), kLdX};

  load_chunk(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    mbar_wait(smem_addr(&full[c & 1]), (c >> 1) & 1);
    __syncthreads();   // chunk c has landed; chunk c - 1 is done with the other stage
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) & 1);
    unsigned char* st = stage_base + (c & 1) * kStageBytes;
    const uint32_t base = smem_addr(st);
    const Sw128 ct{base}, bt{base + kOffB};
    const Sw64 xt{base + kOffX};
    const float* dts = reinterpret_cast<const float*>(st + kOffDt);
    const int t0 = c * q;

    // ---- a_cum: warp 0, 4 rows a lane, then a shuffle scan of lane sums
    if (warp == 0) {
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += Ah * dts[lane * 4 + k];
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float a_end = __shfl_sync(0xffffffffu, incl, 31);   // rows past the end add 0
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = lane * 4 + k;
        const float ac = v[k] + excl;
        acum[r] = ac;
        acum2[r] = ac * 1.4426950408889634f;
        ea[r] = expf(ac);
        wv[r] = dts[r] * expf(a_end - ac);
      }
    }

    // ---- y = C state^T (the carried state as hi + lo) while warp 0 scans
    uint32_t cf[8][4];                       // this warp's C rows as A operands
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) ldsm_x4(cf[ks], a_rows(ct, mt * 16, ks * 16, lane));
    float yacc[4][4], ylo[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) yacc[a][b] = ylo[a][b] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, b_rows(sth, np * 16, ks * 16, lane));
        mma(yacc[2 * np], cf[ks], r[0], r[1]);
        mma(yacc[2 * np + 1], cf[ks], r[2], r[3]);
        ldsm_x4(r, b_rows(stl, np * 16, ks * 16, lane));
        mma(ylo[2 * np], cf[ks], r[0], r[1]);
        mma(ylo[2 * np + 1], cf[ks], r[2], r[3]);
      }
    }
    __syncthreads();   // a_cum, exp(a_cum) and w are in
    {
      const float e0 = ea[mt * 16 + g], e1 = ea[mt * 16 + g + 8];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        yacc[a][0] = (yacc[a][0] + ylo[a][0]) * e0;
        yacc[a][1] = (yacc[a][1] + ylo[a][1]) * e0;
        yacc[a][2] = (yacc[a][2] + ylo[a][2]) * e1;
        yacc[a][3] = (yacc[a][3] + ylo[a][3]) * e1;
      }
    }
    // x o w as hi + lo for the state update (read after the next barrier)
    for (int e = tid; e < kQ * kPB / 2; e += kThreads) {
      const int r = e / (kPB / 2), col = (e % (kPB / 2)) * 2;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          st + (xt(r, col & ~7) - base) + 2 * (col & 7)));
      uint32_t h2, l2;
      split2(xv.x * wv[r], xv.y * wv[r], h2, l2);
      *reinterpret_cast<uint32_t*>(xw_hi + r * kLdX + col) = h2;
      *reinterpret_cast<uint32_t*>(xw_lo + r * kLdX + col) = l2;
    }

    // ---- y += S x, S = (C B^T) o L o dt, over this warp's column blocks
    const int own_end = mt < 4 ? mt : 3;
    for (int kb = 0; kb <= own_end; ++kb) s_block(yacc, cf, bt, xt, acum2, dts, mt, kb, lane);
    if (warp < 4) {                           // blocks 4..helped of tile `helped`
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) ldsm_x4(cf[ks], a_rows(ct, helped * 16, ks * 16, lane));
      float hacc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) hacc[a][b] = 0.f;
      for (int kb = 4; kb <= helped; ++kb) s_block(hacc, cf, bt, xt, acum2, dts, helped, kb, lane);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) part[(warp * 16 + a * 4 + b) * 32 + lane] = hacc[a][b];
    }
    __syncthreads();   // x o w and the helpers' partial y are in; the old state is read
    if (warp >= 4) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) yacc[a][b] += part[((7 - warp) * 16 + a * 4 + b) * 32 + lane];
    }
    // ---- store the chunk's real rows
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = mt * 16 + g + 8 * half;
      if (i < q && t0 + i < s) {
        __nv_bfloat16* yrow = y + (((long long)bi * s + t0 + i) * h + hi) * p + p0;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int col = a * 8 + 2 * t4;
          if (p0 + col < p)
            *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
                __floats2bfloat162_rn(yacc[a][2 * half], yacc[a][2 * half + 1]);
        }
      }
    }

    // ---- state = exp(a_end) state + (x o w)^T B, in this warp's registers
    const float e_end = expf(acum[kQ - 1]);
    float slo[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        stacc[a][b] *= e_end;
        slo[a][b] = 0.f;
      }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t ah[4], al[4];
      ldsm_x4_t(ah, a_cols(xwh, ks * 16, pm * 16, lane));
      ldsm_x4_t(al, a_cols(xwl, ks * 16, pm * 16, lane));
#pragma unroll
      for (int nq = 0; nq < 2; ++nq) {
        uint32_t r[4];
        ldsm_x4_t(r, b_cols(bt, ks * 16, ng * 32 + nq * 16, lane));
        mma(stacc[2 * nq], ah, r[0], r[1]);
        mma(stacc[2 * nq + 1], ah, r[2], r[3]);
        mma(slo[2 * nq], al, r[0], r[1]);
        mma(slo[2 * nq + 1], al, r[2], r[3]);
      }
    }
    // the new state as hi + lo for the next chunk's C state^T
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int col = ng * 32 + a * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = pm * 16 + g + 8 * half;
        stacc[a][2 * half] += slo[a][2 * half];
        stacc[a][2 * half + 1] += slo[a][2 * half + 1];
        uint32_t h2, l2;
        split2(stacc[a][2 * half], stacc[a][2 * half + 1], h2, l2);
        *reinterpret_cast<uint32_t*>(st_hi + r * kLdS + col) = h2;
        *reinterpret_cast<uint32_t*>(st_lo + r * kLdS + col) = l2;
      }
    }
  }

  // ---- the final f32 state of this block's head dims
  float* stb = state + ((long long)bi * h + hi) * p * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int col = ng * 32 + a * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = p0 + pm * 16 + g + 8 * half;
      if (r < p && col < n)
        *reinterpret_cast<float2*>(stb + (long long)r * n + col) =
            make_float2(stacc[a][2 * half], stacc[a][2 * half + 1]);
    }
  }
}

int launch_f32(const void* x, const float* dt, const float* A, const void* B, const void* C,
               void* y, float* state, int b, int s, int h, int p, int n, int q,
               long long xs_b, long long xs_s, long long xs_h, long long dts_b,
               long long dts_s, long long dts_h, long long bs_b, long long bs_s,
               long long cs_b, long long cs_s, cudaStream_t st) {
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      ssd_scan_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  ssd_scan_kernel<float><<<dim3(h, b), kThreads, kSmemBytes, st>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), state, s, h, p, n, q, xs_b, xs_s,
      xs_h, dts_b, dts_s, dts_h, bs_b, bs_s, cs_b, cs_s);
  return (int)cudaGetLastError();
}

// A TMA descriptor of a bf16 tensor (rank dims, innermost first; byte
// strides of the outer dims) read in boxes of `box`, zeros past its edges;
// false where TMA cannot describe it.  cuTensorMapEncodeTiled is looked up
// at first use.
bool bf16_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
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
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int launch_bf16(const void* x, const float* dt, const float* A, const void* B, const void* C,
                void* y, float* state, int b, int s, int h, int p, int n, int q,
                long long xs_b, long long xs_s, long long xs_h, long long dts_b,
                long long dts_s, long long dts_h, long long bs_b, long long bs_s,
                long long cs_b, long long cs_s, cudaStream_t st) {
  // TMA: 16-byte aligned bases and strides, whole 8-column pieces
  const bool aligned =
      p % 8 == 0 && n % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(B) % 16 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0 &&
      xs_b % 8 == 0 && xs_s % 8 == 0 && xs_h % 8 == 0 && bs_b % 8 == 0 && bs_s % 8 == 0 &&
      cs_b % 8 == 0 && cs_s % 8 == 0;
  if (!aligned) return (int)cudaErrorMisalignedAddress;
  CUtensorMap tm_x, tm_b, tm_c;
  const cuuint64_t x_dims[4] = {(cuuint64_t)p, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t x_strides[3] = {(cuuint64_t)xs_h * 2, (cuuint64_t)xs_s * 2,
                                    (cuuint64_t)xs_b * 2};
  const cuuint32_t x_box[4] = {kPB, 1, (cuuint32_t)q, 1};
  const cuuint64_t n_dims[3] = {(cuuint64_t)n, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t b_strides[2] = {(cuuint64_t)bs_s * 2, (cuuint64_t)bs_b * 2};
  const cuuint64_t c_strides[2] = {(cuuint64_t)cs_s * 2, (cuuint64_t)cs_b * 2};
  const cuuint32_t n_box[3] = {64, (cuuint32_t)q, 1};
  if (!bf16_map(&tm_x, x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !bf16_map(&tm_b, B, 3, n_dims, b_strides, n_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !bf16_map(&tm_c, C, 3, n_dims, c_strides, n_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      ssd_scan_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  const int n_split = (p + kPB - 1) / kPB;
  ssd_scan_mma_kernel<<<dim3(h * n_split, b), kThreads, kMmaSmemBytes, st>>>(
      tm_x, tm_b, tm_c, dt, A, static_cast<__nv_bfloat16*>(y), state, s, h, p, n, q, n_split,
      dts_b, dts_s, dts_h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* state, int b, int s, int h, int p,
                            int n, int q, long long xs_b, long long xs_s, long long xs_h,
                            long long dts_b, long long dts_s, long long dts_h,
                            long long bs_b, long long bs_s, long long cs_b, long long cs_s,
                            int dtype, void* stream) {
  if (q < 1 || q > kQ || p < 1 || p > kP || n < 1 || n > kN || b > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* stf = static_cast<float*>(state);
  if (dtype == 0)
    return launch_f32(x, dtf, Af, B, C, y, stf, b, s, h, p, n, q, xs_b, xs_s, xs_h, dts_b,
                      dts_s, dts_h, bs_b, bs_s, cs_b, cs_s, st);
  if (dtype == 1)
    return launch_bf16(x, dtf, Af, B, C, y, stf, b, s, h, p, n, q, xs_b, xs_s, xs_h, dts_b,
                       dts_s, dts_h, bs_b, bs_s, cs_b, cs_s, st);
  return (int)cudaErrorInvalidValue;
}
