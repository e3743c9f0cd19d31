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
// next.  Here one thread block per (h, b) walks its chunks in a loop, with
// the state in shared memory throughout.  This first version is simple:
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
//   SM (the shared memory admits one), 8 warps each.  A two-pass design
//   (chunk states in parallel, then a short scan over chunks) and tensor
//   cores are later PRs' work.

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
           void* y, float* state, int b, int s, int h, int p, int n, int q,
           long long xs_b, long long xs_s, long long xs_h, long long dts_b, long long dts_s,
           long long dts_h, long long bs_b, long long bs_s, long long cs_b, long long cs_s,
           cudaStream_t st) {
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  ssd_scan_kernel<T><<<dim3(h, b), kThreads, kSmemBytes, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<T*>(y), state, s, h, p, n, q, xs_b, xs_s, xs_h, dts_b, dts_s, dts_h,
      bs_b, bs_s, cs_b, cs_s);
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
    return launch<float>(x, dtf, Af, B, C, y, stf, b, s, h, p, n, q, xs_b, xs_s, xs_h,
                         dts_b, dts_s, dts_h, bs_b, bs_s, cs_b, cs_s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, B, C, y, stf, b, s, h, p, n, q, xs_b, xs_s,
                                 xs_h, dts_b, dts_s, dts_h, bs_b, bs_s, cs_b, cs_s, st);
  return (int)cudaErrorInvalidValue;
}
