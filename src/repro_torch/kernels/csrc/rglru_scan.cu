// RG-LRU linear recurrence for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel _rglru_kernel of src/repro/kernels/rglru_scan.py
// (pallas_call at :49, wrapper rglru_scan at :41).  For a, b (B, S, D) in
// f32 or bf16 it computes h_t = a_t * h_{t-1} + b_t from h_{-1} = 0, f32
// inside, and writes h (B, S, D) in f32 (the Pallas kernel's output is f32
// whatever its inputs, :57).  The product is rounded before the sum
// (__fmul_rn, __fadd_rn: no fused multiply-add), so each step is the plain
// version's arithmetic and the two agree bit for bit.
//
// What bounds it on an H100 SXM (published peaks at its 700 W limit), at
// recurrentgemma-9b's shape (1, 8192, 4096) in f32: a and b read once and h
// written once, 402.7 MB, take 0.120 ms at 3.35 TB/s; the 67 M operations
// are negligible.  Bytes bound.
//
// Where Hopper differs from the TPU.  The Pallas grid (B, chunks) runs in
// order and carries h in VMEM scratch across chunks.  Here one thread per
// (b, d) walks all of S with h in a register: the recurrence is sequential
// in S and independent across channels.  A warp's loads and stores are 32
// consecutive channels of one row (coalesced); each thread loads 16 steps
// of a and b ahead of the dependent chain, so the loads of a warp overlap.
// Blocks of 32 threads spread the D / 32 warps over as many SMs as there
// are (128 blocks at D 4096, B 1): only 4,096 threads run, too few to reach
// the card's memory rate.  A chunked two-level scan (chunk-local scans in
// parallel, then the carries) is a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kAhead = 16;       // steps loaded ahead of the recurrence

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                  float* __restrict__ h, int S, int D, long long as_b,
                                  long long as_s, long long bs_b, long long bs_s) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const T* ap = a + bi * as_b + d;
  const T* bp = b + bi * bs_b + d;
  float* hp = h + (long long)bi * S * D + d;
  float hv = 0.f;
  int t = 0;
  for (; t + kAhead <= S; t += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      av[k] = to_f(ap[(long long)(t + k) * as_s]);
      bv[k] = to_f(bp[(long long)(t + k) * bs_s]);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      hv = __fadd_rn(__fmul_rn(av[k], hv), bv[k]);
      hp[(long long)(t + k) * D] = hv;
    }
  }
  for (; t < S; ++t) {
    hv = __fadd_rn(__fmul_rn(to_f(ap[(long long)t * as_s]), hv), to_f(bp[(long long)t * bs_s]));
    hp[(long long)t * D] = hv;
  }
}

template <typename T>
int launch(const void* a, const void* b, float* h, int B, int S, int D, long long as_b,
           long long as_s, long long bs_b, long long bs_s, cudaStream_t st) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(a),
                                                  static_cast<const T*>(b), h, S, D, as_b,
                                                  as_s, bs_b, bs_s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B, int S, int D,
                              long long as_b, long long as_s, long long bs_b, long long bs_s,
                              int dtype, void* stream) {
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h);
  if (dtype == 0) return launch<float>(a, b, hf, B, S, D, as_b, as_s, bs_b, bs_s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, hf, B, S, D, as_b, as_s, bs_b, bs_s, st);
  return (int)cudaErrorInvalidValue;
}
