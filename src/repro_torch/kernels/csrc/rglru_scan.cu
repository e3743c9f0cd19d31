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
// order and carries h in VMEM scratch across chunks.  Here the recurrence
// stays sequential in S per channel, in one register, so that every step
// is the plain version's arithmetic; channels are independent.  A first
// version (one thread per channel, 16 steps loaded ahead in registers)
// kept about 4 KB of loads in flight on an SM, where the card needs about
// 15 KB an SM to reach its memory rate: latency-bound at 16% of the bound.
// Loads issued as cp.async 16-byte copies by the same warp did little
// better: one warp cannot keep enough copies in flight.  This design
// streams a and b through shared memory with the Tensor Memory
// Accelerator, which one thread drives:
// * A block is one warp and owns a tile of 32 channels (a 128-byte f32
//   row; 128 blocks at D 4096, B 1, one an SM).  Its a and b pass through
//   a ring of kStages stages of kSteps steps x 32 channels in shared
//   memory (64 KB in f32): lane 0 asks for each stage as one TMA box per
//   input (32 channels x kSteps steps of one batch row, from a 3D tensor
//   map of the (B, S, D) input), completing on the stage's mbarrier,
//   kStages - 1 stages (48 KB) ahead of the recurrence.  TMA fills the box
//   past S and past D with zeros, so ragged edges need no code; those
//   steps and channels are never stored.
// * The serial chain (a multiply and an add, about 8 cycles a step, 8192 x
//   8 cycles = 37 us at S 8192) stays under the 0.120 ms byte bound, so no
//   split of S (which would reassociate the sum) is needed to reach it.
// * Lane d reads channel d of each step from shared memory (consecutive
//   words, no bank conflict) and stores h_t of its channel: a warp's store
//   is one coalesced 128-byte row of h.
// * TMA needs 16-byte aligned base addresses and strides; inputs without
//   them (a strided view with an odd row stride) take rglru_scan_simple_kernel,
//   one thread per channel with 16 steps loaded ahead in registers.
//   bf16 inputs are staged as bf16 and widened when read.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChan = 32;               // channels a block: one warp, one lane each
constexpr int kSteps = 64;              // steps a stage
constexpr int kStages = 4;              // stages in the ring
constexpr int kAhead = 16;              // steps the simple kernel loads ahead

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// one box (32 channels x kSteps steps of batch row c2) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3, %4}], [%5];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
                  "r"(bar)
               : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kChan)
rglru_scan_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b, float* __restrict__ h, int S,
                  int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring_a = reinterpret_cast<T*>(smem_raw);               // (kStages, kSteps, kChan)
  T* ring_b = ring_a + kStages * kSteps * kChan;
  __shared__ __align__(8) uint64_t full[kStages];
  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * kChan, d = d0 + lane, bi = blockIdx.y;
  float* hp = h + (long long)bi * S * D + d;
  const int n_stages = (S + kSteps - 1) / kSteps;
  constexpr int kBox = kSteps * kChan;
  constexpr int kStageBytes = 2 * kBox * (int)sizeof(T);

  if (lane == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(smem_addr(&full[k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto load = [&](int k) {                   // lane 0: stage k into its slot
    const int slot = k % kStages;
    const uint32_t bar = smem_addr(&full[slot]);
    // this warp's reads of the slot (the generic proxy) come before TMA's
    // writes (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, kStageBytes);
    tma_load(smem_addr(ring_a + slot * kBox), &tm_a, d0, k * kSteps, bi, bar);
    tma_load(smem_addr(ring_b + slot * kBox), &tm_b, d0, k * kSteps, bi, bar);
  };
  if (lane == 0)
    for (int k = 0; k < kStages - 1 && k < n_stages; ++k) load(k);
  float hv = 0.f;
  for (int k = 0; k < n_stages; ++k) {
    if (lane == 0 && k + kStages - 1 < n_stages) load(k + kStages - 1);
    mbar_wait(smem_addr(&full[k % kStages]), (k / kStages) & 1);
    const T* sa = ring_a + (k % kStages) * kBox + lane;
    const T* sb = ring_b + (k % kStages) * kBox + lane;
    const int t0 = k * kSteps, steps = min(kSteps, S - t0);
    if (d < D) {
      if (steps == kSteps) {
#pragma unroll 16
        for (int r = 0; r < kSteps; ++r) {
          hv = __fadd_rn(__fmul_rn(to_f(sa[r * kChan]), hv), to_f(sb[r * kChan]));
          hp[(long long)(t0 + r) * D] = hv;
        }
      } else {
        for (int r = 0; r < steps; ++r) {
          hv = __fadd_rn(__fmul_rn(to_f(sa[r * kChan]), hv), to_f(sb[r * kChan]));
          hp[(long long)(t0 + r) * D] = hv;
        }
      }
    }
    __syncwarp();                            // the slot is free for stage k + kStages
  }
}

// Inputs TMA cannot describe: one thread per channel, kAhead steps of a and
// b loaded into registers ahead of the dependent chain.
template <typename T>
__global__ void rglru_scan_simple_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                         float* __restrict__ h, int S, int D, long long as_b,
                                         long long as_s, long long bs_b, long long bs_s) {
  const int d = blockIdx.x * kChan + threadIdx.x;
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

// A TMA descriptor of a (B, S, D) input with unit stride in D, read in
// boxes of kSteps x 32, zeros past its edges; false where TMA cannot
// describe it.  cuTensorMapEncodeTiled is looked up at first use.
template <typename T>
bool input_map(CUtensorMap* map, const void* ptr, int B, int S, int D, long long s_b,
               long long s_s) {
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
  const long long e = sizeof(T);
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || (s_s * e) % 16 || (s_b * e) % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)(s_s * e), (cuuint64_t)(s_b * e)};
  const cuuint32_t box[3] = {kChan, kSteps, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename T>
int launch(const void* a, const void* b, float* h, int B, int S, int D, long long as_b,
           long long as_s, long long bs_b, long long bs_s, cudaStream_t st) {
  const dim3 grid((D + kChan - 1) / kChan, B);
  CUtensorMap tm_a, tm_b;
  if (input_map<T>(&tm_a, a, B, S, D, as_b, as_s) && input_map<T>(&tm_b, b, B, S, D, bs_b, bs_s)) {
    constexpr int smem = 2 * kStages * kSteps * kChan * sizeof(T);
    static const cudaError_t smem_ok = cudaFuncSetAttribute(
        rglru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (smem_ok != cudaSuccess) return (int)smem_ok;
    rglru_scan_kernel<T><<<grid, kChan, smem, st>>>(tm_a, tm_b, h, S, D);
  } else {
    rglru_scan_simple_kernel<T><<<grid, kChan, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), h, S, D, as_b, as_s, bs_b, bs_s);
  }
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
