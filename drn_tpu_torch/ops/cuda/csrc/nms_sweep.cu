// The greedy suppression sweep of the eval step's temporal NMS
// (ops/nms.py::batched_temporal_nms), one thread block per query:
//
//   keep[b, j] = no i < j with keep[b, i] and IoU(seg[b, i], seg[b, j]) > thr
//
// over the query's K candidates, already sorted by score (rank order).
// It replaces no TPU kernel: the JAX package runs the same sweep as a
// `lax.fori_loop` (drn_tpu/ops/nms.py::temporal_nms), which XLA keeps on
// the chip; in eager PyTorch that loop is K steps of 3 launches over a
// (B, K, K) IoU matrix.
//
// What bounds it is the serial chain of surviving candidates, not bytes or
// operations: each survivor's suppressions must land before the next
// survivor is known. So a query's whole sweep stays in one block and in
// shared memory, where a step of the chain costs one __syncthreads: the K
// segments (8 B each) and a bitmask of survivors. The block finds the next
// survivor by a block-uniform scan of the mask (__ffs), then its threads
// take the later candidates in parallel, a warp a 32-bit word of the mask
// at a time; the warp's __ballot_sync gives the word's suppressions, which
// its lane 0 clears, so no word has two writers in a step and no atomics
// are needed. Queries run side by side, one block each (B blocks); the
// block size follows K (the wrapper's `sweep_threads`), so DRN's K = 48
// and 2D-TAN's K = 2,548 take the same code.
//
// The IoU repeats ops/temporal.py::temporal_iou's fp32 operations in its
// order, with IEEE division (no fast math), so the keep mask equals the
// plain version's bit for bit; NaN passes through the min, max and clamps
// as in PyTorch and ends as an IoU of 0. Plain C interface, bound by ctypes
// (ops/cuda/nms_sweep.py).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kSmallSmem = 48 * 1024;

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.minimum / torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan_(a) || isnan_(b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan_(a) || isnan_(b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
// clamp_min(x, 0): NaN stays NaN.
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// temporal_iou(a, b), a = (a0, a1), b = (b0, b1).
__device__ __forceinline__ float temporal_iou(float a0, float a1, float b0,
                                              float b1) {
  const float inter = clamp0(tmin(a1, b1) - tmax(a0, b0));
  const float len_a = clamp0(a1 - a0);
  const float len_b = clamp0(b1 - b0);
  const float uni = __fsub_rn(__fadd_rn(len_a, len_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-8f)) : 0.f;
}

__global__ void nms_sweep_kernel(const float2* __restrict__ segs, int k,
                                 float thr, uint8_t* __restrict__ keep) {
  extern __shared__ float2 seg[];  // the query's K segments, rank order
  uint32_t* live = reinterpret_cast<uint32_t*>(seg + k);  // survivors
  const int words = (k + 31) >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) seg[j] = segs[row + j];
  for (int w = threadIdx.x; w < words; w += blockDim.x)
    live[w] = (w == words - 1 && (k & 31)) ? (1u << (k & 31)) - 1u
                                           : 0xffffffffu;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // The scan reads through a volatile pointer: a warp that has found the
  // survivor i may already clear bits of i's word while another still
  // scans it. It clears only bits above i, and bits from the last
  // survivor up to i do not change in a step, so every thread finds the
  // same i.
  const volatile uint32_t* scan = live;
  int i = 0;  // the lowest rank not yet decided
  for (;;) {
    int w = i >> 5;
    uint32_t bits = w < words ? scan[w] & (0xffffffffu << (i & 31)) : 0u;
    while (!bits && ++w < words) bits = scan[w];
    if (!bits) break;
    i = (w << 5) + __ffs(static_cast<int>(bits)) - 1;  // the next survivor
    const float2 a = seg[i];
    for (int v = ((i + 1) >> 5) + warp; v < words; v += warps) {
      const uint32_t word = live[v];  // this warp's alone in this step
      if (!word) continue;            // warp-uniform
      const int j = (v << 5) + lane;
      bool hit = false;
      if (j > i && ((word >> lane) & 1u)) {
        const float2 b = seg[j];
        hit = temporal_iou(a.x, a.y, b.x, b.y) > thr;
      }
      const uint32_t gone = __ballot_sync(0xffffffffu, hit);
      if (lane == 0 && gone) live[v] = word & ~gone;
    }
    __syncthreads();
    ++i;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    keep[row + j] = static_cast<uint8_t>((live[j >> 5] >> (j & 31)) & 1u);
}

}  // namespace

// segs (batch, k, 2) fp32 contiguous, 8-byte aligned; keep (batch, k) one
// byte each. threads: a multiple of 32 in [32, 1024]. The cap on k is the
// wrapper's (nms_sweep.py MAX_K); here a k whose shared memory the device
// cannot give a block is refused, and the error is not left pending.
extern "C" int drn_nms_sweep(const void* segs, void* keep, int batch, int k,
                             int threads, float thr, void* stream) {
  if (batch < 0 || k < 0 || threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || k == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float2) * k + sizeof(uint32_t) * ((k + 31) / 32);
  if (smem > static_cast<size_t>(INT_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmallSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  nms_sweep_kernel<<<batch, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(segs), k, thr, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
