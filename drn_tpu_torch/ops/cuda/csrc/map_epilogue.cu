// The epilogue of one 2-D map conv of 2D-TAN (models/tan.py), in place on
// the conv's bf16 channels-last output y (cells × channels, a cell = one
// (b, i, j) of the map):
//
//   y[cell, c] = bf16(max(y[cell, c] + bias[c], 0) · w[cell mod hw])
//
// bias (channels) and w (hw = the layer's H·W, its count weights: 1 / the
// live cells of the previous layer's mask in the kernel's window, 0 where
// there are none) are fp32; the sum, the ReLU and the product are fp32,
// one rounding to bf16 at the end. One thread takes 8 channels (16 bytes)
// of a cell at a time, in a grid-stride loop. Plain C interface, bound by
// ctypes (ops/cuda/map_epilogue.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    map_epilogue_kernel(uint4* __restrict__ y, const float* __restrict__ bias,
                        const float* __restrict__ w, long long n_vec,
                        int vec_per_cell, int hw) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n_vec; i += step) {
    const long long cell = i / vec_per_cell;
    const int c0 = static_cast<int>(i - cell * vec_per_cell) * 8;
    const float wc = __ldg(w + cell % hw);
    uint4 v = y[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      f.x = fmaxf(f.x + __ldg(bias + c0 + 2 * j), 0.f) * wc;
      f.y = fmaxf(f.y + __ldg(bias + c0 + 2 * j + 1), 0.f) * wc;
      h[j] = __floats2bfloat162_rn(f.x, f.y);
    }
    y[i] = v;
  }
}

}  // namespace

extern "C" int drn_map_epilogue(void* y, const void* bias, const void* w,
                                int cells, int channels, int hw, int grid,
                                void* stream) {
  if (cells < 0 || channels <= 0 || channels % 8 || hw <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_per_cell = channels / 8;
  const long long n_vec = static_cast<long long>(cells) * vec_per_cell;
  if (n_vec == 0) return static_cast<int>(cudaSuccess);
  map_epilogue_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(y), static_cast<const float*>(bias),
      static_cast<const float*>(w), n_vec, vec_per_cell, hw);
  return static_cast<int>(cudaGetLastError());
}
