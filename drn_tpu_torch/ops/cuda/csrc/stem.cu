// Replaces drn_tpu/ops/pallas/stem.py::fused_stem (Pallas kernel
// `_stem_kernel`, launched by `_forward`): input LayerNorm over Cin in fp32
// -> cast to bf16 -> conv1d k Cin->Cout -> bias -> LayerNorm in fp32 ->
// ReLU (the output LayerNorm and ReLU can be turned off: the backward pass
// recomputes the pre-LayerNorm conv). Two launches: row_stats_kernel reads the fp32 features once for
// the per-(b, t) mean and rstd (8 bytes a row out), then the conv kernel
// normalises each staged fp32 chunk, applies in_scale / in_bias and casts
// to bf16 in its prologue (kRowNorm). The normalised copy of the features,
// the largest intermediate of the network, never reaches HBM.
//
// The TPU kernel walked Cin as a sequential grid axis with an accumulator
// carried in VMEM scratch (the weight, 12.6 MB at Cin 4096, does not fit
// beside the data); here that axis is the k-tile loop inside each block.
// The price of the two-pass design is one extra read of the features
// (B*T*Cin*4 bytes) for the statistics.
//
// Bound on an H100 and what the design does about it: conv_gemm.cuh.
#include "conv_gemm.cuh"

namespace {

// One warp per row of x (M rows of C fp32 values): float4 loads when rows
// are 16-byte aligned (C % 4 == 0), one value at a time otherwise.
__global__ void row_stats_kernel(const float* __restrict__ x,
                                 float2* __restrict__ stats, int M, int C) {
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + static_cast<size_t>(row) * C;
  float s = 0.f, ss = 0.f;
  if ((C & 3) == 0) {
    const float4* p = reinterpret_cast<const float4*>(xr);
    for (int i = lane; i < C / 4; i += 32) {
      const float4 v = p[i];
      s += (v.x + v.y) + (v.z + v.w);
      ss += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
  } else {
    for (int i = lane; i < C; i += 32) {
      const float v = xr[i];
      s += v;
      ss += v * v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (lane == 0) {
    const float mean = s / C;
    const float var = fmaxf(ss / C - mean * mean, 0.f);
    stats[row] = make_float2(mean, rsqrtf(var + drn::kLnEps));
  }
}

}  // namespace

extern "C" int drn_fused_stem(const void* x, const void* in_scale,
                              const void* in_bias, const void* w,
                              const void* bias, const void* out_scale,
                              const void* out_bias, void* stats, void* out,
                              int B, int T, int Cin, int Cout, int K,
                              int use_norm, int use_act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const int rows_per_block = 8;
  row_stats_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                     32 * rows_per_block, 0, st>>>(
      static_cast<const float*>(x), static_cast<float2*>(stats), M, Cin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  drn::ConvArgs a{};
  a.x = x;
  a.stats = static_cast<const float2*>(stats);
  a.in_scale = static_cast<const float*>(in_scale);
  a.in_bias = static_cast<const float*>(in_bias);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(out_scale);
  a.offset = static_cast<const float*>(out_bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B; a.T = T; a.Cin = Cin; a.Cout = Cout; a.K = K; a.stride = 1;
  a.T_out = T; a.left = (K - 1) / 2; a.use_norm = use_norm; a.use_act = use_act;
  a.eps = drn::kLnEps;
  return static_cast<int>(drn::launch_conv_gemm<drn::kRowNorm>(a, st));
}
