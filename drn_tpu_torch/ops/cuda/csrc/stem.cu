// Replaces drn_tpu/ops/pallas/stem.py::fused_stem (Pallas kernel
// `_stem_kernel`, launched by `_forward`): input LayerNorm over Cin in fp32
// -> cast to bf16 -> conv1d k Cin->Cout -> bias -> LayerNorm in fp32 ->
// ReLU (the output LayerNorm and ReLU can be turned off: the backward pass
// recomputes the pre-LayerNorm conv). Two launches: row_stats_kernel reads
// the fp32 features once for the per-(b, t) mean and rstd (8 bytes a row
// out), then stem_kernel (stem_sm90.cuh) normalises each staged fp32 chunk,
// applies in_scale / in_bias and casts to bf16 as it stages the A tile.
// The normalised copy of the features, the largest intermediate of the
// network, never reaches HBM.
//
// The TPU kernel walked Cin as a sequential grid axis with an accumulator
// carried in VMEM scratch (the weight, 12.6 MB at Cin 4096, does not fit
// beside the data); here that axis is the k-tile loop inside each block.
//
// What bounds it on an H100 (charades_c3d: T = 64, Cin = 4096, Cout = 512):
// at the eval step (B = 48) 38.7 GFLOP, 0.039 ms at the bf16 peak, against
// 66 MB (0.020 ms at 3.35 TB/s); at the train step (B = 384) 309 GFLOP,
// 0.313 ms, against 441 MB (0.132 ms): operations, both. The design's own
// limits: a block owns 64 rows, so B = 48 fills 48 of the 132 SMs (0.107 ms
// at their peak), and every block streams the whole weight from L2 (12.6
// MB; 4.8 GB a launch at B = 384).
//
// Stages built: (1) wgmma from 128-byte-swizzled shared memory, 64-row
// tiles of all Cout columns; (2) the weight ring fed by TMA on mbarriers,
// a producer warpgroup and two consumer warpgroups (setmaxnreg); (3a) each
// chunk of x normalised once per block, its K tap-shifted copies stored
// from registers, the next chunk's loads in flight meanwhile; (3c) at
// Cout = 512, where the row tiles fill at most half the SMs (B = 48: 48
// tiles), a 2-block cluster shares each tile and splits its columns, the
// LayerNorm row sums crossing through distributed shared memory. Not
// built: (3b) multicasting the weight over a cluster at B = 384, where
// switching the weight's copies off altogether saves 15-17%
// (probes/stem_parts.py).
#include "stem_sm90.cuh"

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

// rows, depth, split, stages, smem_bytes, grid: the launch geometry of
// drn_tpu_torch/ops/cuda/stem.py::stem_plan, checked against this build.
extern "C" int drn_fused_stem(const void* x, const void* in_scale,
                              const void* in_bias, const void* w,
                              const void* bias, const void* out_scale,
                              const void* out_bias, void* stats, void* out,
                              int B, int T, int Cin, int Cout, int K,
                              int use_norm, int use_act, int rows, int depth,
                              int split, int stages, int smem_bytes, int grid,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const int rows_per_block = 8;
  row_stats_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                     32 * rows_per_block, 0, st>>>(
      static_cast<const float*>(x), static_cast<float2*>(stats), M, Cin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  drn::StemArgs a{};
  a.x = static_cast<const float*>(x);
  a.stats = static_cast<const float2*>(stats);
  a.in_scale = static_cast<const float*>(in_scale);
  a.in_bias = static_cast<const float*>(in_bias);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(out_scale);
  a.offset = static_cast<const float*>(out_bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M; a.T = T; a.Cin = Cin; a.K = K;
  a.n_k = K * ((Cin + drn::kBK - 1) / drn::kBK);
  a.use_norm = use_norm; a.use_act = use_act;
  return static_cast<int>(drn::launch_stem(a, Cout, rows, depth, split,
                                           stages, smem_bytes, grid, st));
}
