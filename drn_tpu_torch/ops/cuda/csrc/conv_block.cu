// Replaces drn_tpu/ops/pallas/conv_block.py::conv_ln_relu (Pallas kernel
// `_kernel`, launched by `_forward`): relu(LN(conv1d(x, w, SAME, stride)
// + b) * scale + offset), LN and ReLU each optional. The conv output stays
// in the accumulator registers through the epilogue and never reaches HBM,
// which is what the TPU kernel kept in VMEM. The kernel is conv_sm90.cuh.
//
// What bounds it on an H100 (charades_c3d_batched_eval, D = 512): the 15
// launches of an eval step (B = 48) do 65.4 GFLOP, 0.066 ms at the bf16
// peak, against 133 MB of operands and outputs (0.040 ms at 3.35 TB/s);
// the 33 of a train step (B = 384: the forward, the backward's recomputes,
// since taken by drn_conv_ln_relu_bwd below, and the fusion backward's dx
// convs) 1.11 TFLOP, 1.13 ms, against 1.94 GB (0.58 ms): operations,
// both. The backward epilogue adds ~20 fp32 operations an output element
// and two more passes over the tile in shared memory, which 8 warps issue
// alone: 1.6x the forward kernel's time at the training shapes
// (B = 1536, K = 3, Cin = 512), 2.5-2.7x the Hadamard one's, whose 184
// registers a consumer spill there. The design's own limits: a block owns
// 64 rows and streams the whole weight of its columns from L2 (1.5 MB at
// K = 3, Cin = 512), and the eval step's launches have 12 to 86 row tiles
// for 132 SMs.
//
// Stages built: (1) wgmma m64nNk16 from 128-byte-swizzled shared memory,
// 64-row tiles of all Cout columns, a ring fed by a producer warpgroup
// (the weight by TMA, A gathered row by row with cp.async) on full/empty
// mbarriers, the LayerNorm epilogue in registers; (2) the Cout split over
// a cluster of 2 or 4 blocks where the row tiles leave SMs idle (the
// split is chosen by ops/cuda/conv_block.py::conv_plan from the card's
// SM count); (3) A by TMA where K = 1 and stride 1 (a 64-row box of x),
// and the output tile staged in shared memory and stored 16 bytes a
// thread. Not built: a persistent schedule.
#include "conv_sm90.cuh"

// split, grid: ops/cuda/conv_block.py::conv_plan; the launch is refused
// unless this source builds that split for Cout and grid = split *
// ceil(B * T_out / 64).
extern "C" int drn_conv_ln_relu(const void* x, const void* w, const void* bias,
                                const void* scale, const void* offset,
                                void* out, int B, int T, int Cin, int Cout,
                                int K, int stride, int T_out, int left,
                                int use_norm, int use_act, int split, int grid,
                                void* stream) {
  drn::ConvArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = B * T_out; a.T = T; a.T_out = T_out; a.Cin = Cin; a.K = K;
  a.stride = stride; a.left = left; a.use_norm = use_norm; a.use_act = use_act;
  a.nkc = (Cin + drn::kBK - 1) / drn::kBK;
  return static_cast<int>(drn::launch_conv<false>(
      a, Cout, split, grid, static_cast<cudaStream_t>(stream)));
}

// The backward of the block with LayerNorm (ops/cuda/autograd.py
// ConvLnReluFn): the conv recomputed with the backward epilogue, which
// takes the output's cotangent g and writes dpre (B * T_out, Cout) bf16,
// the tiles' column partials (grid, 3, Cout) fp32 and, summed over the
// tiles, ds, doff, db (Cout) fp32. grid = ceil(B * T_out / 64), or the
// launch is refused; never a cluster.
extern "C" int drn_conv_ln_relu_bwd(const void* x, const void* w,
                                    const void* bias, const void* scale,
                                    const void* offset, const void* g,
                                    void* dpre, void* partials, void* ds,
                                    void* doff, void* db, int B, int T,
                                    int Cin, int Cout, int K, int stride,
                                    int T_out, int left, int use_act, int grid,
                                    void* stream) {
  drn::ConvArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.out = static_cast<__nv_bfloat16*>(dpre);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.partials = static_cast<float*>(partials);
  a.M = B * T_out; a.T = T; a.T_out = T_out; a.Cin = Cin; a.K = K;
  a.stride = stride; a.left = left; a.use_norm = 1; a.use_act = use_act;
  a.nkc = (Cin + drn::kBK - 1) / drn::kBK;
  return static_cast<int>(drn::launch_conv_bwd<false>(
      a, Cout, grid, static_cast<float*>(ds), static_cast<float*>(doff),
      static_cast<float*>(db), static_cast<cudaStream_t>(stream)));
}
