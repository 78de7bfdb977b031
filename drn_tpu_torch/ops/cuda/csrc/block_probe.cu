// Replaces scripts/pallas_block_probe.py::pallas_block (Pallas kernel
// `block_kernel`, the measurement probe's fused fusion block):
// relu(LN(conv1d(v * q[:, None, :], w) + b) * scale + offset), with
//   * the bias in bf16, widened to fp32 before it is added (bias_bf16);
//   * the LayerNorm's eps an argument;
//   * K // 2 zero rows of padding on the left for any K, odd or even: output
//     row t reads input rows t - K/2 + i, i < K (XLA's SAME for odd K only).
// The probe's batch block (bb rows of B per grid step) is the TPU's VMEM
// tiling; here a block owns 64 of the flattened (b, t) rows and every batch
// row is computed, B a multiple of bb or not.
//
// It is the Hadamard variant of conv_sm90.cuh's kernel, as the package's
// fusion block (fused_fusion.cu), compiled with the bf16 bias
// (launch_conv<true, true>): the producer forms A = v * q[b] in registers
// while it stages a chunk's window, the conv output stays in the
// accumulator registers through the LayerNorm epilogue. K up to kMaxK (17:
// a producer thread holds a window of 64 + K - 1 rows), stride 1.
//
// What bounds it on an H100 at the probe's shapes (B = 256, T = 64, D =
// 512, K = 3): 25.8 GFLOP, 0.026 ms at the bf16 peak, against 35 MB of
// operands and output (0.011 ms at 3.35 TB/s): operations. The design's
// own limits are the fusion kernels': 256 row tiles of 512 columns make
// two waves on 132 SMs (the second 124 blocks), each tile streams the whole
// weight from L2 and pays a fill and an epilogue, and the producer keeps
// one chunk's loads in flight.
#include "conv_sm90.cuh"

// split, grid: ops/cuda/conv_block.py::conv_plan(B * T, Dout, SMs); the
// launch is refused unless this source builds that split for Dout and grid
// = split * ceil(B * T / 64), and for K past kMaxK.
extern "C" int drn_pallas_block(const void* v, const void* q, const void* w,
                                const void* bias_bf16, const void* scale,
                                const void* offset, void* out, int B, int T,
                                int D, int Dout, int K, int split, int grid,
                                float eps, void* stream) {
  if (K < 1 || K > drn::kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  drn::ConvArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(v);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias_bf16 = static_cast<const __nv_bfloat16*>(bias_bf16);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = B * T; a.T = T; a.T_out = T; a.Cin = D; a.K = K; a.stride = 1;
  a.left = K / 2; a.use_norm = 1; a.use_act = 1;
  a.nkc = (D + drn::kBK - 1) / drn::kBK;
  a.eps = eps;
  return static_cast<int>(drn::launch_conv<true, true>(
      a, Dout, split, grid, static_cast<cudaStream_t>(stream)));
}
