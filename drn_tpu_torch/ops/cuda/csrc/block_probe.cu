// Replaces scripts/pallas_block_probe.py::pallas_block (Pallas kernel
// `block_kernel`, the measurement probe's fused fusion block):
// relu(LN(conv1d(v * q[:, None, :], w) + b) * scale + offset), with
//   * the bias in bf16, widened to fp32 before it is added (bias_bf16);
//   * the LayerNorm's eps an argument;
//   * K // 2 zero rows of padding on the left for any K, odd or even: output
//     row t reads input rows t - K/2 + i, i < K (XLA's SAME for odd K only).
// The probe's batch block (bb rows of B per grid step) is the TPU's VMEM
// tiling; here a block owns 32 of the flattened (b, t) rows and every batch
// row is computed, B a multiple of bb or not.
//
// The Hadamard product is formed while a tile of v is staged (prologue
// kHadamard). Bound on an H100 and what the design does about it:
// conv_gemm.cuh.
#include "conv_gemm.cuh"

extern "C" int drn_pallas_block(const void* v, const void* q, const void* w,
                                const void* bias_bf16, const void* scale,
                                const void* offset, void* out, int B, int T,
                                int D, int Dout, int K, float eps,
                                void* stream) {
  drn::ConvArgs a{};
  a.x = v;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias_bf16 = static_cast<const __nv_bfloat16*>(bias_bf16);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B; a.T = T; a.Cin = D; a.Cout = Dout; a.K = K; a.stride = 1;
  a.T_out = T; a.left = K / 2; a.use_norm = 1; a.use_act = 1;
  a.eps = eps;
  return static_cast<int>(drn::launch_conv_gemm<drn::kHadamard>(
      a, static_cast<cudaStream_t>(stream)));
}
