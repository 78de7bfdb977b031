// Replaces drn_tpu/ops/pallas/conv_block.py::conv_ln_relu (Pallas kernel
// `_kernel`, launched by `_forward`): relu(LN(conv1d(x, w, SAME, stride)
// + b) * scale + offset), LN and ReLU each optional. The conv output stays
// in the block (fp32 accumulator -> shared memory -> epilogue) and never
// reaches HBM, which is what the TPU kernel kept in VMEM.
//
// Bound on an H100 and what the design does about it: conv_gemm.cuh.
#include "conv_gemm.cuh"

extern "C" int drn_conv_ln_relu(const void* x, const void* w, const void* bias,
                                const void* scale, const void* offset,
                                void* out, int B, int T, int Cin, int Cout,
                                int K, int stride, int T_out, int left,
                                int use_norm, int use_act, void* stream) {
  drn::ConvArgs a{};
  a.x = x;
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B; a.T = T; a.Cin = Cin; a.Cout = Cout; a.K = K; a.stride = stride;
  a.T_out = T_out; a.left = left; a.use_norm = use_norm; a.use_act = use_act;
  a.eps = drn::kLnEps;
  return static_cast<int>(drn::launch_conv_gemm<drn::kPlain>(
      a, static_cast<cudaStream_t>(stream)));
}
