// Replaces drn_tpu/ops/pallas/fused_fusion.py::fused_fusion_block (Pallas
// kernel `_block_kernel`, launched by `_block_forward`):
// relu(LN(conv1d(v * q[:, None, :], w, SAME) + b) * scale + offset),
// and drn_tpu/ops/pallas/fused_fusion.py::fused_fusion (Pallas kernel
// `_fusion_kernel`, launched by `_forward`): conv1d(v * q[:, None, :], w,
// SAME) + b with no epilogue, one rounding to bf16.
// The Hadamard product is formed while a tile of v is staged into shared
// memory (prologue kHadamard), so v * q never reaches HBM; the conv output
// stays in the block for the LayerNorm epilogue.
//
// Bound on an H100 and what the design does about it: conv_gemm.cuh.
#include "conv_gemm.cuh"

namespace {

int launch(const void* v, const void* q, const void* w, const void* bias,
           const void* scale, const void* offset, void* out, int B, int T,
           int D, int Dout, int K, int epilogue, void* stream) {
  drn::ConvArgs a{};
  a.x = v;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B; a.T = T; a.Cin = D; a.Cout = Dout; a.K = K; a.stride = 1;
  a.T_out = T; a.left = (K - 1) / 2; a.use_norm = epilogue; a.use_act = epilogue;
  a.eps = drn::kLnEps;
  return static_cast<int>(drn::launch_conv_gemm<drn::kHadamard>(
      a, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int drn_fused_fusion_block(const void* v, const void* q,
                                      const void* w, const void* bias,
                                      const void* scale, const void* offset,
                                      void* out, int B, int T, int D, int Dout,
                                      int K, void* stream) {
  return launch(v, q, w, bias, scale, offset, out, B, T, D, Dout, K, 1, stream);
}

// The conv alone: the LayerNorm's scale and offset are never read.
extern "C" int drn_fused_fusion(const void* v, const void* q, const void* w,
                                const void* bias, void* out, int B, int T,
                                int D, int Dout, int K, void* stream) {
  return launch(v, q, w, bias, nullptr, nullptr, out, B, T, D, Dout, K, 0,
                stream);
}
