// Replaces drn_tpu/ops/pallas/fused_fusion.py::fused_fusion_block (Pallas
// kernel `_block_kernel`, launched by `_block_forward`):
// relu(LN(conv1d(v * q[:, None, :], w, SAME) + b) * scale + offset),
// and drn_tpu/ops/pallas/fused_fusion.py::fused_fusion (Pallas kernel
// `_fusion_kernel`, launched by `_forward`): conv1d(v * q[:, None, :], w,
// SAME) + b with no epilogue, one rounding to bf16. K is odd (the TPU
// kernels' symmetric padding is SAME only then) and at most kMaxK (17: a
// producer thread holds a chunk's window of 64 + K - 1 rows), stride 1.
//
// Both are the Hadamard variant of conv_sm90.cuh's kernel: its producer
// loads a chunk's window of v once, forms A = v * q[b] in registers (each
// row with its own video's query, one bf16 rounding) and stores the K
// tap-shifted tiles, so v * q never reaches HBM, and the conv output stays
// in the accumulator registers through the LayerNorm epilogue (off for
// fused_fusion).
//
// What bounds it on an H100 (charades_c3d_batched_eval, D = 512, K = 3):
// the 3 launches of an eval step (B = 48) do 8.5 GFLOP, 0.0086 ms at the
// bf16 peak, against 16 MB of operands and outputs (0.0047 ms at 3.35
// TB/s); of a train step (B = 384), 67.6 GFLOP a kernel (0.068 ms) against
// 93 MB (0.028 ms): operations. The design's own limits are conv_sm90.cuh's
// (a block streams its columns' whole weight from L2 for 64 rows; 12 to 48
// row tiles at B = 48, split over a cluster of 2 or 4 blocks), and the
// producer's register path: it cannot leave copies in flight as cp.async
// does, so it keeps one chunk's loads ahead, K k-tiles.
#include "conv_sm90.cuh"

namespace {

int launch(const void* v, const void* q, const void* w, const void* bias,
           const void* scale, const void* offset, void* out, int B, int T,
           int D, int Dout, int K, int epilogue, int split, int grid,
           void* stream) {
  if (K % 2 == 0 || K > drn::kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  drn::ConvArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(v);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = B * T; a.T = T; a.T_out = T; a.Cin = D; a.K = K; a.stride = 1;
  a.left = (K - 1) / 2; a.use_norm = epilogue; a.use_act = epilogue;
  a.nkc = (D + drn::kBK - 1) / drn::kBK;
  return static_cast<int>(drn::launch_conv<true>(
      a, Dout, split, grid, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// split, grid: ops/cuda/conv_block.py::conv_plan(B * T, Dout, SMs); the
// launch is refused unless this source builds that split for Dout and grid
// = split * ceil(B * T / 64).
extern "C" int drn_fused_fusion_block(const void* v, const void* q,
                                      const void* w, const void* bias,
                                      const void* scale, const void* offset,
                                      void* out, int B, int T, int D, int Dout,
                                      int K, int split, int grid,
                                      void* stream) {
  return launch(v, q, w, bias, scale, offset, out, B, T, D, Dout, K, 1, split,
                grid, stream);
}

// The conv alone: the LayerNorm's scale and offset are never read.
extern "C" int drn_fused_fusion(const void* v, const void* q, const void* w,
                                const void* bias, void* out, int B, int T,
                                int D, int Dout, int K, int split, int grid,
                                void* stream) {
  return launch(v, q, w, bias, nullptr, nullptr, out, B, T, D, Dout, K, 0,
                split, grid, stream);
}

// The backward of fused_fusion_block (ops/cuda/autograd.py
// FusedFusionBlockFn): the Hadamard conv recomputed with the backward
// epilogue, which takes the output's cotangent g and writes dpre (B * T,
// Dout) bf16, the tiles' column partials (grid, 3, Dout) fp32 and, summed
// over the tiles, ds, doff, db (Dout) fp32. grid = ceil(B * T / 64), or
// the launch is refused; never a cluster.
extern "C" int drn_fused_fusion_block_bwd(
    const void* v, const void* q, const void* w, const void* bias,
    const void* scale, const void* offset, const void* g, void* dpre,
    void* partials, void* ds, void* doff, void* db, int B, int T, int D,
    int Dout, int K, int grid, void* stream) {
  if (K % 2 == 0 || K > drn::kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  drn::ConvArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(v);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.out = static_cast<__nv_bfloat16*>(dpre);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.partials = static_cast<float*>(partials);
  a.M = B * T; a.T = T; a.T_out = T; a.Cin = D; a.K = K; a.stride = 1;
  a.left = (K - 1) / 2; a.use_norm = 1; a.use_act = 1;
  a.nkc = (D + drn::kBK - 1) / drn::kBK;
  return static_cast<int>(drn::launch_conv_bwd<true>(
      a, Dout, grid, static_cast<float*>(ds), static_cast<float*>(doff),
      static_cast<float*>(db), static_cast<cudaStream_t>(stream)));
}
