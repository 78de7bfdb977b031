// conv1d-as-GEMM with a fused LayerNorm/ReLU epilogue, for sm_90a.
//
// The template serves the measurement probe's kernel alone
// (block_probe.cu): the fused fusion block with a bf16 bias, its own eps
// and K/2 rows of left padding for any K. The prologue stages a tile of
// the input:
//
//   kHadamard  x = v * q[b] (bf16 product), never in HBM
//
// (The stem, stem.cu, conv_ln_relu, conv_block.cu, and the package's
// fusion kernels, fused_fusion.cu, have Hopper kernels of their own:
// stem_sm90.cuh and conv_sm90.cuh.)
//
// Any Cin: a row whose width is not a multiple of 8 is staged channel by
// channel (fetch_a).
//
// Output rows are the flattened (b, t_out) pairs, M = B * T_out; a block
// owns BM = 32 of them and ALL Cout columns, because the LayerNorm of the
// epilogue needs a whole row. The reduction runs over (tap, Cin chunk of
// BK = 32): the A tile is gathered row by row (tap i of output row t reads
// input row t*stride - left + i, zero outside [0, T): XLA's SAME padding,
// asymmetric for stride 2), the B tile is w[tap, c0:c0+BK, :] (WIO layout,
// row-major (Cin, Cout) per tap). Two shared-memory stages: B goes in with
// cp.async, A through registers (the prologue transforms it), both for the
// next k-tile while the tensor cores (nvcuda::wmma, bf16 in, fp32
// accumulate) work on the current one. 8 warps as 2 (rows) x 4 (columns),
// each 16 rows x Cout/4 columns of the fp32 accumulator.
//
// Epilogue: accumulator -> shared memory (fp32), then one warp per row:
// + bias (fp32, or bf16 widened to fp32 when bias_bf16 is set), LayerNorm
// in fp32 (eps from the arguments; var = E[x^2] - E[x]^2 clamped at 0,
// flax's fast variance), * scale +
// offset, ReLU, bf16 store. Each of use_norm / use_act can be off.
//
// What bounds it on an H100: at the eval step's shapes the blocks are
// compute-bound in theory (2*M*K*Cin*Cout flops over few bytes), but this
// first version is far from the tensor-core peak: mma.sync through wmma
// instead of wgmma, one block of 32 rows per SM (M = 3072 gives 96 blocks
// for 132 SMs), and a __syncthreads pair per 32-deep k-tile. Making it
// fast (wgmma, TMA, a persistent schedule, split rows) is later work;
// PERF.md keeps its measured time beside its bound.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace drn {
// Internal linkage: each source is its own library, loaded with ctypes.
// With external linkage a function-local `configured` flag of a template
// instantiated by two libraries is one object across both, so the second
// library would skip setting its own kernel's shared-memory limit and its
// launch would be refused.
namespace {

using namespace nvcuda;

constexpr int kBM = 32;          // output rows per block
constexpr int kBK = 32;          // reduction depth per k-tile
constexpr int kThreads = 256;    // 8 warps: 2 along rows x 4 along columns
constexpr int kALd = kBK + 8;    // bf16 row pitch of the A tile (padding vs bank conflicts)

enum Prologue { kHadamard = 1 };

struct ConvArgs {
  const void* x;                 // (B, T, Cin) bf16
  const __nv_bfloat16* q;        // (B, Cin) bf16, kHadamard only
  const __nv_bfloat16* w;        // (K, Cin, Cout) bf16
  const float* bias;             // (Cout), read when bias_bf16 is null
  const __nv_bfloat16* bias_bf16;  // (Cout) bf16, widened to fp32 in the epilogue
  const float* scale;            // (Cout)
  const float* offset;           // (Cout)
  __nv_bfloat16* out;            // (B, T_out, Cout) bf16
  int B, T, Cin, Cout, K, stride, T_out, left, use_norm, use_act;
  float eps;                     // LayerNorm epsilon
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(h);
}

// One 8-channel vector of A for row gm (output row), tap, channel c:
// 16 bytes of bf16, zero outside the input and past Cin.
template <int PRO>
__device__ __forceinline__ uint4 fetch_a(const ConvArgs& a, int gm, int tap,
                                         int c) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  const int M = a.B * a.T_out;
  if (gm >= M || c >= a.Cin) return r;
  const int b = gm / a.T_out;
  const int ts = (gm - b * a.T_out) * a.stride - a.left + tap;
  if (ts < 0 || ts >= a.T) return r;
  const size_t row = static_cast<size_t>(b) * a.T + ts;
  if (a.Cin & 7) {
    // Cin % 8 != 0 (activitynet_c3d's 500 features): a row is not 16-byte
    // aligned and the row's last vector runs past Cin into the next row,
    // so load channel by channel and zero-fill past Cin. Same arithmetic
    // as the vector paths below.
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = c + j;
      f[j] = 0.f;
      if (ch >= a.Cin) continue;
      const size_t at = row * a.Cin + ch;
      f[j] = __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[at]);
      if (PRO == kHadamard)
        f[j] *= __bfloat162float(a.q[static_cast<size_t>(b) * a.Cin + ch]);
    }
    uint32_t* rr = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) rr[i] = pack_bf16x2(f[2 * i], f[2 * i + 1]);
    return r;
  }
  if (PRO == kHadamard) {
    uint4 v = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(a.x) + row * a.Cin + c);
    uint4 q = *reinterpret_cast<const uint4*>(
        a.q + static_cast<size_t>(b) * a.Cin + c);
    const uint32_t* vv = reinterpret_cast<const uint32_t*>(&v);
    const uint32_t* qq = reinterpret_cast<const uint32_t*>(&q);
    uint32_t* rr = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 fv = unpack_bf16x2(vv[i]);
      float2 fq = unpack_bf16x2(qq[i]);
      // bf16 x bf16 is exact in fp32; one rounding to bf16, as the
      // reference's bf16 multiply.
      rr[i] = pack_bf16x2(fv.x * fq.x, fv.y * fq.y);
    }
  }
  return r;
}

// NF = Cout / 64: 16-column accumulator fragments per warp.
template <int NF>
struct Tile {
  static constexpr int kCout = 64 * NF;
  static constexpr int kBLd = kCout + 8;  // bf16 row pitch of the B tile
  static constexpr int kCLd = kCout + 4;  // fp32 row pitch of the epilogue tile
  static constexpr int kAElems = kBM * kALd;
  static constexpr int kStageElems = kAElems + kBK * kBLd;
  static constexpr size_t kPipeBytes = 2 * kStageElems * sizeof(__nv_bfloat16);
  static constexpr size_t kEpiBytes = kBM * kCLd * sizeof(float);
  static constexpr size_t kSmemBytes =
      kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;
};

template <int PRO, int NF>
__global__ void __launch_bounds__(kThreads)
    conv_gemm_kernel(const ConvArgs a) {
  using TL = Tile<NF>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * kBM;
  const int nkc = (a.Cin + kBK - 1) / kBK;
  const int nk = a.K * nkc;

  // A: 32 rows x 32 channels = 128 vectors of 8, threads 0..127.
  const int a_row = tid >> 2, a_col = (tid & 3) * 8;

  auto stage_a = [&](int s) { return smem + s * TL::kStageElems; };
  auto stage_b = [&](int s) { return smem + s * TL::kStageElems + TL::kAElems; };

  auto issue_b = [&](int kt, int s) {
    const int tap = kt / nkc, c0 = (kt - tap * nkc) * kBK;
    __nv_bfloat16* bs = stage_b(s);
    constexpr int kVecPerRow = TL::kCout / 8;
#pragma unroll
    for (int i = 0; i < NF; ++i) {  // kBK * kVecPerRow / kThreads == NF
      const int v = tid + i * kThreads;
      const int r = v / kVecPerRow, cv = (v - r * kVecPerRow) * 8;
      const bool ok = c0 + r < a.Cin;
      const __nv_bfloat16* src =
          ok ? a.w + (static_cast<size_t>(tap) * a.Cin + c0 + r) * TL::kCout + cv
             : a.w;
      cp_async_16(bs + r * TL::kBLd + cv, src, ok);
    }
  };
  auto fetch = [&](int kt) {
    const int tap = kt / nkc, c0 = (kt - tap * nkc) * kBK;
    return fetch_a<PRO>(a, m0 + a_row, tap, c0 + a_col);
  };
  auto store_a = [&](uint4 v, int s) {
    *reinterpret_cast<uint4*>(stage_a(s) + a_row * kALd + a_col) = v;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  issue_b(0, 0);
  cp_async_commit();
  if (tid < 128) store_a(fetch(0), 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const bool next = kt + 1 < nk;
    uint4 a_next = make_uint4(0u, 0u, 0u, 0u);
    if (next) {
      issue_b(kt + 1, s ^ 1);
      cp_async_commit();
      if (tid < 128) a_next = fetch(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* as = stage_a(s);
    const __nv_bfloat16* bs = stage_b(s);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::load_matrix_sync(af, as + (wm * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, bs + kk * TL::kBLd + (wn * NF + j) * 16,
                               TL::kBLd);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
    if (next && tid < 128) store_a(a_next, s ^ 1);
    __syncthreads();
  }

  // Epilogue. The pipeline buffers are free (last __syncthreads above).
  float* cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(cs + (wm * 16) * TL::kCLd + (wn * NF + j) * 16,
                            acc[j], TL::kCLd, wmma::mem_row_major);
  __syncthreads();

  const int M = a.B * a.T_out;
  constexpr int kPerLane = TL::kCout / 32;
  const float inv_n = 1.0f / TL::kCout;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int gm = m0 + r;
    if (gm >= M) break;  // warp-uniform
    float v[kPerLane];
    float sum = 0.f, sumsq = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + 32 * j;
      v[j] = cs[r * TL::kCLd + c] +
             (a.bias_bf16 ? __bfloat162float(a.bias_bf16[c]) : a.bias[c]);
      sum += v[j];
      sumsq += v[j] * v[j];
    }
    if (a.use_norm) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
      }
      const float mean = sum * inv_n;
      const float var = fmaxf(sumsq * inv_n - mean * mean, 0.f);
      const float rstd = rsqrtf(var + a.eps);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int c = lane + 32 * j;
        v[j] = (v[j] - mean) * (rstd * a.scale[c]) + a.offset[c];
      }
    }
    __nv_bfloat16* orow = a.out + static_cast<size_t>(gm) * TL::kCout;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const float y = a.use_act ? fmaxf(v[j], 0.f) : v[j];
      orow[lane + 32 * j] = __float2bfloat16_rn(y);
    }
  }
}

template <int PRO, int NF>
cudaError_t launch_nf(const ConvArgs& a, cudaStream_t stream) {
  using TL = Tile<NF>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_gemm_kernel<PRO, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(TL::kSmemBytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int M = a.B * a.T_out;
  const dim3 grid((M + kBM - 1) / kBM);
  conv_gemm_kernel<PRO, NF><<<grid, kThreads, TL::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// Cout in {64, 128, 256, 512} (checked by the Python wrapper); any Cin.
template <int PRO>
cudaError_t launch_conv_gemm(const ConvArgs& a, cudaStream_t stream) {
  switch (a.Cout) {
    case 64: return launch_nf<PRO, 1>(a, stream);
    case 128: return launch_nf<PRO, 2>(a, stream);
    case 256: return launch_nf<PRO, 4>(a, stream);
    case 512: return launch_nf<PRO, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace drn
