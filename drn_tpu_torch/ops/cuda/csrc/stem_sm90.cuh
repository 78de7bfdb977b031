// The backbone stem on Hopper (sm_90a): one kernel per output tile of 64
// rows x all Cout columns, tensor cores through wgmma.
//
//   y = relu(LN(conv1d(bf16(LN(x) * s_in + b_in), w, SAME) + b) * s + o)
//
// x (M = B*T rows, Cin) fp32; w (K, Cin, Cout) bf16 WIO; y (M, Cout) bf16.
// The input LayerNorm's per-row (mean, rstd) come from a first small pass
// (row_stats_kernel in stem.cu); this kernel normalises each staged chunk
// of x in registers, so the normalised features never reach HBM.
//
// Tiling. A block owns kBM = 64 output rows (one wgmma M) and every Cout
// column, because the output LayerNorm needs whole rows. Two consumer
// warpgroups take Cout/2 columns each (wgmma m64nNk16, N = Cout/2: 256,
// 128, 64 or 32; the fp32 accumulator is N/2 registers a thread, 128 at
// Cout = 512). Where the row tiles alone would leave SMs idle, a cluster
// of two blocks shares a tile and splits its 512 columns (SPLIT = 2,
// N = 128), exchanging the LayerNorm row sums through distributed shared
// memory. The reduction runs over k-tiles of kBK = 64 channels of one
// tap, chunk-outer and tap-inner, so a chunk of x is read and normalised
// once for all K taps. A tile may cross a video boundary: each row gathers input
// row t - K/2 + tap of its own video, zero outside [0, T) (XLA SAME
// padding for odd K) and past Cin.
//
// Shared memory: a ring of stages, each an A tile (64 rows x 64 channels
// bf16, K-major) and a B tile (64 channels x Cout bf16, Cout contiguous:
// MN-major, read by wgmma with the transpose bit), both in the 128-byte
// swizzled layout the wgmma descriptors name. B is Cout/64 boxes of 64
// rows x 128 bytes; row r's 16-byte chunk j lives at chunk j ^ (r % 8).
// As many stages as fit in 227 KB, at most 8 (3 for a block of 512
// columns, 5 for 256).
//
// Pipeline: warp-specialised. A producer warpgroup (setmaxnreg down to
// Regs::kProducer) fills the ring: one thread announces the weight tile's
// bytes on the slot's "full" mbarrier and copies it with TMA (3-D tensor
// map over (K, Cin, Cout), 128-byte swizzle, zeros past Cin); all 128
// load a chunk's window of 64 + K - 1 rows of x once (every load in flight
// together, the next chunk's while this one's copies are stored),
// normalise and cast it in registers, store its K tap-shifted A tiles
// (16-byte swizzled stores), fence to the async proxy and arrive. The two
// consumer warpgroups (setmaxnreg up to Regs::kConsumer) wait on "full",
// issue the tile's four k16 wgmma, keep one group in flight, and release
// the previous slot on its "empty" mbarrier.
//
// Epilogue from the accumulator registers: + bias, row sums and sums of
// squares reduced across the 4 lanes that share a row, exchanged between
// the warpgroups through shared memory (the peer block's too, over
// distributed shared memory, when SPLIT = 2), flax LayerNorm (fast variance
// clamped at 0, eps 1e-6), * scale + offset, ReLU, bf16 store. Each of
// use_norm / use_act can be off (the backward's recompute).
#pragma once

#include "sm90.cuh"

namespace drn {
// Internal linkage, as in conv_sm90.cuh: each source is its own library,
// and a function-local "configured" flag must be one per library.
namespace {

constexpr int kBM = 64;                  // output rows per block
constexpr int kProducers = 128;          // one producer warpgroup
constexpr int kThreads = kProducers + 256;  // and two consumer warpgroups
// Registers a thread after setmaxnreg, within the launch's allocation:
// 128 x 136 + 256 x 184 <= 384 x 168 where a consumer holds 128 fp32
// accumulators, else 128 x 152 + 256 x 176.
template <int ACC>
struct Regs {
  static constexpr int kProducer = ACC > 64 ? 136 : 152;
  static constexpr int kConsumer = ACC > 64 ? 184 : 176;
};
constexpr int kUnits = 5;   // 16-byte A units a producer thread holds: 80 rows
constexpr int kMaxK = 17;   // the window kBM + K - 1 fits 16 * kUnits rows
constexpr int kMaxStages = 8;
constexpr int kATileBytes = kBM * kBK * 2;
// LayerNorm (sum, sum of squares) per row from each consumer warpgroup of
// the (up to two) blocks that share a row tile.
constexpr int kXchgBytes = 4 * kBM * 8;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;
constexpr int kAlignSlack = 1024;        // the ring starts 1024-byte aligned
constexpr int kFixedBytes = kXchgBytes + kBarrierBytes + kAlignSlack;

// Parts compiled out, for a breakdown of the kernel's time
// (drn_tpu_torch/probes/stem_parts.py builds with -DSTEM_OFF=1..7): bit 1
// the producer's A staging, 2 the weight's TMA copies, 4 the consumers'
// wgmma. Such a build computes nothing useful. 0, the default, is the
// kernel.
#ifndef STEM_OFF
#define STEM_OFF 0
#endif
constexpr bool kStageA = !(STEM_OFF & 1);
constexpr bool kCopyB = !(STEM_OFF & 2);
constexpr bool kMma = !(STEM_OFF & 4);

// Launch geometry of a block that computes 64 * NW output columns;
// drn_tpu_torch/ops/cuda/stem.py (stem_plan) computes the same and passes
// it in, the entry point checks.
template <int NW>
struct Geometry {
  static constexpr int kCout = 64 * NW;  // columns of one block
  static constexpr int kStageBytes = kATileBytes + kBK * kCout * 2;
  static constexpr int kFit = (kSmemLimit - kFixedBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = kStages * kStageBytes + kFixedBytes;
};

struct StemArgs {
  const float* x;                // (M, Cin) fp32
  const float2* stats;           // (M) (mean, rstd) of each row of x
  const float* in_scale;         // (Cin)
  const float* in_bias;          // (Cin)
  const __nv_bfloat16* w;        // (K, Cin, Cout)
  const float* bias;             // (Cout)
  const float* scale;            // (Cout)
  const float* offset;           // (Cout)
  __nv_bfloat16* out;            // (M, Cout)
  int M, T, Cin, K, n_k, use_norm, use_act;  // n_k = K * ceil(Cin / kBK)
};

// 8 channels c..c+7 of input row `row`, LayerNorm'd, scaled, shifted and
// cast to bf16, channel by channel: 16 bytes of A for the chunks the
// producer's float4 path does not take (the ragged last one, rows not
// 16-byte aligned); zero past Cin (the in_bias term included).
__device__ __forceinline__ uint4 load_a(const StemArgs& a, int row, int c) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (c >= a.Cin) return r;
  const float2 st = __ldg(a.stats + row);
  const float* xr = a.x + static_cast<size_t>(row) * a.Cin;
  float f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = c + j;
    f[j] = ch < a.Cin ? (__ldg(xr + ch) - st.x) * (st.y * __ldg(a.in_scale + ch))
                            + __ldg(a.in_bias + ch)
                      : 0.f;
  }
  r.x = pack_bf16x2(f[0], f[1]);
  r.y = pack_bf16x2(f[2], f[3]);
  r.z = pack_bf16x2(f[4], f[5]);
  r.w = pack_bf16x2(f[6], f[7]);
  return r;
}

// SPLIT = 1: a block computes all Cout = 64 * NW columns of its 64 rows.
// SPLIT = 2: a cluster of two blocks shares the row tile, block rank r
// computes columns r * 64 * NW .. of Cout = 128 * NW (both stage the same
// A; only the LayerNorm row sums cross, through distributed shared
// memory): twice the blocks where the row tiles alone leave SMs idle.
template <int NW, int SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    stem_kernel(const __grid_constant__ CUtensorMap wmap, const StemArgs a) {
  using G = Geometry<NW>;
  constexpr int kS = G::kStages;
  constexpr int kCout = G::kCout * SPLIT;  // the output row's width
  constexpr int kN = G::kCout / 2;  // columns of each consumer warpgroup
  constexpr int kAcc = kN / 2;      // fp32 accumulators a consumer thread
  constexpr uint32_t kBBytes = kBK * G::kCout * 2;
  static_assert(kS >= 3, "the pipeline needs three stages");
  static_assert(kN >= 32 && (SPLIT == 1 || SPLIT == 2), "no such wgmma");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  float2* xchg = reinterpret_cast<float2*>(ring_ptr + kS * G::kStageBytes);
  const uint32_t bars = smem_u32(xchg + 2 * SPLIT * kBM);
  auto full = [&](int s) { return bars + 8 * s; };          // tile s is in
  auto empty = [&](int s) { return bars + 8 * (kS + s); };  // slot s is read
  auto a_tile = [&](int s) { return ring + s * G::kStageBytes; };
  auto b_tile = [&](int s) { return a_tile(s) + kATileBytes; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), kProducers + 1);  // + the weight copies' arrival
      mbar_init(empty(s), 2);              // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Both blocks of a cluster are running before either writes the other's
  // shared memory.
  if (SPLIT == 2) cluster_sync(); else __syncthreads();
  const int m0 = blockIdx.x / SPLIT * kBM;
  const int rank = SPLIT == 2 ? static_cast<int>(cluster_rank()) : 0;
  const int col_base = rank * G::kCout;  // this block's first column

  if (tid < kProducers) {
    // Producer warpgroup. Thread 0 copies each weight tile with TMA. All
    // 128 stage A: a chunk's window of kBM + K - 1 input rows (rows m0 -
    // K/2 + w, w = ar + 16 i) is loaded, normalised and cast once, in
    // registers (channels 8 aj .. 8 aj + 7 of the chunk), then stored into
    // each tap's A tile at row w - tap: the tap-shifted copies. keep[i]
    // bit tap says whether that tile row takes window row w (its own
    // video's input at time t - K/2 + tap lies in [0, T)) or zeros.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Regs<kAcc>::kProducer));
    const int aj = tid & 7, ar = tid >> 3;
    const int left = (a.K - 1) >> 1, win = kBM + a.K - 1;
    int src[kUnits];
    unsigned keep[kUnits];
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int w = ar + 16 * i;
      src[i] = min(max(m0 - left + w, 0), a.M - 1);
      keep[i] = 0u;
      for (int tap = 0; tap < a.K; ++tap) {
        const int r = w - tap, gm = m0 + r;
        if (r < 0 || r >= kBM || gm >= a.M) continue;
        const int ts = gm % a.T - left + tap;
        if (ts >= 0 && ts < a.T) keep[i] |= 1u << tap;
      }
    }
    // The next chunk's window is fetched (x, row stats, scale and shift
    // in registers) while this chunk's tap copies are stored.
    const int nkc = (a.Cin + kBK - 1) / kBK;
    float4 x0[kUnits], x1[kUnits], s0, s1, o0, o1;
    float2 st[kUnits];
    auto fast = [&](int chunk) {  // 8 whole channels, 16-byte aligned rows
      return (a.Cin & 3) == 0 && chunk * kBK + 8 * aj + 8 <= a.Cin;
    };
    auto fetch = [&](int chunk) {
      const int c = chunk * kBK + 8 * aj;
      s0 = __ldg(reinterpret_cast<const float4*>(a.in_scale + c));
      s1 = __ldg(reinterpret_cast<const float4*>(a.in_scale + c + 4));
      o0 = __ldg(reinterpret_cast<const float4*>(a.in_bias + c));
      o1 = __ldg(reinterpret_cast<const float4*>(a.in_bias + c + 4));
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        if (ar + 16 * i >= win) continue;
        const float* xr = a.x + static_cast<size_t>(src[i]) * a.Cin + c;
        x0[i] = __ldg(reinterpret_cast<const float4*>(xr));
        x1[i] = __ldg(reinterpret_cast<const float4*>(xr + 4));
        st[i] = __ldg(a.stats + src[i]);
      }
    };
    if (kStageA && nkc > 0 && fast(0)) fetch(0);
    int kt = 0;
    for (int chunk = 0; chunk < nkc; ++chunk) {
      uint4 v[kUnits] = {};
      if (!kStageA) {  // compiled out: the tiles keep what they held
      } else if (fast(chunk)) {
#pragma unroll
        for (int i = 0; i < kUnits; ++i) {
          if (ar + 16 * i >= win) continue;
          const float mu = st[i].x, rs = st[i].y;
          v[i] = make_uint4(
              pack_bf16x2((x0[i].x - mu) * (rs * s0.x) + o0.x,
                          (x0[i].y - mu) * (rs * s0.y) + o0.y),
              pack_bf16x2((x0[i].z - mu) * (rs * s0.z) + o0.z,
                          (x0[i].w - mu) * (rs * s0.w) + o0.w),
              pack_bf16x2((x1[i].x - mu) * (rs * s1.x) + o1.x,
                          (x1[i].y - mu) * (rs * s1.y) + o1.y),
              pack_bf16x2((x1[i].z - mu) * (rs * s1.z) + o1.z,
                          (x1[i].w - mu) * (rs * s1.w) + o1.w));
        }
      } else {  // the ragged last chunk, or rows not 16-byte aligned
        const int c = chunk * kBK + 8 * aj;
#pragma unroll
        for (int i = 0; i < kUnits; ++i)
          if (ar + 16 * i < win) v[i] = load_a(a, src[i], c);
      }
      if (kStageA && chunk + 1 < nkc && fast(chunk + 1)) fetch(chunk + 1);
      for (int tap = 0; tap < a.K; ++tap, ++kt) {
        const int s = kt % kS;
        if (kt >= kS) mbar_wait(empty(s), (kt / kS - 1) & 1);
        if (tid == 0 && !kCopyB) mbar_arrive(full(s));
        if (tid == 0 && kCopyB) {
          mbar_arrive_expect_tx(full(s), kBBytes);
#pragma unroll
          for (int nb = 0; nb < NW; ++nb)
            tma_load_3d(b_tile(s) + nb * (kBK * 128), &wmap, full(s),
                        col_base + 64 * nb, chunk * kBK, tap);
        }
        unsigned char* at = ring_ptr + s * G::kStageBytes;
#pragma unroll
        for (int i = 0; i < (kStageA ? kUnits : 0); ++i) {
          const int r = ar + 16 * i - tap;
          if (r < 0 || r >= kBM) continue;
          *reinterpret_cast<uint4*>(at + r * 128 + ((aj ^ (r & 7)) << 4)) =
              (keep[i] >> tap) & 1u ? v[i] : make_uint4(0u, 0u, 0u, 0u);
        }
        // A was written through the generic proxy; wgmma reads through the
        // async one.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full(s));
      }
    }
    if (SPLIT == 2) cluster_sync();  // the consumers' LayerNorm exchange
  } else {
    // Consumer warpgroups: columns wg * kN .. of the block's tile. At Cout
    // = 64 each takes half of the one 64-column box (a 64-byte start
    // offset inside the swizzle row, as the k16 steps of A take 32-byte
    // offsets).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Regs<kAcc>::kConsumer));
    const int ct = tid - kProducers, wg = ct >> 7;
    const uint32_t b_col = (wg * kN / 64) * (kBK * 128) + (wg * kN % 64) * 2;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < a.n_k; ++kt) {
      const int s = kt % kS;
      mbar_wait(full(s), (kt / kS) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (kMma ? kBK / 16 : 0); ++kk)
        wgmma<kN>(acc, make_desc(a_tile(s) + kk * 32, 16, 1024),
                  make_desc(b_tile(s) + b_col + kk * 2048, kBK * 128, 1024));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // tile kt - 1's products are done: release its slot
      fence_acc(acc);
      if (kt > 0 && (ct & 127) == 0) mbar_arrive(empty((kt - 1) % kS));
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Epilogue. acc[4 n8 + e] is row r0 (e < 2) or r0 + 8 (e >= 2),
    // column col0 + 8 n8 + (e & 1) of the tile.
    const int lane = ct & 31;
    const int r0 = ((ct >> 5) & 3) * 16 + (lane >> 2);
    const int col0 = col_base + wg * kN + (lane & 3) * 2;
    float s0 = 0.f, q0 = 0.f, s1 = 0.f, q1 = 0.f;
#pragma unroll
    for (int n8 = 0; n8 < kN / 8; ++n8) {
      const float2 bb =
          __ldg(reinterpret_cast<const float2*>(a.bias + col0 + 8 * n8));
      acc[4 * n8] += bb.x;
      acc[4 * n8 + 1] += bb.y;
      acc[4 * n8 + 2] += bb.x;
      acc[4 * n8 + 3] += bb.y;
      s0 += acc[4 * n8] + acc[4 * n8 + 1];
      q0 += acc[4 * n8] * acc[4 * n8] + acc[4 * n8 + 1] * acc[4 * n8 + 1];
      s1 += acc[4 * n8 + 2] + acc[4 * n8 + 3];
      q1 += acc[4 * n8 + 2] * acc[4 * n8 + 2] + acc[4 * n8 + 3] * acc[4 * n8 + 3];
    }
    if (a.use_norm) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        q0 += __shfl_xor_sync(0xffffffffu, q0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        q1 += __shfl_xor_sync(0xffffffffu, q1, o);
      }
      // Each consumer warpgroup of the row tile (two, or four over a
      // cluster) writes its partial sums to slot 2 * rank + wg, in this
      // block and in the peer; all add every slot in the same order.
      if ((lane & 3) == 0) {
        const int p = 2 * rank + wg;
        xchg[p * kBM + r0] = make_float2(s0, q0);
        xchg[p * kBM + r0 + 8] = make_float2(s1, q1);
        if (SPLIT == 2) {
          st_peer(xchg + p * kBM + r0, rank ^ 1, make_float2(s0, q0));
          st_peer(xchg + p * kBM + r0 + 8, rank ^ 1, make_float2(s1, q1));
        }
      }
    }
    if (SPLIT == 2)
      cluster_sync();
    else if (a.use_norm)
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * 128) : "memory");  // consumers
    if (a.use_norm) {
      s0 = q0 = s1 = q1 = 0.f;
#pragma unroll
      for (int p = 0; p < 2 * SPLIT; ++p) {
        const float2 v0 = xchg[p * kBM + r0], v1 = xchg[p * kBM + r0 + 8];
        s0 += v0.x;
        q0 += v0.y;
        s1 += v1.x;
        q1 += v1.y;
      }
      const float inv_n = 1.0f / kCout;
      const float mean0 = s0 * inv_n, mean1 = s1 * inv_n;
      const float rstd0 =
          rsqrtf(fmaxf(q0 * inv_n - mean0 * mean0, 0.f) + kLnEps);
      const float rstd1 =
          rsqrtf(fmaxf(q1 * inv_n - mean1 * mean1, 0.f) + kLnEps);
#pragma unroll
      for (int n8 = 0; n8 < kN / 8; ++n8) {
        const int c = col0 + 8 * n8;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(a.scale + c));
        const float2 of = __ldg(reinterpret_cast<const float2*>(a.offset + c));
        acc[4 * n8] = (acc[4 * n8] - mean0) * (rstd0 * sc.x) + of.x;
        acc[4 * n8 + 1] = (acc[4 * n8 + 1] - mean0) * (rstd0 * sc.y) + of.y;
        acc[4 * n8 + 2] = (acc[4 * n8 + 2] - mean1) * (rstd1 * sc.x) + of.x;
        acc[4 * n8 + 3] = (acc[4 * n8 + 3] - mean1) * (rstd1 * sc.y) + of.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + r0 + 8 * h;
      if (gm >= a.M) continue;
      __nv_bfloat16* orow = a.out + static_cast<size_t>(gm) * kCout + col0;
#pragma unroll
      for (int n8 = 0; n8 < kN / 8; ++n8) {
        float y0 = acc[4 * n8 + 2 * h], y1 = acc[4 * n8 + 2 * h + 1];
        if (a.use_act) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(orow + 8 * n8) = pack_bf16x2(y0, y1);
      }
    }
  }
}

template <int NW, int SPLIT>
cudaError_t launch_nw(const StemArgs& a, int stages, int smem_bytes, int grid,
                      cudaStream_t stream) {
  using G = Geometry<NW>;
  if (stages != G::kStages || smem_bytes != G::kSmemBytes)
    return cudaErrorInvalidValue;
  bind_context();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        stem_kernel<NW, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::kSmemBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap wmap;
  cudaError_t e = weight_map(&wmap, a.w, a.K, a.Cin, G::kCout * SPLIT);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = G::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = SPLIT;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = SPLIT == 2 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, stem_kernel<NW, SPLIT>, wmap, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The geometry computed by the caller (rows, depth, split, stages,
// shared-memory bytes, grid) must be the one this source instantiates.
cudaError_t launch_stem(const StemArgs& a, int cout, int rows, int depth,
                        int split, int stages, int smem_bytes, int grid,
                        cudaStream_t stream) {
  if (rows != kBM || depth != kBK || (split != 1 && split != 2) ||
      grid != split * ((a.M + kBM - 1) / kBM) || a.K % 2 == 0 || a.K > kMaxK)
    return cudaErrorInvalidValue;
  if (split == 2)  // built for the one width it was measured to help
    return cout == 512 ? launch_nw<4, 2>(a, stages, smem_bytes, grid, stream)
                       : cudaErrorInvalidValue;
  switch (cout) {
    case 64: return launch_nw<1, 1>(a, stages, smem_bytes, grid, stream);
    case 128: return launch_nw<2, 1>(a, stages, smem_bytes, grid, stream);
    case 256: return launch_nw<4, 1>(a, stages, smem_bytes, grid, stream);
    case 512: return launch_nw<8, 1>(a, stages, smem_bytes, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace drn
