// conv1d + bias + LayerNorm + ReLU on Hopper (sm_90a): one kernel per
// output tile of 64 rows x all Cout columns, tensor cores through wgmma.
//
//   y = relu(LN(conv1d(x, w, SAME, stride) + b) * s + o)
//
// x (B, T, Cin) bf16; w (K, Cin, Cout) bf16 WIO; y (M = B*T_out, Cout)
// bf16. Output rows are the flattened (b, t_out) pairs. Any Cin, K >= 1,
// stride >= 1, T; Cout in {64, 128, 256, 512}.
//
// Tiling. A block owns kBM = 64 output rows (one wgmma M) and every Cout
// column of its share, because the output LayerNorm needs whole rows. Two
// consumer warpgroups take half the block's columns each (wgmma m64nNk16,
// N = 256, 128, 64 or 32; the fp32 accumulator is N/2 registers a
// thread). Where the row tiles alone would leave SMs idle, a cluster of
// SPLIT blocks (2 or 4, Cout 512) shares a tile and splits its columns,
// exchanging the LayerNorm row sums through distributed shared memory.
// The reduction runs over k-tiles of kBK = 64 channels of one tap,
// chunk-outer and tap-inner, so a chunk of a row is read K times in a
// row (from L1/L2).
//
// A is gathered row by row: k-tile (chunk, tap), tile row r is output row
// gm = m0 + r, video b = gm / T_out, input row t_out * stride - left +
// tap of video b (XLA SAME padding, asymmetric for stride 2, `left` from
// the caller); zero outside [0, T), past Cin and for gm >= M. A tile may
// cross video boundaries and the last one may be ragged.
//
// Shared memory: a ring of stages, each an A tile (64 rows x 64 channels
// bf16, K-major) and a B tile (64 channels x the block's columns,
// MN-major, read by wgmma with the transpose bit), both in the 128-byte
// swizzled layout the wgmma descriptors name; row r's 16-byte chunk j
// lives at chunk j ^ (r % 8). As many stages as fit in 227 KB, at most
// kMaxStages (3 for a block of 512 columns, 5 for 256, 8 for 128).
//
// Pipeline: warp-specialised. A producer warpgroup (setmaxnreg down to
// kProducerRegs) fills the ring. One thread announces the weight tile's
// bytes on the slot's "full" mbarrier and copies it with TMA (3-D tensor
// map over (K, Cin, Cout), 128-byte swizzle, zeros past Cin). Where K = 1,
// stride 1 and rows are 16-byte aligned (TMA_A: the FPN laterals, the IoU
// mixes), output row gm reads input row gm, so the same thread copies A
// by TMA too, a box of 64 rows of x seen as (B*T, Cin), and the slot's
// barrier waits for that thread alone. Otherwise all 128 copy A: four
// 16-byte units each, with cp.async straight into the swizzled slot
// (zero-filled where the row is padding), or, where rows are not 16-byte
// aligned (Cin % 8 != 0), channel by channel through registers; a thread
// keeps kLag k-tiles of copies in flight, and when the oldest has landed
// (cp.async.wait_group) it fences the slot to the async proxy, which wgmma
// reads through, and arrives on its "full" mbarrier. The two consumer
// warpgroups (setmaxnreg up to kConsumerRegs) wait on "full", issue the
// tile's four k16 wgmma, keep one group in flight, and release the
// previous slot on its "empty" mbarrier.
//
// Epilogue from the accumulator registers: + bias, row sums and sums of
// squares reduced across the 4 lanes that share a row, exchanged between
// the warpgroups through shared memory (and every block of the cluster
// over distributed shared memory when SPLIT > 1), flax LayerNorm (fast
// variance clamped at 0, eps 1e-6), * scale + offset, ReLU; the bf16 tile
// is staged in the (by then idle) ring and stored 16 bytes a thread, each
// warp writing whole rows. Each of use_norm / use_act can be off (the
// backward's recompute, the fusion backward's dx conv, the FPN laterals).
#pragma once

#include "sm90.cuh"

namespace drn {
namespace {

constexpr int kBM = 64;                  // output rows per block
constexpr int kProducers = 128;          // one producer warpgroup
constexpr int kThreads = kProducers + 256;  // and two consumer warpgroups
// Registers a thread after setmaxnreg, within the launch's allocation of
// 384 x 168: the producer holds addresses only, a consumer up to 128 fp32
// accumulators.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
// 16-byte A units a producer thread copies per k-tile: 64 rows x 8.
constexpr int kUnits = kBM * kBK * 2 / 16 / kProducers;
constexpr int kMaxSplit = 4;
constexpr int kMaxStages = 8;
constexpr int kMaxLag = 3;  // a deeper lag was no faster on an H100
constexpr int kATileBytes = kBM * kBK * 2;
// LayerNorm (sum, sum of squares) per row from each consumer warpgroup of
// the (up to four) blocks that share a row tile.
constexpr int kXchgBytes = 2 * kMaxSplit * kBM * 8;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;
constexpr int kAlignSlack = 1024;        // the ring starts 1024-byte aligned
constexpr int kFixedBytes = kXchgBytes + kBarrierBytes + kAlignSlack;

// Launch geometry of a block that computes 64 * NW output columns. The
// entry point launches only what it derives here; the caller chooses the
// split (ops/cuda/conv_block.py::conv_plan) and hence the grid.
template <int NW>
struct Geometry {
  static constexpr int kCout = 64 * NW;  // columns of one block
  static constexpr int kStageBytes = kATileBytes + kBK * kCout * 2;
  static constexpr int kFit = (kSmemLimit - kFixedBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = kStages * kStageBytes + kFixedBytes;
  // k-tiles of A copies in flight per producer thread. A consumer
  // releases a slot one tile late (it keeps one wgmma group in flight),
  // so more than kStages - 2 would deadlock the ring.
  static constexpr int kLag = kStages - 2 < kMaxLag ? kStages - 2 : kMaxLag;
};

struct ConvArgs {
  const __nv_bfloat16* x;        // (B, T, Cin)
  const __nv_bfloat16* w;        // (K, Cin, Cout)
  const float* bias;             // (Cout)
  const float* scale;            // (Cout)
  const float* offset;           // (Cout)
  __nv_bfloat16* out;            // (M, Cout)
  int M, T, T_out, Cin, K, stride, left, use_norm, use_act;
  int nkc;                       // ceil(Cin / kBK): k-tiles per tap
};

// 16 bytes global -> shared, asynchronously; `bytes` = 0 zero-fills them.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's latest groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Channels c..c+7 of an input row that is not 16-byte aligned (Cin % 8 !=
// 0: activitynet_c3d's 500 features), one at a time; zero past Cin.
__device__ __forceinline__ uint4 load_unaligned(const __nv_bfloat16* row,
                                                int c, int cin) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c + j < cin) v[j >> 1] |= static_cast<uint32_t>(__ldg(h + c + j))
                                  << (16 * (j & 1));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// SPLIT = 1: a block computes all Cout = 64 * NW columns of its 64 rows.
// SPLIT = 2 or 4: a cluster of SPLIT blocks shares the row tile, block
// rank r computes columns r * 64 * NW .. of Cout = 64 * NW * SPLIT (each
// stages the same A; only the LayerNorm row sums cross, through
// distributed shared memory): SPLIT times the blocks where the row tiles
// alone leave SMs idle. TMA_A: A comes by TMA through `xmap` (K = 1,
// stride 1, Cin % 8 == 0); otherwise `xmap` is not read.
template <int NW, int SPLIT, bool TMA_A>
__global__ void __launch_bounds__(kThreads, 1)
    conv_ln_relu_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap,
                        const ConvArgs a) {
  using G = Geometry<NW>;
  constexpr int kS = G::kStages;
  constexpr int kLag = G::kLag;
  constexpr int kCout = G::kCout * SPLIT;  // the output row's width
  constexpr int kN = G::kCout / 2;  // columns of each consumer warpgroup
  constexpr int kAcc = kN / 2;      // fp32 accumulators a consumer thread
  constexpr uint32_t kBBytes = kBK * G::kCout * 2;
  constexpr uint32_t kTileBytes = kBBytes + (TMA_A ? kATileBytes : 0);
  static_assert(kS >= 3 && kLag >= 1, "the pipeline needs three stages");
  static_assert(kN >= 32 && SPLIT <= kMaxSplit, "no such wgmma");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  float2* xchg = reinterpret_cast<float2*>(ring_ptr + kS * G::kStageBytes);
  const uint32_t bars = smem_u32(xchg + 2 * kMaxSplit * kBM);
  auto full = [&](int s) { return bars + 8 * s; };          // tile s is in
  auto empty = [&](int s) { return bars + 8 * (kS + s); };  // slot s is read
  auto a_tile = [&](int s) { return ring + s * G::kStageBytes; };
  auto b_tile = [&](int s) { return a_tile(s) + kATileBytes; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      // The copying thread's arrival, + every producer's with cp.async.
      mbar_init(full(s), TMA_A ? 1 : kProducers + 1);
      mbar_init(empty(s), 2);              // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block of a cluster is running before any writes another's
  // shared memory.
  if (SPLIT > 1) cluster_sync(); else __syncthreads();
  const int m0 = blockIdx.x / SPLIT * kBM;
  const int rank = SPLIT > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int col_base = rank * G::kCout;  // this block's first column
  const int n_k = a.K * a.nkc;

  if (tid < kProducers) {
    // Producer warpgroup.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (TMA_A) {
      // Thread 0 copies both tiles of every k-tile (K = 1: k-tile kt is
      // channels kt * kBK ..); the rest only join the cluster's barrier.
      for (int kt = 0; kt < n_k && tid == 0; ++kt) {
        const int s = kt % kS;
        if (kt >= kS) mbar_wait(empty(s), (kt / kS - 1) & 1);
        mbar_arrive_expect_tx(full(s), kTileBytes);
#pragma unroll
        for (int nb = 0; nb < NW; ++nb)
          tma_load_3d(b_tile(s) + nb * (kBK * 128), &wmap, full(s),
                      col_base + 64 * nb, kt * kBK, 0);
        tma_load_3d(a_tile(s), &xmap, full(s), kt * kBK, m0, 0);
      }
      __syncwarp();  // warp 0 meets again before the aligned barrier
      if (SPLIT > 1) cluster_sync();  // the consumers' LayerNorm exchange
      return;
    }
    // Thread 0 copies each weight tile with TMA. All 128 copy A: 16-byte
    // unit aj (channels 8 aj .. 8 aj + 7 of the chunk) of tile rows ar +
    // 16 i. vrow[i] is that row's video's first input row, t0[i] its input
    // time at tap 0 (T for a row past M: never in [0, T)).
    const int aj = tid & 7, ar = tid >> 3;
    int vrow[kUnits], t0[kUnits];
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int gm = m0 + ar + 16 * i;
      const int b = gm / a.T_out;
      vrow[i] = b * a.T;
      t0[i] = gm < a.M ? (gm - b * a.T_out) * a.stride - a.left : a.T;
    }
    // Swizzled offset of unit aj in row ar + 16 i: (ar + 16 i) % 8 is ar % 8.
    const uint32_t unit = ar * 128 + ((aj ^ (ar & 7)) << 4);
    const bool aligned = (a.Cin & 7) == 0;
    int kt = 0;
    for (int chunk = 0; chunk < a.nkc; ++chunk) {
      const int c = chunk * kBK + 8 * aj;
      for (int tap = 0; tap < a.K; ++tap, ++kt) {
        const int s = kt % kS;
        if (kt >= kS) mbar_wait(empty(s), (kt / kS - 1) & 1);
        if (tid == 0) {
          mbar_arrive_expect_tx(full(s), kTileBytes);
#pragma unroll
          for (int nb = 0; nb < NW; ++nb)
            tma_load_3d(b_tile(s) + nb * (kBK * 128), &wmap, full(s),
                        col_base + 64 * nb, chunk * kBK, tap);
        }
#pragma unroll
        for (int i = 0; i < kUnits; ++i) {
          const int ts = t0[i] + tap;
          const bool ok = c < a.Cin && ts >= 0 && ts < a.T;
          const __nv_bfloat16* row =
              a.x + static_cast<size_t>(vrow[i] + (ok ? ts : 0)) * a.Cin;
          const uint32_t dst = a_tile(s) + unit + i * 16 * 128;
          if (aligned) {
            cp_async_16(dst, ok ? row + c : a.x, ok ? 16u : 0u);
          } else {
            const uint4 v = ok ? load_unaligned(row, c, a.Cin)
                               : make_uint4(0u, 0u, 0u, 0u);
            *reinterpret_cast<uint4*>(ring_ptr + (dst - ring)) = v;
          }
        }
        cp_async_commit();
        if (kt >= kLag) {
          // Tile kt - kLag's copies have landed; A was written through the
          // generic proxy, wgmma reads through the async one.
          cp_async_wait<kLag>();
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full((kt - kLag) % kS));
        }
      }
    }
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int j = n_k > kLag ? n_k - kLag : 0; j < n_k; ++j)
      mbar_arrive(full(j % kS));
    if (SPLIT > 1) cluster_sync();  // the consumers' LayerNorm exchange
  } else {
    // Consumer warpgroups: columns wg * kN .. of the block's tile. At Cout
    // = 64 each takes half of the one 64-column box (a 64-byte start
    // offset inside the swizzle row, as the k16 steps of A take 32-byte
    // offsets).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = tid - kProducers, wg = ct >> 7;
    const uint32_t b_col = (wg * kN / 64) * (kBK * 128) + (wg * kN % 64) * 2;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kS;
      mbar_wait(full(s), (kt / kS) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
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
      // Each consumer warpgroup of the row tile (2 * SPLIT over the
      // cluster) writes its partial sums to slot 2 * rank + wg, in this
      // block and in every peer; all add every slot in the same order.
      if ((lane & 3) == 0) {
        const int p = 2 * rank + wg;
        xchg[p * kBM + r0] = make_float2(s0, q0);
        xchg[p * kBM + r0 + 8] = make_float2(s1, q1);
#pragma unroll
        for (int d = 1; d < SPLIT; ++d) {
          const uint32_t peer = (rank + d) % SPLIT;
          st_peer(xchg + p * kBM + r0, peer, make_float2(s0, q0));
          st_peer(xchg + p * kBM + r0 + 8, peer, make_float2(s1, q1));
        }
      }
    }
    if (SPLIT > 1)
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
    // The bf16 tile goes through the ring, rows of kPitch bytes, 16-byte
    // chunk j of row r at chunk j ^ (r % 8) (no bank conflicts either
    // way): every wgmma of both warpgroups has completed by the barrier
    // before (the LayerNorm exchange's, or this one), and every copy into
    // the ring has landed.
    if (SPLIT == 1 && !a.use_norm)
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * 128) : "memory");
    constexpr int kPitch = G::kCout * 2;
    constexpr int kChunks = G::kCout / 8;  // 16-byte chunks of a row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
#pragma unroll
      for (int n8 = 0; n8 < kN / 8; ++n8) {
        float y0 = acc[4 * n8 + 2 * h], y1 = acc[4 * n8 + 2 * h + 1];
        if (a.use_act) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        const int j = wg * kN / 8 + n8;
        *reinterpret_cast<uint32_t*>(ring_ptr + r * kPitch +
                                     ((j ^ (r & 7)) << 4) + (lane & 3) * 4) =
            pack_bf16x2(y0, y1);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(2 * 128) : "memory");
#pragma unroll 4
    for (int i = ct; i < kBM * kChunks; i += 256) {
      const int r = i / kChunks, j = i % kChunks, gm = m0 + r;
      if (gm >= a.M) continue;
      *reinterpret_cast<uint4*>(a.out + static_cast<size_t>(gm) * kCout +
                                col_base + 8 * j) =
          *reinterpret_cast<const uint4*>(ring_ptr + r * kPitch +
                                          ((j ^ (r & 7)) << 4));
    }
  }
}

template <int NW, int SPLIT, bool TMA_A>
cudaError_t launch_kernel(const ConvArgs& a, int grid, cudaStream_t stream) {
  using G = Geometry<NW>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_ln_relu_kernel<NW, SPLIT, TMA_A>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap wmap, xmap;
  cudaError_t e = weight_map(&wmap, a.w, a.K, a.Cin, G::kCout * SPLIT);
  if (e != cudaSuccess) return e;
  // x as (B*T, Cin) in the weight map's layout with one tap: boxes of kBK
  // channels x 64 rows, zeros past Cin and past the last row.
  static_assert(kBK == kBM, "a box of the weight's map is kBK rows");
  xmap = wmap;
  if (TMA_A && (e = weight_map(&xmap, a.x, 1, a.M, a.Cin)) != cudaSuccess)
    return e;
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
  cfg.numAttrs = SPLIT > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, conv_ln_relu_kernel<NW, SPLIT, TMA_A>, wmap,
                         xmap, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// A by TMA where output row gm reads input row gm and rows are 16-byte
// aligned; by cp.async otherwise.
template <int NW, int SPLIT>
cudaError_t launch_nw(const ConvArgs& a, int grid, cudaStream_t stream) {
  return a.K == 1 && a.stride == 1 && (a.Cin & 7) == 0
             ? launch_kernel<NW, SPLIT, true>(a, grid, stream)
             : launch_kernel<NW, SPLIT, false>(a, grid, stream);
}

// The caller's split and grid must be ones this source builds: a split of
// Cout 512 over 2 or 4 blocks, else one block a tile; grid = split *
// ceil(M / kBM).
cudaError_t launch_conv(const ConvArgs& a, int cout, int split, int grid,
                        cudaStream_t stream) {
  if (grid != split * ((a.M + kBM - 1) / kBM) || grid <= 0)
    return cudaErrorInvalidValue;
  if (split == 2)
    return cout == 512 ? launch_nw<4, 2>(a, grid, stream) : cudaErrorInvalidValue;
  if (split == 4)
    return cout == 512 ? launch_nw<2, 4>(a, grid, stream) : cudaErrorInvalidValue;
  if (split != 1) return cudaErrorInvalidValue;
  switch (cout) {
    case 64: return launch_nw<1, 1>(a, grid, stream);
    case 128: return launch_nw<2, 1>(a, grid, stream);
    case 256: return launch_nw<4, 1>(a, grid, stream);
    case 512: return launch_nw<8, 1>(a, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace drn
