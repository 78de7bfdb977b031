// conv1d + bias + LayerNorm + ReLU on Hopper (sm_90a): one kernel per
// output tile of 64 rows x all Cout columns, tensor cores through wgmma.
//
//   y = relu(LN(conv1d(x, w, SAME, stride) + b) * s + o)
//
// x (B, T, Cin) bf16; w (K, Cin, Cout) bf16 WIO; y (M = B*T_out, Cout)
// bf16. Output rows are the flattened (b, t_out) pairs. Any Cin, K >= 1,
// stride >= 1, T; Cout in {64, 128, 256, 512}. The Hadamard variant
// (fused_fusion.cu, block_probe.cu) convolves x = v * q[b] instead, the
// product of each row of v (B, T, Cin) with its own video's query q (B,
// Cin), rounded to bf16 once and formed while A is staged, so it never
// reaches HBM.
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
// Regs::kProducer) fills the ring. One thread announces the weight tile's
// bytes on the slot's "full" mbarrier and copies it with TMA (3-D tensor
// map over (K, Cin, Cout), 128-byte swizzle, zeros past Cin). Where K = 1,
// stride 1 and rows are 16-byte aligned (kTmaA: the FPN laterals, the IoU
// mixes), output row gm reads input row gm, so the same thread copies A
// by TMA too, a box of 64 rows of x seen as (B*T, Cin), and the slot's
// barrier waits for that thread alone. Otherwise all 128 copy A: four
// 16-byte units each, with cp.async straight into the swizzled slot
// (zero-filled where the row is padding), or, where rows are not 16-byte
// aligned (Cin % 8 != 0), channel by channel through registers; a thread
// keeps kLag k-tiles of copies in flight, and when the oldest has landed
// (cp.async.wait_group) it fences the slot to the async proxy, which wgmma
// reads through, and arrives on its "full" mbarrier. The Hadamard
// variant (stride 1, K <= kMaxK, any left) loads a chunk's window of 64 +
// K - 1 rows of v once into registers (ld.global.nc, the next chunk's while
// this one's tiles are stored), each row with its own video's 8 channels
// of q, multiplies in fp32, packs to bf16 and stores the K tap-shifted A
// tiles 16 bytes at a time, then fences and arrives; it never takes TMA
// for A, which would copy v without q. The two consumer
// warpgroups (setmaxnreg up to Regs::kConsumer) wait on "full", issue the
// tile's four k16 wgmma, keep one group in flight, and release the
// previous slot on its "empty" mbarrier.
//
// Epilogue from the accumulator registers: + bias (fp32, or bf16 widened
// to fp32 in the probe's block, a compile-time variant), row sums and sums of
// squares reduced across the 4 lanes that share a row, exchanged between
// the warpgroups through shared memory (and every block of the cluster
// over distributed shared memory when SPLIT > 1), flax LayerNorm (fast
// variance clamped at 0, eps 1e-6 unless the caller sets another), *
// scale + offset, ReLU; the bf16 tile is staged in the (by then idle) ring
// and stored 16 bytes a thread, each warp writing whole rows. Each of
// use_norm / use_act can be off (the fusion backward's dx conv, the FPN
// laterals, the split epilogue of the model axis).
//
// The backward epilogue (BWD, a kernel of its own; one block a row tile,
// never a cluster, so a row's sums stay in the block): the same conv + bias
// in the accumulators, the same mean and rstd, then the VJP of relu?(LN(.))
// for the output cotangent g (M, Cout) bf16, which is copied into the ring
// by cp.async while the row statistics are formed. With x^ = (acc - mean) *
// rstd, y the forward's pre-ReLU output and gh = g * [y > 0 where use_act] *
// scale, two more row sums (sum gh, sum gh * x^: 4 lanes, then the two
// warpgroups through xchg) give
//   dpre = rstd * (gh - mean(gh) - x^ * mean(gh * x^)),
// rounded as rstd * gh - rstd * (mean(gh) + x^ * mean(gh * x^)), the order
// the plain version keeps (ops/cuda/conv_block.py::ln_relu_vjp); the x^
// term is off where the fast variance clamps, as autograd's clamp_min
// gives it. dpre is written once in bf16 through the ring. Each tile's
// column sums of g * mask * x^ (dscale), g * mask (doffset) and the fp32
// dpre (db) go to partials (tiles, 3, Cout): each thread adds its two rows,
// stores them in the ring by row group, and one thread a column adds the 32
// groups in order; `column_sums_kernel` then adds the tiles in order. No
// atomics: the sums are the same from run to run.
#pragma once

#include "sm90.cuh"

namespace drn {
namespace {

constexpr int kBM = 64;                  // output rows per block
constexpr int kProducers = 128;          // one producer warpgroup
constexpr int kThreads = kProducers + 256;  // and two consumer warpgroups
// Where a k-tile's A comes from; each is a kernel of its own.
enum ASource {
  kGatherA,    // x row by row, cp.async
  kTmaA,       // x by TMA: K = 1, stride 1, 16-byte aligned rows
  kHadamardA,  // v * q[b] row by row, through registers
};
// Registers a thread after setmaxnreg, within the launch's allocation of
// 384 x 168 (128 x P + 256 x C <= 384 x 168): a gathering producer holds
// addresses only, a consumer up to ACC = 128 fp32 accumulators; the
// Hadamard producer holds a chunk's product and the next chunk's window of
// v and q besides (60 registers), so it takes the stem's split.
template <int A, int ACC>
struct Regs {
  static constexpr int kProducer = A != kHadamardA ? 56 : ACC > 64 ? 136 : 152;
  static constexpr int kConsumer = A != kHadamardA ? 224 : ACC > 64 ? 184 : 176;
};
// 16-byte A units a producer thread copies per k-tile: 64 rows x 8.
constexpr int kUnits = kBM * kBK * 2 / 16 / kProducers;
// The Hadamard producer's window: 16-byte units a thread holds, 80 rows,
// so kBM + K - 1 rows for K up to kMaxK.
constexpr int kWinUnits = 5;
constexpr int kMaxK = 16 * kWinUnits - kBM + 1;
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
  const __nv_bfloat16* x;        // (B, T, Cin): v for kHadamardA
  const __nv_bfloat16* q;        // (B, Cin), read by kHadamardA alone
  const __nv_bfloat16* w;        // (K, Cin, Cout)
  const float* bias;             // (Cout), unless BF16_BIAS
  const __nv_bfloat16* bias_bf16;  // (Cout), read instead where BF16_BIAS
  const float* scale;            // (Cout)
  const float* offset;           // (Cout)
  __nv_bfloat16* out;            // (M, Cout): dpre where BWD
  int M, T, T_out, Cin, K, stride, left, use_norm, use_act;
  int nkc;                       // ceil(Cin / kBK): k-tiles per tap
  float eps = kLnEps;            // LayerNorm epsilon; `ConvArgs a{}` keeps it
  const __nv_bfloat16* g;        // (M, Cout), read where BWD alone
  float* partials;               // (tiles, 3, Cout), written where BWD alone
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

// 8 channels of v times the same 8 of q: bf16 x bf16 is exact in fp32, so
// one rounding to bf16, as the plain version's bf16 multiply.
__device__ __forceinline__ uint4 hadamard(uint4 v, uint4 q) {
  const uint32_t* vv = reinterpret_cast<const uint32_t*>(&v);
  const uint32_t* qq = reinterpret_cast<const uint32_t*>(&q);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(vv + i));
    const float2 fq = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(qq + i));
    r[i] = pack_bf16x2(fv.x * fq.x, fv.y * fq.y);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Row groups of the backward's column sums: a warp of a consumer warpgroup
// holds 8 groups of two rows (r0 and r0 + 8), so 32 over the tile, each one
// row of kCout + 8 floats (the 8 spread a warp's stores over the banks).
constexpr int kGroups = 32;
template <int kCout>
__host__ __device__ constexpr int bwd_epilogue_bytes() {
  return kBM * kCout * 2 + 2 * kGroups * (kCout + 8) * 4;
}

// The backward epilogue (BWD), after the forward's bias add and row sums
// have been exchanged (xchg slots 0 and 1): acc holds conv + bias of rows
// r0 (e < 2) and r0 + 8 (e >= 2), columns col0 + 8 n8 + (e & 1). The ring
// (at `ring`, `ring_ptr` in the generic space) is free. Writes dpre (bf16)
// to a.out and this tile's three column sums to a.partials.
template <int kCout>
__device__ __forceinline__ void ln_relu_vjp(float (&acc)[kCout / 4],
                                            float2* xchg, uint32_t ring,
                                            unsigned char* ring_ptr,
                                            const ConvArgs& a, int m0, int ct,
                                            int wg, int lane, int r0,
                                            int col0) {
  constexpr int kN = kCout / 2;  // columns of each consumer warpgroup
  constexpr int kPitch = kCout * 2;
  constexpr int kChunks = kCout / 8;
  constexpr int kColPitch = kCout + 8;
  float* cols = reinterpret_cast<float*>(ring_ptr + kBM * kPitch);
  auto consumers_sync = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(2 * 128) : "memory");
  };
  // g's tile into the ring, laid out as the output tile (zeros past M).
  for (int i = ct; i < kBM * kChunks; i += 256) {
    const int r = i / kChunks, j = i % kChunks, gm = m0 + r;
    cp_async_16(ring + r * kPitch + ((j ^ (r & 7)) << 4),
                gm < a.M ? a.g + static_cast<size_t>(gm) * kCout + 8 * j
                         : a.g,
                gm < a.M ? 16u : 0u);
  }
  cp_async_commit();
  float s0 = 0.f, q0 = 0.f, s1 = 0.f, q1 = 0.f;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float2 v0 = xchg[p * kBM + r0], v1 = xchg[p * kBM + r0 + 8];
    s0 += v0.x;
    q0 += v0.y;
    s1 += v1.x;
    q1 += v1.y;
  }
  const float inv_n = 1.0f / kCout;
  const float mean[2] = {s0 * inv_n, s1 * inv_n};
  const float var[2] = {q0 * inv_n - mean[0] * mean[0],
                        q1 * inv_n - mean[1] * mean[1]};
  const float rstd[2] = {rsqrtf(fmaxf(var[0], 0.f) + a.eps),
                         rsqrtf(fmaxf(var[1], 0.f) + a.eps)};
  // Position of (row r0 + 8 h, columns n8) in the bf16 tile: 16-byte chunk
  // j = j0 + n8 of row r lives at j ^ (r % 8), and r % 8 = r0 % 8 < 8 only
  // flips the low 3 bits of j (j0 a multiple of 8, or n8 < 8), so chunk
  // n8 = 8 m + k sits 8 m chunks past chunk k: 2 x 8 row bases.
  constexpr int kBases = kN / 8 < 8 ? kN / 8 : 8;
  unsigned char* base[2][kBases];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < kBases; ++k)
      base[h][k] = ring_ptr + (r0 + 8 * h) * kPitch + (lane & 3) * 4 +
                   (((wg * kN / 8 + k) ^ (r0 & 7)) << 4);
  auto at = [&](int h, int n8) {
    return reinterpret_cast<uint32_t*>(base[h][n8 % 8] + (n8 / 8) * 128);
  };
  // g * mask at (h, n8) and x^ there; the mask is the forward's ReLU, its
  // pre-ReLU output computed as the forward computes it.
  auto masked = [&](int h, int n8, float2 sc, float2 of, float a0, float a1,
                    float2& xh) {
    float2 gg =
        __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(at(h, n8)));
    const float d0 = a0 - mean[h], d1 = a1 - mean[h];
    xh = make_float2(d0 * rstd[h], d1 * rstd[h]);
    if (a.use_act) {
      if (!(d0 * (rstd[h] * sc.x) + of.x > 0.f)) gg.x = 0.f;
      if (!(d1 * (rstd[h] * sc.y) + of.y > 0.f)) gg.y = 0.f;
    }
    return gg;
  };
  cp_async_wait<0>();
  consumers_sync();

  // Pass 1: sum gh and gh * x^ by row; g * mask * x^ and g * mask by column.
  const int grp = ((ct >> 5) & 3) * 8 + (lane >> 2);
  float gs[2] = {0.f, 0.f}, gx[2] = {0.f, 0.f};
#pragma unroll
  for (int n8 = 0; n8 < kN / 8; ++n8) {
    const int c = col0 + 8 * n8;
    const float2 sc = __ldg(reinterpret_cast<const float2*>(a.scale + c));
    const float2 of = __ldg(reinterpret_cast<const float2*>(a.offset + c));
    float2 dsc = make_float2(0.f, 0.f), dof = make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 xh;
      const float2 gg = masked(h, n8, sc, of, acc[4 * n8 + 2 * h],
                               acc[4 * n8 + 2 * h + 1], xh);
      dsc.x += gg.x * xh.x;
      dsc.y += gg.y * xh.y;
      dof.x += gg.x;
      dof.y += gg.y;
      const float gh0 = gg.x * sc.x, gh1 = gg.y * sc.y;
      gs[h] += gh0 + gh1;
      gx[h] += gh0 * xh.x + gh1 * xh.y;
    }
    *reinterpret_cast<float2*>(cols + grp * kColPitch + c) = dsc;
    *reinterpret_cast<float2*>(cols + (kGroups + grp) * kColPitch + c) = dof;
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gs[h] += __shfl_xor_sync(0xffffffffu, gs[h], o);
      gx[h] += __shfl_xor_sync(0xffffffffu, gx[h], o);
    }
  }
  // Slots 2 + wg: this warpgroup's half of each row's two sums.
  if ((lane & 3) == 0) {
    xchg[(2 + wg) * kBM + r0] = make_float2(gs[0], gx[0]);
    xchg[(2 + wg) * kBM + r0 + 8] = make_float2(gs[1], gx[1]);
  }
  consumers_sync();
  float* part = a.partials + static_cast<size_t>(blockIdx.x) * 3 * kCout;
  for (int c = ct; c < 2 * kCout; c += 256) {
    const float* src = cols + (c / kCout) * kGroups * kColPitch + c % kCout;
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < kGroups; ++i) s += src[i * kColPitch];
    part[c] = s;
  }
  float mg[2], mgx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 u = xchg[2 * kBM + r0 + 8 * h];
    const float2 v = xchg[3 * kBM + r0 + 8 * h];
    mg[h] = (u.x + v.x) * inv_n;
    // The variance's path, cut where the variance clamps.
    mgx[h] = var[h] >= 0.f ? (u.y + v.y) * inv_n : 0.f;
  }
  consumers_sync();  // every column sum is read: group rows are free

  // Pass 2: dpre over g in the ring (the same thread's words), fp32 dpre
  // by column.
#pragma unroll
  for (int n8 = 0; n8 < kN / 8; ++n8) {
    const int c = col0 + 8 * n8;
    const float2 sc = __ldg(reinterpret_cast<const float2*>(a.scale + c));
    const float2 of = __ldg(reinterpret_cast<const float2*>(a.offset + c));
    float2 dbs = make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 xh;
      const float2 gg = masked(h, n8, sc, of, acc[4 * n8 + 2 * h],
                               acc[4 * n8 + 2 * h + 1], xh);
      const float p0 =
          rstd[h] * (gg.x * sc.x) - rstd[h] * (mg[h] + xh.x * mgx[h]);
      const float p1 =
          rstd[h] * (gg.y * sc.y) - rstd[h] * (mg[h] + xh.y * mgx[h]);
      dbs.x += p0;
      dbs.y += p1;
      *at(h, n8) = pack_bf16x2(p0, p1);
    }
    *reinterpret_cast<float2*>(cols + grp * kColPitch + c) = dbs;
  }
  consumers_sync();
  for (int c = ct; c < kCout; c += 256) {
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < kGroups; ++i) s += cols[i * kColPitch + c];
    part[2 * kCout + c] = s;
  }
#pragma unroll 4
  for (int i = ct; i < kBM * kChunks; i += 256) {
    const int r = i / kChunks, j = i % kChunks, gm = m0 + r;
    if (gm >= a.M) continue;
    *reinterpret_cast<uint4*>(a.out + static_cast<size_t>(gm) * kCout +
                              8 * j) =
        *reinterpret_cast<const uint4*>(ring_ptr + r * kPitch +
                                        ((j ^ (r & 7)) << 4));
  }
}

// The tiles' column sums of the backward: out_q[c] = sum over t, in order,
// of partials[t][q][c], q = 0, 1, 2 -> ds, doff, db. A block takes 32
// columns (a warp's lanes), its 8 warps every 8th tile, then warp 0 adds the
// 8 in order.
__global__ void __launch_bounds__(256)
    column_sums_kernel(const float* partials, int tiles, int cout, float* ds,
                       float* doff, float* db) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;  // of the 3 * cout columns
  float s = 0.f;
  if (c < 3 * cout)
    for (int t = warp; t < tiles; t += 8)
      s += partials[static_cast<size_t>(t) * 3 * cout + c];
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || c >= 3 * cout) return;
  s = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) s += part[w][lane];
  float* out = c < cout ? ds : c < 2 * cout ? doff : db;
  out[c % cout] = s;
}

// SPLIT = 1: a block computes all Cout = 64 * NW columns of its 64 rows.
// SPLIT = 2 or 4: a cluster of SPLIT blocks shares the row tile, block
// rank r computes columns r * 64 * NW .. of Cout = 64 * NW * SPLIT (each
// stages the same A; only the LayerNorm row sums cross, through
// distributed shared memory): SPLIT times the blocks where the row tiles
// alone leave SMs idle. A: where A comes from (ASource); kTmaA copies it
// through `xmap` (K = 1, stride 1, Cin % 8 == 0), the others do not read
// `xmap`. BF16_BIAS: the bias is a.bias_bf16 (the probe's block), widened
// to fp32; a runtime branch there slowed the package's Hadamard kernels.
// BWD: the backward epilogue (ln_relu_vjp) in place of the forward's, SPLIT
// 1, LayerNorm on.
template <int NW, int SPLIT, int A, bool BF16_BIAS, bool BWD>
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
  constexpr uint32_t kTileBytes = kBBytes + (A == kTmaA ? kATileBytes : 0);
  static_assert(kS >= 3 && kLag >= 1, "the pipeline needs three stages");
  static_assert(kN >= 32 && SPLIT <= kMaxSplit, "no such wgmma");
  static_assert(!BWD || (SPLIT == 1 && !BF16_BIAS &&
                         bwd_epilogue_bytes<kCout>() <= kS * G::kStageBytes),
                "the backward epilogue takes a whole tile in the ring");

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
      mbar_init(full(s), A == kTmaA ? 1 : kProducers + 1);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Regs<A, kAcc>::kProducer));
    if (A == kTmaA) {
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
    // Thread 0 copies each weight tile with TMA. All 128 stage A: 16-byte
    // unit aj (channels 8 aj .. 8 aj + 7 of the chunk) of rows ar + 16 i.
    const int aj = tid & 7, ar = tid >> 3;
    const bool aligned = (a.Cin & 7) == 0;
    if (A == kHadamardA) {
      // Stride 1, K <= kMaxK, any left (SAME's (K - 1) / 2 or the
      // probe's K / 2), T_out = T. A chunk's window of kBM + K - 1 input
      // rows (window row w = ar + 16 i is flattened input row m0 - left +
      // w, clamped to a valid row) is loaded and multiplied once, in
      // registers (channels 8 aj .. 8 aj + 7 of the chunk, each row times
      // its own video's q), then stored into each tap's A tile at row w -
      // tap. keep[i] bit tap says whether that tile row takes window row w
      // (its own video's input at t - left + tap lies in [0, T)) or zeros.
      // The next chunk's loads are issued before this chunk's K tiles are
      // stored.
      const int win = kBM + a.K - 1;
      int src[kWinUnits], qb[kWinUnits];
      unsigned keep[kWinUnits];
#pragma unroll
      for (int i = 0; i < kWinUnits; ++i) {
        const int w = ar + 16 * i;
        src[i] = min(max(m0 - a.left + w, 0), a.M - 1);
        qb[i] = src[i] / a.T;
        keep[i] = 0u;
        for (int tap = 0; tap < a.K; ++tap) {
          const int r = w - tap, gm = m0 + r;
          if (r < 0 || r >= kBM || gm >= a.M) continue;
          const int ts = gm % a.T - a.left + tap;
          if (ts >= 0 && ts < a.T) keep[i] |= 1u << tap;
        }
      }
      uint4 vn[kWinUnits] = {}, qn[kWinUnits] = {};
      auto fetch = [&](int chunk) {
        const int c = chunk * kBK + 8 * aj;
#pragma unroll
        for (int i = 0; i < kWinUnits; ++i) {
          if (ar + 16 * i >= win) continue;
          const __nv_bfloat16* vr = a.x + static_cast<size_t>(src[i]) * a.Cin;
          const __nv_bfloat16* qr = a.q + static_cast<size_t>(qb[i]) * a.Cin;
          if (c >= a.Cin) {
            vn[i] = qn[i] = make_uint4(0u, 0u, 0u, 0u);
          } else if (aligned) {
            vn[i] = __ldg(reinterpret_cast<const uint4*>(vr + c));
            qn[i] = __ldg(reinterpret_cast<const uint4*>(qr + c));
          } else {
            vn[i] = load_unaligned(vr, c, a.Cin);
            qn[i] = load_unaligned(qr, c, a.Cin);
          }
        }
      };
      fetch(0);
      int kt = 0;
      for (int chunk = 0; chunk < a.nkc; ++chunk) {
        uint4 p[kWinUnits];
#pragma unroll
        for (int i = 0; i < kWinUnits; ++i) p[i] = hadamard(vn[i], qn[i]);
        if (chunk + 1 < a.nkc) fetch(chunk + 1);
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
          unsigned char* at = ring_ptr + (a_tile(s) - ring);
#pragma unroll
          for (int i = 0; i < kWinUnits; ++i) {
            const int r = ar + 16 * i - tap;
            if (r < 0 || r >= kBM) continue;
            *reinterpret_cast<uint4*>(at + r * 128 + ((aj ^ (r & 7)) << 4)) =
                (keep[i] >> tap) & 1u ? p[i] : make_uint4(0u, 0u, 0u, 0u);
          }
          // A was written through the generic proxy; wgmma reads through
          // the async one.
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full(s));
        }
      }
      if (SPLIT > 1) cluster_sync();  // the consumers' LayerNorm exchange
      return;
    }
    // Tile row ar + 16 i: vrow[i] is its video's first input row, t0[i] its
    // input time at tap 0 (T for a row past M: never in [0, T)).
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Regs<A, kAcc>::kConsumer));
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
      float2 bb;
      if constexpr (BF16_BIAS) {
        const uint32_t h = __ldg(reinterpret_cast<const unsigned int*>(
            a.bias_bf16 + col0 + 8 * n8));
        bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h));
      } else {
        bb = __ldg(reinterpret_cast<const float2*>(a.bias + col0 + 8 * n8));
      }
      acc[4 * n8] += bb.x;
      acc[4 * n8 + 1] += bb.y;
      acc[4 * n8 + 2] += bb.x;
      acc[4 * n8 + 3] += bb.y;
      s0 += acc[4 * n8] + acc[4 * n8 + 1];
      q0 += acc[4 * n8] * acc[4 * n8] + acc[4 * n8 + 1] * acc[4 * n8 + 1];
      s1 += acc[4 * n8 + 2] + acc[4 * n8 + 3];
      q1 += acc[4 * n8 + 2] * acc[4 * n8 + 2] + acc[4 * n8 + 3] * acc[4 * n8 + 3];
    }
    if (BWD || a.use_norm) {
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
    else if (BWD || a.use_norm)
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * 128) : "memory");  // consumers
    if constexpr (BWD) {
      ln_relu_vjp<kCout>(acc, xchg, ring, ring_ptr, a, m0, ct, wg, lane, r0,
                         col0);
      return;
    }
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
          rsqrtf(fmaxf(q0 * inv_n - mean0 * mean0, 0.f) + a.eps);
      const float rstd1 =
          rsqrtf(fmaxf(q1 * inv_n - mean1 * mean1, 0.f) + a.eps);
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

template <int NW, int SPLIT, int A, bool BF16_BIAS, bool BWD>
cudaError_t launch_kernel(const ConvArgs& a, int grid, cudaStream_t stream) {
  using G = Geometry<NW>;
  bind_context();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_ln_relu_kernel<NW, SPLIT, A, BF16_BIAS, BWD>,
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
  if (A == kTmaA && (e = weight_map(&xmap, a.x, 1, a.M, a.Cin)) != cudaSuccess)
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
  e = cudaLaunchKernelEx(&cfg,
                         conv_ln_relu_kernel<NW, SPLIT, A, BF16_BIAS, BWD>,
                         wmap, xmap, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The Hadamard variant for fused_fusion.cu and block_probe.cu; otherwise
// A by TMA where output row gm reads input row gm and rows are 16-byte
// aligned, by cp.async where not. BWD: the backward epilogue.
template <int NW, int SPLIT, bool H, bool B, bool BWD = false>
cudaError_t launch_nw(const ConvArgs& a, int grid, cudaStream_t stream) {
  static_assert(H || !B, "a bf16 bias only in the Hadamard variant");
  if constexpr (H)
    return launch_kernel<NW, SPLIT, kHadamardA, B, BWD>(a, grid, stream);
  else
    return a.K == 1 && a.stride == 1 && (a.Cin & 7) == 0
               ? launch_kernel<NW, SPLIT, kTmaA, false, BWD>(a, grid, stream)
               : launch_kernel<NW, SPLIT, kGatherA, false, BWD>(a, grid, stream);
}

// The caller's split and grid must be ones this source builds: a split of
// Cout 512 over 2 or 4 blocks, else one block a tile; grid = split *
// ceil(M / kBM). H: the Hadamard variant (x is v, convolved as v * q[b]);
// B: its bias is a.bias_bf16 (block_probe.cu).
template <bool H, bool B = false>
cudaError_t launch_conv(const ConvArgs& a, int cout, int split, int grid,
                        cudaStream_t stream) {
  if (grid != split * ((a.M + kBM - 1) / kBM) || grid <= 0)
    return cudaErrorInvalidValue;
  if (split == 2)
    return cout == 512 ? launch_nw<4, 2, H, B>(a, grid, stream) : cudaErrorInvalidValue;
  if (split == 4)
    return cout == 512 ? launch_nw<2, 4, H, B>(a, grid, stream) : cudaErrorInvalidValue;
  if (split != 1) return cudaErrorInvalidValue;
  switch (cout) {
    case 64: return launch_nw<1, 1, H, B>(a, grid, stream);
    case 128: return launch_nw<2, 1, H, B>(a, grid, stream);
    case 256: return launch_nw<4, 1, H, B>(a, grid, stream);
    case 512: return launch_nw<8, 1, H, B>(a, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The backward: the conv again with the backward epilogue (a.g the output's
// cotangent, a.out dpre, a.partials (grid, 3, cout)), one block a row tile
// (grid = ceil(M / kBM), never a cluster: a row's sums stay in its block),
// then the tiles' column sums into ds, doff, db (cout each). H: the
// Hadamard variant.
template <bool H>
cudaError_t launch_conv_bwd(const ConvArgs& a, int cout, int grid, float* ds,
                            float* doff, float* db, cudaStream_t stream) {
  if (grid != (a.M + kBM - 1) / kBM || grid <= 0 || !a.use_norm)
    return cudaErrorInvalidValue;
  cudaError_t e;
  switch (cout) {
    case 64: e = launch_nw<1, 1, H, false, true>(a, grid, stream); break;
    case 128: e = launch_nw<2, 1, H, false, true>(a, grid, stream); break;
    case 256: e = launch_nw<4, 1, H, false, true>(a, grid, stream); break;
    case 512: e = launch_nw<8, 1, H, false, true>(a, grid, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  column_sums_kernel<<<(3 * cout + 31) / 32, 256, 0, stream>>>(
      a.partials, grid, cout, ds, doff, db);
  return cudaGetLastError();
}

}  // namespace
}  // namespace drn
