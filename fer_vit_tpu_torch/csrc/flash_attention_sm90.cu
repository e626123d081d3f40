// Fused attention for Hopper (sm_90a), one score pass over TMA-staged heads:
// out = softmax(Q K^T / sqrt(Dh)) V in bf16.
//
// Replaces the TPU kernel fer_vit_tpu/ops/flash_attention.py::_attn_kernel,
// which holds one head's whole (L, L) score tile on chip. It keeps the TPU
// kernel's rounding points, as the streaming kernel (flash_attention.cu) does:
//
//   s   = (q . k in f32, from bf16 operands) * scale     scale = 1/sqrt(Dh)
//   m   = max over keys of s;  e = expf(s - m);  sum(e) in f32
//   w   = round_bf16(e / sum(e))                         a true division
//   out = round_bf16(w . v accumulated in f32)
//
// It takes bf16, 1 <= L <= 256, Dh a multiple of 16 up to 64, and q, k, v
// whose base addresses and batch, head and row strides are multiples of 16
// bytes with Dh contiguous (TMA's rules). Everything else goes to the
// streaming kernel; the wrapper (ops/flash_attention.py::route) decides by
// shape, dtype and strides before the launch.
//
// Bound on an H100 SXM: bytes. q, k, v read once and out written once: at
// (B, H, L, Dh) = (64, 12, 197, 64) that is 77.5 MB, 23.1 us at 3.35 TB/s,
// against 7.6 GFLOP, 7.7 us at 989 TFLOP/s.
//
// Design. A persistent block per SM walks the (batch, head) pairs, i, i +
// gridDim.x, ... It has three warpgroups: two consumers and a producer,
// which hands most of its registers to the consumers (setmaxnreg: 40 and
// 232 a thread) and uses one thread. Shared memory holds a ring of two
// stages; a stage is one head's Q, K and V, each as ceil(L/64) TMA boxes of
// 64 rows x 64 columns in bf16 (8 KB, 128-byte swizzle, rows and columns
// past L and Dh filled with zeros by TMA). The producer loads head i + 1
// into one stage while the consumers work on head i in the other; an
// mbarrier per stage reports the bytes landed ("full"), another the eight
// consumer warps done with it ("empty"). A head's loads start only once the
// previous head's have landed, so the first head, which the consumers wait
// for, does not share the bandwidth with the second. Consumer warpgroup w
// takes the 64-row query tiles w and w + 2 of each head. For one tile:
//   1. S = Q K^T by wgmma, Q and K read K-major from the swizzled stage:
//      m64n64k16 for each full 64-key chunk and m64n8k16 for the rest, so
//      the keys run to the next multiple of 8 (197 -> 200), not 256. The
//      scores stay in registers: 4 f32 a thread per 8 keys, at most 128.
//   2. The exact row max and sum come from those registers (each row lives
//      in one quad of lanes); the weights are divided by the sum, rounded to
//      bf16 and packed in place: the accumulator layout of S is the A
//      register layout of the next product, as in FlashAttention-3. A warp
//      whose 16 rows all lie past L (3 of the 4 in the last tile at L = 197)
//      skips this step and weighs nothing.
//   3. O = W V by wgmma m64n64k16 with A from registers and B = V read
//      MN-major from the same stage (the transpose bit), over ceil(L'/16)
//      key steps.
//   4. O, rounded to bf16, goes into the tile's Q box (free after step 1)
//      and out by one TMA store, which leaves out rows past L and columns
//      past Dh; the stage is released once the stores have read it.
//
// What this does about the streaming kernel's costs: one score pass, not
// two (the weights are rounded where the TPU kernel rounds them without
// recomputing S); K and V are loaded once per head by TMA, not per query
// tile and twice for K; loads of the next head are in flight while the
// tensor cores and the softmax work on this one; V is read as it lies (no
// transposing store) and W never goes through shared memory; keys are
// padded to a multiple of 8, not 64; both products are wgmma. What remains
// is the softmax on the CUDA cores, about 15 instructions a score (the max,
// the scaled difference, expf's 8, the sum, the division's 3, a share of
// the check for tiny quotients), which the two consumer warps of each SM
// sub-partition issue at well under one a cycle: on an H100, taking expf
// out alone makes the kernel 22 % faster (scripts/k2_ablations.py).
//
// The tensor maps are encoded on the host at every call, over the views as
// they are given: (Dh, L, H, B) with the tensors' own byte strides, so the
// head-split views of a packed qkv projection need no copy. The barrier,
// TMA and wgmma helpers are those of sm90.cuh, shared with the fused IR-SE
// unit's Hopper kernel.

#include <cuda.h>
#include <math.h>
#include <stddef.h>
#include <stdio.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int kConsumerWarpgroups = 2;
constexpr int kThreads = 128 * (kConsumerWarpgroups + 1);  // + the producer's
// Registers a thread after the producer hands its own back: an SM
// sub-partition holds one warp of each warpgroup, 512 registers a lane, and
// 40 + 2 x 232 fit in them (168 each at launch).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kTile = 64;                  // rows of a TMA box and a query tile
constexpr int kMaxL = 256;
constexpr int kMaxTiles = kMaxL / kTile;
constexpr int kMaxDh = 64;
constexpr int kBoxBytes = kTile * 128;     // 64 rows of 64 bf16
constexpr int kTensorBytes = kMaxTiles * kBoxBytes;  // one tensor of a stage
constexpr int kStageBytes = 3 * kTensorBytes;        // Q, K, V
constexpr int kStages = 2;
constexpr int kSmemBytes = kStages * kStageBytes + 64 + 1024;  // + barriers,
                                                               // alignment

struct Params {
  int B, H, L, dh;
  float scale;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- the kernel ----------------------------------------------------------------

// Accumulator layout (wgmma m64nN): a thread of a warpgroup holds rows r0 =
// 16 * (warp in warpgroup) + lane / 4 and r0 + 8, and in each 8-column group
// j the columns 8j + 2 (lane % 4) and the next one: acc[4j], acc[4j + 1] on
// row r0, acc[4j + 2], acc[4j + 3] on row r0 + 8.

// The wgmma sequences are straight-line code, fixed by the template: a
// branch or a guard predicate on any wgmma makes ptxas serialize the whole
// pipeline and spill. So the kernel is instantiated per number of 8-key
// groups NG, and keys past L are zero in shared memory up to 8 NG.

// S = Q K^T over NG 8-key groups: for each 16-column step of Dh (always 4:
// the columns past Dh are zero in shared memory), one m64n64k16 per full
// 64-key chunk and one m64n8k16 per group after them.
//
// The accumulators are zeroed and fenced before each sequence and fenced
// after its commit, as CUTLASS does: that keeps ptxas from moving anything
// that touches them into the sequence (1-2 % faster on an H100,
// scripts/k2_ablations.py).
template <int NG>
__device__ __forceinline__ void issue_scores(float* s, uint32_t q,
                                             uint32_t k) {
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) s[i] = 0.f;
  fence_regs<4 * NG>(s);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < kMaxDh / 16; ++kd) {
    const uint64_t da = sw128_desc(q + 32 * kd);
#pragma unroll
    for (int c = 0; c < NG / 8; ++c)
      wgmma_ss_n64(s + 32 * c, da, sw128_desc(k + c * kBoxBytes + 32 * kd),
                   kd > 0);
#pragma unroll
    for (int j = NG / 8 * 8; j < NG; ++j)
      wgmma_ss_n8(s + 4 * j, da, sw128_desc(k + j * 1024 + 32 * kd), kd > 0);
  }
  wgmma_commit();
  fence_regs<4 * NG>(s);
}

// O = W V over the 16-key steps of NG groups: A = the weights of groups 2kk
// and 2kk + 1 from registers, B = V rows 16kk .. 16kk + 15, MN-major.
template <int NG>
__device__ __forceinline__ void weighted_sum(float* o, const uint32_t* w,
                                             uint32_t v) {
#pragma unroll
  for (int i = 0; i < kMaxDh / 2; ++i) o[i] = 0.f;
  fence_regs<kMaxDh / 2>(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < (NG + 1) / 2; ++kk)
    wgmma_rs_n64_tb(o, w + 4 * kk, sw128_desc(v + kk * 2048), kk > 0);
  wgmma_commit();
  fence_regs<kMaxDh / 2>(o);
  wgmma_wait_all();
}

// e / sum rounded to nearest, as __fdiv_rn gives it, for e in [0, 1] and sum
// in [1, 256]: with y = 1/sum rounded to nearest and q = e y rounded,
// q + (e - sum q) y rounded is the correctly rounded quotient (Markstein's
// theorem), the remainder being exact in an FMA, as long as nothing
// underflows. So e below 2^-100 is scaled by 2^64 first and the quotient
// back after: exact while the quotient is normal; one below 2^-126 may
// differ from __fdiv_rn in its last bit (2^-149). kTiny: whether e may be
// below 2^-100 (a warp takes that path only where one of its weights is).
template <bool kTiny>
__device__ __forceinline__ float divide(float e, float sum, float y) {
  const bool tiny = kTiny && e < 0x1p-100f;
  const float es = tiny ? e * 0x1p64f : e;
  const float q = __fmul_rn(es, y);
  const float d = __fmaf_rn(__fmaf_rn(-q, sum, es), y, q);
  return tiny ? d * 0x1p-64f : d;
}

// w[2j + r] = the bf16 pair of weights of group j on row r0 + 8r; a group
// from ng on weighs 0.
template <int NG, bool kTiny>
__device__ __forceinline__ void weights(uint32_t* w, const float* e, int ng,
                                        const float* sum, const float* y) {
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (j < ng)
        w[2 * j + r] = pack_bf16(divide<kTiny>(e[4 * j + 2 * r], sum[r], y[r]),
                                 divide<kTiny>(e[4 * j + 2 * r + 1], sum[r],
                                               y[r]));
      else
        w[2 * j + r] = 0u;
    }
  }
  if constexpr (NG % 2 == 1) w[2 * NG] = w[2 * NG + 1] = 0u;
}

// The row max and sum are taken over kParts independent partials (then
// combined), not one chain of dependent steps.
constexpr int kParts = 4;

// The softmax of one thread's two rows, from the raw scores s (q . k in f32)
// to the packed bf16 weights w. kPow2: the scale is a power of two, so s *
// scale is exact and the subtraction of the max folds into one fma with the
// same result.
template <int NG, bool kExact, bool kPow2>
__device__ __forceinline__ void softmax(const Params& p, float* s,
                                        uint32_t* w) {
  const int tq = threadIdx.x & 3;
  // 8-key groups with a key below L: all NG where the launch made it so
  const int ng = kExact ? NG : (p.L + 7) >> 3;

  // the row max of the raw scores, keys past L (in group ng - 1 only) at
  // -inf. Scaling is monotone, so the max of the scaled scores is the
  // scaled max.
  float mx[2][kParts];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < kParts; ++i) mx[r][i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    if (j < ng) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = kPow2 ? s[4 * j + e] : __fmul_rn(s[4 * j + e], p.scale);
        if (j == ng - 1 && 8 * j + 2 * tq + (e & 1) >= p.L) x = -INFINITY;
        s[4 * j + e] = x;
        float& m = mx[e >> 1][j % kParts];
        m = fmaxf(m, x);
      }
    }
  }
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 1; i < kParts; ++i) mx[r][0] = fmaxf(mx[r][0], mx[r][i]);
    m[r] = quad_max(mx[r][0]);
    if (kPow2) m[r] = __fmul_rn(m[r], p.scale);
  }
  float part[2][kParts];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < kParts; ++i) part[r][i] = 0.f;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    if (j < ng) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * j + e];
        s[4 * j + e] = expf(kPow2 ? __fmaf_rn(x, p.scale, -m[e >> 1])
                                  : __fsub_rn(x, m[e >> 1]));
        part[e >> 1][j % kParts] += s[4 * j + e];
      }
    }
  }
  float sum[2], y[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 1; i < kParts; ++i) part[r][0] += part[r][i];
    sum[r] = quad_sum(part[r][0]);
    y[r] = __frcp_rn(sum[r]);
  }
  // The weights by the fast division, exact unless e < 2^-100. Such an e
  // gives a weight below 2^-99 (sum >= 1), which the least weight shows: the
  // bit patterns of bf16 values >= 0 order as the values, so it is a packed
  // 16-bit minimum (three pairs an instruction), with the keys past L (in
  // group ng - 1) left out. A warp that has one redoes its weights exactly.
  weights<NG, false>(w, s, ng, sum, y);
  uint32_t least = 0xffffffffu;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    if (j < ng) {
      uint32_t a = w[2 * j], b = w[2 * j + 1];
      if (j == ng - 1) {
        const int k0 = 8 * j + 2 * tq;
        const uint32_t past = (k0 >= p.L ? 0xffffu : 0u) |
                              (k0 + 1 >= p.L ? 0xffff0000u : 0u);
        a |= past;
        b |= past;
      }
      least = __vimin3_u16x2(least, a, b);
    }
  }
  // 0x0e00: the bits of 2^-99 in bf16
  const bool tiny = __any_sync(
      0xffffffffu, min(least & 0xffffu, least >> 16) < 0x0e00u);
  if (tiny) weights<NG, true>(w, s, ng, sum, y);
}

// The rest of query tile t of head (b, h), by warpgroup wg, once its scores
// s are issued: v is the shared address of the stage's V, obuf that of the
// tile's Q box, which takes the output once the scores are in.
template <int NG, bool kExact, bool kPow2>
__device__ __forceinline__ void finish_tile(const Params& p, float* s,
                                            uint32_t v, uint32_t obuf, int t,
                                            int wg, const CUtensorMap* to,
                                            int h, int b) {
  const int tq = threadIdx.x & 3;
  const int lane = threadIdx.x & 31;
  const int rl = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // tile row
  const int r0 = t * kTile + rl;                               // head row

  // 1. S = Q K^T, f32 in registers
  wgmma_wait_all();
  fence_regs<4 * NG>(s);

  // 2. w = softmax(S * scale) rounded to bf16; a warp whose 16 rows all lie
  // past L (in the last tile) weighs nothing: its rows are not stored
  uint32_t w[2 * ((NG + 1) / 2 * 2)];
  if (r0 - (lane >> 2) < p.L) {
    softmax<NG, kExact, kPow2>(p, s, w);
  } else {
#pragma unroll
    for (int i = 0; i < 2 * ((NG + 1) / 2 * 2); ++i) w[i] = 0u;
  }

  // 3. O = W V
  float o[kMaxDh / 2];
  fence_regs<2 * ((NG + 1) / 2 * 2)>(w);
  weighted_sum<NG>(o, w, v);
  fence_regs<kMaxDh / 2>(o);

  // 4. O rounded to bf16 into the Q box in its 128-byte swizzled layout
  // (the 16-byte chunk j of row r at chunk j ^ (r mod 8)), then one TMA
  // store of the box, which leaves out the rows and columns past L and Dh
#pragma unroll
  for (int j = 0; j < kMaxDh / 8; ++j) {
    const uint32_t at = obuf + rl * 128 + ((j ^ (rl & 7)) << 4) + 4 * tq;
    st_shared(at, pack_bf16(o[4 * j], o[4 * j + 1]));
    st_shared(at + 8 * 128, pack_bf16(o[4 * j + 2], o[4 * j + 3]));
  }
  fence_async_shared();
  warpgroup_sync(1 + wg);
  if ((threadIdx.x & 127) == 0 && t * kTile < p.L)
    tma_store_4d(to, obuf, 0, t * kTile, h, b);
}

template <int NG, bool kExact, bool kPow2>
__global__ void __launch_bounds__(kThreads, 1)
attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors repeat every 1024 bytes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + kStages * kStageBytes;  // kStages barriers
  const uint32_t empty = full + 8 * kStages;           // kStages barriers
  const int n_tiles = (p.L + kTile - 1) / kTile;
  const int n_heads = p.B * p.H;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumerWarpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumerWarpgroups) {
    // producer warpgroup: one thread keeps the next head's loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 128 * kConsumerWarpgroups) return;
    const uint32_t bytes = 3u * n_tiles * kBoxBytes;
    int it = 0;
    for (int bh = blockIdx.x; bh < n_heads; bh += gridDim.x, ++it) {
      const int s = it % kStages;
      // a head's loads start once the previous head's have landed, so the
      // second head does not share the bandwidth of the first, which the
      // consumers wait for
      if (it > 0)
        mbar_wait(full + 8 * ((it - 1) % kStages), ((it - 1) / kStages) & 1);
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, bytes);
      const int b = bh / p.H;
      const int h = bh - b * p.H;
      const uint32_t stage = base + s * kStageBytes;
      for (int t = 0; t < n_tiles; ++t) {
        tma_load_4d(stage + t * kBoxBytes, &tq, bar, 0, t * kTile, h, b);
        tma_load_4d(stage + kTensorBytes + t * kBoxBytes, &tk, bar, 0,
                    t * kTile, h, b);
        tma_load_4d(stage + 2 * kTensorBytes + t * kBoxBytes, &tv, bar, 0,
                    t * kTile, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg takes the query tiles wg, wg + 2, ... in rounds
  // of two tiles, and both take the same number of tiles (a tile past the
  // last is computed and not stored), so no wgmma sits under a condition.
  // The two run side by side, their softmaxes at the same time: two warps
  // on each SM sub-partition issue them (one at a time was slower).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int rounds = (n_tiles + 1) / 2;
  const int my_heads = (n_heads - blockIdx.x + gridDim.x - 1) / gridDim.x;
  for (int it = 0; it < my_heads; ++it) {
    const int bh = blockIdx.x + it * gridDim.x;
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    const uint32_t q = base + s * kStageBytes;
    const int b = bh / p.H;
    const int h = bh - b * p.H;
    for (int r = 0; r < rounds; ++r) {
      const int t = 2 * r + wg;
      float sc[4 * NG];
      issue_scores<NG>(sc, q + t * kBoxBytes, q + kTensorBytes);
      finish_tile<NG, kExact, kPow2>(p, sc, q + 2 * kTensorBytes,
                                     q + t * kBoxBytes, t, wg, &to, h, b);
    }
    // the stage is released once the output stores have read it
    if ((threadIdx.x & 127) == 0) bulk_wait_read();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
  }
}

// -- host side -------------------------------------------------------------------

char g_message[256];

// Own errors are negative, with their text in g_message.
int fail(const char* what, int code) {
  snprintf(g_message, sizeof g_message, "%s (%d)", what, code);
  return -1;
}

// A (Dh, L, H, B) map over one of q, k, v: strides (batch, head, row) in
// elements, boxes of 64 x 64, 128-byte swizzle, zeros out of bounds.
int encode(CUtensorMap* map, const void* ptr, int B, int H, int L, int dh,
           const long long* st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return fail("cuTensorMapEncodeTiled not found", 0);
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kMaxDh, (cuuint32_t)kTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return fail("cuTensorMapEncodeTiled failed", (int)r);
  return 0;
}

template <int NG, bool kExact, bool kPow2>
int launch_kernel(const CUtensorMap* maps, const Params& p, int grid,
                  cudaStream_t stream) {
  auto kernel = attention_sm90_kernel<NG, kExact, kPow2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(maps[0], maps[1], maps[2],
                                                 maps[3], p);
  return (int)cudaGetLastError();
}

// kExact: every one of the NG groups holds a key below L.
template <int NG, bool kExact>
int launch(const CUtensorMap* maps, const Params& p, int grid,
           cudaStream_t stream) {
  // 1/sqrt(Dh) is a power of two for Dh = 16 and 64
  if (p.dh == 16 || p.dh == 64)
    return launch_kernel<NG, kExact, true>(maps, p, grid, stream);
  return launch_kernel<NG, kExact, false>(maps, p, grid, stream);
}

}  // namespace

extern "C" {

// bf16 only. strides: 12 values, the (batch, head, row) strides in elements
// of q, k, v and o, in that order (Dh contiguous). Returns 0 when launched,
// a CUDA error code, or -1 (see fused_attention_sm90_error_string).
int fused_attention_sm90_forward(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int L, int dh,
                                 const long long* strides, void* stream) {
  if (dh < 16 || dh > kMaxDh || dh % 16 != 0 || L < 1 || L > kMaxL ||
      B < 1 || H < 1 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const int rc = encode(&maps[i], ptrs[i], B, H, L, dh, strides + 3 * i);
    if (rc != 0) return rc;
  }
  Params p;
  p.B = B;
  p.H = H;
  p.L = L;
  p.dh = dh;
  p.scale = (float)(1.0 / sqrt((double)dh));
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int heads = B * H;
  const int grid = heads < sms ? heads : sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // keys run to a multiple of 64, or of 8 where the last 64-key chunk would
  // hold at most 8 keys (197 -> 200)
  switch ((L + 7) / 8) {
    case 9:
      return launch<9, true>(maps, p, grid, st);
    case 17:
      return launch<17, true>(maps, p, grid, st);
    case 25:
      return launch<25, true>(maps, p, grid, st);
  }
  switch ((L + kTile - 1) / kTile) {
    case 1:
      return launch<8, false>(maps, p, grid, st);
    case 2:
      return launch<16, false>(maps, p, grid, st);
    case 3:
      return launch<24, false>(maps, p, grid, st);
    default:
      return launch<32, false>(maps, p, grid, st);
  }
}

const char* fused_attention_sm90_error_string(int code) {
  if (code < 0) return g_message;
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
