// Fused IR-SE residual branch for Hopper (sm_90a): two implicit-GEMM
// convolutions on wgmma, with the weights streamed by TMA.
//
// Replaces the TPU kernel fer_vit_tpu/ops/fused_irse_unit.py::_kernel (as
// does fused_irse_unit.cu, which keeps the f32 path and channel counts that
// are not multiples of 64). For one IR-SE bottleneck unit, bf16 NHWC:
//
//   h    = round_bf16(a1 * x + b1)            bn1 eval affine in f32, zero outside the image
//   y1   = round_bf16(PReLU(conv3x3_s1(h)))   f32 accumulation, zero outside the image
//   res2 = conv3x3_s(y1) + b2                 stride s in {1, 2}, f32 accumulation, b2 in f32
//   sums = sum over space of res2 (f32, taken before res2 is rounded to bf16)
//
// The rounding points are the TPU kernel's. The weights arrive in bf16,
// OHWI: a (N = Cout, K = 9 C) matrix with K contiguous in (kh, kw, ci)
// order, which is wgmma's K-major B as it lies.
//
// Bound on an H100 SXM: operations, max(2 MACs / 989e12, bytes / 3.35e12)
// with MACs = B (H W Cin + H2 W2 Cout) 9 Cout and bytes = x read once, res2
// written once, both weights (chip_smoke.unit_bound_ms). At batch 16 every
// IR-SE50 shape is bound by operations: 39 us for a stride-1 unit, 59 us for
// the stride-2 ones from 64 channels up, 98 us for the first unit.
//
// Why two passes. The TPU kernel keeps the conv1 output y1 in VMEM and
// recomputes conv1 on each block's halo; on this card shared memory is too
// small for that at 256 and 512 channels (the one-launch kernel,
// fused_irse_unit.cu, is left with 8 x 4 to 4 x 2 output tiles, 1.9-2.3x
// conv1 work and every weight byte feeding 16-32 pixels). Here each unit
// makes three launches:
//   1. conv1: M = B H W pixels, N = Cout, K = 9 Cin. x's slabs are loaded
//      by TMA, the bn1 affine is applied to them in place, and the epilogue
//      applies PReLU, rounds to bf16 and stores y1 (B, H, W, Cout).
//   2. conv2: M = B H2 W2, N = Cout, K = 9 Cout over y1 at stride s; TMA's
//      zero fill outside the image is conv2's padding. The epilogue adds b2
//      in f32, stores res2 and writes each tile's per-channel partial sums.
//   3. reduce_tile_sums adds the partial sums in tile order (no atomics).
// y1 goes through device memory and, for the deep units, stays in the 50 MB
// L2: 4.2 MB at 16 x 16 x 512, 8.4 MB at 32 x 32 x 256, 16.8 MB at 64 x 64
// x 128, at batch 16. Over the 24 units it is 487 MB written and read once:
// 0.29 ms at 3.35 TB/s against a forward's 1.055 ms bound, and no halo is
// recomputed. L2 traffic in weights falls with the tile: at 32 x 32, 256 ->
// 256, each of 128 blocks reads the 1.18 MB of a pass once, 0.15 GB a pass,
// where the one-launch kernel reads 1.2 GB.
//
// The core, one template for both passes (kConv1 picks the prologue and
// epilogue; NS the N slab). A persistent block per SM walks work items
// (image, output tile, N slab) i, i + gridDim.x, ... An output tile is th x
// tw pixels of one image, 8 x 16 (or the image where it is narrower or
// shorter; at most 128 pixels, rows past the image computed and not
// stored); its N slab is NS = 64, 128 or 256 channels. Three warpgroups: two
// consumers (224 registers each through setmaxnreg) take the tile's two
// 64-row halves, each with the NS columns in f32 registers; the producer
// warpgroup (56 registers) runs
//   - A (one thread): per 64-channel slab of the input, the tile's halo,
//     (s (th - 1) + 3) x (s (tw - 1) + 3) pixels x 128 bytes, by one TMA
//     load from a 4D map (C, W, H, B) with 128-byte swizzle (pixel p at
//     byte 128 p, its 16-byte chunk j at j ^ (p mod 8)); two buffers, so one
//     slab feeds its 9 taps while the next one lands;
//   - B (one thread): per (slab, tap) one box of 64 K x NS rows of the
//     weights from a 2D map (K, N), 128-byte swizzle, into a ring of
//     mbarrier-tracked stages;
//   - in conv1, the bn1 prologue (two warps): each landed slab gets a1 x +
//     b1 in f32 (__fmul_rn, __fadd_rn), rounded to bf16, in place, on the
//     pixels inside the image (TMA wrote zeros outside it); then the slab is
//     "ready". Fixing the slab up in place keeps its load one TMA copy; on
//     the producer's warps it overlaps the consumers' products.
// The consumers, for each slab and each of the 9 taps: ldmatrix reads the
// A fragments of 4 k16 steps from the halo, the rows shifted by the tap
// (kh, kw) and, at stride 2, every second pixel; 4 wgmma m64nNSk16 take A
// from those registers (the mma.sync A fragment layout, which ldmatrix
// yields) and B from the stage; the tap's products are waited for, which
// frees the stage. The wait is per tap because ptxas serialises every wgmma
// of the kernel (C7513) once the next tap's fragments are loaded while
// products are in flight; the two consumer warpgroups fill each other's
// gaps. The tensor cores keep one f32 accumulator per output across K <=
// 4608, as the one-launch kernel's bf16 path does; their sums round toward
// zero, a bias far below bf16's output rounding. The epilogue transposes
// each quad's 4 x 4 bf16 pairs so that every lane stores 16 bytes (8
// channels of a pixel), and conv2 adds its f32 values over the warp's rows
// by three halving exchanges, over the 8 warps in warp order through
// shared memory.
//
// The host (ops/fused_irse_unit.py::plan) picks per pass the tile, the N
// slab (the widest of 256, 128, 64 that divides Cout and leaves at least
// 128 work items at batch 16) and the stages (as many as fit, up to 8). At
// batch 16 on the IR-SE50 shapes (conv1 | conv2; tile, NS, stages, items):
//   256, 64->64, s2     8x16, 64, 8, 8192   | 8x16, 64, 8, 2048
//   128, 64->64, s1     8x16, 64, 8, 2048   | 8x16, 64, 8, 2048
//   128, 64->128, s2    8x16, 128, 8, 2048  | 8x16, 128, 4, 512
//   64, 128->128, s1    8x16, 128, 8, 512   | 8x16, 128, 8, 512
//   64, 128->256, s2    8x16, 256, 5, 512   | 8x16, 256, 2, 128
//   32, 256->256, s1    8x16, 256, 5, 128   | 8x16, 256, 5, 128
//   32, 256->512, s2    8x16, 256, 5, 256   | 8x16, 128, 4, 128
//   16, 512->512, s1    8x16, 128, 8, 128   | 8x16, 128, 8, 128
// Shared memory: A 2 x 23,552 bytes at stride 1 (10 x 18 halo pixels) and
// 2 x 72,704 at stride 2 (17 x 33); B stages of 8, 16 or 32 KB; conv1 the
// bn1 affine (8 Cin bytes), conv2 the partial sums of the 8 consumer warps
// (32 NS bytes); 93,952 to 220,416 bytes a block, one block an SM. ptxas
// for sm_90a: 168 registers a thread at launch in each of the six
// instantiations (NS 64, 128, 256; conv1, conv2), no spills.
//
// Tried on an H100 and left out (PERF.md): a cluster of 2 blocks on
// neighbouring tiles with each weight box multicast to both halves the
// weights' L2 reads and was no faster (the consumers' waits for a box are
// not L2 bandwidth); a second consumer warpgroup started a few taps behind
// the first, and three taps per commit group, were slower.

#include <cuda.h>
#include <stddef.h>
#include <stdio.h>

#include "irse.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int kConsumerWarpgroups = 2;
constexpr int kConsumerWarps = 4 * kConsumerWarpgroups;
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
// Registers a thread after the producer hands its own back: 56 + 2 x 224
// fit in an SM sub-partition's 512 (the producer's fix-up of conv1's slabs
// needs more than flash_attention_sm90.cu's 40).
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kTileMax = 128;   // output pixels of a tile: two 64-row halves
constexpr int kSlab = 64;       // channels of an A slab, K of a B box
constexpr int kTaps = 9;
constexpr int kMaxStages = 8;
constexpr int kMaxHalo = 256;   // TMA's largest box side
constexpr int kSmemMax = 232448;
constexpr int kBarrierBytes = 256;

struct Params {
  int H, W;        // input of the pass
  int Ho, Wo;      // its output
  int c;           // input channels: K = 9 c
  int cout;        // output channels: N
  int s;           // stride
  int th, tw;      // output tile
  int hh, hw;      // the tile's halo: s (th - 1) + 3, s (tw - 1) + 3
  int ntw, tiles;  // tiles across an image, tiles per image
  int nslabs;      // N slabs per tile: cout / NS
  int items;       // B tiles nslabs
  int stages;      // B ring
  int a_bytes;     // one A buffer: hh hw 128 rounded up to 1024
};

// The work item's image, output tile origin and N slab.
struct Item {
  int b, tile, oy0, ox0, n0;
  __device__ Item(const Params& p, int item, int ns) {
    const int slab = item % p.nslabs;
    const int rest = item / p.nslabs;
    tile = rest % p.tiles;
    b = rest / p.tiles;
    const int ty = tile / p.ntw;
    oy0 = ty * p.th;
    ox0 = (tile - ty * p.ntw) * p.tw;
    n0 = slab * ns;
  }
};

// Dynamic shared memory of one block (ops/fused_irse_unit.py::plan computes
// the same): alignment slack, the B stages, two A buffers, the pass's own
// vectors and the barriers.
size_t smem_bytes(const Params& p, int ns, bool conv1) {
  return 1024 + (size_t)p.stages * ns * 128 + 2 * (size_t)p.a_bytes +
         (conv1 ? 8 * (size_t)p.c : 32 * (size_t)ns) + kBarrierBytes;
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Barrier of the 256 consumer threads (id 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// Conv1's prologue on one landed slab (channels 64 j ...), by the kFixers
// threads f = 0 .. kFixers - 1 of the producer warpgroup: h = a1 x + b1
// rounded to bf16 on the pixels inside the image. Pixels outside it arrived
// as zeros, which is conv1's padding. Thread f takes the 16-byte chunk of
// channels 8 (f mod 8) ... of every 8th pixel from f / 8, two pixels a
// round (both loads before either store); aff holds a1 then b1 (f32, c
// each) in shared memory.
constexpr int kFixers = 64;
constexpr int kFixRound = 2;

__device__ __forceinline__ void bn1_affine(uint8_t* slab, const float* aff,
                                           const Params& p, int oy0, int ox0,
                                           int j, int f) {
  const int chunk = f & 7;
  float a[8], b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    a[e] = aff[kSlab * j + 8 * chunk + e];
    b[e] = aff[p.c + kSlab * j + 8 * chunk + e];
  }
  // pix / hw as floor((pix + 0.5) / hw), exact in f32 for pix < 2^12
  const float rcp = 1.f / p.hw;
  const int pixels = p.hh * p.hw;
  for (int pix0 = f >> 3; pix0 < pixels; pix0 += kFixRound * (kFixers / 8)) {
    uint4 v[kFixRound];
    uint4* at[kFixRound];
    bool in[kFixRound];
#pragma unroll
    for (int u = 0; u < kFixRound; ++u) {
      const int pix = pix0 + u * (kFixers / 8);
      const int hy = (int)(((float)pix + 0.5f) * rcp);
      const int gy = oy0 - 1 + hy;
      const int gx = ox0 - 1 + (pix - hy * p.hw);
      in[u] = pix < pixels && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      at[u] = reinterpret_cast<uint4*>(slab + 128 * pix +
                                       16 * (chunk ^ (pix & 7)));
      if (in[u]) v[u] = *at[u];
    }
#pragma unroll
    for (int u = 0; u < kFixRound; ++u) {
      if (!in[u]) continue;
      uint32_t* w = reinterpret_cast<uint32_t*>(&v[u]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 x =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[q]));
        w[q] = pack_bf16(affine(x.x, a[2 * q], b[2 * q]),
                         affine(x.y, a[2 * q + 1], b[2 * q + 1]));
      }
      *at[u] = v[u];
    }
  }
}

// v[k] of lane q of a quad becomes v[q] of lane k (a 4 x 4 transpose of
// 32-bit values among the quad's lanes, tq = lane mod 4), in two exchanges.
__device__ __forceinline__ void quad_transpose(uint32_t* v, int tq) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const bool up = tq & m;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k & m) continue;
      // the lower lane keeps v[k] and gets the upper lane's v[k]; the upper
      // lane keeps v[k + m] and gets the lower lane's v[k + m]
      const uint32_t send = up ? v[k] : v[k + m];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, m);
      if (up)
        v[k] = got;
      else
        v[k + m] = got;
    }
  }
}

// Halves an N-value partial sum with the lane across ``mask``: the lane
// with the bit clear keeps values [0, N/2), the other [N/2, N), each adding
// its partner's share, into s[0 .. N/2).
template <int N>
__device__ __forceinline__ void reduce_half(float* s, int upper, int mask) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? s[i] : s[i + N / 2];
    const float keep = upper ? s[i + N / 2] : s[i];
    s[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// Accumulator layout (wgmma m64nN): a thread of a consumer warpgroup holds
// rows r0 = 16 (warp in warpgroup) + lane / 4 and r0 + 8 of its 64-row half,
// and in each 8-column group g the columns 8g + 2 (lane % 4) and the next:
// acc[4g], acc[4g + 1] on row r0, acc[4g + 2], acc[4g + 3] on row r0 + 8.
template <int NS, bool kConv1>
__global__ void __launch_bounds__(kThreads, 1)
irse_conv_sm90(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, const Params p,
               const float* __restrict__ a1, const float* __restrict__ b1,
               const float* __restrict__ alpha, const float* __restrict__ b2,
               bf16* __restrict__ out, float* __restrict__ partials) {
  constexpr uint32_t kBoxBytes = NS * 128;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors repeat every 1024 bytes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gen = smem_raw + (base - raw);  // base, as a pointer
  const uint32_t a_buf = base + p.stages * kBoxBytes;
  const uint32_t extra = a_buf + 2 * p.a_bytes;  // affine or partial sums
  float* const extra_f = reinterpret_cast<float*>(gen + (extra - base));
  const uint32_t a_full = extra + (kConv1 ? 8 * p.c : 32 * NS);
  const uint32_t a_empty = a_full + 16;
  const uint32_t b_full = a_empty + 16;
  const uint32_t b_empty = b_full + 8 * p.stages;
  // conv1: a slab is ready once fixed up, conv2: once landed
  const uint32_t a_ready = kConv1 ? b_empty + 8 * p.stages : a_full;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kslabs = p.c / kSlab;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(a_full + 8 * i, 1);
      mbar_init(a_empty + 8 * i, kConsumerWarps);
      if (kConv1) mbar_init(a_ready + 8 * i, kFixers / 32);
    }
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(b_full + 8 * i, 1);
      mbar_init(b_empty + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kConv1) {
    for (int i = threadIdx.x; i < p.c; i += kThreads) {
      extra_f[i] = a1[i];
      extra_f[p.c + i] = b1[i];
    }
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer warpgroup: lane 0 of its first warp loads the A slabs, lane
    // 0 of its second the B boxes; in conv1 its last two warps apply the
    // bn1 affine to each landed slab
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int role = warp - kConsumerWarps;
    if (kConv1 && role >= 2) {
      const int fixer = threadIdx.x - kConsumerThreads - 64;
      int sl = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const Item it(p, item, NS);
        for (int j = 0; j < kslabs; ++j, ++sl) {
          const int buf = sl & 1;
          mbar_wait(a_full + 8 * buf, (sl >> 1) & 1);
          bn1_affine(gen + (a_buf + buf * p.a_bytes - base), extra_f, p,
                     it.oy0, it.ox0, j, fixer);
          // these writes come before the next TMA load into the buffer
          fence_async_shared();
          __syncwarp();
          if (lane == 0) mbar_arrive(a_ready + 8 * buf);
        }
      }
      return;
    }
    if (lane != 0 || role > 1) return;
    if (role == 0) {
      const uint32_t bytes = p.hh * p.hw * 128;
      int sl = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const Item it(p, item, NS);
        for (int j = 0; j < kslabs; ++j, ++sl) {
          const int buf = sl & 1;
          mbar_wait(a_empty + 8 * buf, ((sl >> 1) & 1) ^ 1);
          mbar_expect_tx(a_full + 8 * buf, bytes);
          tma_load_4d(a_buf + buf * p.a_bytes, &ta, a_full + 8 * buf,
                      kSlab * j, p.s * it.ox0 - 1, p.s * it.oy0 - 1, it.b);
        }
      }
    } else {
      int st = 0, phase = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const Item it(p, item, NS);
        for (int j = 0; j < kslabs; ++j) {
          for (int t = 0; t < kTaps; ++t) {
            mbar_wait(b_empty + 8 * st, phase ^ 1);
            mbar_expect_tx(b_full + 8 * st, kBoxBytes);
            tma_load_2d(base + st * kBoxBytes, &tb, b_full + 8 * st,
                        t * p.c + kSlab * j, it.n0);
            if (++st == p.stages) {
              st = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int tile_px = p.th * p.tw;
  // the pixel whose row this lane hands ldmatrix (tile rows past the tile
  // read a pixel inside it; their results are not stored), and the 16-byte
  // half of a k16 step it reads
  const int m_ld = min(64 * wg + 16 * (warp & 3) + (lane & 15), tile_px - 1);
  const int ry = m_ld / p.tw;
  const int p0 = p.s * (ry * p.hw + (m_ld - ry * p.tw));
  const int half = lane >> 4;
  // the two tile rows of this thread's accumulators
  const int m_acc = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int tq = lane & 3;

  float acc[NS / 2];
  uint32_t af[16];
  int sl = 0, st = 0, phase = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const Item it(p, item, NS);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < kslabs; ++j, ++sl) {
      const int buf = sl & 1;
      const uint32_t slab = a_buf + buf * p.a_bytes;
      mbar_wait(a_ready + 8 * buf, (sl >> 1) & 1);
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const int pix = p0 + (t / 3) * p.hw + t % 3;
        const uint32_t row = slab + pix * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(af + 4 * kk, row + (((2 * kk + half) ^ (pix & 7)) << 4));
        if (t == kTaps - 1) {
          // every ldmatrix of this slab has read it
          __syncwarp();
          if (lane == 0) mbar_arrive(a_empty + 8 * buf);
        }
        mbar_wait(b_full + 8 * st, phase);
        const uint32_t box = base + st * kBoxBytes;
        fence_regs<16>(af);
        fence_regs<NS / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<NS>(acc, af + 4 * kk, sw128_desc(box + 32 * kk));
        wgmma_commit();
        fence_regs<NS / 2>(acc);
        // The tap's products are waited for before the next tap's A
        // fragments are loaded: ptxas serialises every wgmma of a kernel
        // where registers that a wgmma reads are written while another is
        // in flight. The other consumer warpgroup's products fill the gap.
        wgmma_wait<0>();
        fence_regs<16>(af);
        __syncwarp();
        if (lane == 0) mbar_arrive(b_empty + 8 * st);
        if (++st == p.stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }

    // epilogue: the offsets of this thread's two output pixels, or -1
    // where the row lies past the tile or the image
    long long off[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m_acc + 8 * r;
      const int oy = it.oy0 + m / p.tw;
      const int ox = it.ox0 + m % p.tw;
      off[r] = (m < tile_px && oy < p.Ho && ox < p.Wo)
                   ? (((long long)it.b * p.Ho + oy) * p.Wo + ox) * p.cout +
                         it.n0
                   : -1;
    }
    // In blocks of 4 column groups: the 4 x 4 bf16 pairs of a row that a
    // quad of lanes holds are transposed among them, so that each lane
    // stores 8 channels (16 bytes) of one group.
#pragma unroll
    for (int blk = 0; blk < NS / 32; ++blk) {
      float2 vec[4];  // conv1: the PReLU slopes, conv2: b2
#pragma unroll
      for (int k = 0; k < 4; ++k)
        vec[k] = __ldg(reinterpret_cast<const float2*>(
            (kConv1 ? alpha : b2) + it.n0 + 8 * (4 * blk + k) + 2 * tq));
      float sums[8];  // conv2: the f32 values of groups 4 blk + k summed over
                      // this thread's valid rows, [2 k + e]
#pragma unroll
      for (int i = 0; i < 8; ++i) sums[i] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int g = 4 * blk + k;
          float v0 = acc[4 * g + 2 * r], v1 = acc[4 * g + 2 * r + 1];
          if constexpr (kConv1) {
            // y1 = round_bf16(PReLU(acc))
            v0 = v0 >= 0.f ? v0 : vec[k].x * v0;
            v1 = v1 >= 0.f ? v1 : vec[k].y * v1;
          } else {
            // res2 = acc + b2 in f32, summed before it is rounded
            v0 = __fadd_rn(v0, vec[k].x);
            v1 = __fadd_rn(v1, vec[k].y);
            if (off[r] >= 0) {
              sums[2 * k] += v0;
              sums[2 * k + 1] += v1;
            }
          }
          v[k] = pack_bf16(v0, v1);
        }
        quad_transpose(v, tq);
        if (off[r] >= 0)
          *reinterpret_cast<uint4*>(out + off[r] + 8 * (4 * blk + tq)) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
      if constexpr (!kConv1) {
        // over the warp's 8 rows (lane bits 2-4) by halving exchanges:
        // after them lane l holds sums[4 b2 + 2 b3 + b4] of the 8 rows,
        // b_i = bit i of l
        reduce_half<8>(sums, lane & 4, 4);
        reduce_half<4>(sums, lane & 8, 8);
        reduce_half<2>(sums, lane & 16, 16);
        const int i = 4 * ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1) +
                      ((lane >> 4) & 1);
        extra_f[warp * NS + 8 * (4 * blk + (i >> 1)) + 2 * tq + (i & 1)] =
            sums[0];
      }
    }
    if constexpr (!kConv1) {
      // the 8 warps' sums, added in warp order
      consumers_sync();
      float* const pt =
          partials + ((size_t)it.b * p.tiles + it.tile) * p.cout + it.n0;
      for (int n = threadIdx.x; n < NS; n += kConsumerThreads) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) v += extra_f[w * NS + n];
        pt[n] = v;
      }
      consumers_sync();
    }
  }
}

// -- host side -------------------------------------------------------------------

char g_message[256];

// Own errors are negative, with their text in g_message.
int fail(const char* what, int code) {
  snprintf(g_message, sizeof g_message, "%s (%d)", what, code);
  return -1;
}

// A tensor map over bf16 data: dims and box innermost first, byte strides
// of the outer dims; 128-byte swizzle, zeros outside the tensor.
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return fail("cuTensorMapEncodeTiled not found", 0);
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return fail("cuTensorMapEncodeTiled failed", (int)r);
  return 0;
}

// One pass: activations act (B, H, W, c) NHWC, weights w (cout, 9 c), plan
// = {th, tw, NS, stages}.
struct Pass {
  Params p;
  int ns;
  CUtensorMap maps[2];
};

int prepare(Pass* ps, const void* act, const void* w, int B, int H, int W,
            int c, int cout, int s, const int* plan) {
  Params& p = ps->p;
  p.H = H;
  p.W = W;
  p.Ho = H / s;
  p.Wo = W / s;
  p.c = c;
  p.cout = cout;
  p.s = s;
  p.th = plan[0];
  p.tw = plan[1];
  ps->ns = plan[2];
  p.stages = plan[3];
  p.hh = s * (p.th - 1) + 3;
  p.hw = s * (p.tw - 1) + 3;
  const int ns = ps->ns;
  if (c % kSlab != 0 || (ns != 64 && ns != 128 && ns != 256) ||
      cout % ns != 0 || p.th < 1 || p.tw < 1 || p.th * p.tw > kTileMax ||
      p.hh > kMaxHalo || p.hw > kMaxHalo || p.stages < 2 ||
      p.stages > kMaxStages)
    return fail("plan not taken", 0);
  p.ntw = (p.Wo + p.tw - 1) / p.tw;
  p.tiles = ((p.Ho + p.th - 1) / p.th) * p.ntw;
  p.nslabs = cout / ns;
  const long long items = (long long)B * p.tiles * p.nslabs;
  if (items > 0x7fffffffLL) return fail("too many work items", 0);
  p.items = (int)items;
  p.a_bytes = (p.hh * p.hw * 128 + 1023) / 1024 * 1024;
  const cuuint64_t adims[4] = {(cuuint64_t)c, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t astrides[3] = {(cuuint64_t)c * 2, (cuuint64_t)W * c * 2,
                                  (cuuint64_t)H * W * c * 2};
  const cuuint32_t abox[4] = {kSlab, (cuuint32_t)p.hw, (cuuint32_t)p.hh, 1};
  int rc = encode(&ps->maps[0], act, 4, adims, astrides, abox);
  if (rc != 0) return rc;
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * c, (cuuint64_t)cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)9 * c * 2};
  const cuuint32_t wbox[2] = {kSlab, (cuuint32_t)ns};
  return encode(&ps->maps[1], w, 2, wdims, wstrides, wbox);
}

template <int NS, bool kConv1>
int launch_pass(const Pass& ps, const float* a1, const float* b1,
                const float* alpha, const float* b2, bf16* out,
                float* partials, int sms, cudaStream_t stream) {
  auto kernel = irse_conv_sm90<NS, kConv1>;
  const size_t smem = smem_bytes(ps.p, NS, kConv1);
  if (smem > (size_t)kSmemMax) return fail("plan exceeds shared memory", 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = ps.p.items < sms ? ps.p.items : sms;
  kernel<<<grid, kThreads, smem, stream>>>(ps.maps[0], ps.maps[1], ps.p, a1,
                                           b1, alpha, b2, out, partials);
  return (int)cudaGetLastError();
}

template <bool kConv1>
int run_pass(const Pass& ps, const float* a1, const float* b1,
             const float* alpha, const float* b2, bf16* out, float* partials,
             int sms, cudaStream_t stream) {
  switch (ps.ns) {
    case 64:
      return launch_pass<64, kConv1>(ps, a1, b1, alpha, b2, out, partials,
                                     sms, stream);
    case 128:
      return launch_pass<128, kConv1>(ps, a1, b1, alpha, b2, out, partials,
                                      sms, stream);
    default:
      return launch_pass<256, kConv1>(ps, a1, b1, alpha, b2, out, partials,
                                      sms, stream);
  }
}

}  // namespace

extern "C" {

// bf16 x (B, H, W, cin) NHWC, w1 (cout, 3, 3, cin) and w2 (cout, 3, 3,
// cout) OHWI in bf16, a1, b1, alpha, b2 in f32. y1 (B, H, W, cout) bf16
// scratch; out (B, H/s, W/s, cout) bf16; partials (B, conv2 tiles, cout) and
// sums (B, cout) f32. plan: 8 ints, {th, tw, NS, stages} of conv1 then of
// conv2. passes: 1 conv1, 2 conv2 and the reduction, 3 both. Returns 0
// when launched, a CUDA error code, or -1 (see
// fused_irse_unit_sm90_error_string).
int fused_irse_unit_sm90_forward(const void* x, const void* a1,
                                 const void* b1, const void* w1,
                                 const void* alpha, const void* w2,
                                 const void* b2, void* y1, void* out,
                                 void* partials, void* sums, int B, int H,
                                 int W, int cin, int cout, int stride,
                                 const int* plan, int passes, void* stream) {
  if (B < 1 || H < 1 || W < 1 || (stride != 1 && stride != 2) ||
      H % stride != 0 || W % stride != 0 || passes < 1 || passes > 3)
    return (int)cudaErrorInvalidValue;
  Pass conv1, conv2;
  int rc = prepare(&conv1, x, w1, B, H, W, cin, cout, 1, plan);
  if (rc == 0) rc = prepare(&conv2, y1, w2, B, H, W, cout, cout, stride,
                            plan + 4);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[4] = {static_cast<const float*>(a1),
                       static_cast<const float*>(b1),
                       static_cast<const float*>(alpha),
                       static_cast<const float*>(b2)};
  if (passes & 1) {
    rc = run_pass<true>(conv1, f[0], f[1], f[2], f[3], static_cast<bf16*>(y1),
                        nullptr, sms, st);
    if (rc != 0) return rc;
  }
  if (passes & 2) {
    rc = run_pass<false>(conv2, f[0], f[1], f[2], f[3],
                         static_cast<bf16*>(out),
                         static_cast<float*>(partials), sms, st);
    if (rc != 0) return rc;
    reduce_tile_sums<<<dim3((cout + 255) / 256, B), 256, 0, st>>>(
        static_cast<const float*>(partials), static_cast<float*>(sums),
        conv2.p.tiles, cout);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

const char* fused_irse_unit_sm90_error_string(int code) {
  if (code < 0) return g_message;
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
