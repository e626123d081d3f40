// Fused IR-SE residual branch for Hopper (sm_90a), one launch per trunk unit.
//
// Replaces the TPU kernel fer_vit_tpu/ops/fused_irse_unit.py::_kernel.
// For one IR-SE bottleneck unit it computes, in NHWC activations:
//
//   h    = round_T(a1 * x + b1)               bn1 eval affine, f32, zero outside the image
//   y1   = round_T(PReLU(conv3x3_s1(h)))      f32 accumulation, zero outside the image
//   res2 = conv3x3_s(y1) + b2                 stride s in {1, 2}, f32 accumulation
//   sums = sum over space of res2 (f32, taken before res2 is rounded to T)
//
// T is the input type: bf16 on the main path, f32 for tight checks. Both
// types run the same kernel body; only the tensor-core instruction differs.
// The weights arrive already rounded to T, in OHWI layout. The rounding
// points are the TPU kernel's.
//
// Design. Each block owns a TH x TW output tile of one image and all Cout
// channels. It loads the input tile with its 2-pixel halo
// ((s*(TH-1)+5) x (s*(TW-1)+5) x Cin), applies the bn1 affine and keeps it in
// shared memory; it computes the conv1 + PReLU intermediate for the tile's
// conv2 halo ((s*(TH-1)+3) x (s*(TW-1)+3) x Cout) into shared memory too;
// conv2 then reads only shared memory. The conv1 output never reaches device
// memory, which is the point of the TPU kernel. The host picks the tile per
// shape (fused_irse_unit.py::pick_tile): the largest that lets two blocks
// share an SM (<= 112 KB), else the largest within 227 KB. The price is
// conv1 work on the halo: at a stride-1 tile of 8x4 conv1 runs on 60 pixels
// for 32 outputs (1.88x), at 16x16 on 324 for 256 (1.27x); at stride 2 an
// 8x8 tile needs 289 intermediates for 256 (1.13x), a 4x2 tile 45 for 32
// (1.41x).
//
// Both convolutions are implicit GEMMs on the tensor cores with f32
// accumulators: M = the stage's pixels, N = Cout, K = 9 * C in (kh, kw, ci)
// order. A (pixels x K) comes from the shared tiles through ldmatrix; each
// pixel row is padded by 16 bytes so the 8 rows of an 8x8 matrix fall in
// different banks. B comes from the OHWI weights (K contiguous per output
// channel) straight from L2, one k-step ahead in registers. A k-step is 32
// bytes of K, so the fragments' byte addressing is the same for both types:
//   bf16: mma.sync m16n8k16, 16 channels per k-step;
//   f32:  mma.sync m16n8k8 tf32, 8 channels per k-step, at f32 accuracy by
//         the 3xTF32 split (x = hi + lo, a*b ~ hi*hi + hi*lo + lo*hi), each
//         k-step summed apart and added to the accumulator in f32.
// bf16 keeps one tensor-core accumulator per output: its sums round toward
// zero, a bias that grows with K but stays far below the bf16 output
// rounding (2^-9).
// Each warp takes work items of 4 m-tiles x 2 n-tiles; an item's epilogue
// applies PReLU / the bias, and conv2's SE partial sums are reduced over the
// item's pixels with warp shuffles.
//
// SE squeeze sums: blocks run in parallel, so each block writes its tile's
// per-channel partial sums to a (B, n_tiles, Cout) scratch, and a second small
// launch reduces them in tile order. Deterministic, no atomics.
//
// Bound on an H100 SXM: max(2 * MACs / 989e12, bytes / 3.35e12), with
// MACs = B*(H*W*Cin + H2*W2*Cout)*9*Cout and bytes = x read once + res2 written
// once + both weights. Every IR-SE50 unit shape is bound by operations (for
// example 32x32, 256->256, stride 1: 39 us of operations against 6 us of bytes
// at batch 16). What keeps this kernel from the bound: the halo recompute
// above, mma.sync in place of wgmma, and B re-read from L2 by every block and
// every m-chunk rather than staged in shared memory by TMA.

#include <stddef.h>

#include "irse.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMC = 4;  // m-tiles (16 pixels) per warp item
constexpr int kNC = 2;  // n-tiles (8 channels) per warp item

struct Geometry {
  int H, W, H2, W2, cin, cout, s, th, tw;
  int oh0, ow0;          // output tile origin
  int yh, yw, xh, xw;    // intermediate and input tile sizes
  int y_r0, y_c0;        // global position of intermediate (0, 0)
  int x_r0, x_c0;        // global position of input (0, 0)

  __device__ Geometry(int H_, int W_, int cin_, int cout_, int s_, int th_,
                      int tw_, int tile, int ntw)
      : H(H_), W(W_), H2(H_ / s_), W2(W_ / s_), cin(cin_), cout(cout_), s(s_),
        th(th_), tw(tw_) {
    oh0 = (tile / ntw) * th;
    ow0 = (tile % ntw) * tw;
    yh = s * (th - 1) + 3;
    yw = s * (tw - 1) + 3;
    xh = yh + 2;
    xw = yw + 2;
    y_r0 = s * oh0 - 1;
    y_c0 = s * ow0 - 1;
    x_r0 = y_r0 - 1;
    x_c0 = y_c0 - 1;
  }
  __device__ bool in_image(int r, int c) const {
    return r >= 0 && r < H && c >= 0 && c < W;
  }
};

// conv1 epilogue: PReLU on channels (co, co+1) of pixel p, zero outside the
// image, round to T into the shared intermediate.
template <typename T>
struct Conv1Epilogue {
  T* ys;
  int cp;  // pixel stride of ys
  const float* alpha;
  const Geometry* g;

  __device__ __forceinline__ void pixel2(int p, int co, float v0, float v1) {
    const int j = p / g->yw;
    const int k = p - j * g->yw;
    if (g->in_image(g->y_r0 + j, g->y_c0 + k)) {
      v0 = v0 >= 0.f ? v0 : alpha[co] * v0;
      v1 = v1 >= 0.f ? v1 : alpha[co + 1] * v1;
    } else {
      v0 = v1 = 0.f;
    }
    store2(ys + p * cp + co, v0, v1);
  }
};

// conv2 epilogue: + b2 in f32, store res2 in T, return the f32 values for
// the SE partial sums (0 for pixels outside the image).
template <typename T>
struct Conv2Epilogue {
  T* out;  // this image's res2
  const float* b2;
  float* red;  // (m-chunks, cout)
  const Geometry* g;

  __device__ __forceinline__ float2 pixel2(int p, int co, float v0, float v1) {
    const int r = p / g->tw;
    const int c = p - r * g->tw;
    const int gr = g->oh0 + r;
    const int gc = g->ow0 + c;
    if (gr >= g->H2 || gc >= g->W2) return make_float2(0.f, 0.f);
    v0 = __fadd_rn(v0, b2[co]);
    v1 = __fadd_rn(v1, b2[co + 1]);
    store2(out + ((size_t)gr * g->W2 + gc) * g->cout + co, v0, v1);
    return make_float2(v0, v1);
  }
};

// One 3x3 conv stage on the tensor cores:
//   acc(p, co) = sum_{kh,kw,ci} src[(s*r+kh)*src_w + s*c+kw][ci] * w[co][kh][kw][ci]
// over the nh x nw pixels p = (r, c) of a stage, src a shared tile of pixel
// stride cp and C channels, w in OHWI. Conv1 (kWithSums = false) stores into
// shared memory; conv2 stores res2 and writes per-(m-chunk, channel) partial
// sums to red.
template <typename T, bool kWithSums, typename Epilogue>
__device__ void mma_conv_stage(const T* __restrict__ src, int src_w, int cp,
                               int c, int s, int nh, int nw,
                               const T* __restrict__ w, int cout,
                               Epilogue& epi) {
  constexpr bool kTf32 = sizeof(T) == 4;
  constexpr int kK = Elems<T>::kK;
  constexpr int kHalf = Elems<T>::kHalf;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // accumulator row (and B column) of this lane
  const int tq = lane & 3;   // accumulator column pair of this lane
  const int np = nh * nw;
  const int m_tiles = (np + 15) / 16;
  const int n_tiles = cout / 8;
  const int m_chunks = (m_tiles + kMC - 1) / kMC;
  const int n_chunks = (n_tiles + kNC - 1) / kNC;
  const int K = 9 * c;
  const int k_steps = K / kK;

  for (int item = warp; item < m_chunks * n_chunks; item += kWarps) {
    const int mc = item / n_chunks;
    const int nc = item - mc * n_chunks;
    const int mt_n = min(kMC, m_tiles - mc * kMC);
    const int nt_n = min(kNC, n_tiles - nc * kNC);

    // ldmatrix rows: lane l reads pixel row (l % 16) of each m-tile, 16-byte
    // column half (l / 16) of the k-step.
    int a_row[kMC];
#pragma unroll
    for (int i = 0; i < kMC; ++i) {
      const int p = min((mc * kMC + i) * 16 + (lane & 15), np - 1);
      const int r = p / nw;
      const int q = p - r * nw;
      a_row[i] = (s * r * src_w + s * q) * cp + (lane >> 4) * kHalf;
    }
    // B fragment: lane reads 4 bytes at column gq, k-offset 4*tq bytes, and
    // 16 bytes further.
    const T* wb[kNC];
#pragma unroll
    for (int j = 0; j < kNC; ++j) {
      const int n = min((nc * kNC + j) * 8 + gq, cout - 1);
      wb[j] = w + (size_t)n * K + tq * (4 / (int)sizeof(T));
    }

    float acc[kMC][kNC][4];
#pragma unroll
    for (int i = 0; i < kMC; ++i)
#pragma unroll
      for (int j = 0; j < kNC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    uint32_t bn[kNC][2];
#pragma unroll
    for (int j = 0; j < kNC; ++j) {
      bn[j][0] = ld_b32(wb[j]);
      bn[j][1] = ld_b32(wb[j] + kHalf);
    }
    int ci = 0;
    int off = 0;  // shared offset of tap (kh, kw)
    int tap = 0;
    for (int ks = 0; ks < k_steps; ++ks) {
      uint32_t b[kNC][2];
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        b[j][0] = bn[j][0];
        b[j][1] = bn[j][1];
      }
      if (ks + 1 < k_steps) {
        const int k1 = (ks + 1) * kK;
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          bn[j][0] = ld_b32(wb[j] + k1);
          bn[j][1] = ld_b32(wb[j] + k1 + kHalf);
        }
      }
      [[maybe_unused]] uint32_t b_hi[kNC][2], b_lo[kNC][2];
      if constexpr (kTf32) {
#pragma unroll
        for (int j = 0; j < kNC; ++j) split_tf32(b[j], b_hi[j], b_lo[j]);
      }
#pragma unroll
      for (int i = 0; i < kMC; ++i) {
        if (i < mt_n) {
          uint32_t a[4];
          ldmatrix_x4(a, src + a_row[i] + off + ci);
          if constexpr (kTf32) {
            uint32_t a_hi[4], a_lo[4];
            split_tf32(a, a_hi, a_lo);
#pragma unroll
            for (int j = 0; j < kNC; ++j) {
              // The tensor cores round their sums toward zero, a bias that
              // would grow with K in one accumulator: each k-step gets a
              // fresh one, added to acc with a rounded f32 add.
              float t[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(t, a_lo, b_hi[j]);
              mma_tf32(t, a_hi, b_lo[j]);
              mma_tf32(t, a_hi, b_hi[j]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
            }
          } else {
#pragma unroll
            for (int j = 0; j < kNC; ++j) mma_bf16(acc[i][j], a, b[j]);
          }
        }
      }
      ci += kK;
      if (ci == c) {
        ci = 0;
        ++tap;
        const int kh = tap / 3;
        off = (kh * src_w + (tap - kh * 3)) * cp;
      }
    }

#pragma unroll
    for (int j = 0; j < kNC; ++j) {
      if (j >= nt_n) continue;
      const int co = (nc * kNC + j) * 8 + 2 * tq;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < kMC; ++i) {
        if (i >= mt_n) continue;
        const int p = (mc * kMC + i) * 16 + gq;
        if constexpr (kWithSums) {
          if (p < np) {
            const float2 v = epi.pixel2(p, co, acc[i][j][0], acc[i][j][1]);
            s0 += v.x;
            s1 += v.y;
          }
          if (p + 8 < np) {
            const float2 v = epi.pixel2(p + 8, co, acc[i][j][2], acc[i][j][3]);
            s0 += v.x;
            s1 += v.y;
          }
        } else {
          if (p < np) epi.pixel2(p, co, acc[i][j][0], acc[i][j][1]);
          if (p + 8 < np) epi.pixel2(p + 8, co, acc[i][j][2], acc[i][j][3]);
        }
      }
      if constexpr (kWithSums) {
        // sum over the 8 accumulator rows (lanes with the same tq)
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, m);
          s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        }
        if (gq == 0) {
          epi.red[mc * cout + co] = s0;
          epi.red[mc * cout + co + 1] = s1;
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_irse_unit(const T* __restrict__ x, const float* __restrict__ a1,
                const float* __restrict__ b1, const T* __restrict__ w1,
                const float* __restrict__ alpha, const T* __restrict__ w2,
                const float* __restrict__ b2, T* __restrict__ out,
                float* __restrict__ partials, int H, int W, int cin, int cout,
                int s, int th, int tw, int ntw) {
  extern __shared__ float4 smem4[];
  const Geometry g(H, W, cin, cout, s, th, tw, blockIdx.x, ntw);
  const int b = blockIdx.y;
  const int cp1 = cin + Elems<T>::kPad;
  const int cp2 = cout + Elems<T>::kPad;
  T* xs = reinterpret_cast<T*>(smem4);      // (xh, xw, cp1)
  T* ys = xs + g.xh * g.xw * cp1;           // (yh, yw, cp2)
  float* red = reinterpret_cast<float*>(ys + g.yh * g.yw * cp2);  // (mc, cout)

  const T* xb = x + (size_t)b * H * W * cin;
  const int n_x = g.xh * g.xw * cin;
  for (int idx = threadIdx.x; idx < n_x; idx += kThreads) {
    const int ci = idx % cin;
    const int pix = idx / cin;
    const int i = pix / g.xw;
    const int j = pix - i * g.xw;
    const int gr = g.x_r0 + i;
    const int gc = g.x_c0 + j;
    float v = 0.f;
    if (g.in_image(gr, gc))
      v = affine(to_f32(xb[((size_t)gr * W + gc) * cin + ci]), a1[ci], b1[ci]);
    xs[pix * cp1 + ci] = from_f32<T>(v);
  }
  __syncthreads();

  Conv1Epilogue<T> e1{ys, cp2, alpha, &g};
  mma_conv_stage<T, false>(xs, g.xw, cp1, cin, 1, g.yh, g.yw, w1, cout, e1);
  __syncthreads();

  Conv2Epilogue<T> e2{out + (size_t)b * g.H2 * g.W2 * cout, b2, red, &g};
  mma_conv_stage<T, true>(ys, g.yw, cp2, cout, s, th, tw, w2, cout, e2);
  __syncthreads();

  const int m_chunks = ((th * tw + 15) / 16 + kMC - 1) / kMC;
  float* pb = partials + ((size_t)b * gridDim.x + blockIdx.x) * cout;
  for (int co = threadIdx.x; co < cout; co += kThreads) {
    float acc = 0.f;
    for (int q = 0; q < m_chunks; ++q) acc += red[q * cout + co];
    pb[co] = acc;
  }
}

// Dynamic shared memory of one block (fused_irse_unit.py::smem_bytes).
template <typename T>
size_t smem_bytes(int cin, int cout, int s, int th, int tw) {
  const size_t yh = s * (th - 1) + 3;
  const size_t yw = s * (tw - 1) + 3;
  const size_t m_chunks = ((th * tw + 15) / 16 + kMC - 1) / kMC;
  return sizeof(T) * ((yh + 2) * (yw + 2) * (cin + Elems<T>::kPad) +
                      yh * yw * (cout + Elems<T>::kPad)) +
         4 * m_chunks * cout;
}

template <typename T>
int launch(const void* x, const void* a1, const void* b1, const void* w1,
           const void* alpha, const void* w2, const void* b2, void* out,
           void* partials, void* sums, int B, int H, int W, int cin, int cout,
           int s, int th, int tw, cudaStream_t stream) {
  const int nth = (H / s + th - 1) / th;
  const int ntw = (W / s + tw - 1) / tw;
  const size_t smem = smem_bytes<T>(cin, cout, s, th, tw);
  cudaError_t err = cudaFuncSetAttribute(
      fused_irse_unit<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_irse_unit<T><<<dim3(nth * ntw, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a1),
      static_cast<const float*>(b1), static_cast<const T*>(w1),
      static_cast<const float*>(alpha), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out),
      static_cast<float*>(partials), H, W, cin, cout, s, th, tw, ntw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_tile_sums<<<dim3((cout + 255) / 256, B), 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(sums),
      nth * ntw, cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16; weights OHWI in that type. Returns the CUDA error
// code (0 = launched).
int fused_irse_unit_forward(int dtype, const void* x, const void* a1,
                            const void* b1, const void* w1, const void* alpha,
                            const void* w2, const void* b2, void* out,
                            void* partials, void* sums, int B, int H, int W,
                            int cin, int cout, int stride, int th, int tw,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<bf16>(x, a1, b1, w1, alpha, w2, b2, out, partials, sums, B,
                        H, W, cin, cout, stride, th, tw, st);
  if (dtype == 0)
    return launch<float>(x, a1, b1, w1, alpha, w2, b2, out, partials, sums, B,
                         H, W, cin, cout, stride, th, tw, st);
  return (int)cudaErrorInvalidValue;
}

const char* fused_irse_unit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
