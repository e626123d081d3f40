// A 4x4 FIR over NHWC activations for Hopper (sm_90a): StyleGAN2's up-conv
// blur, forward and backward.
//
// Replaces no TPU kernel: the JAX package's upfirdn2d (fer_vit_tpu/encoders/
// stylegan2.py) is a plain XLA conv. In the port, the up-conv blur ran as a
// depthwise F.conv2d on the channels-last transposed conv output, for which
// cuDNN transposed the activation three times a call and ran a grouped direct
// conv: on an H100, about 75 ms of a 180 ms AFS step at 1024, 512 and 256 px.
// This kernel reads and writes NHWC as it lies. For x (B, H, W, C):
//
//   y[b, i, j, c] = sum over u, v < 4 of x[b, i + u - pad, j + v - pad, c]
//                   * taps[4 u + v]          (x read as 0 outside its bounds)
//
// for i < OH, j < OW, accumulated in f32 in that order (u, then v), rounded
// once to T. taps are 16 f32 values on the device: the blur's kernel flipped
// (a convolution), so the up-conv's blur is pad 1, OH = H - 1. Its gradient
// is the same kernel on the output gradient with the taps flipped back and
// pad 3 - pad, OH the input's side: no zero-stuffed or padded copy, and no
// input kept for it.
//
// T is x's type: bf16 on the main path, f32 for checks.
//
// Bound. Bytes: x read once and y written once. At 1024 px x 32 channels,
// batch 8, bf16 (x 1025^2, y 1024^2): 1.075 GB, 0.32 ms at 3.35 TB/s; the 16
// f32 multiply-adds a value are ~0.13 ms of the card's f32 rate, hidden
// under the loads.
// Design. A block of 256 threads owns an output tile of kTileH rows x tile_w
// pixels x one chunk of a pixel's channels: tpp 16-byte slices, the largest
// divisor of C's slices up to 8 (128 bytes), and tile_w = 128 / tpp, so a
// tile row is 128 slices. It copies the tile's input with its 3-pixel halo
// into shared memory with 16-byte cp.async copies, zero-filled outside x, all
// in flight at once (a tile row of one chunk is contiguous in x). Each thread
// then owns one slice of one output column and kRows rows of it: it reads 4
// slices a row from shared memory and keeps 4 rows' sums in registers, so
// each input row it reads finishes one output row, written as one 16-byte
// store. Neighbouring threads read and write neighbouring 16 bytes. The halo
// makes the tiles read (kTileH + 3)(tile_w + 3) / (kTileH tile_w) of x from
// L2 (1.23 at 32 channels, 1.34 at 64 and over), but device memory about
// once: neighbouring tiles run together. The grid is (tiles, chunks, B). A
// tile of 24 rows takes 60-66 KB of shared memory, so 3 blocks share an SM
// and one block's copies overlap another's sums. The tile is the fastest of
// those measured on an H100 (4 to 24 rows a thread, 64 to 256 slices a tile
// row): 75 % of the bound at 1024 px x 32 and 512 px x 64, batch 8, bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileSlices = 128;     // tile_w x tpp: slices in a tile row
constexpr int kRows = 12;            // output rows a thread computes
constexpr int kGroups = kThreads / kTileSlices;  // threads on one column
constexpr int kTileH = kGroups * kRows;          // output rows a block
constexpr int kMaxTpp = 8;           // slices of a pixel a block takes
constexpr int kTaps = 4;

using bf16 = __nv_bfloat16;

// 16 bytes of T <-> kN floats.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<bf16> {
  static constexpr int kN = 8;
  // a 32-bit word holds two bf16, the first in its low half
  __device__ static void unpack2(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack2(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static void unpack(const uint4& r, float* f) {
    unpack2(r.x, f);
    unpack2(r.y, f + 2);
    unpack2(r.z, f + 4);
    unpack2(r.w, f + 6);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

// How a block cuts the work; tpp 0 for C the kernel does not take.
struct Geometry {
  int tpp, chunks, tile_w, tiles_w, tiles;
};

Geometry geometry(int C, int vec, int OH, int OW) {
  Geometry g = {0, 0, 0, 0, 0};
  if (C <= 0 || C % vec || OH <= 0 || OW <= 0) return g;
  const int slices = C / vec;
  for (int t = kMaxTpp; t >= 1; --t) {
    if (slices % t == 0) {
      g.tpp = t;
      break;
    }
  }
  g.chunks = slices / g.tpp;
  g.tile_w = kTileSlices / g.tpp;
  g.tiles_w = (OW + g.tile_w - 1) / g.tile_w;
  g.tiles = g.tiles_w * ((OH + kTileH - 1) / kTileH);
  return g;
}

size_t smem_bytes(const Geometry& g) {
  return sizeof(uint4) * (kTileH + kTaps - 1) * (g.tile_w + kTaps - 1) * g.tpp;
}

// 16 bytes global -> shared, in flight until cp.async.wait_all; zeros when
// !valid (the source is then not read).
__device__ __forceinline__ void copy16(uint4* dst, const void* src,
                                       bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fir4x4(const T* __restrict__ x, const float* __restrict__ taps,
           T* __restrict__ y, int H, int W, int C, int pad, int OH, int OW,
           int tpp, int tile_w, int tiles_w) {
  constexpr int N = Pack<T>::kN;
  extern __shared__ uint4 tile[];  // (kTileH + 3, tile_w + 3, tpp)
  const int b = blockIdx.z;
  const int ch0 = blockIdx.y * tpp * N;
  const int oi0 = (blockIdx.x / tiles_w) * kTileH;
  const int oj0 = (blockIdx.x % tiles_w) * tile_w;
  const int in_w = tile_w + kTaps - 1;

  const T* xb = x + (size_t)b * H * W * C + ch0;
  const int n = (kTileH + kTaps - 1) * in_w * tpp;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int s = e % tpp;
    const int p = e / tpp;
    const int gi = oi0 - pad + p / in_w;
    const int gj = oj0 - pad + p % in_w;
    const bool in = (unsigned)gi < (unsigned)H && (unsigned)gj < (unsigned)W;
    copy16(tile + e, in ? xb + ((size_t)gi * W + gj) * C + s * N : xb, in);
  }
  float f[kTaps * kTaps];
#pragma unroll
  for (int k = 0; k < kTaps * kTaps; ++k) f[k] = __ldg(taps + k);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= kGroups * tile_w * tpp) return;
  const int s = t % tpp;
  const int col = (t / tpp) % tile_w;
  const int r0 = (t / (tpp * tile_w)) * kRows;
  const int oj = oj0 + col;
  if (oj >= OW) return;
  const uint4* src = tile + ((size_t)r0 * in_w + col) * tpp + s;
  T* yb = y + ((size_t)b * OH * OW + oj) * C + ch0 + s * N;

  float acc[kRows][N];
#pragma unroll
  for (int o = 0; o < kRows; ++o)
#pragma unroll
    for (int k = 0; k < N; ++k) acc[o][k] = 0.f;
#pragma unroll
  for (int r = 0; r < kRows + kTaps - 1; ++r) {
    uint4 raw[kTaps];
#pragma unroll
    for (int v = 0; v < kTaps; ++v) raw[v] = src[(r * in_w + v) * tpp];
#pragma unroll
    for (int u = 0; u < kTaps; ++u) {
      const int o = r - u;  // the output row this input row is tap u of
      if (o < 0 || o >= kRows) continue;
#pragma unroll
      for (int v = 0; v < kTaps; ++v) {
        float xv[N];
        Pack<T>::unpack(raw[v], xv);
#pragma unroll
        for (int k = 0; k < N; ++k)
          acc[o][k] = __fmaf_rn(xv[k], f[u * kTaps + v], acc[o][k]);
      }
    }
    if (r >= kTaps - 1) {
      const int o = r - (kTaps - 1);
      const int oi = oi0 + r0 + o;
      if (oi < OH)
        *reinterpret_cast<uint4*>(yb + (size_t)oi * OW * C) =
            Pack<T>::pack(acc[o]);
    }
  }
}

template <typename T>
int fir(const void* x, const void* taps, void* y, int B, int H, int W, int C,
        int pad, int OH, int OW, cudaStream_t stream) {
  const Geometry g = geometry(C, Pack<T>::kN, OH, OW);
  if (g.tpp == 0 || B <= 0 || B > 65535 || g.chunks > 65535 || H <= 0 ||
      W <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fir4x4<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fir4x4<T><<<dim3(g.tiles, g.chunks, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps),
      static_cast<T*>(y), H, W, C, pad, OH, OW, g.tpp, g.tile_w, g.tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16 (x, y); taps 16 f32. x and y are contiguous NHWC and
// 16-byte aligned, C a whole number of 16-byte slices. Returns the CUDA error
// code (0 = launched).
int upfirdn2d_fir4x4(int dtype, const void* x, const void* taps, void* y,
                     int B, int H, int W, int C, int pad, int OH, int OW,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fir<bf16>(x, taps, y, B, H, W, C, pad, OH, OW, st);
  if (dtype == 0)
    return fir<float>(x, taps, y, B, H, W, C, pad, OH, OW, st);
  return (int)cudaErrorInvalidValue;
}

const char* upfirdn2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
