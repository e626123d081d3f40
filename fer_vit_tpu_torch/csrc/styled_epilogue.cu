// StyleGAN2's styled-conv epilogue for Hopper (sm_90a), forward and backward,
// on NHWC activations.
//
// Replaces no TPU kernel: in the JAX package (fer_vit_tpu/encoders/
// stylegan2.py, StyledConv) XLA fuses this chain under jit. Eager PyTorch ran
// it as five passes over the activation; this kernel is that fusion. For one
// StyledConv, on the conv output c (B, H, W, C) before demodulation:
//
//   z = c * demod[b, ch] + w_n * noise[b or 0, h, w] + bias[ch]  (f32)
//   y = lrelu(z, 0.2) * sqrt(2)                           (rounded once)
//
// and its backward to c and demod, recomputing z from the saved c:
//
//   g_z        = (z > 0 ? g * sqrt(2) : g * sqrt(2) * 0.2)    (f32)
//   grad_c     = g_z * demod[b, ch]                      (rounded once)
//   grad_demod = sum over (h, w) of g_z * c                       (f32)
//
// T is c's type: bf16 on the main path, f32 for checks. demod, noise, w_n
// and bias are f32. The f32 operations are the plain version's, in its order
// and without contraction (ops/styled_epilogue.py), so in f32 the kernel
// gives the plain chain's values; in bf16 it rounds once where the chain
// rounded at every step.
//
// Bound. Pure data movement: the forward reads c and writes y (2 T bytes),
// the backward reads g and c and writes grad_c (3 T); demod, bias and the
// noise plane are 1/C of that or less. On an H100 that is bytes / 3.35e12.
// Design. Each thread owns 16 bytes of channels (8 bf16 or 4 f32) of a pixel,
// keeps that slice's demod and bias in registers, and walks kIters pixels
// of its block, loading all of them before it computes, so each thread has
// kIters 16-byte loads in flight. A block of 256 threads covers 256 * 16
// contiguous bytes a step: 256 / (C / vec) pixels. The grid is (blocks of
// kIters steps over H * W, B), from the shape alone
// (styled_epilogue_blocks). The demod gradient is reduced without atomics: each block writes
// its per-channel sums to a (B, blocks, C) scratch, in a fixed order over
// its threads, and a second launch sums the blocks in a fixed tree, so two
// runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFwdIters = 8;
constexpr int kBwdIters = 4;
constexpr float kSqrt2 = 1.41421356237309515f;  // float(math.sqrt(2))
constexpr float kSlope = 0.2f;

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

// Where a thread works: its 16-byte channel slice and its pixel offset in a
// block step. Threads past the last whole pixel row idle.
struct Lane {
  int tpp, ppi, c0, po;
  bool active;
  __device__ Lane(int C, int vec) {
    tpp = C / vec;
    ppi = kThreads / tpp;
    active = threadIdx.x < ppi * tpp;
    c0 = (threadIdx.x % tpp) * vec;
    po = threadIdx.x / tpp;
  }
};

// z for one pixel's slice; ``wn`` is w_n * noise (unused without noise).
template <int N>
__device__ __forceinline__ void pre_activation(const float* x, const float* d,
                                               const float* bi, bool noise,
                                               float wn, float* z) {
#pragma unroll
  for (int v = 0; v < N; ++v) {
    float t = __fmul_rn(x[v], d[v]);
    if (noise) t = __fadd_rn(t, wn);
    z[v] = __fadd_rn(t, bi[v]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    epilogue_forward(const T* __restrict__ c, const float* __restrict__ demod,
                     const float* __restrict__ noise,
                     const float* __restrict__ w_n,
                     const float* __restrict__ bias, T* __restrict__ y, int HW,
                     int C, int noise_batched) {
  constexpr int N = Pack<T>::kN;
  const Lane L(C, N);
  if (!L.active) return;
  const int b = blockIdx.y;
  float d[N], bi[N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    d[v] = demod[(size_t)b * C + L.c0 + v];
    bi[v] = bias[L.c0 + v];
  }
  const bool has_noise = noise != nullptr;
  const float w = has_noise ? *w_n : 0.f;
  const float* nz = has_noise ? noise + (noise_batched ? (size_t)b * HW : 0)
                              : nullptr;
  const size_t base = (size_t)b * HW * C + L.c0;
  const int p0 = blockIdx.x * L.ppi * kFwdIters + L.po;

  uint4 raw[kFwdIters];
  float nv[kFwdIters];
#pragma unroll
  for (int k = 0; k < kFwdIters; ++k) {
    const int p = p0 + k * L.ppi;
    if (p < HW) {
      raw[k] = *reinterpret_cast<const uint4*>(c + base + (size_t)p * C);
      nv[k] = has_noise ? __fmul_rn(w, nz[p]) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kFwdIters; ++k) {
    const int p = p0 + k * L.ppi;
    if (p >= HW) break;
    float x[N], z[N];
    Pack<T>::unpack(raw[k], x);
    pre_activation<N>(x, d, bi, has_noise, nv[k], z);
#pragma unroll
    for (int v = 0; v < N; ++v)
      z[v] = __fmul_rn(z[v] > 0.f ? z[v] : __fmul_rn(z[v], kSlope), kSqrt2);
    *reinterpret_cast<uint4*>(y + base + (size_t)p * C) = Pack<T>::pack(z);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    epilogue_backward(const T* __restrict__ g, const T* __restrict__ c,
                      const float* __restrict__ demod,
                      const float* __restrict__ noise,
                      const float* __restrict__ w_n,
                      const float* __restrict__ bias, T* __restrict__ grad_c,
                      float* __restrict__ partials, int HW, int C,
                      int noise_batched) {
  constexpr int N = Pack<T>::kN;
  extern __shared__ float red[];  // (ppi, C): each thread's sums
  const Lane L(C, N);
  const int b = blockIdx.y;
  float acc[N];
#pragma unroll
  for (int v = 0; v < N; ++v) acc[v] = 0.f;
  if (L.active) {
    float d[N], bi[N];
#pragma unroll
    for (int v = 0; v < N; ++v) {
      d[v] = demod[(size_t)b * C + L.c0 + v];
      bi[v] = bias[L.c0 + v];
    }
    const bool has_noise = noise != nullptr;
    const float w = has_noise ? *w_n : 0.f;
    const float* nz =
        has_noise ? noise + (noise_batched ? (size_t)b * HW : 0) : nullptr;
    const size_t base = (size_t)b * HW * C + L.c0;
    const int p0 = blockIdx.x * L.ppi * kBwdIters + L.po;

    uint4 graw[kBwdIters], craw[kBwdIters];
    float nv[kBwdIters];
#pragma unroll
    for (int k = 0; k < kBwdIters; ++k) {
      const int p = p0 + k * L.ppi;
      if (p < HW) {
        const size_t off = base + (size_t)p * C;
        graw[k] = *reinterpret_cast<const uint4*>(g + off);
        craw[k] = *reinterpret_cast<const uint4*>(c + off);
        nv[k] = has_noise ? __fmul_rn(w, nz[p]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kBwdIters; ++k) {
      const int p = p0 + k * L.ppi;
      if (p >= HW) break;
      float x[N], gv[N], z[N];
      Pack<T>::unpack(craw[k], x);
      Pack<T>::unpack(graw[k], gv);
      pre_activation<N>(x, d, bi, has_noise, nv[k], z);
#pragma unroll
      for (int v = 0; v < N; ++v) {
        const float g1 = __fmul_rn(gv[v], kSqrt2);
        const float gz = z[v] > 0.f ? g1 : __fmul_rn(g1, kSlope);
        acc[v] = __fadd_rn(acc[v], __fmul_rn(gz, x[v]));
        gv[v] = __fmul_rn(gz, d[v]);
      }
      *reinterpret_cast<uint4*>(grad_c + base + (size_t)p * C) =
          Pack<T>::pack(gv);
    }
  }
  // the block's sums per channel, over its threads in pixel order
  if (L.active) {
#pragma unroll
    for (int v = 0; v < N; ++v) red[L.po * C + L.c0 + v] = acc[v];
  }
  __syncthreads();
  float* out = partials + ((size_t)b * gridDim.x + blockIdx.x) * C;
  for (int ch = threadIdx.x; ch < C; ch += kThreads) {
    float s = 0.f;
    for (int q = 0; q < L.ppi; ++q) s = __fadd_rn(s, red[q * C + ch]);
    out[ch] = s;
  }
}

// grad_demod[b][ch] = sum over blocks of partials[b][block][ch]: 32 channels
// by 32 rows a block, each row summing every 32nd block, then the rows in
// order.
__global__ void __launch_bounds__(1024)
    reduce_blocks(const float* __restrict__ partials,
                  float* __restrict__ grad_demod, int n_blocks, int C) {
  __shared__ float rows[32][33];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (ch < C) {
    const float* p = partials + (size_t)b * n_blocks * C + ch;
    for (int t = threadIdx.y; t < n_blocks; t += 32)
      s = __fadd_rn(s, p[(size_t)t * C]);
  }
  rows[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && ch < C) {
    float total = 0.f;
    for (int r = 0; r < 32; ++r)
      total = __fadd_rn(total, rows[r][threadIdx.x]);
    grad_demod[(size_t)b * C + ch] = total;
  }
}

// Blocks over H * W for a pass of ``iters`` steps; 0 if C is not a whole
// number of 16-byte slices or a pixel row needs more than a block's threads.
int blocks_x(int HW, int C, int vec, int iters) {
  if (HW <= 0 || C <= 0 || C % vec || C / vec > kThreads) return 0;
  const int ppi = kThreads / (C / vec);
  return (HW + ppi * iters - 1) / (ppi * iters);
}

template <typename T>
int forward(const void* c, const void* demod, const void* noise,
            const void* w_n, const void* bias, void* y, int B, int HW, int C,
            int noise_batched, cudaStream_t stream) {
  const int gx = blocks_x(HW, C, Pack<T>::kN, kFwdIters);
  if (gx == 0 || B <= 0) return (int)cudaErrorInvalidValue;
  epilogue_forward<T><<<dim3(gx, B), kThreads, 0, stream>>>(
      static_cast<const T*>(c), static_cast<const float*>(demod),
      static_cast<const float*>(noise), static_cast<const float*>(w_n),
      static_cast<const float*>(bias), static_cast<T*>(y), HW, C,
      noise_batched);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* g, const void* c, const void* demod,
             const void* noise, const void* w_n, const void* bias,
             void* grad_c, void* partials, void* grad_demod, int B, int HW,
             int C, int noise_batched, cudaStream_t stream) {
  constexpr int N = Pack<T>::kN;
  const int gx = blocks_x(HW, C, N, kBwdIters);
  if (gx == 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kThreads / (C / N)) * C;
  epilogue_backward<T><<<dim3(gx, B), kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(c),
      static_cast<const float*>(demod), static_cast<const float*>(noise),
      static_cast<const float*>(w_n), static_cast<const float*>(bias),
      static_cast<T*>(grad_c), static_cast<float*>(partials), HW, C,
      noise_batched);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_blocks<<<dim3((C + 31) / 32, B), dim3(32, 32), 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(grad_demod),
      gx, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16 (c, y, g, grad_c); demod, noise, w_n, bias,
// partials and grad_demod f32.

// Blocks over H * W of a pass (backward != 0: the backward's, which sizes
// its (B, blocks, C) partials); 0 for a shape the kernels do not take.
int styled_epilogue_blocks(int dtype, int HW, int C, int backward) {
  if (dtype != 0 && dtype != 1) return 0;
  const int vec = dtype == 1 ? Pack<bf16>::kN : Pack<float>::kN;
  return blocks_x(HW, C, vec, backward ? kBwdIters : kFwdIters);
}

// noise may be null (then w_n is not read); noise_batched: noise is
// (B, H, W, 1), else (1, H, W, 1). c and g are contiguous NHWC and 16-byte
// aligned. Returns the CUDA error code (0 = launched).
int styled_epilogue_forward(int dtype, const void* c, const void* demod,
                            const void* noise, const void* w_n,
                            const void* bias, void* y, int B, int HW, int C,
                            int noise_batched, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return forward<bf16>(c, demod, noise, w_n, bias, y, B, HW, C,
                         noise_batched, st);
  if (dtype == 0)
    return forward<float>(c, demod, noise, w_n, bias, y, B, HW, C,
                          noise_batched, st);
  return (int)cudaErrorInvalidValue;
}

int styled_epilogue_backward(int dtype, const void* g, const void* c,
                             const void* demod, const void* noise,
                             const void* w_n, const void* bias, void* grad_c,
                             void* partials, void* grad_demod, int B, int HW,
                             int C, int noise_batched, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return backward<bf16>(g, c, demod, noise, w_n, bias, grad_c, partials,
                          grad_demod, B, HW, C, noise_batched, st);
  if (dtype == 0)
    return backward<float>(g, c, demod, noise, w_n, bias, grad_c, partials,
                           grad_demod, B, HW, C, noise_batched, st);
  return (int)cudaErrorInvalidValue;
}

const char* styled_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
