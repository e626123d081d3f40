// Fused attention for Hopper (sm_90a): out = softmax(Q K^T / sqrt(Dh)) V.
//
// Replaces the TPU kernel fer_vit_tpu/ops/flash_attention.py::_attn_kernel
// where the Hopper kernel of flash_attention_sm90.cu does not apply: this is
// the streaming kernel for f32 (the 3xTF32 check path), L > 256, Dh above 64
// or not a multiple of 16 (up to 128), and views whose addresses or strides
// TMA cannot take; the wrapper (ops/flash_attention.py::route) chooses
// before the launch. Over (B, H, L, Dh) tensors of type T (f32 or bf16),
// with the TPU kernel's rounding points:
//
//   s   = (q . k in f32, from operands in T) * scale      scale = 1/sqrt(Dh)
//   m   = max over keys of s;  e = exp(s - m)
//   w   = round_T(e / sum(e))                             a true division
//   out = round_T(w . v accumulated in f32)
//
// Design. A block owns 64 query rows of one (batch, head): 4 warps of 16
// rows. Its Q tile sits in shared memory; K and V stream through shared
// memory in chunks of 64 keys, zero past L and past Dh up to the next
// multiple of 16 (Dh <= 128). Two passes over the chunks:
//   1. the scores of each chunk give each row's running max and sum of
//      exp, in f32, rescaled when the max grows;
//   2. the scores are recomputed (bit for bit as in pass 1), normalised by a
//      true division, rounded to T into the warp's rows of a shared W tile,
//      and W . V is accumulated in f32 registers.
// So nothing of size L x L is stored, L is not limited by shared memory, and
// the weights are rounded where the TPU kernel rounds them (a one-pass
// online softmax would normalise after the product with V). Keys past L score
// -inf and weigh 0; query rows past L read zeros and are not stored.
//
// Both products run on the tensor cores with one body for both types
// (mma.cuh): Q K^T reads Q through ldmatrix and K rows as B; W V reads W
// through ldmatrix and V^T rows as B, V being stored transposed in shared
// memory when it is staged. bf16 runs m16n8k16; f32 runs m16n8k8 tf32 with
// the 3xTF32 split, each k-step summed in a fresh accumulator and added to
// the total in f32, since the tensor cores round their sums toward zero.
//
// Q, K and V may be strided views (the packed qkv projection of a layer):
// the kernel takes each tensor's batch, head and row strides in elements,
// with Dh contiguous; 16-byte loads are used when every row allows them.
//
// Bound on an H100 SXM: bytes. q, k, v read once and out written once: at
// B = 64, H = 12, L = 197, Dh = 64 in bf16 that is 77.5 MB, 23.1 us at
// 3.35 TB/s, against 7.6 GFLOP, 7.7 us at 989 TFLOP/s. What keeps this
// kernel from it: K is staged twice per query tile and every query tile of a
// head re-reads K and V (from L2), the scores are computed twice, ragged L
// pads the last key chunk (197 keys take 256), and mma.sync with plain
// shared-memory staging stands where wgmma with TMA would overlap the loads.
// flash_attention_sm90.cu does those things for the bf16 main path; this
// kernel keeps the general one.

#include <math.h>
#include <stddef.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 64;           // keys per chunk
constexpr int kMaxDh = 128;
constexpr int kKeyTiles = kKeys / 8;   // n-tiles of a chunk's scores
constexpr int kDhTiles = kMaxDh / 8;   // n-tiles of the output, at most

struct Strides {
  long long b, h, l;  // in elements; Dh is contiguous
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  Strides sq, sk, sv, so;
  int H, L, dh, dp, n_tiles;
  float scale;
  int vec;  // 1: every row of q, k and v may be read in 16-byte pieces
};

// The A fragment of one k-step and the product with one B fragment. bf16: one
// m16n8k16. f32: the 3xTF32 split (a*b ~ hi*hi + hi*lo + lo*hi) summed in a
// fresh accumulator, then added to acc.
template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  uint32_t a[4];
  __device__ __forceinline__ void load_a(const bf16* p) { ldmatrix_x4(a, p); }
  __device__ __forceinline__ void step(float (&acc)[4],
                                       const uint32_t (&b)[2]) const {
    mma_bf16(acc, a, b);
  }
};

template <>
struct Mma<float> {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void load_a(const float* p) {
    uint32_t a[4];
    ldmatrix_x4(a, p);
    split_tf32(a, hi, lo);
  }
  __device__ __forceinline__ void step(float (&acc)[4],
                                       const uint32_t (&b)[2]) const {
    uint32_t b_hi[2], b_lo[2];
    split_tf32(b, b_hi, b_lo);
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(t, lo, b_hi);
    mma_tf32(t, hi, b_lo);
    mma_tf32(t, hi, b_hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += t[e];
  }
};

// B fragment of one k-step from a shared row (n = this lane's column) that
// holds K contiguously, starting at k0.
template <typename T>
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const T* row, int k0) {
  const int tq = threadIdx.x & 3;
  const T* p = row + k0 + tq * (4 / (int)sizeof(T));
  b[0] = ld_b32(p);
  b[1] = ld_b32(p + Elems<T>::kHalf);
}

// Rows [r0, r0 + n) of one head's (L, Dh) matrix into shared memory, zero
// past L and past Dh up to dp. kTrans = false: dst[r * cp + d]; true:
// dst[d * cp + r] (V^T).
template <typename T, bool kTrans>
__device__ void stage(T* dst, int cp, const T* src, long long sl, int r0, int n,
                      int L, int dh, int dp, int vec) {
  constexpr int kV = 16 / (int)sizeof(T);  // values per 16-byte piece
  const int units = dp / kV;
  for (int idx = threadIdx.x; idx < n * units; idx += kThreads) {
    const int r = idx / units;
    const int d0 = (idx - r * units) * kV;
    const int gr = r0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    T* vals = reinterpret_cast<T*>(&raw);
    if (gr < L && d0 < dh) {
      const T* s = src + gr * sl + d0;
      if (vec) {  // dh is a multiple of kV here, so the piece is inside
        raw = *reinterpret_cast<const uint4*>(s);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e)
          if (d0 + e < dh) vals[e] = s[e];
      }
    }
    if constexpr (kTrans) {
#pragma unroll
      for (int e = 0; e < kV; ++e) dst[(d0 + e) * cp + r] = vals[e];
    } else {
      *reinterpret_cast<uint4*>(dst + r * cp + d0) = raw;
    }
  }
}

// This warp's 16 x 64 scores of one key chunk, scaled, keys past L at -inf.
// s[j][e]: row gq (e < 2) or gq + 8, key key0 + 8j + 2tq + (e & 1).
template <typename T>
__device__ __forceinline__ void chunk_scores(float (&s)[kKeyTiles][4],
                                             const T* qs, const T* ks, int cp,
                                             int dp, float scale, int key0,
                                             int L) {
  constexpr int kK = Elems<T>::kK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const T* a_row = qs + (warp * 16 + (lane & 15)) * cp +
                   (lane >> 4) * Elems<T>::kHalf;
  for (int k0 = 0; k0 < dp; k0 += kK) {
    Mma<T> a;
    a.load_a(a_row + k0);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      uint32_t b[2];
      load_b(b, ks + (j * 8 + gq) * cp, k0);
      a.step(s[j], b);
    }
  }
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + 2 * tq + (e & 1);
      s[j][e] = key < L ? __fmul_rn(s[j][e], scale) : -INFINITY;
    }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const Params<T> p) {
  extern __shared__ float4 smem4[];
  constexpr int kK = Elems<T>::kK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int cp = p.dp + Elems<T>::kPad;   // row pitch of Q and K
  const int cpv = kKeys + Elems<T>::kPad;  // row pitch of V^T and W
  T* qs = reinterpret_cast<T*>(smem4);     // (kRows, cp)
  T* ks = qs + kRows * cp;                 // (kKeys, cp)
  T* vts = ks + kKeys * cp;                // (dp, cpv)
  T* ws = vts + p.dp * cpv + warp * 16 * cpv;  // this warp's (16, cpv)

  const int tile = blockIdx.x % p.n_tiles;
  const int bh = blockIdx.x / p.n_tiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = tile * kRows;
  const T* qh = p.q + b * p.sq.b + h * p.sq.h;
  const T* kh = p.k + b * p.sk.b + h * p.sk.h;
  const T* vh = p.v + b * p.sv.b + h * p.sv.h;
  const int n_chunks = (p.L + kKeys - 1) / kKeys;

  stage<T, false>(qs, cp, qh, p.sq.l, q0, kRows, p.L, p.dh, p.dp, p.vec);

  // pass 1: row max and sum of exp (rows gq and gq + 8 of this warp)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // Q staged; the last chunk's K no longer read
    stage<T, false>(ks, cp, kh, p.sk.l, c * kKeys, kKeys, p.L, p.dh, p.dp,
                    p.vec);
    __syncthreads();
    float s[kKeyTiles][4];
    chunk_scores<T>(s, qs, ks, cp, p.dp, p.scale, c * kKeys, p.L);
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][e]);
    float mn[2], cs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) mn[r] = fmaxf(m[r], quad_max(cm[r]));
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cs[e >> 1] += expf(s[j][e] - mn[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float scale_old = m[r] == -INFINITY ? 0.f : expf(m[r] - mn[r]);
      l[r] = l[r] * scale_old + quad_sum(cs[r]);
      m[r] = mn[r];
    }
  }

  // pass 2: w = e / sum, rounded to T, times V
  float o[kDhTiles][4];
#pragma unroll
  for (int j = 0; j < kDhTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const T* w_row = ws + (lane & 15) * cpv + (lane >> 4) * Elems<T>::kHalf;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the last chunk's K and V^T no longer read
    stage<T, false>(ks, cp, kh, p.sk.l, c * kKeys, kKeys, p.L, p.dh, p.dp,
                    p.vec);
    stage<T, true>(vts, cpv, vh, p.sv.l, c * kKeys, kKeys, p.L, p.dh, p.dp,
                   p.vec);
    __syncthreads();
    float s[kKeyTiles][4];
    chunk_scores<T>(s, qs, ks, cp, p.dp, p.scale, c * kKeys, p.L);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = __fdiv_rn(expf(s[j][e] - m[e >> 1]), l[e >> 1]);
      store2(ws + gq * cpv + j * 8 + 2 * tq, w[0], w[1]);
      store2(ws + (gq + 8) * cpv + j * 8 + 2 * tq, w[2], w[3]);
    }
    __syncwarp();
    for (int k0 = 0; k0 < kKeys; k0 += kK) {
      Mma<T> a;
      a.load_a(w_row + k0);
#pragma unroll
      for (int j = 0; j < kDhTiles; ++j) {
        if (j * 8 < p.dp) {
          uint32_t bv[2];
          load_b(bv, vts + (j * 8 + gq) * cpv, k0);
          a.step(o[j], bv);
        }
      }
    }
    __syncwarp();
  }

  T* oh = p.o + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int j = 0; j < kDhTiles; ++j) {
    const int d = j * 8 + 2 * tq;
    if (j * 8 >= p.dp) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + warp * 16 + gq + (e >> 1) * 8;
      const int dd = d + (e & 1);
      if (r < p.L && dd < p.dh) oh[r * p.so.l + dd] = from_f32<T>(o[j][e]);
    }
  }
}

// Dynamic shared memory of one block: Q and K tiles, V^T and the warps' W.
template <typename T>
size_t smem_bytes(int dp) {
  return sizeof(T) * ((size_t)(kRows + kKeys) * (dp + Elems<T>::kPad) +
                      (size_t)(dp + kRows) * (kKeys + Elems<T>::kPad));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int L, int dh, const long long* strides, int vec,
           cudaStream_t stream) {
  if (dh < 1 || dh > kMaxDh || L < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<T*>(o);
  Strides* s[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i)
    *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.H = H;
  p.L = L;
  p.dh = dh;
  p.dp = (dh + 15) / 16 * 16;
  p.n_tiles = (L + kRows - 1) / kRows;
  p.scale = (float)(1.0 / sqrt((double)dh));
  p.vec = vec;
  const long long blocks = (long long)B * H * p.n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes<T>(p.dp);
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_attention_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16. strides: 12 values, the (batch, head, row) strides
// in elements of q, k, v and o, in that order. Returns the CUDA error code
// (0 = launched).
int fused_attention_forward(int dtype, const void* q, const void* k,
                            const void* v, void* o, int B, int H, int L,
                            int dh, const long long* strides, int vec,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<bf16>(q, k, v, o, B, H, L, dh, strides, vec, st);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, H, L, dh, strides, vec, st);
  return (int)cudaErrorInvalidValue;
}

const char* fused_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
