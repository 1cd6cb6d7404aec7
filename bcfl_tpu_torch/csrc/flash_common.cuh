// flash_common.cuh: what the three flash-attention kernels share (their
// parameters and C-entry dispatch), and the float32 FMA design of their
// float32 instances; the bf16 and fp16 instances are built from
// flash_sm90.cuh.
//
// The kernels (flash_fwd.cu, flash_bwd_dkv.cu, flash_bwd_dq.cu) replace the
// Pallas kernels of bcfl_tpu/ops/pallas_flash.py. Each block owns one
// 64-row tile (queries or keys) of one (batch, head) and loops over the
// other side's 64-row tiles, which it stages in shared memory as float.
// 128 threads cover a 64 x 64 tile of scores as 16 row groups of 4 rows by
// 8 column groups of 8 columns (tid = row_group * 8 + col_group), so the 8
// threads of one row group are 8 neighbouring lanes of one warp and a row
// reduction is three shuffles. A 64 x D tile of outputs uses the same row
// groups and D / 8 columns per thread.
//
// Products are float32 FMAs on values staged in shared memory: a bf16
// input converts to float exactly, so each product is exact and only the
// order of the float32 sums differs from the Pallas kernels' bf16 matmuls
// with float32 accumulation. Every operand is staged in the layout its
// product reads (row-major or transposed), so each thread reads its 4 rows
// and its 8 (or D / 8) columns as float4 words.
//
// Inputs are [B, H, S, D] tensors read through their (b, h, s) element
// strides with D contiguous; the wrapper checks that rows start on 16-byte
// boundaries, since each thread loads 8 consecutive elements at once.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kBM = 64;       // query rows per tile
constexpr int kBN = 64;       // key rows per tile
constexpr int kThreads = 128;
constexpr int kPad = 4;       // floats of padding per shared row (16 B)
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // elements between batches, heads and rows
};

// Pointers and sizes of one call; the unused ones are null.
template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const float* bias;  // [B, Sk] additive key bias
  const T* o;         // forward output (backward only)
  const T* dout;      // gradient of the output (backward only)
  const float* lse;   // [B, H, Sq] (backward only)
  T* out;             // forward: out; dq kernel: dq
  float* lse_out;     // forward: [B, H, Sq]
  T* dk;
  T* dv;
  float* db;          // [B, H, Sk] per-head key-bias gradient
  int H, Sq, Sk;
  Strides qs, ks, vs, os, dos;
  float scale;
  int causal;
};

__device__ __forceinline__ int row_group() { return threadIdx.x >> 3; }
__device__ __forceinline__ int col_group() { return threadIdx.x & 7; }

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and back: the Pallas kernels' casts of p and ds to the
// inputs' dtype before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Stage rows [row0, row0 + 64) of one head's [S, D] slab (rows `stride`
// elements apart) as float: row-major into rows[r * (D + kPad) + d] and/or
// transposed into cols[d * (64 + kPad) + r] (either may be null). Rows at
// or past `limit` are zero, as _zero_oob_rows makes them in Pallas.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          long long stride, int row0,
                                          int limit, float* rows,
                                          float* cols) {
  const int r = threadIdx.x & 63;
  const bool ok = row0 + r < limit;
  const T* src = base + (long long)(row0 + r) * stride;
  for (int c = threadIdx.x >> 6; c < D / 8; c += kThreads / 64) {
    float x[8];
    if (ok) {
      load8(src + c * 8, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.0f;
    }
    if (rows != nullptr) {
      float4* dst = reinterpret_cast<float4*>(rows + r * (D + kPad) + c * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    if (cols != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[(c * 8 + j) * (64 + kPad) + r] = x[j];
    }
  }
}

// acc[i][j] += sum over kk < K of a[kk * lda + r0 + i] * b[kk * ldb + c0 + j]
// for the thread's TM rows and TN columns; a and b live in shared memory.
template <int TM, int TN, int K>
__device__ __forceinline__ void mma_acc(float (&acc)[TM][TN], const float* a,
                                        int lda, const float* b, int ldb,
                                        int r0, int c0) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(a + kk * lda + r0 + i);
      av[i] = t.x; av[i + 1] = t.y; av[i + 2] = t.z; av[i + 3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(b + kk * ldb + c0 + j);
      bv[j] = t.x; bv[j + 1] = t.y; bv[j + 2] = t.z; bv[j + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Sum over the 8 column groups of a row group (8 neighbouring lanes).
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

// dsum[r] = rowsum(dO * O) for the 64 query rows from q0 (0 past Sq), as
// the Pallas backward kernels compute it: dO from its staged copy (at
// dos[r * ld_r + d * ld_d]), O read from device memory. Two threads per
// row, each over half of D.
template <typename T, int D>
__device__ __forceinline__ void tile_dsum(const T* __restrict__ o_base,
                                          long long o_stride, int q0, int Sq,
                                          const float* dos, int ld_r,
                                          int ld_d, float* dsum) {
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  float acc = 0.0f;
  if (q0 + r < Sq) {
    const T* src = o_base + (long long)(q0 + r) * o_stride;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); d += 8) {
      float x[8];
      load8(src + d, x);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = fmaf(dos[r * ld_r + (d + j) * ld_d], x[j], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) dsum[r] = acc;
}

// The dtype codes of the C entries' `dtype` argument; any other code is
// refused with cudaErrorInvalidValue.
enum DtypeCode : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// C entries: the D and dtype of a call pick one template instance.
template <template <typename, int> class Launch, typename T>
int dispatch_d(int D, const Params<T>& p, int B, cudaStream_t stream) {
  switch (D) {
    case 32: return Launch<T, 32>::run(p, B, stream);
    case 64: return Launch<T, 64>::run(p, B, stream);
    case 128: return Launch<T, 128>::run(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Fill the shared fields of Params from a C call; `strides` holds (b, h, s)
// for q, k, v and then, in the backward, o and dO.
template <typename T>
Params<T> make_params(const void* q, const void* k, const void* v,
                      const float* bias, int H, int Sq, int Sk,
                      const long long* strides, int n_strided, float scale,
                      int causal) {
  Params<T> p{};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.bias = bias;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  Strides* dst[5] = {&p.qs, &p.ks, &p.vs, &p.os, &p.dos};
  for (int i = 0; i < n_strided; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace flash
