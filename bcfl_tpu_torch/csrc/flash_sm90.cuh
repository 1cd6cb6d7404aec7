// flash_sm90.cuh: Hopper (sm_90a) building blocks of the 16-bit
// flash-attention kernels: warpgroup tensor-core products (wgmma) on bf16
// or fp16 tiles held in shared memory, fed by a zero-filling cp.async ring.
//
// Every block is generic over the element type T, __nv_bfloat16 or __half
// (Elem<T>): both have the same m64nNk16 wgmma shapes, operand layouts,
// swizzled 16-bit tiles and float32 accumulators, and differ only in the
// instruction's type name and in how two floats pack into one register.
//
// A tile is 64 rows (queries or keys) of D 16-bit values, the rows of one
// head's [S, D] slab. It is stored as 2D / P "atom columns" of 64 rows x P
// bytes, P = min(2D, 128), with the 16-byte chunks of each row permuted by
// the hardware's swizzle of that width (chunk c of row r at c ^ (r & 7) for
// P = 128, c ^ ((r >> 1) & 3) for P = 64), so cp.async writes and wgmma reads
// hit distinct banks. One tile serves as a K-major operand (D is the
// contraction: S = Q K^T) and as an MN-major operand (D is the product's N:
// O += P V), so no transposed copy is ever made.
//
// wgmma, per warpgroup of 128 threads (warp w of the group, lane 4 g + t):
// - the accumulator of an m64nN product holds, in thread order,
//   d[4 j + 2 h + e] = D[16 w + g + 8 h][8 j + 2 t + e], j < N / 8;
// - an A operand from registers (the "RS" form) holds, for a 16-wide slice
//   kk of the contraction, a[0] = A[16w+g][2t, 2t+1], a[1] = A[16w+g+8][2t,
//   2t+1], a[2] = A[16w+g][2t+8, 2t+9], a[3] = A[16w+g+8][2t+8, 2t+9] as
//   16-bit pairs, so an accumulator whose columns are the next product's
//   contraction turns into A fragments in place (acc_to_a);
// - a shared-memory operand is a 64-bit descriptor: start address, leading
//   and stride byte offsets, swizzle mode (desc_k, desc_mn).
// Ordering rules the kernels follow: cp.async writes are generic-proxy
// writes, so each thread issues fence.proxy.async after its copies land and
// before the barrier that lets wgmma (async proxy) read them; wgmma.fence
// precedes every batch of wgmma whose registers were touched since; the
// accumulators are not touched between a batch's issue and its wait.
//
// The ring: rows at or past the tile's limit are zero-filled by cp.async
// with a source size of 0, never left stale (a tensor-core product of
// p = 0 with a stale NaN is NaN), as _zero_oob_rows does in Pallas.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace flash {
namespace sm90 {

constexpr int kRows = 64;       // rows per tile, and per warpgroup
constexpr int kThreads = 128;   // one warpgroup
constexpr int kAlign = 1024;    // tile alignment: the 128-byte swizzle's period

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 16-bit element types of the tiles. pack rounds two floats to
// nearest even into one register (the low half first), unpack widens one
// register's pair; kHalf picks the wgmma type name (f16 or bf16).
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kHalf = false;
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  }
};

template <>
struct Elem<__half> {
  static constexpr bool kHalf = true;
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  }
};

// Layout of one 64 x D tile of 16-bit elements.
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int kPitch = 2 * D < 128 ? 2 * D : 128;  // bytes per row
  static constexpr int kAtomBytes = kRows * kPitch;
  static constexpr int kBytes = kRows * 2 * D;
  static constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static constexpr int kAtomChunks = kPitch / 16;
  // descriptor swizzle mode: 1 = 128 B, 2 = 64 B
  static constexpr uint64_t kSwizzle = kPitch == 128 ? 1 : 2;

  // byte offset of chunk c of row r from the tile's start
  __device__ __forceinline__ static uint32_t offset(int r, int c) {
    const uint32_t off = (c / kAtomChunks) * kAtomBytes + r * kPitch +
                         (c % kAtomChunks) * 16;
    return off ^ (((off >> 7) & (kAtomChunks - 1)) << 4);
  }
};

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swz << 62);
}

// The tile at `tile` as a K-major operand (its rows are M or N, D is the
// contraction), at contraction slice kk: d in [16 kk, 16 kk + 16).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = Tile<D>;
  const uint32_t at = tile + (kk * 32 / L::kPitch) * L::kAtomBytes +
                      (kk * 32) % L::kPitch;
  return make_desc(at, 16, 8 * L::kPitch, L::kSwizzle);
}

// The tile as an MN-major operand (its rows are the contraction, D is N),
// at contraction slice kk: rows [16 kk, 16 kk + 16).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using L = Tile<D>;
  return make_desc(tile + kk * 16 * L::kPitch, L::kAtomBytes, 8 * L::kPitch,
                   L::kSwizzle);
}

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes (cp.async) before async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage rows [row0, row0 + 64) of one head's [S, D] slab (rows `stride`
// elements apart, D contiguous, 16-byte aligned) into the tile at `dst`;
// rows at or past `limit` are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(uint32_t dst, const T* base,
                                          long long stride, int row0,
                                          int limit) {
  static_assert(sizeof(T) == 2, "16-bit elements");
  using L = Tile<D>;
#pragma unroll
  for (int it = 0; it < kRows * L::kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / L::kChunks, c = i % L::kChunks;
    const bool ok = row0 + r < limit;
    const T* src = ok ? base + (long long)(row0 + r) * stride + c * 8 : base;
    cp_async16(dst + L::offset(r, c), src, ok);
  }
}

// Stage 64 floats src[n0 .. n0 + 64) at `dst`, zero at or past `limit`.
__device__ __forceinline__ void stage_row(uint32_t dst, const float* src,
                                         int n0, int limit) {
  if (threadIdx.x < kRows) {
    const int n = n0 + threadIdx.x;
    cp_async4(dst + threadIdx.x * 4, n < limit ? src + n : src, n < limit);
  }
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of these registers across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ------------------------------------------------------ fragment helpers

__device__ __forceinline__ int warp_in_group() { return (threadIdx.x >> 5) & 3; }
__device__ __forceinline__ int frag_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int frag_t() { return threadIdx.x & 3; }

// row of accumulator half h (0: d[4j + e], 1: d[4j + 2 + e]) of this thread
__device__ __forceinline__ int frag_row(int h) {
  return 16 * warp_in_group() + frag_g() + 8 * h;
}
// column of d[4 j + 2 h + e]
__device__ __forceinline__ int frag_col(int j, int e) {
  return 8 * j + 2 * frag_t() + e;
}

// across the 4 threads (a quad) that hold one accumulator row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// The 64-column accumulator s (columns = the next product's contraction),
// rounded to T, as the A fragments of its four 16-wide slices.
template <typename T>
__device__ __forceinline__ void acc_to_a(const float (&s)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = Elem<T>::pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// The asm of each product is written once, as a macro of the wgmma type
// name TY ("bf16" or "f16"); BCFL_BY_TYPE expands it for T's name.
#define BCFL_BY_TYPE(T, ASM) \
  if constexpr (Elem<T>::kHalf) {  \
    ASM("f16");                    \
  } else {                         \
    ASM("bf16");                   \
  }

// m64n<N>k16 with float32 accumulators on operands of wgmma type TY
#define BCFL_WGMMA(N, TY) \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {"

// the accumulator's registers: operands %0 .. %(N/2 - 1)
#define BCFL_REGS16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define BCFL_REGS32                                                       \
  BCFL_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
              "%27, %28, %29, %30, %31"
#define BCFL_REGS64                                                       \
  BCFL_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
              "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
              "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define BCFL_ACC16(d)                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),    \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),            \
      "+f"(d[14]), "+f"(d[15])
#define BCFL_ACC32(d)                                                \
  BCFL_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),            \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),            \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define BCFL_ACC64(d)                                                \
  BCFL_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),            \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),            \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),            \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),            \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),            \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B for m64n64k16, A and B K-major T tiles in shared memory
// (descriptors da, db); d += when scale_d != 0, d = A B when it is 0.
template <typename T>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
#define BCFL_SS_N64(TY)                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"       \
               BCFL_WGMMA(64, TY) BCFL_REGS32                      \
               "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                  \
               : BCFL_ACC32(d)                                     \
               : "l"(da), "l"(db), "r"(scale_d))
  BCFL_BY_TYPE(T, BCFL_SS_N64)
#undef BCFL_SS_N64
}

// d (+)= A B for m64nNk16, N = 32, 64 or 128: A from registers (four T
// pairs in the fragment layout), B an MN-major T tile in shared memory
// (descriptor db). The A pairs, db and scale_d follow the N / 2
// accumulator operands.
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
#define BCFL_RS(N, TY, REGS, ACC, A, SC)                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"     \
               BCFL_WGMMA(N, TY) REGS "}, " A ", p, 1, 1, 1;\n}\n" \
               : ACC(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),        \
                 "l"(db), "r"(scale_d))
  if constexpr (N == 32) {
#define BCFL_RS_N32(TY) \
  BCFL_RS(32, TY, BCFL_REGS16, BCFL_ACC16, "{%16, %17, %18, %19}, %20", "%21")
    BCFL_BY_TYPE(T, BCFL_RS_N32)
#undef BCFL_RS_N32
  } else if constexpr (N == 64) {
#define BCFL_RS_N64(TY) \
  BCFL_RS(64, TY, BCFL_REGS32, BCFL_ACC32, "{%32, %33, %34, %35}, %36", "%37")
    BCFL_BY_TYPE(T, BCFL_RS_N64)
#undef BCFL_RS_N64
  } else {
    static_assert(N == 128, "N = 32, 64 or 128");
#define BCFL_RS_N128(TY) \
  BCFL_RS(128, TY, BCFL_REGS64, BCFL_ACC64, "{%64, %65, %66, %67}, %68", "%69")
    BCFL_BY_TYPE(T, BCFL_RS_N128)
#undef BCFL_RS_N128
  }
#undef BCFL_RS
}

// Store a 64 x D accumulator's rows (this thread's two) as T pairs, times
// `mul`, into rows `row0 + r` of a contiguous [*, D] output; rows at or
// past `limit` are skipped.
template <int D, typename T>
__device__ __forceinline__ void store_acc(const float (&d)[D / 2], float mul,
                                          T* out, long long row0, int r0,
                                          int limit) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = frag_row(h);
    if (r0 + r >= limit) continue;
    T* o = out + (row0 + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + frag_col(j, 0)) =
          Elem<T>::pack(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
  }
}

// Sum of x . y over the 8-element chunk at each of two 16-byte words of T.
template <typename T>
__device__ __forceinline__ float dot8(const uint4& x, const uint4& y,
                                      float acc) {
  const uint32_t* xs = reinterpret_cast<const uint32_t*>(&x);
  const uint32_t* ys = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 xf = Elem<T>::unpack(xs[u]);
    const float2 yf = Elem<T>::unpack(ys[u]);
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

}  // namespace sm90
}  // namespace flash
