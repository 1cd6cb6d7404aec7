// int8_quantize: per-chunk int8 quantization of the update codec.
//
// Replaces the TPU kernel bcfl_tpu/ops/pallas_codec.py::_int8_kernel
// (launched by _int8_quantize_pallas). For every chunk row g[r, 0:chunk]:
//   scale = max|g| / 127
//   z     = g / max(scale, 1e-30)
//   q     = clip(floor(z + u), -127, 127)   (stochastic, u passed in)
//         = clip(rint(z), -127, 127)        (round half to even otherwise)
// in exactly that operation order, so the codes and scales are bit-identical
// to the plain PyTorch version (ops/codec_kernels.py::int8_quantize_ref) and
// to eager JAX. That rests on IEEE division (__fdiv_rn), on an un-contracted
// add (__fadd_rn) and on rintf/floorf: build without --use_fast_math.
//
// Non-finite input follows the plain version too: the row maximum, the
// 1e-30 floor and the clip all keep a NaN (as amax, clamp and jnp.maximum
// do), so a NaN anywhere in a row makes its scale NaN and every code of the
// row 0, the value the card's float -> int8 conversion gives a NaN; an inf
// makes the scale inf, every finite element's code 0 and its own NaN -> 0.
//
// Bound: bytes. The kernel reads g (4 B/elt) and u (4 B/elt when
// stochastic) once from device memory and writes q (1 B/elt) plus one f32
// scale per chunk, against a handful of flops per element. One launch
// covers every grid of a call (the codec's round: one grid per distinct
// chunk width, up to 16), from a table passed by value: a block finds its
// grid and runs that grid's row mapping, so the short grids of a round
// cost no launch of their own. Row mappings, by chunk width:
// - chunk == 256 (the codec's default, which carries almost every byte of
//   a round): one warp per row, grid-stride over rows. Each lane owns 8
//   consecutive elements: it issues its two 16-byte loads of g (and two of
//   u) with streaming hints before it uses any, keeps the row in registers
//   (g is never read twice), reduces the row's absmax with warp shuffles
//   and writes its 8 codes as one 8-byte store.
// - chunk <= 32: one row per group of pow2ceil(chunk) lanes, so a grid of
//   1-wide chunks (the classifier bias) keeps every lane busy.
// - any other width (and 256 on pointers not aligned for the vector
//   loads): one warp per row, two passes over the row.
// Only the mapping of rows to threads differs between the paths; the
// per-element arithmetic is the same code.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr unsigned kFull = 0xffffffffu;

// NaN-propagating maximum (torch.amax and jnp.max keep a NaN; fmaxf drops
// it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The 1e-30 floor of the scale, NaN kept (clamp(scale, min=1e-30)).
__device__ __forceinline__ float floor_scale(float s) {
  return s < 1e-30f ? 1e-30f : s;
}

// One element's code: divide, round, clip to [-127, 127] keeping a NaN (as
// torch.clamp does), then the float -> int8 conversion, which gives 0 for
// a NaN.
template <bool kStochastic>
__device__ __forceinline__ int code_of(float x, float u, float d) {
  float z = __fdiv_rn(x, d);
  z = kStochastic ? floorf(__fadd_rn(z, u)) : rintf(z);
  z = z < -127.0f ? -127.0f : (z > 127.0f ? 127.0f : z);
  return z != z ? 0 : (int)z;
}

// One grid of the call: g, u, q, scale of [rows, chunk], the row mapping
// (`path`), the lanes per row of the short-chunk mapping (`width`), and the
// first block of the launch that works on it.
struct Grid {
  const float* g;
  const float* u;
  int8_t* q;
  float* scale;
  long long rows;
  long long first_block;
  int chunk;
  int width;
  int path;
};

enum Path { kChunk256 = 0, kSmall = 1, kWide = 2 };

constexpr int kMaxGrids = 16;

struct Grids {
  Grid grid[kMaxGrids];
  int n;
};

// chunk == 256: one warp per row, 8 consecutive elements per lane.
template <bool kStochastic>
__device__ __forceinline__ void rows_256(const Grid& d, long long block,
                                         long long nblocks) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = nblocks * (kThreads / 32);
  for (long long row = block * (kThreads / 32) + (threadIdx.x >> 5);
       row < d.rows; row += nwarps) {
    const long long off = row * 256 + lane * 8;
    const float4 g0 = __ldcs(reinterpret_cast<const float4*>(d.g + off));
    const float4 g1 = __ldcs(reinterpret_cast<const float4*>(d.g + off + 4));
    float4 u0 = make_float4(0.f, 0.f, 0.f, 0.f), u1 = u0;
    if (kStochastic) {
      u0 = __ldcs(reinterpret_cast<const float4*>(d.u + off));
      u1 = __ldcs(reinterpret_cast<const float4*>(d.u + off + 4));
    }
    const float x[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float r[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    float m = fabsf(x[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) m = nan_max(m, fabsf(x[i]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = nan_max(m, __shfl_xor_sync(kFull, m, o));
    const float s = __fdiv_rn(m, 127.0f);
    const float dd = floor_scale(s);
    unsigned word[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      word[i >> 2] |= (unsigned)(code_of<kStochastic>(x[i], r[i], dd) & 0xff)
                      << (8 * (i & 3));
    __stcs(reinterpret_cast<uint2*>(d.q + off), make_uint2(word[0], word[1]));
    if (lane == 0) d.scale[row] = s;
  }
}

// chunk <= 32: `width` = pow2ceil(chunk) lanes per row, 32 / width rows per
// warp; lanes past the chunk (or past the last row) carry 0 into the
// reduction and store nothing.
template <bool kStochastic>
__device__ __forceinline__ void rows_small(const Grid& d, long long block,
                                           long long nblocks) {
  const int lane = threadIdx.x & 31;
  const int width = d.width, chunk = d.chunk;
  const int per_warp = 32 / width;
  const int j = lane % width;
  const long long nwarps = nblocks * (kThreads / 32);
  for (long long first =
           (block * (kThreads / 32) + (threadIdx.x >> 5)) * per_warp;
       first < d.rows; first += nwarps * per_warp) {
    const long long row = first + lane / width;
    const bool live = row < d.rows && j < chunk;
    const long long at = row * chunk + j;
    const float x = live ? __ldcs(d.g + at) : 0.0f;
    const float r = (kStochastic && live) ? __ldcs(d.u + at) : 0.0f;
    float m = fabsf(x);
    for (int o = width >> 1; o > 0; o >>= 1)
      m = nan_max(m, __shfl_xor_sync(kFull, m, o));
    const float s = __fdiv_rn(m, 127.0f);
    if (live) {
      d.q[at] = (int8_t)code_of<kStochastic>(x, r, floor_scale(s));
      if (j == 0) d.scale[row] = s;
    }
  }
}

// Every other chunk: one warp per row, the row read twice.
template <bool kStochastic>
__device__ __forceinline__ void rows_wide(const Grid& d, long long block,
                                          long long nblocks) {
  const int lane = threadIdx.x & 31;
  const int chunk = d.chunk;
  const long long nwarps = nblocks * (kThreads / 32);
  for (long long row = block * (kThreads / 32) + (threadIdx.x >> 5);
       row < d.rows; row += nwarps) {
    const long long base = row * chunk;
    float m = 0.0f;
    for (int j = lane; j < chunk; j += 32)
      m = nan_max(m, fabsf(d.g[base + j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = nan_max(m, __shfl_xor_sync(kFull, m, o));
    const float s = __fdiv_rn(m, 127.0f);
    const float dd = floor_scale(s);
    for (int j = lane; j < chunk; j += 32)
      d.q[base + j] = (int8_t)code_of<kStochastic>(
          d.g[base + j], kStochastic ? d.u[base + j] : 0.0f, dd);
    if (lane == 0) d.scale[row] = s;
  }
}

// One launch over every grid of the call: a block finds its grid in the
// table (blocks are handed out grid by grid) and runs that grid's mapping
// over its share of the rows; the branch is uniform across the block.
template <bool kStochastic>
__global__ void __launch_bounds__(kThreads) int8_quantize_kernel(
    const Grids gs) {
  // Every table index is a constant after unrolling: indexing the
  // parameter table with a variable would make each thread copy the whole
  // table to local memory first.
  const long long bid = blockIdx.x;
  Grid d = gs.grid[0];
  long long end = gridDim.x;
#pragma unroll
  for (int k = 1; k < kMaxGrids; ++k) {
    if (k < gs.n) {
      if (bid >= gs.grid[k].first_block)
        d = gs.grid[k];
      else if (gs.grid[k].first_block < end)
        end = gs.grid[k].first_block;
    }
  }
  const long long block = bid - d.first_block;
  const long long nblocks = end - d.first_block;
  switch (d.path) {
    case kChunk256: rows_256<kStochastic>(d, block, nblocks); break;
    case kSmall: rows_small<kStochastic>(d, block, nblocks); break;
    default: rows_wide<kStochastic>(d, block, nblocks); break;
  }
}

// Blocks for `warps` warps of work on the current device: enough to fill
// every SM (8 blocks of 256 threads each), never more than the work needs.
// The SM count is read once per device: client shards launch on every
// card of a host, and a host may mix cards.
constexpr int kMaxDevices = 64;

long long blocks_for(long long warps) {
  static std::atomic<int> sms_of[kMaxDevices];  // zero: not read yet
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms <= 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
    if (cached) sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  const long long need = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const long long cap = 8LL * sms;
  return need < cap ? need : cap;
}

}  // namespace

// Quantize `n` grids (1 <= n <= 16) in one launch: grid k is g[k], u[k]
// (null when not stochastic), q[k], scale[k] of rows[k] rows of chunk[k].
extern "C" int bcfl_int8_quantize(const float* const* g, const float* const* u,
                                  int8_t* const* q, float* const* scale,
                                  const long long* rows, const int* chunk,
                                  int n, int stochastic, void* stream) {
  if (n < 1 || n > kMaxGrids) return (int)cudaErrorInvalidValue;
  Grids gs;
  gs.n = 0;
  long long blocks = 0;
  for (int k = 0; k < n; ++k) {
    if (rows[k] <= 0) continue;
    Grid& d = gs.grid[gs.n++];
    d.g = g[k];
    d.u = stochastic ? u[k] : nullptr;
    d.q = q[k];
    d.scale = scale[k];
    d.rows = rows[k];
    d.chunk = chunk[k];
    d.first_block = blocks;
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(d.g) |
          reinterpret_cast<uintptr_t>(d.u)) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(d.q) & 7) == 0;
    long long warps = d.rows;
    d.width = 32;
    if (d.chunk == 256 && aligned) {
      d.path = kChunk256;
    } else if (d.chunk <= 32) {
      d.path = kSmall;
      d.width = 1;
      while (d.width < d.chunk) d.width <<= 1;
      warps = (d.rows + 32 / d.width - 1) / (32 / d.width);
    } else {
      d.path = kWide;
    }
    blocks += blocks_for(warps);
  }
  if (gs.n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (stochastic)
    int8_quantize_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(gs);
  else
    int8_quantize_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(gs);
  return (int)cudaGetLastError();
}
