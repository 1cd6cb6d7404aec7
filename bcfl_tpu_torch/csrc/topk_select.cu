// topk_select: per-row magnitude top-k of the update codec.
//
// Replaces the TPU kernel bcfl_tpu/ops/pallas_codec.py::_topk_kernel
// (launched by _topk_select_pallas). For each row x[r, 0:N] (f32) it returns
// the k entries of largest |x| as (val f32 [R, k], idx int32 [R, k]) in
// lax.top_k order: |x| descending, equal |x| lower index first; values are
// loaded straight from x, so -0.0 stays -0.0. Bit-identical to the plain
// PyTorch version (ops/codec_kernels.py::topk_select_ref). Inputs are
// finite (NaN has no defined place in the order). Unlike the Pallas kernel,
// which declines rows past its VMEM budget, this kernel takes every width.
//
// Sort key: key = bits(x) & 0x7fffffff, the float bits with the sign
// cleared, which orders non-negative floats as uint32.
//
// Design, correctness first:
//   1. radix select of T, the k-th largest key of each row: four 8-bit
//      passes, MSB first. Each pass is a histogram kernel (several blocks
//      per row, a shared-memory histogram per block, atomics into a per-row
//      histogram in global scratch) and a one-block-per-row select kernel
//      that walks the 256 bins down, fixes one byte of T, and accumulates
//      n_gt, the number of keys above T.
//   2. compaction: every key > T goes to a slot from a per-row atomic
//      counter; of the keys == T, the first (k - n_gt) in INDEX order are
//      kept. That needs their rank in index order: a count pass per block,
//      an exclusive scan of the block counts per row, and an ordered pass
//      (warp ballots within each 256-element tile, tiles in order).
//   3. order: the k candidates are sorted ascending by the composite
//      (~key << 32) | idx with a bitonic network in global memory (the
//      stages below 2048 elements run in shared memory), then gathered.
//
// Bound: bytes. A row must be read at least once (4 B/elt) and k (val, idx)
// pairs written; the select does no arithmetic worth counting. This design
// reads the row six times (four histogram passes, the count pass and the
// compaction pass) and then sorts k candidates of 8 bytes in
// O(k log^2 k) global traffic, so it sits several times above the one-pass
// bound; a single-pass select (one histogram pass with a sample, a
// candidate filter in shared memory) and a radix sort of the survivors are
// later work.
//
// C interface (ctypes): returns cudaGetLastError() after the last launch.
// The caller allocates every buffer (see codec_kernels.py::_topk_cuda):
//   hist   uint32 [R, 256]  zeroed
//   state  uint32 [R, 4]    {prefix=0, k_remaining=k, n_gt=0, gt_slot=0}
//   tiecnt uint32 [R, nblk] (nblk = ceil(N / seg))
//   buf    uint64 [R, kpad] filled with 0xff..ff (kpad = pow2 >= k, >= 2)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSortTile = 2048;  // elements per shared-memory sort tile

__device__ __forceinline__ unsigned key_of(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned long long composite(unsigned key,
                                                        unsigned idx) {
  return ((unsigned long long)(~key) << 32) | (unsigned long long)idx;
}

__global__ void hist_kernel(const float* __restrict__ x, long long n, int seg,
                            unsigned* __restrict__ hist,
                            const unsigned* __restrict__ state, int shift) {
  __shared__ unsigned sh[256];
  const long long row = blockIdx.y;
  const unsigned prefix = state[row * 4 + 0];
  const unsigned hi_mask = shift == 24 ? 0u : (0xffffffffu << (shift + 8));
  sh[threadIdx.x] = 0;
  __syncthreads();
  const float* xr = x + row * n;
  const long long lo = (long long)blockIdx.x * seg;
  const long long hi = min(n, lo + seg);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const unsigned key = key_of(xr[i]);
    if ((key & hi_mask) == (prefix & hi_mask))
      atomicAdd(&sh[(key >> shift) & 0xffu], 1u);
  }
  __syncthreads();
  const unsigned c = sh[threadIdx.x];
  if (c) atomicAdd(&hist[row * 256 + threadIdx.x], c);
}

__global__ void select_kernel(unsigned* __restrict__ hist,
                              unsigned* __restrict__ state, int shift) {
  __shared__ unsigned h[256];
  const long long row = blockIdx.x;
  h[threadIdx.x] = hist[row * 256 + threadIdx.x];
  hist[row * 256 + threadIdx.x] = 0;  // ready for the next pass
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned* st = state + row * 4;
  const unsigned krem = st[1];
  unsigned cum = 0;
  for (int d = 255; d >= 0; --d) {
    const unsigned c = h[d];
    if (cum + c >= krem) {
      st[0] |= (unsigned)d << shift;
      st[1] = krem - cum;
      st[2] += cum;
      return;
    }
    cum += c;
  }
}

__global__ void tie_count_kernel(const float* __restrict__ x, long long n,
                                 int seg, const unsigned* __restrict__ state,
                                 unsigned* __restrict__ tiecnt, int nblk) {
  const long long row = blockIdx.y;
  const unsigned t = state[row * 4 + 0];
  const float* xr = x + row * n;
  const long long lo = (long long)blockIdx.x * seg;
  const long long hi = min(n, lo + seg);
  unsigned cnt = 0;
  for (long long base = lo; base < hi; base += kThreads) {
    const long long i = base + threadIdx.x;
    cnt += __syncthreads_count(i < hi && key_of(xr[i]) == t);
  }
  if (threadIdx.x == 0) tiecnt[row * nblk + blockIdx.x] = cnt;
}

// exclusive scan of tiecnt[row, 0:nblk] in place; one 1024-thread block
// per row, each thread owning a contiguous span of block counts
__global__ void tie_scan_kernel(unsigned* __restrict__ tiecnt, int nblk) {
  __shared__ unsigned sums[1024];
  const long long row = blockIdx.x;
  unsigned* c = tiecnt + row * nblk;
  const int span = (nblk + 1023) / 1024;
  const int lo = threadIdx.x * span;
  const int hi = min(nblk, lo + span);
  unsigned s = 0;
  for (int b = lo; b < hi; ++b) s += c[b];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    const unsigned v = threadIdx.x >= off ? sums[threadIdx.x - off] : 0u;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  unsigned run = sums[threadIdx.x] - s;  // exclusive prefix of this span
  for (int b = lo; b < hi; ++b) {
    const unsigned v = c[b];
    c[b] = run;
    run += v;
  }
}

__global__ void compact_kernel(const float* __restrict__ x, long long n,
                               int seg, unsigned* __restrict__ state,
                               const unsigned* __restrict__ tiebase, int nblk,
                               unsigned long long* __restrict__ buf,
                               long long kpad) {
  __shared__ unsigned warp_tot[kThreads / 32];
  const long long row = blockIdx.y;
  unsigned* st = state + row * 4;
  const unsigned t = st[0], need = st[1], ngt = st[2];
  const float* xr = x + row * n;
  unsigned long long* out = buf + row * kpad;
  const long long lo = (long long)blockIdx.x * seg;
  const long long hi = min(n, lo + seg);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned run = tiebase[row * nblk + blockIdx.x];
  for (long long base = lo; base < hi; base += kThreads) {
    const long long i = base + threadIdx.x;
    const unsigned key = i < hi ? key_of(xr[i]) : 0u;
    const bool tie = i < hi && key == t;
    if (i < hi && key > t) {
      const unsigned slot = atomicAdd(&st[3], 1u);
      out[slot] = composite(key, (unsigned)i);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, tie);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    unsigned off = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      off += w < warp ? warp_tot[w] : 0u;
      tot += warp_tot[w];
    }
    const unsigned rank =
        run + off + __popc(ballot & ((1u << lane) - 1u));
    if (tie && rank < need) out[ngt + rank] = composite(key, (unsigned)i);
    run += tot;
    __syncthreads();  // warp_tot is rewritten by the next tile
  }
}

__device__ __forceinline__ void cmp_swap(unsigned long long& a,
                                         unsigned long long& b, bool asc) {
  if ((a > b) == asc) {
    const unsigned long long tmp = a;
    a = b;
    b = tmp;
  }
}

// sizes 2..tile of the bitonic network, each tile sorted in shared memory
__global__ void bitonic_tile_sort(unsigned long long* __restrict__ buf,
                                  long long kpad, int tile) {
  extern __shared__ unsigned long long s[];
  unsigned long long* b = buf + blockIdx.y * kpad;
  const long long t0 = (long long)blockIdx.x * tile;
  const int p = threadIdx.x;
  s[p] = b[t0 + p];
  s[p + tile / 2] = b[t0 + p + tile / 2];
  __syncthreads();
  for (int size = 2; size <= tile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int i = (p / stride) * 2 * stride + (p % stride);
      cmp_swap(s[i], s[i + stride], ((t0 + i) & size) == 0);
      __syncthreads();
    }
  }
  b[t0 + p] = s[p];
  b[t0 + p + tile / 2] = s[p + tile / 2];
}

// strides tile/2..1 of one network size, in shared memory
__global__ void bitonic_tile_merge(unsigned long long* __restrict__ buf,
                                   long long kpad, int tile, long long size) {
  extern __shared__ unsigned long long s[];
  unsigned long long* b = buf + blockIdx.y * kpad;
  const long long t0 = (long long)blockIdx.x * tile;
  const int p = threadIdx.x;
  s[p] = b[t0 + p];
  s[p + tile / 2] = b[t0 + p + tile / 2];
  __syncthreads();
  for (int stride = tile >> 1; stride > 0; stride >>= 1) {
    const int i = (p / stride) * 2 * stride + (p % stride);
    cmp_swap(s[i], s[i + stride], ((t0 + i) & size) == 0);
    __syncthreads();
  }
  b[t0 + p] = s[p];
  b[t0 + p + tile / 2] = s[p + tile / 2];
}

// one (size, stride) step of the network with stride >= tile
__global__ void bitonic_global_step(unsigned long long* __restrict__ buf,
                                    long long kpad, long long size,
                                    long long stride) {
  unsigned long long* b = buf + blockIdx.y * kpad;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= kpad / 2) return;
  const long long i = (p / stride) * 2 * stride + (p % stride);
  cmp_swap(b[i], b[i + stride], (i & size) == 0);
}

__global__ void gather_kernel(const float* __restrict__ x, long long n,
                              const unsigned long long* __restrict__ buf,
                              long long kpad, long long k,
                              float* __restrict__ val, int* __restrict__ idx) {
  const long long row = blockIdx.y;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= k) return;
  const unsigned i = (unsigned)(buf[row * kpad + t] & 0xffffffffull);
  idx[row * k + t] = (int)i;
  val[row * k + t] = x[row * n + i];
}

}  // namespace

extern "C" int bcfl_topk_select(const float* x, float* val, int* idx,
                                long long rows, long long n, long long k,
                                int seg, unsigned* hist, unsigned* state,
                                unsigned* tiecnt, unsigned long long* buf,
                                long long kpad, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (rows <= 0) return (int)cudaGetLastError();
  const int nblk = (int)((n + seg - 1) / seg);
  const dim3 grid_seg(nblk, (unsigned)rows);
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist_kernel<<<grid_seg, kThreads, 0, stream>>>(x, n, seg, hist, state,
                                                   shift);
    select_kernel<<<(unsigned)rows, 256, 0, stream>>>(hist, state, shift);
  }
  tie_count_kernel<<<grid_seg, kThreads, 0, stream>>>(x, n, seg, state,
                                                      tiecnt, nblk);
  tie_scan_kernel<<<(unsigned)rows, 1024, 0, stream>>>(tiecnt, nblk);
  compact_kernel<<<grid_seg, kThreads, 0, stream>>>(x, n, seg, state, tiecnt,
                                                    nblk, buf, kpad);
  const int tile = (int)(kpad < kSortTile ? kpad : kSortTile);
  const dim3 grid_tile((unsigned)(kpad / tile), (unsigned)rows);
  const size_t smem = (size_t)tile * sizeof(unsigned long long);
  bitonic_tile_sort<<<grid_tile, tile / 2, smem, stream>>>(buf, kpad, tile);
  const dim3 grid_pairs((unsigned)((kpad / 2 + kThreads - 1) / kThreads),
                        (unsigned)rows);
  for (long long size = 2LL * tile; size <= kpad; size <<= 1) {
    for (long long stride = size >> 1; stride >= tile; stride >>= 1)
      bitonic_global_step<<<grid_pairs, kThreads, 0, stream>>>(buf, kpad,
                                                               size, stride);
    bitonic_tile_merge<<<grid_tile, tile / 2, smem, stream>>>(buf, kpad, tile,
                                                              size);
  }
  const dim3 grid_k((unsigned)((k + kThreads - 1) / kThreads),
                    (unsigned)rows);
  gather_kernel<<<grid_k, kThreads, 0, stream>>>(x, n, buf, kpad, k, val,
                                                 idx);
  return (int)cudaGetLastError();
}
