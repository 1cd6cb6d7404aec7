// topk_select: per-row magnitude top-k of the update codec.
//
// Replaces the TPU kernel bcfl_tpu/ops/pallas_codec.py::_topk_kernel
// (launched by _topk_select_pallas). For each row x[r, 0:N] (f32) it returns
// the k entries of largest |x| as (val f32 [R, k], idx int32 [R, k]) in
// lax.top_k order: |x| descending, equal |x| lower index first; values are
// loaded straight from x, so -0.0 stays -0.0. Bit-identical to the plain
// PyTorch version (ops/codec_kernels.py::topk_select_ref). Inputs are
// finite (NaN has no defined place in the order). Unlike the Pallas kernel,
// which declines rows past its VMEM budget, this kernel takes every width
// (N < 2^31, R < 65536).
//
// Sort key: key = bits(x) & 0x7fffffff, the float bits with the sign
// cleared, which orders non-negative floats as uint32. Its 31 bits are cut
// into three digits, most significant first: d1 = bits 30..19 (12 bits:
// the exponent and 4 mantissa bits), d2 = bits 18..9, d3 = bits 8..0.
//
// Bound: bytes. A row must be read once (4 B/elt) and k (val, idx) pairs
// written; the select does no arithmetic worth counting. The design reads
// each row twice and touches only the threshold bin's candidates and the
// k survivors after that:
//   1. hist_row_kernel: histogram of d1 over the row (a shared-memory
//      histogram per block; the 12-bit digit spreads a row of deltas over
//      many bins, and a warp whose lanes share one bin adds once, so a
//      bin that takes most of the row does not serialise the atomics),
//      summed per row in global memory. select_kernel then finds the
//      threshold bin b1 and the number of keys above it.
//   2. compact_kernel<filter>: the second read of the row. Keys with
//      d1 > b1 are survivors; keys with d1 == b1 are candidates. Both are
//      written in index order, survivors (sort key, index) to the front of
//      the row's sort buffer, candidates (index) to the row's candidate
//      buffer, which holds N entries: a row that lies in one bin fits.
//      The order comes from a block count (ballots), a scan within the
//      block and a decoupled look-back across the row's chunks (each block
//      publishes its chunk's counts, then its inclusive prefix; chunks are
//      taken by ticket, so a block only waits on chunks already taken).
//   3. hist_cand_kernel + select_kernel twice: d2, then d3, over the
//      candidates only (keys gathered through their indices, in index
//      order), fixing T, the k-th largest key, and `need`, the number of
//      keys equal to T that make the top k.
//   4. compact_kernel<final>: over the candidates, keys > T and the first
//      `need` keys == T in index order go behind the survivors, again in
//      index order.
//   5. a stable LSD radix sort of the k survivors on 0x7fffffff - key,
//      four 8-bit digits: per digit a count (shared-memory histogram per
//      4096-element tile), one scan per row, and a scatter that ranks
//      equal digits stably within each warp's run (one ballot per digit
//      bit) and across warps and tiles, then writes the tile out through
//      shared memory in digit order, so the stores to a digit's run
//      coalesce. A stable sort on the key alone keeps equal keys in index
//      order, the lax.top_k tie rule, since the sort's input holds the
//      survivors and the selected candidates each in index order and no
//      key occurs in both. The last pass writes val (gathered from x) and
//      idx.
// Launches per call: a memset and 20 kernels, whatever the width.
//
// C interface (ctypes): bcfl_topk_select(x, val, idx, rows, n, k, work,
// words, stream) returns cudaGetLastError() after the last launch, or
// cudaErrorInvalidValue if `work` holds fewer than
// bcfl_topk_scratch_words(rows, n, k) 32-bit words (the wrapper,
// codec_kernels.py::_topk_cuda, asks that entry). `work` is carved, in
// order, into:
//   zeroed here per call: hist1 [R, 4096], hist2 [R, 1024], hist3 [R, 512],
//     state [R, 8], two look-back status arrays of [R, nchunks] uint64
//     (nchunks = ceil(N / 4096));
//   cand [R, N]; four sort buffers of [R, k] (keys and indices, twice);
//   counts [R, ntiles, 256] (ntiles = ceil(k / 4096)).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                 // elements per thread per chunk
constexpr int kChunk = kThreads * kPer;  // elements per chunk (and tile)
constexpr unsigned kFull = 0xffffffffu;

// the select digits: bits [shift, shift + log2(bins)) of the key
constexpr int kShift1 = 19, kBins1 = 4096;
constexpr int kShift2 = 9, kBins2 = 1024;
constexpr int kShift3 = 0, kBins3 = 512;
constexpr int kSortBins = 256;  // the sort's 8-bit digits, 4 passes

// per-row state words
constexpr int kPrefix = 0;   // the digits of T fixed so far
constexpr int kKrem = 1;     // keys still to take at and below the prefix
constexpr int kNAbove = 2;   // keys with d1 > b1 (the survivors)
constexpr int kNCand = 3;    // keys with d1 == b1 (the candidates)
constexpr int kTicket = 4;   // chunk tickets: filter at 4, final at 5
constexpr int kStateWords = 8;

constexpr unsigned long long kFlagAgg = 1ull << 62;  // the chunk's counts
constexpr unsigned long long kFlagInc = 2ull << 62;  // inclusive prefix
constexpr unsigned long long kValMask = kFlagAgg - 1;
constexpr unsigned kMask31 = 0x7fffffffu;

__device__ __forceinline__ unsigned key_of(float v) {
  return __float_as_uint(v) & kMask31;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// h[bin] += 1 for each lane with `valid`, in shared memory. A warp whose
// 32 lanes all hold one bin (a row of one repeated value) adds once; else
// each lane adds, and lanes of equal bins serialise on their address,
// which the 12-bit leading digit keeps to a few for real rows. Every lane
// of the warp calls it.
__device__ __forceinline__ void hist_add(unsigned* h, unsigned bin,
                                         bool valid) {
  const unsigned first = __shfl_sync(kFull, bin, 0);
  if (__all_sync(kFull, valid && bin == first)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&h[first], 32u);
  } else if (valid) {
    atomicAdd(&h[bin], 1u);
  }
}

// The lanes of the warp whose 8-bit digit equals this lane's (invalid
// lanes match only each other): one ballot per bit, as a radix sort's
// warp-level multisplit does.
__device__ __forceinline__ unsigned match_digit(unsigned d, bool valid) {
  const unsigned v = __ballot_sync(kFull, valid);
  unsigned m = valid ? v : ~v;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned ones = __ballot_sync(kFull, bit);
    m &= bit ? ones : ~ones;
  }
  return m;
}

template <int kBins>
__device__ __forceinline__ void hist_flush(const unsigned* sh, unsigned* h) {
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += kThreads)
    if (sh[i]) atomicAdd(&h[i], sh[i]);
}

template <int kBins>
__device__ __forceinline__ void hist_zero(unsigned* sh) {
  for (int i = threadIdx.x; i < kBins; i += kThreads) sh[i] = 0;
  __syncthreads();
}

// pass 1: histogram of d1 over each row; grid (blocks per row, R)
__global__ void __launch_bounds__(kThreads)
    hist_row_kernel(const float* __restrict__ x, long long n,
                    unsigned* __restrict__ hist1) {
  __shared__ unsigned sh[kBins1];
  hist_zero<kBins1>(sh);
  const long long row = blockIdx.y;
  const float* xr = x + row * n;
  const long long step = (long long)gridDim.x * kChunk;
  for (long long c0 = (long long)blockIdx.x * kChunk; c0 < n; c0 += step) {
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long i = c0 + j * kThreads + threadIdx.x;
      v[j] = i < n ? xr[i] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      hist_add(sh, key_of(v[j]) >> kShift1,
               c0 + j * kThreads + threadIdx.x < n);
  }
  hist_flush<kBins1>(sh, hist1 + row * kBins1);
}

// passes 3: histogram of the digit at kShift over the candidates whose
// higher digits equal the prefix; grid (blocks per row, R)
template <int kShift, int kBins>
__global__ void __launch_bounds__(kThreads)
    hist_cand_kernel(const float* __restrict__ x, long long n,
                     const unsigned* __restrict__ cand,
                     const unsigned* __restrict__ state,
                     unsigned* __restrict__ hist) {
  constexpr int kHigh = kShift + (kBins == 1024 ? 10 : 9);
  __shared__ unsigned sh[kBins];
  hist_zero<kBins>(sh);
  const long long row = blockIdx.y;
  const unsigned* st = state + row * kStateWords;
  const long long count = st[kNCand];
  const unsigned high = st[kPrefix] >> kHigh;
  const float* xr = x + row * n;
  const unsigned* cr = cand + row * n;
  const long long step = (long long)gridDim.x * kChunk;
  for (long long c0 = (long long)blockIdx.x * kChunk; c0 < count;
       c0 += step) {
    unsigned key[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long c = c0 + j * kThreads + threadIdx.x;
      key[j] = c < count ? key_of(xr[cr[c]]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long c = c0 + j * kThreads + threadIdx.x;
      hist_add(sh, (key[j] >> kShift) & (kBins - 1),
               c < count && (key[j] >> kHigh) == high);
    }
  }
  hist_flush<kBins>(sh, hist + row * kBins);
}

// Find the bin of the k_rem-th largest key of each row from its histogram:
// fix the bin's digit in the prefix, and take the keys above the bin off
// k_rem (the first select also records them as n_above). One block per
// row; thread t owns kBins / 256 bins, from the top down.
template <int kShift, int kBins>
__global__ void __launch_bounds__(kThreads)
    select_kernel(const unsigned* __restrict__ hist,
                  unsigned* __restrict__ state, long long k, int first) {
  constexpr int kOwn = kBins / kThreads;
  __shared__ unsigned warp_sums[kWarps];
  const long long row = blockIdx.x;
  const unsigned* h = hist + row * kBins;
  unsigned* st = state + row * kStateWords;
  const unsigned krem = first ? (unsigned)k : st[kKrem];
  const int top = kBins - 1 - (int)threadIdx.x * kOwn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned c[kOwn], sum = 0;
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    c[u] = h[top - u];
    sum += c[u];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += warp_sums[w];
  const unsigned excl = incl - sum;
  if (excl < krem && incl >= krem) {  // one thread: its bins hold the crossing
    unsigned cum = excl;
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      if (cum + c[u] >= krem) {
        st[kPrefix] |= (unsigned)(top - u) << kShift;
        st[kKrem] = krem - cum;
        if (first) st[kNAbove] = cum;
        break;
      }
      cum += c[u];
    }
  }
}

// The exclusive prefix, over the chunks of one row before chunk t, of the
// packed counts (class 0 in bits 61..31, class 1 in bits 30..0): publish
// this chunk's counts `agg`, add up the predecessors' back to the nearest
// inclusive prefix, publish this chunk's inclusive prefix. Called by all
// lanes of one warp; returns the prefix in every lane.
__device__ unsigned long long look_back(unsigned long long* stat, long long t,
                                        unsigned long long agg) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) atomicExch(stat, kFlagInc | agg);
    return 0;
  }
  if (lane == 0) atomicExch(stat + t, kFlagAgg | agg);
  unsigned long long excl = 0;
  for (long long last = t - 1;; last -= 32) {
    const long long q = last - lane;
    unsigned long long s = kFlagInc;  // before chunk 0: an inclusive 0
    if (q >= 0) {
      do {
        s = *reinterpret_cast<volatile unsigned long long*>(stat + q);
      } while ((s >> 62) == 0);
    }
    const unsigned inc = __ballot_sync(kFull, (s >> 62) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    unsigned long long v = lane <= stop ? (s & kValMask) : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    excl += v;
    if (inc) break;
  }
  if (lane == 0) atomicExch(stat + t, kFlagInc | (excl + agg));
  return excl;
}

// Ordered compaction over one row, chunk by chunk (grid (blocks per row,
// R), chunks taken by ticket):
// - kFinal false (the filter): over x[row]; class 0 = d1 > b1 goes to the
//   sort buffer at its rank, class 1 = d1 == b1 to the candidate buffer;
//   the block of the last chunk records the number of candidates.
// - kFinal true: over the candidates; class 0 = key > T, class 1 = key ==
//   T; a key of class 0, or of class 1 ranked below `need`, goes to the
//   sort buffer behind the n_above survivors, in index order.
template <bool kFinal>
__global__ void __launch_bounds__(kThreads, 4)
    compact_kernel(const float* __restrict__ x, long long n, long long k,
                   unsigned* __restrict__ state,
                   unsigned long long* __restrict__ status, long long nchunks,
                   unsigned* __restrict__ cand, unsigned* __restrict__ skey,
                   unsigned* __restrict__ sidx) {
  __shared__ unsigned s_cnt[2][kPer * kWarps];
  __shared__ unsigned s_base[2];
  __shared__ unsigned s_ticket;
  const long long row = blockIdx.y;
  unsigned* st = state + row * kStateWords;
  const float* xr = x + row * n;
  unsigned* cr = cand + row * n;
  unsigned* kr = skey + row * k;
  unsigned* ir = sidx + row * k;
  unsigned long long* stat = status + row * nchunks;
  const unsigned prefix = st[kPrefix];
  const unsigned b1 = prefix >> kShift1;
  const unsigned need = st[kKrem];
  const unsigned n_above = st[kNAbove];
  const long long count = kFinal ? (long long)st[kNCand] : n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = lanemask_lt();
  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(&st[kTicket + kFinal], 1u);
    __syncthreads();
    const long long t = s_ticket;
    const long long c0 = t * kChunk;
    if (c0 >= count) break;
    unsigned key[kPer], idx[kFinal ? kPer : 1];
    unsigned m0 = 0, m1 = 0;  // bit j: element j is of class 0 / class 1
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long c = c0 + j * kThreads + threadIdx.x;
      const bool valid = c < count;
      bool a, b;
      if (kFinal) {
        idx[j] = valid ? cr[c] : 0u;
        key[j] = valid ? key_of(xr[idx[j]]) : 0u;
        a = valid && key[j] > prefix;
        b = valid && key[j] == prefix;
      } else {
        key[j] = valid ? key_of(xr[c]) : 0u;
        a = valid && (key[j] >> kShift1) > b1;
        b = valid && (key[j] >> kShift1) == b1;
      }
      m0 |= (unsigned)a << j;
      m1 |= (unsigned)b << j;
    }
    // counts per (j, warp), in index order
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned a = __ballot_sync(kFull, (m0 >> j) & 1u);
      const unsigned b = __ballot_sync(kFull, (m1 >> j) & 1u);
      if (lane == 0) {
        s_cnt[0][j * kWarps + warp] = __popc(a);
        s_cnt[1][j * kWarps + warp] = __popc(b);
      }
    }
    __syncthreads();
    if (warp == 0) {  // scan of the 128 counts; lane l owns 4 l .. 4 l + 3
      unsigned v0[4], v1[4], sum0 = 0, sum1 = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v0[u] = s_cnt[0][4 * lane + u];
        v1[u] = s_cnt[1][4 * lane + u];
        sum0 += v0[u];
        sum1 += v1[u];
      }
      unsigned inc0 = sum0, inc1 = sum1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y0 = __shfl_up_sync(kFull, inc0, off);
        const unsigned y1 = __shfl_up_sync(kFull, inc1, off);
        if (lane >= off) {
          inc0 += y0;
          inc1 += y1;
        }
      }
      unsigned e0 = inc0 - sum0, e1 = inc1 - sum1;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s_cnt[0][4 * lane + u] = e0;
        s_cnt[1][4 * lane + u] = e1;
        e0 += v0[u];
        e1 += v1[u];
      }
      const unsigned tot0 = __shfl_sync(kFull, inc0, 31);
      const unsigned tot1 = __shfl_sync(kFull, inc1, 31);
      const unsigned long long before = look_back(
          stat, t, ((unsigned long long)tot0 << 31) | tot1);
      if (lane == 0) {
        s_base[0] = (unsigned)(before >> 31) & kMask31;
        s_base[1] = (unsigned)before & kMask31;
        if (!kFinal && c0 + kChunk >= count)
          st[kNCand] = ((unsigned)before & kMask31) + tot1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool is0 = (m0 >> j) & 1u, is1 = (m1 >> j) & 1u;
      const unsigned a = __ballot_sync(kFull, is0);
      const unsigned b = __ballot_sync(kFull, is1);
      const unsigned r0 =
          s_base[0] + s_cnt[0][j * kWarps + warp] + __popc(a & lt);
      const unsigned r1 =
          s_base[1] + s_cnt[1][j * kWarps + warp] + __popc(b & lt);
      const unsigned i = kFinal ? idx[j]
                                : (unsigned)(c0 + j * kThreads + threadIdx.x);
      if (kFinal) {
        if (is0 || (is1 && r1 < need)) {
          const unsigned pos = n_above + r0 + min(r1, need);
          kr[pos] = kMask31 - key[j];
          ir[pos] = i;
        }
      } else if (is0) {
        kr[r0] = kMask31 - key[j];
        ir[r0] = i;
      } else if (is1) {
        cr[r1] = i;
      }
    }
    __syncthreads();  // s_cnt, s_base and s_ticket are rewritten
  }
}

// sort pass, step 1: the digit counts of each 4096-element tile of each
// row, into counts[row][tile][digit]; grid (tiles, R)
__global__ void __launch_bounds__(kThreads)
    sort_count_kernel(const unsigned* __restrict__ skey, long long k,
                      int ntiles, int shift, unsigned* __restrict__ counts) {
  __shared__ unsigned sh[kSortBins];
  hist_zero<kSortBins>(sh);
  const long long row = blockIdx.y;
  const unsigned* kr = skey + row * k;
  const long long e0 = (long long)blockIdx.x * kChunk;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long e = e0 + j * kThreads + threadIdx.x;
    const bool valid = e < k;
    const unsigned d = valid ? (kr[e] >> shift) & 255u : 0u;
    // the high digits of the survivors' keys fall in a few bins: one
    // atomic per group of equal digits
    const unsigned peers = match_digit(d, valid);
    if (valid && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&sh[d], (unsigned)__popc(peers));
  }
  __syncthreads();
  counts[(row * ntiles + blockIdx.x) * kSortBins + threadIdx.x] =
      sh[threadIdx.x];
}

// sort pass, step 2: counts[row][tile][d] becomes the position in the
// row's output of the tile's first key with digit d: keys with a smaller
// digit first, then earlier tiles. One block of 1024 threads per row:
// thread (g, d) walks quarter g of the tiles for digit d.
__global__ void __launch_bounds__(1024)
    sort_scan_kernel(unsigned* __restrict__ counts, int ntiles) {
  constexpr int kGroups = 1024 / kSortBins;
  __shared__ unsigned part[kGroups][kSortBins];
  __shared__ unsigned warp_sums[kSortBins / 32];
  const long long row = blockIdx.x;
  unsigned* c = counts + row * ntiles * kSortBins;
  const int d = threadIdx.x % kSortBins, g = threadIdx.x / kSortBins;
  const int span = (ntiles + kGroups - 1) / kGroups;
  const int lo = min(ntiles, g * span), hi = min(ntiles, lo + span);
  unsigned sum = 0;
  for (int t = lo; t < hi; ++t) sum += c[(long long)t * kSortBins + d];
  part[g][d] = sum;
  __syncthreads();
  // exclusive scan over the digits of their row totals (threads g == 0,
  // the first 256: whole warps)
  const int lane = d & 31, warp = d >> 5;
  unsigned tot = 0, incl = 0;
  if (g == 0) {
#pragma unroll
    for (int q = 0; q < kGroups; ++q) tot += part[q][d];
    incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
  }
  __syncthreads();
  if (g == 0) {
    for (int w = 0; w < warp; ++w) incl += warp_sums[w];
    unsigned run = incl - tot;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const unsigned v = part[q][d];
      part[q][d] = run;
      run += v;
    }
  }
  __syncthreads();
  unsigned run = part[g][d];
  for (int t = lo; t < hi; ++t) {
    const unsigned v = c[(long long)t * kSortBins + d];
    c[(long long)t * kSortBins + d] = run;
    run += v;
  }
}

// sort pass, step 3: move each key to its place, stably. Warp w of the
// block holds elements [512 w, 512 w + 512) of the tile, 32 at a time in
// index order, and ranks each among the equal digits before it in its run
// (match_digit and a per-warp count per digit); the counts of the earlier
// warps and of the smaller digits give its place in the tile. The tile is
// reordered by digit in shared memory, then written out with neighbouring
// threads on neighbouring addresses of each digit's run. The last pass
// (val != nullptr) writes val, gathered from x, and idx.
__global__ void __launch_bounds__(kThreads)
    sort_scatter_kernel(const float* __restrict__ x, long long n,
                        const unsigned* __restrict__ kin,
                        const unsigned* __restrict__ iin, long long k,
                        int ntiles, int shift,
                        const unsigned* __restrict__ counts,
                        unsigned* __restrict__ kout,
                        unsigned* __restrict__ iout, float* __restrict__ val,
                        int* __restrict__ idx) {
  __shared__ unsigned wcnt[kWarps][kSortBins];
  __shared__ unsigned gbase[kSortBins];
  __shared__ unsigned warp_sums[kWarps];
  __shared__ unsigned tkey[kChunk], tid_[kChunk];
  for (int i = threadIdx.x; i < kWarps * kSortBins; i += kThreads)
    (&wcnt[0][0])[i] = 0;
  __syncthreads();
  const long long row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = lanemask_lt();
  const long long t0 = (long long)blockIdx.x * kChunk;
  const long long e0 = t0 + warp * (kChunk / kWarps);
  unsigned key[kPer], id[kPer], rank[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long e = e0 + j * 32 + lane;
    const bool valid = e < k;
    key[j] = valid ? kin[row * k + e] : 0u;
    id[j] = valid ? iin[row * k + e] : 0u;
    const unsigned d = (key[j] >> shift) & 255u;
    const unsigned peers = match_digit(d, valid);
    const unsigned before = valid ? wcnt[warp][d] : 0u;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) wcnt[warp][d] += __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & lt);
  }
  __syncthreads();
  {  // thread d: where digit d's keys of each warp start in the tile
    const int d = threadIdx.x;
    unsigned tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned v = wcnt[w][d];
      wcnt[w][d] = tot;
      tot += v;
    }
    unsigned incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += warp_sums[w];
    const unsigned start = incl - tot;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcnt[w][d] += start;
    // modulo 2^32: gbase[d] + i is the row position of tile entry i
    gbase[d] = counts[(row * ntiles + blockIdx.x) * kSortBins + d] - start;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (e0 + j * 32 + lane >= k) continue;
    const unsigned at = wcnt[warp][(key[j] >> shift) & 255u] + rank[j];
    tkey[at] = key[j];
    tid_[at] = id[j];
  }
  __syncthreads();
  const int live = (int)min((long long)kChunk, k - t0);
  for (int i = threadIdx.x; i < live; i += kThreads) {
    const unsigned kk = tkey[i], ii = tid_[i];
    const unsigned at = gbase[(kk >> shift) & 255u] + i;
    const long long pos = row * k + at;
    if (val != nullptr) {
      val[pos] = x[row * n + ii];
      idx[pos] = (int)ii;
    } else {
      kout[pos] = kk;
      iout[pos] = ii;
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// 32-bit words of scratch a call needs (see the layout above).
extern "C" long long bcfl_topk_scratch_words(long long rows, long long n,
                                             long long k) {
  const long long nchunks = ceil_div(n, kChunk), ntiles = ceil_div(k, kChunk);
  return rows * (kBins1 + kBins2 + kBins3 + kStateWords) +
         4 * rows * nchunks + rows * n + 4 * rows * k +
         rows * ntiles * kSortBins;
}

extern "C" int bcfl_topk_select(const float* x, float* val, int* idx,
                                long long rows, long long n, long long k,
                                unsigned* work, long long words,
                                void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (rows <= 0) return (int)cudaGetLastError();
  if (words < bcfl_topk_scratch_words(rows, n, k) || k < 1 || k > n)
    return (int)cudaErrorInvalidValue;
  const long long nchunks = ceil_div(n, kChunk), ntiles = ceil_div(k, kChunk);
  unsigned* hist1 = work;
  unsigned* hist2 = hist1 + rows * kBins1;
  unsigned* hist3 = hist2 + rows * kBins2;
  unsigned* state = hist3 + rows * kBins3;
  auto* status = reinterpret_cast<unsigned long long*>(state +
                                                       rows * kStateWords);
  unsigned long long* status_final = status + rows * nchunks;
  unsigned* cand = reinterpret_cast<unsigned*>(status_final + rows * nchunks);
  unsigned* sk0 = cand + rows * n;
  unsigned* si0 = sk0 + rows * k;
  unsigned* sk1 = si0 + rows * k;
  unsigned* si1 = sk1 + rows * k;
  unsigned* counts = si1 + rows * k;
  cudaError_t e = cudaMemsetAsync(
      work, 0, (size_t)((char*)cand - (char*)work), stream);
  if (e != cudaSuccess) return (int)e;

  // blocks per row of the passes over a row: about 8 per SM in all
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long per_row = ceil_div(8LL * sms, rows);
  per_row = per_row < 1 ? 1 : (per_row > nchunks ? nchunks : per_row);
  const dim3 grid_row((unsigned)per_row, (unsigned)rows);
  const unsigned R = (unsigned)rows;

  hist_row_kernel<<<grid_row, kThreads, 0, stream>>>(x, n, hist1);
  select_kernel<kShift1, kBins1><<<R, kThreads, 0, stream>>>(hist1, state,
                                                             k, 1);
  compact_kernel<false><<<grid_row, kThreads, 0, stream>>>(
      x, n, k, state, status, nchunks, cand, sk0, si0);
  hist_cand_kernel<kShift2, kBins2><<<grid_row, kThreads, 0, stream>>>(
      x, n, cand, state, hist2);
  select_kernel<kShift2, kBins2><<<R, kThreads, 0, stream>>>(hist2, state,
                                                             k, 0);
  hist_cand_kernel<kShift3, kBins3><<<grid_row, kThreads, 0, stream>>>(
      x, n, cand, state, hist3);
  select_kernel<kShift3, kBins3><<<R, kThreads, 0, stream>>>(hist3, state,
                                                             k, 0);
  compact_kernel<true><<<grid_row, kThreads, 0, stream>>>(
      x, n, k, state, status_final, nchunks, cand, sk0, si0);

  const dim3 grid_tiles((unsigned)ntiles, R);
  unsigned *kin = sk0, *iin = si0, *kout = sk1, *iout = si1;
  for (int shift = 0; shift < 32; shift += 8) {
    const bool last = shift == 24;
    sort_count_kernel<<<grid_tiles, kThreads, 0, stream>>>(
        kin, k, (int)ntiles, shift, counts);
    sort_scan_kernel<<<R, 1024, 0, stream>>>(counts, (int)ntiles);
    sort_scatter_kernel<<<grid_tiles, kThreads, 0, stream>>>(
        x, n, kin, iin, k, (int)ntiles, shift, counts, kout, iout,
        last ? val : nullptr, last ? idx : nullptr);
    unsigned* t = kin;
    kin = kout;
    kout = t;
    t = iin;
    iin = iout;
    iout = t;
  }
  return (int)cudaGetLastError();
}
