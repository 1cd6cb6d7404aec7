// flash_bwd_dkv: flash-attention backward for dK, dV and the key-bias
// gradient, one head dim per template instance (32, 64, 128), bf16, fp16
// or float32 inputs.
//
// Replaces the TPU kernel bcfl_tpu/ops/pallas_flash.py::_bwd_dkv_kernel
// (launched by _flash_bwd_pallas). For each key j against every query i,
// with the forward's lse:
//   p_ij  = exp(s_ij - lse_i), 0 where dead (j >= Sk, i >= Sq, or causal
//           and j > Sk - Sq + i)
//   dv_j += p_ij dO_i        (p cast to dO's dtype)
//   Dsum_i = rowsum(dO_i * O_i)
//   ds_ij = p_ij (dO_i . v_j - Dsum_i)
//   dk_j += ds_ij q_i scale  (ds cast to q's dtype)
//   db_j += ds_ij            (float32, per head: db_h [B, H, Sk])
// The caller sums db_h over heads for the [B, Sk] bias gradient.
//
// Bound: at bert-base's [32, 12, 512, 64] bf16 call the 8 B H Sq Sk D =
// 51.5 GFLOP of matmul take 0.052 ms at 989 TFLOP/s, the 178 MB read and
// written (q, k, v, o, dO, dk, dv, db_h) 0.053 ms at 3.35 TB/s: bytes and
// tensor-core work bound it about equally. Both routes run one block per
// (64-key tile, b * h), looping over the query tiles; the block owns its
// keys for one head, so dk, dv and db_h accumulate in registers and are
// written once, with no atomics, and Dsum is recomputed per query tile from
// dO and O, as the Pallas kernel does. A causal block starts at the first
// query tile that sees its keys. The route is picked by dtype alone:
// - bf16 or fp16, flash_bwd_dkv_wgmma<T>: one warpgroup (128 threads).
//   K, V and the key biases stay resident; the Q, dO and O tiles and the
//   64 lse values of each query tile go through a 2-stage cp.async ring,
//   so the next tile's copy overlaps this tile's products, and Dsum comes
//   from the staged dO and O. All four products are wgmma chains on
//   16-bit tiles: S^T = K Q^T and dP^T = V dO^T with both operands K-major
//   in shared memory, then dV += P^T dO and dK += dS^T Q with P^T and
//   dS^T, rounded to T, as register A operands and dO, Q read MN-major
//   from the same tiles: no transposed copy, no p or ds through shared
//   memory. lse and Dsum are indexed by the accumulator's column (the
//   query). About 66 KB of shared memory at D = 64 (3 blocks would fit),
//   but four 64 x 64 float accumulators (S^T, dP^T, dK, dV) take the
//   thread to 255 registers, so registers hold it to 2 blocks per SM; at
//   D = 128 ptxas spills and serializes the wgmma. See flash_sm90.cuh.
// - float32, flash_bwd_dkv_kernel: tensor cores have no float32 product
//   that holds 1e-4, so float32 keeps the float32 FMA kernel, 4 warps with
//   every operand staged as float in the layout its product reads.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {
namespace {

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * D * (kBN + kPad) + 2 * D * (kBM + kPad) +
                          2 * kBM * (D + kPad) + kBM * (kBN + kPad) +
                          2 * kBM);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params<T> p) {
  constexpr int TD = D / 8;
  constexpr int LQ = kBM + kPad, LK = kBN + kPad, LD = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;               // [D][LK]   this block's k tile, transposed
  float* vt = kt + D * LK;        // [D][LK]   v tile, transposed
  float* qt = vt + D * LK;        // [D][LQ]   q tile, transposed
  float* qs = qt + D * LQ;        // [kBM][LD] q tile
  float* dos = qs + kBM * LD;     // [kBM][LD] dO tile
  float* dot_t = dos + kBM * LD;  // [D][LQ]   dO tile, transposed
  float* ps = dot_t + D * LQ;     // [kBM][LK] p, then ds, cast; [query][key]
  float* lse_s = ps + kBM * LK;   // [kBM]
  float* dsum = lse_s + kBM;      // [kBM]

  // rows are keys (4 per row group); columns are queries (8 per column
  // group) in the score tiles and head dims (TD) in dk / dv
  const int rg = row_group(), cg = col_group();
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.x * kBN;
  const T* qb = p.q + b * p.qs.b + h * p.qs.h;
  const T* kb = p.k + b * p.ks.b + h * p.ks.h;
  const T* vb = p.v + b * p.vs.b + h * p.vs.h;
  const T* ob = p.o + b * p.os.b + h * p.os.h;
  const T* dob = p.dout + b * p.dos.b + h * p.dos.h;
  load_tile<T, D>(kb, p.ks.s, k0, p.Sk, nullptr, kt);
  load_tile<T, D>(vb, p.vs.s, k0, p.Sk, nullptr, vt);
  float bias_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg * 4 + i;
    bias_k[i] = key < p.Sk ? p.bias[(long long)b * p.Sk + key] : 0.0f;
  }

  float dk[4][TD], dv[4][TD], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) dk[i][c] = dv[i][c] = 0.0f;
  }
  const int shift = p.Sk - p.Sq;  // query i sits at key position shift + i
  int t0 = 0;
  if (p.causal) {  // the first query that sees key k0 is k0 - shift
    const int first = k0 - shift;
    t0 = first <= 0 ? 0 : first / kBM;
  }
  const int nq = (p.Sq + kBM - 1) / kBM;
  for (int t = t0; t < nq; ++t) {
    const int q0 = t * kBM;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(qb, p.qs.s, q0, p.Sq, qs, qt);
    load_tile<T, D>(dob, p.dos.s, q0, p.Sq, dos, dot_t);
    if (threadIdx.x < kBM)
      lse_s[threadIdx.x] = q0 + (int)threadIdx.x < p.Sq
                               ? p.lse[(long long)bh * p.Sq + q0 + threadIdx.x]
                               : 0.0f;
    __syncthreads();
    tile_dsum<T, D>(ob, p.os.s, q0, p.Sq, dos, LD, 1, dsum);

    float pr[4][8];  // s^T, then p: [key][query]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) pr[i][j] = 0.0f;
    mma_acc<4, 8, D>(pr, kt, LK, qt, LQ, rg * 4, cg * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qi = q0 + cg * 8 + j;
        const bool dead =
            key >= p.Sk || qi >= p.Sq || (p.causal && key > shift + qi);
        pr[i][j] = dead ? 0.0f
                        : expf(__fadd_rn(__fmul_rn(pr[i][j], p.scale),
                                         bias_k[i]) -
                               lse_s[cg * 8 + j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(ps + (cg * 8 + j) * LK + rg * 4) =
          make_float4(round_to<T>(pr[0][j]), round_to<T>(pr[1][j]),
                      round_to<T>(pr[2][j]), round_to<T>(pr[3][j]));
    __syncthreads();  // p and dsum are visible
    mma_acc<4, TD, kBM>(dv, ps, LK, dos, LD, rg * 4, cg * TD);

    float ds[4][8];  // dP^T, then ds: [key][query]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ds[i][j] = 0.0f;
    mma_acc<4, 8, D>(ds, vt, LK, dot_t, LQ, rg * 4, cg * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qi = q0 + cg * 8 + j;
        const bool dead =
            key >= p.Sk || qi >= p.Sq || (p.causal && key > shift + qi);
        ds[i][j] = dead ? 0.0f : pr[i][j] * (ds[i][j] - dsum[cg * 8 + j]);
        db[i] += ds[i][j];
      }
    }
    __syncthreads();  // every thread is done reading p from ps
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(ps + (cg * 8 + j) * LK + rg * 4) =
          make_float4(round_to<T>(ds[0][j]), round_to<T>(ds[1][j]),
                      round_to<T>(ds[2][j]), round_to<T>(ds[3][j]));
    __syncthreads();
    mma_acc<4, TD, kBM>(dk, ps, LK, qs, LD, rg * 4, cg * TD);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dbi = group_sum(db[i]);
    const int key = k0 + rg * 4 + i;
    if (key >= p.Sk) continue;
    const long long row = (long long)bh * p.Sk + key;
    T* dko = p.dk + row * D + cg * TD;
    T* dvo = p.dv + row * D + cg * TD;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      dko[c] = from_float<T>(dk[i][c] * p.scale);
      dvo[c] = from_float<T>(dv[i][c]);
    }
    if (cg == 0) p.db[row] = dbi;
  }
}

template <typename T, int D>
struct DkvLaunch {
  static int run(const Params<T>& p, int B, cudaStream_t stream) {
    constexpr size_t bytes = dkv_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.Sk + kBN - 1) / kBN, B * p.H);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
};

// ---------------------------------------- bf16 and fp16: wgmma, cp.async

// shared memory: the K and V tiles, 2 stages of (Q, dO, O tiles, 64 lse
// values), 64 Dsum values, and the slack to align the tiles to 1024 bytes
template <int D>
constexpr size_t dkv_wgmma_smem_bytes() {
  return 8 * sm90::Tile<D>::kBytes + 3 * kBM * sizeof(float) + sm90::kAlign;
}

template <typename T, int D>
__global__ void __launch_bounds__(sm90::kThreads)
    flash_bwd_dkv_wgmma(const Params<T> p) {
  using namespace sm90;
  using L = Tile<D>;
  constexpr int kTile = L::kBytes;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint8_t* smem = smem_raw + (base - raw);  // generic view of base
  const uint32_t sk = base, sv = base + kTile;
  // stage s: Q at base + (2 + 3 s) kTile, dO one tile on, O two tiles on
  const uint32_t slse = base + 8 * kTile;  // [2][64] floats, then Dsum [64]
  const float* lse_s = reinterpret_cast<const float*>(smem + 8 * kTile);
  float* dsum_s = reinterpret_cast<float*>(
      smem_raw + (slse - raw) + 2 * kBM * sizeof(float));

  // accumulator rows are keys, columns queries (scores) or head dims
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.x * kBN;
  const T* qb = p.q + b * p.qs.b + h * p.qs.h;
  const T* ob = p.o + b * p.os.b + h * p.os.h;
  const T* dob = p.dout + b * p.dos.b + h * p.dos.h;
  const float* lseb = p.lse + (long long)bh * p.Sq;
  stage_tile<D>(sk, p.k + b * p.ks.b + h * p.ks.h, p.ks.s, k0, p.Sk);
  stage_tile<D>(sv, p.v + b * p.vs.b + h * p.vs.h, p.vs.s, k0, p.Sk);
  int key[2];
  float bias_k[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = k0 + frag_row(hh);
    bias_k[hh] = key[hh] < p.Sk ? p.bias[(long long)b * p.Sk + key[hh]] : 0.0f;
  }

  const int shift = p.Sk - p.Sq;  // query i sits at key position shift + i
  int t0 = 0;
  if (p.causal) {  // the first query that sees key k0 is k0 - shift
    const int first = k0 - shift;
    t0 = first <= 0 ? 0 : first / kBM;
  }
  const int nq = (p.Sq + kBM - 1) / kBM;
  auto issue = [&](int tile) {
    const int st = tile & 1, q0 = tile * kBM;
    const uint32_t sq = base + (2 + 3 * st) * kTile;
    stage_tile<D>(sq, qb, p.qs.s, q0, p.Sq);
    stage_tile<D>(sq + kTile, dob, p.dos.s, q0, p.Sq);
    stage_tile<D>(sq + 2 * kTile, ob, p.os.s, q0, p.Sq);
    stage_row(slse + st * kBM * 4, lseb, q0, p.Sq);
  };
  if (t0 < nq) issue(t0);
  cp_async_commit();  // with the K and V tiles

  float dk[D / 2], dv[D / 2], db[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  for (int it = t0; it < nq; ++it) {
    cp_async_wait<0>();  // this thread's copies of tile it have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; tile it - 1's readers are done
    if (it + 1 < nq) issue(it + 1);
    cp_async_commit();
    const int st = it & 1, q0 = it * kBM;
    const uint32_t sq = base + (2 + 3 * st) * kTile;
    const uint32_t sdo = sq + kTile;
    const float* ls = lse_s + st * kBM;

    // S^T = K Q^T and dP^T = V dO^T, issued together
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64<T>(s, desc_k<D>(sk, kk), desc_k<D>(sq, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64<T>(dp, desc_k<D>(sv, kk), desc_k<D>(sdo, kk), 1);
    wgmma_commit();

    {  // Dsum_i = rowsum(dO_i * O_i) from the staged tiles, two threads a row
      const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
      const uint8_t* tdo = smem + (sdo - base);
      const uint8_t* to = tdo + kTile;
      float acc = 0.0f;
#pragma unroll
      for (int c = half * (L::kChunks / 2); c < (half + 1) * (L::kChunks / 2);
           ++c) {
        const uint4 x = *reinterpret_cast<const uint4*>(tdo + L::offset(r, c));
        const uint4 y = *reinterpret_cast<const uint4*>(to + L::offset(r, c));
        acc = dot8<T>(x, y, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) dsum_s[r] = acc;
    }

    // the rest on S^T's and dP^T's fragments; the dead-entry checks only
    // on a tile with keys past Sk, queries past Sq or, causal, keys past
    // the tile's first query
    auto finish = [&](auto masked) {
      constexpr bool kMask = decltype(masked)::value;
      wgmma_wait<1>();  // S^T
      fence_regs(s);
      // p = exp(s - lse), 0 where dead
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e, col = frag_col(j, e);
            const int qi = q0 + col;
            const bool dead = kMask && (key[hh] >= p.Sk || qi >= p.Sq ||
                                        (p.causal && key[hh] > shift + qi));
            s[i] = dead ? 0.0f
                        : expf(__fadd_rn(__fmul_rn(s[i], p.scale), bias_k[hh]) -
                               ls[col]);
          }
      uint32_t a[4][4];  // p cast to dO's dtype, as A fragments
      acc_to_a<T>(s, a);
      wgmma_wait<0>();  // dP^T
      fence_regs(dp);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T, D>(dv, a[kk], desc_mn<D>(sdo, kk), 1);
      wgmma_commit();

      __syncthreads();  // Dsum is visible
      // ds = p (dP - Dsum), 0 where dead
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e, col = frag_col(j, e);
            const int qi = q0 + col;
            const bool dead = kMask && (key[hh] >= p.Sk || qi >= p.Sq ||
                                        (p.causal && key[hh] > shift + qi));
            dp[i] = dead ? 0.0f : s[i] * (dp[i] - dsum_s[col]);
            db[hh] += dp[i];
          }
      uint32_t a2[4][4];  // ds cast to q's dtype
      acc_to_a<T>(dp, a2);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T, D>(dk, a2[kk], desc_mn<D>(sq, kk), 1);
      wgmma_commit();
    };
    if (k0 + kBN > p.Sk || q0 + kBM > p.Sq ||
        (p.causal && k0 + kBN - 1 > shift + q0))
      finish(std::true_type{});
    else
      finish(std::false_type{});
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
  }
  cp_async_wait<0>();  // the K and V tiles, when no query tile was live

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float dbi = quad_sum(db[hh]);
    if (frag_t() == 0 && key[hh] < p.Sk)
      p.db[(long long)bh * p.Sk + key[hh]] = dbi;
  }
  const long long row0 = (long long)bh * p.Sk + k0;
  store_acc<D>(dk, p.scale, p.dk, row0, k0, p.Sk);
  store_acc<D>(dv, 1.0f, p.dv, row0, k0, p.Sk);
}

template <typename T, int D>
struct DkvWgmmaLaunch {
  static int run(const Params<T>& p, int B, cudaStream_t stream) {
    constexpr size_t bytes = dkv_wgmma_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_wgmma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.Sk + kBN - 1) / kBN, B * p.H);
    flash_bwd_dkv_wgmma<T, D><<<grid, sm90::kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
};

template <typename T, template <typename, int> class Launch>
int dkv_call(const void* q, const void* k, const void* v, const float* bias,
             const void* o, const void* dout, const float* lse, void* dk,
             void* dv, float* db, int B, int H, int Sq, int Sk, int D,
             const long long* strides, float scale, int causal,
             cudaStream_t stream) {
  auto p = make_params<T>(q, k, v, bias, H, Sq, Sk, strides, 5, scale,
                          causal);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = lse;
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.db = db;
  return dispatch_d<Launch>(D, p, B, stream);
}

}  // namespace
}  // namespace flash

// strides: (b, h, s) of q, k, v, o, dO in elements. dtype (a DtypeCode):
// bf16 and fp16 launch their wgmma kernels, float32 the FMA kernel.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a dtype code or head dim not built.
extern "C" int bcfl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const float* bias, const void* o,
                                  const void* dout, const float* lse,
                                  void* dk, void* dv, float* db, int B,
                                  int H, int Sq, int Sk, int D, int dtype,
                                  const long long* strides, float scale,
                                  int causal, void* stream) {
  using namespace flash;
  if (B * H == 0 || Sk == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBFloat16:
      return dkv_call<__nv_bfloat16, DkvWgmmaLaunch>(
          q, k, v, bias, o, dout, lse, dk, dv, db, B, H, Sq, Sk, D, strides,
          scale, causal, st);
    case kFloat16:
      return dkv_call<__half, DkvWgmmaLaunch>(
          q, k, v, bias, o, dout, lse, dk, dv, db, B, H, Sq, Sk, D, strides,
          scale, causal, st);
    case kFloat32:
      return dkv_call<float, DkvLaunch>(q, k, v, bias, o, dout, lse, dk, dv,
                                        db, B, H, Sq, Sk, D, strides, scale,
                                        causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
