// flash_bwd_dq: flash-attention backward for dQ, one head dim per template
// instance (32, 64, 128), bf16 or float32 inputs.
//
// Replaces the TPU kernel bcfl_tpu/ops/pallas_flash.py::_bwd_dq_kernel
// (launched by _flash_bwd_pallas). For each query i over every key j, with
// the forward's lse:
//   p_ij  = exp(s_ij - lse_i), 0 where dead (j >= Sk, or causal and
//           j > Sk - Sq + i)
//   ds_ij = p_ij (dO_i . v_j - rowsum(dO_i * O_i))
//   dq_i += ds_ij k_j scale  (ds cast to k's dtype)
//
// Bound: at bert-base's [32, 12, 512, 64] bf16 call the 6 B H Sq Sk D =
// 38.7 GFLOP of matmul take 0.039 ms at 989 TFLOP/s, the 151 MB read and
// written (q, k, v, o, dO, dq) 0.045 ms at 3.35 TB/s: bytes and tensor-core
// work bound it about equally, so a kernel near the bound needs the tensor
// cores and reads each K/V tile once per 64 queries. Both routes run one
// block per (64-query tile, b * h), looping over the key tiles with the
// 64 x D dq accumulator in registers; Dsum is computed once per block from
// dO and O; a causal block stops at the last key tile its rows can see (a
// block whose rows see no key writes zeros). The route is picked by dtype
// alone (never by trying one and falling back):
// - bf16, flash_bwd_dq_wgmma: one warpgroup (128 threads). The Q and dO
//   tiles are staged once and stay resident; the K and V tiles and the 64
//   key biases of each key tile go through a 2-stage cp.async ring, so the
//   next tile's copy overlaps this tile's products. S = Q K^T and
//   dP = dO V^T are wgmma m64n64k16 chains issued together on bf16 tiles in
//   shared memory (both K-major); p and ds are computed on their
//   accumulator fragments (the key bias by column, lse and Dsum by row);
//   ds, rounded to bf16 in registers, is the A operand of dQ += dS K, with
//   K read MN-major from the same tile, as K1's O += P V reads V: no
//   transposed copy, no p or ds through shared memory. Three float
//   accumulators (S, dP, dQ) against K2's four; what bounds it is the
//   score math between the products, which nothing inside the warpgroup
//   overlaps, so several blocks share an SM (kDqMinBlocks at D <= 64).
//   Interior tiles skip the dead-entry checks. See flash_sm90.cuh.
// - float32, flash_bwd_dq_kernel: tensor cores have no float32 product
//   that holds 1e-4 (TF32 keeps about three digits), so float32 keeps the
//   FMA kernel of flash_common.cuh: 4 warps, every operand staged as float
//   in the layout its product reads, ds through shared memory.
//
// C interface: bcfl_flash_bwd_dq (below).

#include <type_traits>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {
namespace {

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * D * (kBM + kPad) + 2 * D * (kBN + kPad) +
                          kBN * (D + kPad) + kBN * (kBM + kPad) + kBN + kBM);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params<T> p) {
  constexpr int TD = D / 8;
  constexpr int LQ = kBM + kPad, LK = kBN + kPad, LD = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [D][LQ]   q tile, transposed
  float* dot_t = qt + D * LQ;    // [D][LQ]   dO tile, transposed
  float* kt = dot_t + D * LQ;    // [D][LK]   k tile, transposed
  float* vt = kt + D * LK;       // [D][LK]   v tile, transposed
  float* ks = vt + D * LK;       // [kBN][LD] k tile
  float* dst = ks + kBN * LD;    // [kBN][LQ] ds cast to k's dtype, transposed
  float* bs = dst + kBN * LQ;    // [kBN]     key bias
  float* dsum = bs + kBN;        // [kBM]

  // rows are queries (4 per row group); columns are keys (8 per column
  // group) in the score tiles and head dims (TD) in dq
  const int rg = row_group(), cg = col_group();
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * kBM;
  const T* qb = p.q + b * p.qs.b + h * p.qs.h;
  const T* kb = p.k + b * p.ks.b + h * p.ks.h;
  const T* vb = p.v + b * p.vs.b + h * p.vs.h;
  const T* ob = p.o + b * p.os.b + h * p.os.h;
  const T* dob = p.dout + b * p.dos.b + h * p.dos.h;
  load_tile<T, D>(qb, p.qs.s, q0, p.Sq, nullptr, qt);
  load_tile<T, D>(dob, p.dos.s, q0, p.Sq, nullptr, dot_t);
  __syncthreads();
  tile_dsum<T, D>(ob, p.os.s, q0, p.Sq, dot_t, 1, LQ, dsum);
  __syncthreads();
  float lse_r[4], dsum_r[4], dq[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    lse_r[i] = qi < p.Sq ? p.lse[(long long)bh * p.Sq + qi] : 0.0f;
    dsum_r[i] = dsum[rg * 4 + i];
#pragma unroll
    for (int c = 0; c < TD; ++c) dq[i][c] = 0.0f;
  }

  const int shift = p.Sk - p.Sq;  // query i sits at key position shift + i
  int nk = (p.Sk + kBN - 1) / kBN;
  if (p.causal) {  // key tiles past the tile's last visible key are dead
    const int last = min(q0 + kBM, p.Sq) - 1 + shift;
    nk = last < 0 ? 0 : min(nk, last / kBN + 1);
  }
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(kb, p.ks.s, k0, p.Sk, ks, kt);
    load_tile<T, D>(vb, p.vs.s, k0, p.Sk, nullptr, vt);
    if (threadIdx.x < kBN)
      bs[threadIdx.x] = k0 + (int)threadIdx.x < p.Sk
                            ? p.bias[(long long)b * p.Sk + k0 + threadIdx.x]
                            : 0.0f;
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
    mma_acc<4, 8, D>(s, qt, LQ, kt, LK, rg * 4, cg * 8);
    mma_acc<4, 8, D>(dp, dot_t, LQ, vt, LK, rg * 4, cg * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = shift + q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + cg * 8 + j;
        const bool dead = key >= p.Sk || (p.causal && key > qpos);
        const float pv =
            expf(__fadd_rn(__fmul_rn(s[i][j], p.scale), bs[cg * 8 + j]) -
                 lse_r[i]);
        s[i][j] = dead ? 0.0f : pv * (dp[i][j] - dsum_r[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(dst + (cg * 8 + j) * LQ + rg * 4) =
          make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]),
                      round_to<T>(s[2][j]), round_to<T>(s[3][j]));
    __syncthreads();
    mma_acc<4, TD, kBN>(dq, dst, LQ, ks, LD, rg * 4, cg * TD);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= p.Sq) continue;
    T* o = p.out + ((long long)bh * p.Sq + qi) * D + cg * TD;
#pragma unroll
    for (int c = 0; c < TD; ++c) o[c] = from_float<T>(dq[i][c] * p.scale);
  }
}

template <typename T, int D>
struct DqLaunch {
  static int run(const Params<T>& p, int B, cudaStream_t stream) {
    constexpr size_t bytes = dq_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.Sq + kBM - 1) / kBM, B * p.H);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
};

// ------------------------------------------------ bf16: wgmma, cp.async

// blocks per SM that __launch_bounds__ asks ptxas to fit at D <= 64
constexpr int kDqMinBlocks = 3;

// shared memory: the Q and dO tiles, 2 stages of (K tile, V tile), 2 x 64
// key biases, 64 Dsum values, and the slack to align the tiles to 1024
// bytes
template <int D>
constexpr size_t dq_wgmma_smem_bytes() {
  return 6 * sm90::Tile<D>::kBytes + 3 * kBN * sizeof(float) + sm90::kAlign;
}

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, D <= 64 ? kDqMinBlocks : 1)
    flash_bwd_dq_wgmma(const Params<__nv_bfloat16> p) {
  using namespace sm90;
  using T = __nv_bfloat16;
  using L = Tile<D>;
  constexpr int kTile = L::kBytes;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint8_t* smem = smem_raw + (base - raw);  // generic view of base
  const uint32_t sq = base, sdo = base + kTile;
  // stage s: K at base + (2 + 2 s) kTile, V one tile on
  const uint32_t sbias = base + 6 * kTile;  // [2][64] floats, then Dsum [64]
  const float* bias_s = reinterpret_cast<const float*>(smem + 6 * kTile);
  float* dsum_s = reinterpret_cast<float*>(smem_raw + (sbias - raw) +
                                           2 * kBN * sizeof(float));

  // accumulator rows are queries, columns keys (scores) or head dims (dq)
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * kBM;
  const T* kb = p.k + b * p.ks.b + h * p.ks.h;
  const T* vb = p.v + b * p.vs.b + h * p.vs.h;
  const T* ob = p.o + b * p.os.b + h * p.os.h;
  const float* biasb = p.bias + (long long)b * p.Sk;
  stage_tile<D>(sq, p.q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.Sq);
  stage_tile<D>(sdo, p.dout + b * p.dos.b + h * p.dos.h, p.dos.s, q0, p.Sq);
  cp_async_commit();

  const int shift = p.Sk - p.Sq;  // query i sits at key position shift + i
  int nk = (p.Sk + kBN - 1) / kBN;
  if (p.causal) {  // key tiles past the tile's last visible key are dead
    const int last = min(q0 + kBM, p.Sq) - 1 + shift;
    nk = last < 0 ? 0 : min(nk, last / kBN + 1);
  }
  auto issue = [&](int tile) {
    const int st = tile & 1, k0 = tile * kBN;
    stage_tile<D>(base + (2 + 2 * st) * kTile, kb, p.ks.s, k0, p.Sk);
    stage_tile<D>(base + (3 + 2 * st) * kTile, vb, p.vs.s, k0, p.Sk);
    stage_row(sbias + st * kBN * 4, biasb, k0, p.Sk);
  };
  if (nk > 0) issue(0);
  cp_async_commit();

  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + frag_row(hh);
    lse_r[hh] = qi < p.Sq ? p.lse[(long long)bh * p.Sq + qi] : 0.0f;
  }
  cp_async_wait<1>();  // this thread's copies of the Q and dO tiles
  __syncthreads();     // everyone's
  {  // Dsum_i = rowsum(dO_i * O_i): dO from its tile, O from device memory,
     // two threads a row
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const uint8_t* tdo = smem + kTile;
    float acc = 0.0f;
    if (q0 + r < p.Sq) {
      const T* orow = ob + (long long)(q0 + r) * p.os.s;
#pragma unroll
      for (int c = half * (L::kChunks / 2); c < (half + 1) * (L::kChunks / 2);
           ++c) {
        const uint4 x = *reinterpret_cast<const uint4*>(tdo + L::offset(r, c));
        const uint4 y = *reinterpret_cast<const uint4*>(orow + c * 8);
        const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 xf = __bfloat1622float2(xh[u]);
          const float2 yf = __bfloat1622float2(yh[u]);
          acc = fmaf(xf.x, yf.x, acc);
          acc = fmaf(xf.y, yf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) dsum_s[r] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) dsum_r[hh] = dsum_s[frag_row(hh)];

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<0>();  // this thread's copies of tile it have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; tile it - 1's readers are done
    if (it + 1 < nk) issue(it + 1);
    cp_async_commit();
    const int st = it & 1, k0 = it * kBN;
    const uint32_t sk = base + (2 + 2 * st) * kTile;
    const uint32_t sv = sk + kTile;
    const float* bs = bias_s + st * kBN;

    // S = Q K^T and dP = dO V^T, issued together
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64(s, desc_k<D>(sq, kk), desc_k<D>(sk, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64(dp, desc_k<D>(sdo, kk), desc_k<D>(sv, kk), 1);
    wgmma_commit();

    // p and ds on S's and dP's fragments; the dead-entry checks only on a
    // tile that holds keys past Sk or, causal, past the block's first query
    auto scores = [&](auto masked) {
      constexpr bool kMask = decltype(masked)::value;
      wgmma_wait<1>();  // S
      fence_regs(s);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qpos = shift + q0 + frag_row(hh);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e, col = frag_col(j, e);
            const int key = k0 + col;
            const bool dead =
                kMask && (key >= p.Sk || (p.causal && key > qpos));
            s[i] = dead ? 0.0f
                        : expf(__fadd_rn(__fmul_rn(s[i], p.scale), bs[col]) -
                               lse_r[hh]);
          }
      }
      wgmma_wait<0>();  // dP
      fence_regs(dp);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qpos = shift + q0 + frag_row(hh);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const int key = k0 + frag_col(j, e);
            const bool dead =
                kMask && (key >= p.Sk || (p.causal && key > qpos));
            s[i] = dead ? 0.0f : s[i] * (dp[i] - dsum_r[hh]);
          }
      }
    };
    if (k0 + kBN > p.Sk || (p.causal && k0 + kBN - 1 > shift + q0))
      scores(std::true_type{});
    else
      scores(std::false_type{});

    uint32_t a[4][4];  // ds cast to k's dtype, as A fragments
    acc_to_a(s, a);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<D>(dq, a[kk], desc_mn<D>(sk, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  }
  cp_async_wait<0>();  // an empty ring group, when no key tile was live

  store_acc<D>(dq, p.scale, p.out, (long long)bh * p.Sq + q0, q0, p.Sq);
}

template <typename T, int D>
struct DqWgmmaLaunch {
  static int run(const Params<T>& p, int B, cudaStream_t stream) {
    constexpr size_t bytes = dq_wgmma_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.Sq + kBM - 1) / kBM, B * p.H);
    flash_bwd_dq_wgmma<D><<<grid, sm90::kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace flash

// strides: (b, h, s) of q, k, v, o, dO in elements. bf16 launches the
// wgmma kernel, float32 the FMA kernel. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a head dim not built.
extern "C" int bcfl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const float* bias, const void* o,
                                 const void* dout, const float* lse, void* dq,
                                 int B, int H, int Sq, int Sk, int D,
                                 int is_bf16, const long long* strides,
                                 float scale, int causal, void* stream) {
  using namespace flash;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    auto p = make_params<T>(q, k, v, bias, H, Sq, Sk, strides, 5, scale,
                            causal);
    p.o = static_cast<const T*>(o);
    p.dout = static_cast<const T*>(dout);
    p.lse = lse;
    p.out = static_cast<T*>(dq);
    return dispatch_d<DqWgmmaLaunch>(D, p, B, st);
  }
  auto p = make_params<float>(q, k, v, bias, H, Sq, Sk, strides, 5, scale,
                              causal);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = lse;
  p.out = static_cast<float*>(dq);
  return dispatch_d<DqLaunch>(D, p, B, st);
}
