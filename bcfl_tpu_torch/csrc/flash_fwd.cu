// flash_fwd: flash-attention forward (online softmax), one head dim per
// template instance (32, 64, 128), bf16 or float32 inputs.
//
// Replaces the TPU kernel bcfl_tpu/ops/pallas_flash.py::_fwd_kernel
// (launched by _flash_fwd_pallas). For each query row i of q [B, H, Sq, D]
// against keys k, v [B, H, Sk, D] and the key bias [B, Sk]:
//   s_ij = (q_i . k_j) * scale + bias_j, scale = 1 / sqrt(D)
//   dead: j >= Sk, or causal and j > Sk - Sq + i (suffix alignment);
//         s = -1e30 there and p = 0 after the exp
//   m, l, acc: running max, normaliser and float32 accumulator of
//         p = exp(s - m) . v over the key tiles, p cast to v's dtype
//   out = acc / max(l, 1e-9) in q's dtype; lse = m + log(max(l, 1e-30))
// lse is stored [B, H, Sq] (the Pallas kernel pads it to 128 lanes).
//
// Bound: at bert-base's [32, 12, 512, 64] bf16 call the 4 B H Sq Sk D =
// 25.8 GFLOP of matmul take 0.026 ms at the card's 989 TFLOP/s of bf16
// tensor-core work, and the 100.7 MB of q, k, v and out 0.030 ms at
// 3.35 TB/s: the two are close, so a kernel at the bound needs the tensor
// cores and reads each K/V tile once per 64 queries.
//
// Two routes, picked by dtype alone (never by trying one and falling back):
// - bf16, flash_fwd_wgmma: one block (one warpgroup, 128 threads) per
//   (64-query tile, b * h). The Q tile is loaded once; the K and V tiles
//   and the 64 key biases go through a 2-stage cp.async ring, so the next
//   tile's copy overlaps this tile's products. S = Q K^T is a wgmma
//   m64n64k16 chain on bf16 tiles in shared memory (both K-major); the
//   running max and normaliser come from quad shuffles on S's accumulator
//   fragment; p, rounded to bf16 in registers, is the A operand of
//   O += P V (wgmma RS form, V read MN-major from the same tile layout), so
//   p never goes through shared memory. About 42 KB of shared memory and
//   128 registers a thread at D = 64, so 4 blocks share an SM: while one
//   block runs its softmax (nothing overlaps it inside the block), the
//   others keep the tensor cores busy. See flash_sm90.cuh.
// - float32, flash_fwd_kernel: tensor cores have no float32 product that
//   holds 1e-4 (TF32 keeps about three digits), so float32 inputs keep the
//   float32 FMA kernel: K and V staged in shared memory as float, one
//   block per (64-query tile, b * h) with 4 warps.
// A causal block stops at the last key tile its rows can see.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {
namespace {

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (D * (kBM + kPad) + D * (kBN + kPad) +
                          kBN * (D + kPad) + kBN * (kBM + kPad) + kBN);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params<T> p) {
  constexpr int TD = D / 8;  // output columns per thread
  constexpr int LQ = kBM + kPad, LK = kBN + kPad, LD = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // [D][LQ]   q tile, transposed
  float* kt = qt + D * LQ;     // [D][LK]   k tile, transposed
  float* vs = kt + D * LK;     // [kBN][LD] v tile
  float* pt = vs + kBN * LD;   // [kBN][LQ] p cast to v's dtype, transposed
  float* bs = pt + kBN * LQ;   // [kBN]     key bias

  const int rg = row_group(), cg = col_group();
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * kBM;
  const T* qb = p.q + b * p.qs.b + h * p.qs.h;
  const T* kb = p.k + b * p.ks.b + h * p.ks.h;
  const T* vb = p.v + b * p.vs.b + h * p.vs.h;
  load_tile<T, D>(qb, p.qs.s, q0, p.Sq, nullptr, qt);

  float m[4], l[4], acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.0f;
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
    load_tile<T, D>(kb, p.ks.s, k0, p.Sk, nullptr, kt);
    load_tile<T, D>(vb, p.vs.s, k0, p.Sk, vs, nullptr);
    if (threadIdx.x < kBN)
      bs[threadIdx.x] = k0 + (int)threadIdx.x < p.Sk
                            ? p.bias[(long long)b * p.Sk + k0 + threadIdx.x]
                            : 0.0f;
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    mma_acc<4, 8, D>(s, qt, LQ, kt, LK, rg * 4, cg * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = shift + q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + cg * 8 + j;
        const bool dead = key >= p.Sk || (p.causal && key > qpos);
        s[i][j] = dead ? kNegInf
                       : __fadd_rn(__fmul_rn(s[i][j], p.scale), bs[cg * 8 + j]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + cg * 8 + j;
        const bool dead = key >= p.Sk || (p.causal && key > qpos);
        const float e = dead ? 0.0f : expf(s[i][j] - m_new);
        sum += e;
        s[i][j] = e;
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(pt + (cg * 8 + j) * LQ + rg * 4) =
          make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]),
                      round_to<T>(s[2][j]), round_to<T>(s[3][j]));
    __syncthreads();
    mma_acc<4, TD, kBN>(acc, pt, LQ, vs, LD, rg * 4, cg * TD);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= p.Sq) continue;
    const long long row = (long long)bh * p.Sq + qi;
    const float den = fmaxf(l[i], 1e-9f);
    T* o = p.out + row * D + cg * TD;
#pragma unroll
    for (int c = 0; c < TD; ++c) o[c] = from_float<T>(acc[i][c] / den);
    if (cg == 0) p.lse_out[row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int D>
struct FwdLaunch {
  static int run(const Params<T>& p, int B, cudaStream_t stream) {
    constexpr size_t bytes = fwd_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.Sq + kBM - 1) / kBM, B * p.H);
    flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
};

// ------------------------------------------------ bf16: wgmma, cp.async

// shared memory: the Q tile, 2 stages of (K tile, V tile), 2 x 64 key
// biases, and the slack to align the tiles to 1024 bytes
template <int D>
constexpr size_t fwd_wgmma_smem_bytes() {
  return 5 * sm90::Tile<D>::kBytes + 2 * kBN * sizeof(float) + sm90::kAlign;
}

// at D <= 64, 4 blocks per SM: ptxas keeps the kernel at 128 registers
// (147 unbounded, 3 blocks), which hides more of each block's softmax
template <int D>
__global__ void __launch_bounds__(sm90::kThreads, D <= 64 ? 4 : 1)
    flash_fwd_wgmma(const Params<__nv_bfloat16> p) {
  using namespace sm90;
  using T = __nv_bfloat16;
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint32_t sq = base;  // then K of stage s at base + (1 + 2 s) kTile,
                             // V at base + (2 + 2 s) kTile
  const uint32_t sbias = base + 5 * kTile;
  const float* bias_s =
      reinterpret_cast<const float*>(smem_raw + (sbias - raw));

  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * kBM;
  const T* kb = p.k + b * p.ks.b + h * p.ks.h;
  const T* vb = p.v + b * p.vs.b + h * p.vs.h;
  const float* biasb = p.bias + (long long)b * p.Sk;
  stage_tile<D>(sq, p.q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.Sq);

  const int shift = p.Sk - p.Sq;  // query i sits at key position shift + i
  int nk = (p.Sk + kBN - 1) / kBN;
  if (p.causal) {  // key tiles past the tile's last visible key are dead
    const int last = min(q0 + kBM, p.Sq) - 1 + shift;
    nk = last < 0 ? 0 : min(nk, last / kBN + 1);
  }
  auto issue = [&](int tile) {
    const int st = tile & 1, k0 = tile * kBN;
    stage_tile<D>(base + (1 + 2 * st) * kTile, kb, p.ks.s, k0, p.Sk);
    stage_tile<D>(base + (2 + 2 * st) * kTile, vb, p.vs.s, k0, p.Sk);
    stage_row(sbias + st * kBN * 4, biasb, k0, p.Sk);
  };
  if (nk > 0) issue(0);
  cp_async_commit();  // with the Q tile

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<0>();  // this thread's copies of tile it have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; tile it - 1's readers are done
    if (it + 1 < nk) issue(it + 1);
    cp_async_commit();
    const int st = it & 1, k0 = it * kBN;
    const uint32_t sk = base + (1 + 2 * st) * kTile;
    const uint32_t sv = sk + kTile;
    const float* bs = bias_s + st * kBN;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64(s, desc_k<D>(sq, kk), desc_k<D>(sk, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the online softmax on S's fragment, in place (s becomes p); the
    // dead-key checks only on a tile that holds keys past Sk or, causal,
    // past the block's first query
    auto softmax = [&](auto masked) {
      constexpr bool kMask = decltype(masked)::value;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qpos = shift + q0 + frag_row(hh);
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e, col = frag_col(j, e);
            const int key = k0 + col;
            const bool dead =
                kMask && (key >= p.Sk || (p.causal && key > qpos));
            s[i] = dead ? kNegInf
                        : __fadd_rn(__fmul_rn(s[i], p.scale), bs[col]);
            mx = fmaxf(mx, s[i]);
          }
        const float m_new = fmaxf(m[hh], quad_max(mx));
        const float alpha = expf(m[hh] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const int key = k0 + frag_col(j, e);
            const bool dead =
                kMask && (key >= p.Sk || (p.causal && key > qpos));
            const float ex = dead ? 0.0f : expf(s[i] - m_new);
            sum += ex;
            s[i] = ex;
          }
        l[hh] = l[hh] * alpha + quad_sum(sum);
        m[hh] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * hh] *= alpha;
          o[4 * j + 2 * hh + 1] *= alpha;
        }
      }
    };
    if (k0 + kBN > p.Sk || (p.causal && k0 + kBN - 1 > shift + q0))
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    uint32_t a[4][4];  // p cast to v's dtype, as A fragments
    acc_to_a(s, a);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<D>(o, a[kk], desc_mn<D>(sv, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();  // the Q tile, when no key tile was live

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float den = fmaxf(l[hh], 1e-9f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * hh] /= den;
      o[4 * j + 2 * hh + 1] /= den;
    }
    const int qi = q0 + frag_row(hh);
    if (frag_t() == 0 && qi < p.Sq)
      p.lse_out[(long long)bh * p.Sq + qi] = m[hh] + logf(fmaxf(l[hh], 1e-30f));
  }
  store_acc<D>(o, 1.0f, p.out, (long long)bh * p.Sq + q0, q0, p.Sq);
}

template <typename T, int D>
struct FwdWgmmaLaunch {
  static int run(const Params<T>& p, int B, cudaStream_t stream) {
    constexpr size_t bytes = fwd_wgmma_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.Sq + kBM - 1) / kBM, B * p.H);
    flash_fwd_wgmma<D><<<grid, sm90::kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace flash

// strides: (b, h, s) of q, k, v in elements. bf16 launches the wgmma
// kernel, float32 the FMA kernel. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a head dim not built.
extern "C" int bcfl_flash_fwd(const void* q, const void* k, const void* v,
                              const float* bias, void* out, float* lse,
                              int B, int H, int Sq, int Sk, int D,
                              int is_bf16, const long long* strides,
                              float scale, int causal, void* stream) {
  using namespace flash;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    auto p = make_params<__nv_bfloat16>(q, k, v, bias, H, Sq, Sk, strides, 3,
                                        scale, causal);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.lse_out = lse;
    return dispatch_d<FwdWgmmaLaunch>(D, p, B, st);
  }
  auto p = make_params<float>(q, k, v, bias, H, Sq, Sk, strides, 3, scale,
                              causal);
  p.out = static_cast<float*>(out);
  p.lse_out = lse;
  return dispatch_d<FwdLaunch>(D, p, B, st);
}
