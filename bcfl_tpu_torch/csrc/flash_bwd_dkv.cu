// flash_bwd_dkv: flash-attention backward for dK, dV and the key-bias
// gradient, one head dim per template instance (32, 64, 128), bf16 or
// float32 inputs.
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
// written (q, k, v, o, dO, dk, dv, db_h) 0.053 ms at 3.35 TB/s. Design: one
// block per (64-key tile, b * h) with 4 warps, looping over the query tiles;
// the block owns its keys for one head, so dk, dv and db_h accumulate in
// registers and are written once, with no atomics. Dsum is recomputed per
// query tile from dO and O, as the Pallas kernel does. Products are float32
// FMAs (exact for bf16 inputs), a fraction of the tensor-core rate; a causal
// block starts at the first query tile that sees its keys.

#include "flash_common.cuh"

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

}  // namespace
}  // namespace flash

// strides: (b, h, s) of q, k, v, o, dO in elements. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim not built.
extern "C" int bcfl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const float* bias, const void* o,
                                  const void* dout, const float* lse,
                                  void* dk, void* dv, float* db, int B,
                                  int H, int Sq, int Sk, int D, int is_bf16,
                                  const long long* strides, float scale,
                                  int causal, void* stream) {
  using namespace flash;
  if (B * H == 0 || Sk == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    auto p = make_params<T>(q, k, v, bias, H, Sq, Sk, strides, 5, scale,
                            causal);
    p.o = static_cast<const T*>(o);
    p.dout = static_cast<const T*>(dout);
    p.lse = lse;
    p.dk = static_cast<T*>(dk);
    p.dv = static_cast<T*>(dv);
    p.db = db;
    return dispatch_d<DkvLaunch>(D, p, B, st);
  }
  auto p = make_params<float>(q, k, v, bias, H, Sq, Sk, strides, 5, scale,
                              causal);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = lse;
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.db = db;
  return dispatch_d<DkvLaunch>(D, p, B, st);
}
