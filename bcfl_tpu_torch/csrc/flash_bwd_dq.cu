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
// written (q, k, v, o, dO, dq) 0.045 ms at 3.35 TB/s. Design: one block per
// (64-query tile, b * h) with 4 warps, looping over the key tiles, the
// 64 x D dq accumulator in registers; Dsum is computed once per block from
// dO and O. Products are float32 FMAs (exact for bf16 inputs), a fraction
// of the tensor-core rate; a causal block stops at the last key tile its
// rows can see.

#include "flash_common.cuh"

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

}  // namespace
}  // namespace flash

// strides: (b, h, s) of q, k, v, o, dO in elements. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim not built.
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
    return dispatch_d<DqLaunch>(D, p, B, st);
  }
  auto p = make_params<float>(q, k, v, bias, H, Sq, Sk, strides, 5, scale,
                              causal);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = lse;
  p.out = static_cast<float*>(dq);
  return dispatch_d<DqLaunch>(D, p, B, st);
}
