// sm90_check: one warpgroup product of each form the bf16 flash kernels
// use, built from flash_sm90.cuh, for tests/test_torch_kernels.py to hold
// against torch.matmul on the card:
// - form 0, C[64, 64] = A B^T: A [64, D] and B [64, D] bf16 tiles staged
//   by the cp.async ring, both K-major operands in shared memory (S = Q K^T);
// - form 1, C[64, D] = bf16(P) V: P [64, 64] float, loaded into the
//   accumulator fragment and packed in registers as the A operand, V
//   [64, D] an MN-major operand in shared memory (O += P V).
// The second operand's rows at or past `live` are zero-filled by the ring.

#include "../../bcfl_tpu_torch/csrc/flash_sm90.cuh"

using namespace flash::sm90;

template <int D>
__global__ void __launch_bounds__(kThreads)
    check_ss(const __nv_bfloat16* a, const __nv_bfloat16* b, float* c,
             int live) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint32_t sa = base, sb = base + Tile<D>::kBytes;
  stage_tile<D>(sa, a, D, 0, kRows);
  stage_tile<D>(sb, b, D, 0, live);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss_n64(d, desc_k<D>(sa, kk), desc_k<D>(sb, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c[frag_row(h) * 64 + frag_col(j, e)] = d[4 * j + 2 * h + e];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    check_rs(const float* p, const __nv_bfloat16* v, float* c, int live) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sv = (smem_addr(smem) + kAlign - 1) & ~uint32_t(kAlign - 1);
  stage_tile<D>(sv, v, D, 0, live);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float s[32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s[4 * j + 2 * h + e] = p[frag_row(h) * 64 + frag_col(j, e)];
  uint32_t a[4][4];
  acc_to_a(s, a);
  float d[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) d[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs<D>(d, a[kk], desc_mn<D>(sv, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c[frag_row(h) * D + frag_col(j, e)] = d[4 * j + 2 * h + e];
}

template <int D>
int run(int form, const void* x, const void* y, float* c, int live) {
  const int bytes = 2 * Tile<D>::kBytes + kAlign;
  cudaError_t e;
  if (form == 0) {
    e = cudaFuncSetAttribute(check_ss<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    check_ss<D><<<1, kThreads, bytes>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y), c, live);
  } else {
    e = cudaFuncSetAttribute(check_rs<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    check_rs<D><<<1, kThreads, bytes>>>(static_cast<const float*>(x),
                                        static_cast<const __nv_bfloat16*>(y),
                                        c, live);
  }
  return (int)cudaGetLastError();
}

// form 0 (x = A, y = B) or 1 (x = P, y = V) at head dim D; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a D
// outside {32, 64, 128}
extern "C" int bcfl_sm90_check(int form, int D, const void* x, const void* y,
                               float* c, int live) {
  switch (D) {
    case 32: return run<32>(form, x, y, c, live);
    case 64: return run<64>(form, x, y, c, live);
    case 128: return run<128>(form, x, y, c, live);
  }
  return (int)cudaErrorInvalidValue;
}
