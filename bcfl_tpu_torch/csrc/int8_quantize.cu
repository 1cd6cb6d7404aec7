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
// Bound: bytes. The kernel reads g (4 B/elt) and u (4 B/elt when
// stochastic) once from device memory and writes q (1 B/elt) plus one f32
// scale per chunk, against a handful of flops per element, far below the
// card's ~295 flop/byte ridge. Design: one warp per chunk row; each lane
// strides over the row (coalesced), a shuffle reduction gives the row's
// absmax, and the second pass over the row re-reads g from L1/L2 rather than
// device memory. No shared memory, no atomics.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void int8_quantize_kernel(const float* __restrict__ g,
                                     const float* __restrict__ u,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scale,
                                     long long rows, int chunk,
                                     int stochastic) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = row * (long long)chunk;
  float m = 0.0f;
  for (int j = lane; j < chunk; j += 32) m = fmaxf(m, fabsf(g[base + j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = __fdiv_rn(m, 127.0f);
  const float d = fmaxf(s, 1e-30f);
  for (int j = lane; j < chunk; j += 32) {
    float z = __fdiv_rn(g[base + j], d);
    z = stochastic ? floorf(__fadd_rn(z, u[base + j])) : rintf(z);
    z = fminf(fmaxf(z, -127.0f), 127.0f);
    q[base + j] = (int8_t)(int)z;
  }
  if (lane == 0) scale[row] = s;
}

}  // namespace

extern "C" int bcfl_int8_quantize(const float* g, const float* u, int8_t* q,
                                  float* scale, long long rows, int chunk,
                                  int stochastic, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  int8_quantize_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(g, u, q, scale, rows, chunk,
                                                 stochastic);
  return (int)cudaGetLastError();
}
