"""Codec kernels: port of ``bcfl_tpu/ops/pallas_codec.py``.

Four ops, registered with :mod:`bcfl_tpu_torch.ops.registry`:

- ``int8_quantize`` — plain version :func:`int8_quantize_ref`, CUDA kernel
  ``csrc/int8_quantize.cu`` (replaces ``pallas_codec.py::_int8_kernel``);
- ``topk_select`` — plain version :func:`topk_select_ref`, CUDA kernel
  ``csrc/topk_select.cu`` (replaces ``pallas_codec.py::_topk_kernel``);
- ``int8_dequant`` / ``topk_scatter`` — plain PyTorch on every device
  (XLA-only in the JAX package too).

Parity is **bit-identical** for all four: codes, scales, values and
indices equal their plain versions bit for bit, and the plain versions
equal eager JAX (``_int8_quantize_xla``, ``_topk_select_xla``) on the CPU.
The CUDA wrappers check device, dtype, shape and contiguity, allocate every
output and scratch buffer with ``torch`` on the tensor's device, launch on
the current stream, raise on a non-zero ``cudaGetLastError()``, and add
one to the op's ``launches`` per launch. ``triton``/``nvcc`` are reached
only inside a wrapper call, never at import.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from bcfl_tpu_torch.ops import cuda_build, registry

# ------------------------------------------------------ int8 chunk quantize


def int8_quantize_ref(g: torch.Tensor, u: Optional[torch.Tensor], *,
                      stochastic: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """[C, M, chunk] f32 grid (+ uniforms) -> (q int8 [C, M, chunk],
    scale f32 [C, M]), in ``_int8_quantize_xla``'s op order: the /127 comes
    BEFORE the 1e-30 floor; round half to even when not stochastic.

    The divisor 127 is a tensor on g's device, not a Python number: on a
    CUDA tensor PyTorch turns division by a host scalar into a multiply by
    its reciprocal, which can differ from IEEE division by one ULP."""
    amax = g.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0)
    z = g / torch.clamp(scale, min=1e-30)[..., None]
    z = torch.floor(z + u) if stochastic else torch.round(z)
    q = torch.clamp(z, -127.0, 127.0).to(torch.int8)
    return q, scale


def _int8_cuda(g: torch.Tensor, u: Optional[torch.Tensor], *,
               stochastic: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if g.dim() != 3 or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"int8_quantize: g must be a contiguous float32 "
                         f"[C, M, chunk] tensor, got {g.dtype} "
                         f"{tuple(g.shape)}")
    if stochastic:
        if (u is None or u.shape != g.shape or u.dtype != torch.float32
                or u.device != g.device or not u.is_contiguous()):
            raise ValueError("int8_quantize: stochastic rounding needs "
                             "contiguous float32 uniforms shaped like g on "
                             "g's device")
    C, M, chunk = g.shape
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    scale = torch.empty((C, M), dtype=torch.float32, device=g.device)
    lib = cuda_build.load("int8_quantize")
    fn = lib.bcfl_int8_quantize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), u.data_ptr() if stochastic else None,
                 q.data_ptr(), scale.data_ptr(), C * M, chunk,
                 int(stochastic), stream)
    cuda_build.check(err, "int8_quantize launch")
    INT8_QUANTIZE.launches += 1
    return q, scale


# -------------------------------------------------------- top-k magnitude


def topk_select_ref(x: torch.Tensor, *, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, N] f32 -> (val f32 [R, k], idx int32 [R, k]) by |x|, in
    ``lax.top_k`` order: a STABLE descending sort of |x| puts equal
    magnitudes lower index first; values are gathered from x, so -0.0
    stays -0.0."""
    _, order = torch.sort(x.abs(), dim=1, descending=True, stable=True)
    idx = order[:, :k]
    return torch.gather(x, 1, idx), idx.to(torch.int32)


#: elements of one row handled by one block of the select/compact passes
TOPK_SEG = 4096


def _topk_cuda(x: torch.Tensor, *, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"topk_select: x must be a contiguous float32 "
                         f"[R, N] tensor, got {x.dtype} {tuple(x.shape)}")
    R, N = x.shape
    if not 1 <= k <= N:
        raise ValueError(f"topk_select: need 1 <= k <= N, got k={k} N={N}")
    if N >= 2 ** 31 or R >= 65536:
        raise ValueError(f"topk_select: rows {R} (< 65536) or width {N} "
                         f"(< 2**31) out of range")
    dev = x.device
    kpad = max(2, 1 << (k - 1).bit_length())
    nblk = -(-N // TOPK_SEG)
    val = torch.empty((R, k), dtype=torch.float32, device=dev)
    idx = torch.empty((R, k), dtype=torch.int32, device=dev)
    hist = torch.zeros((R, 256), dtype=torch.int32, device=dev)
    state = torch.zeros((R, 4), dtype=torch.int32, device=dev)
    state[:, 1] = k
    tiecnt = torch.empty((R, nblk), dtype=torch.int32, device=dev)
    buf = torch.full((R, kpad), -1, dtype=torch.int64, device=dev)
    lib = cuda_build.load("topk_select")
    fn = lib.bcfl_topk_select
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), val.data_ptr(), idx.data_ptr(), R, N, k,
                 TOPK_SEG, hist.data_ptr(), state.data_ptr(),
                 tiecnt.data_ptr(), buf.data_ptr(), kpad, stream)
    cuda_build.check(err, "topk_select launch")
    TOPK_SELECT.launches += 1
    return val, idx


# ------------------------------------------------------------- decode ops


def int8_dequant(q: torch.Tensor, scale: torch.Tensor, *, n: int
                 ) -> torch.Tensor:
    """(q [C, M, chunk], scale [C, M]) -> [C, n] f32, padding stripped."""
    y = q.to(torch.float32) * scale[..., None]
    return y.reshape(q.shape[0], -1)[:, :n]


def topk_scatter(val: torch.Tensor, idx: torch.Tensor, *, n: int
                 ) -> torch.Tensor:
    """(val [C, k], idx [C, k]) -> dense [C, n] f32 (scatter by index)."""
    out = torch.zeros((val.shape[0], n), dtype=torch.float32,
                      device=val.device)
    return out.scatter_(1, idx.long(), val)


# ------------------------------------------------------------ registration

# bench_shapes: the shapes the codec is paid at (copied from pallas_codec
# INT8_BENCH_SHAPES / TOPK_BENCH_SHAPES): BERT-base leaf widths and the
# LoRA rank-2/4/8 adapter widths, C=8 clients per row

INT8_QUANTIZE = registry.register_op(registry.KernelOp(
    name="int8_quantize", torch=int8_quantize_ref, cuda=_int8_cuda,
    bench_shapes=(
        {"label": "bert-attn-768x768", "C": 8, "N": 589824, "chunk": 256},
        {"label": "bert-mlp-768x3072", "C": 8, "N": 2359296, "chunk": 256},
        {"label": "bert-vec-768", "C": 8, "N": 768, "chunk": 256},
        {"label": "lora-r2-1536", "C": 8, "N": 1536, "chunk": 256},
        {"label": "lora-r4-3072", "C": 8, "N": 3072, "chunk": 256},
        {"label": "lora-r8-6144", "C": 8, "N": 6144, "chunk": 256},
    ),
    replaces="bcfl_tpu/ops/pallas_codec.py:75 (_int8_kernel)"))

TOPK_SELECT = registry.register_op(registry.KernelOp(
    name="topk_select", torch=topk_select_ref, cuda=_topk_cuda,
    bench_shapes=(
        {"label": "bert-attn-768x768", "R": 8, "N": 589824},
        {"label": "bert-vec-768", "R": 96, "N": 768},
        {"label": "lora-r2-1536", "R": 96, "N": 1536},
        {"label": "lora-r4-3072", "R": 96, "N": 3072},
        {"label": "lora-r8-6144", "R": 96, "N": 6144},
    ),
    replaces="bcfl_tpu/ops/pallas_codec.py:136 (_topk_kernel)"))

INT8_DEQUANT = registry.register_op(registry.KernelOp(
    name="int8_dequant", torch=int8_dequant))

TOPK_SCATTER = registry.register_op(registry.KernelOp(
    name="topk_scatter", torch=topk_scatter))

#: the kernel sources under csrc/ (cuda_build.build_all)
KERNEL_SOURCES = ("int8_quantize", "topk_select")
