"""Codec kernels: port of ``bcfl_tpu/ops/pallas_codec.py``.

Four ops, registered with :mod:`bcfl_tpu_torch.ops.registry`:

- ``int8_quantize`` — a sequence of grids in one call (the codec's round
  passes one grid per distinct chunk width): plain version
  :func:`int8_quantize_grids_ref` (:func:`int8_quantize_ref` per grid),
  CUDA kernel ``csrc/int8_quantize.cu``, one launch for all the grids
  (replaces ``pallas_codec.py::_int8_kernel``);
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
from typing import List, Optional, Sequence, Tuple

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


Grid = Tuple[torch.Tensor, torch.Tensor]


def int8_quantize_grids_ref(gs: Sequence[torch.Tensor],
                            us: Optional[Sequence[torch.Tensor]], *,
                            stochastic: bool) -> List[Grid]:
    """The ``int8_quantize`` op's plain version: :func:`int8_quantize_ref`
    on each grid (``us`` the matching uniforms, None when not
    stochastic)."""
    return [int8_quantize_ref(g, us[k] if stochastic else None,
                              stochastic=stochastic)
            for k, g in enumerate(gs)]


#: the most grids one launch takes (the C entry's table)
INT8_MAX_GRIDS = 16
_INT8_FN = []


def _int8_entry():
    """``bcfl_int8_quantize`` with its argument types set once."""
    if not _INT8_FN:
        fn = cuda_build.load(INT8_QUANTIZE.source).bcfl_int8_quantize
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = [ptrs, ptrs, ptrs, ptrs,
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _INT8_FN.append(fn)
    return _INT8_FN[0]


def _int8_cuda(gs: Sequence[torch.Tensor],
               us: Optional[Sequence[torch.Tensor]], *,
               stochastic: bool) -> List[Grid]:
    n = len(gs)
    if not 1 <= n <= INT8_MAX_GRIDS:
        raise ValueError(f"int8_quantize: 1 to {INT8_MAX_GRIDS} grids per "
                         f"call, got {n}")
    dev = gs[0].device
    for k, g in enumerate(gs):
        if (g.dim() != 3 or g.dtype != torch.float32
                or not g.is_contiguous() or g.device != dev):
            raise ValueError(f"int8_quantize: grid {k} must be a contiguous "
                             f"float32 [C, M, chunk] tensor on {dev}, got "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")
        if stochastic and (us is None or len(us) != n
                           or us[k].shape != g.shape
                           or us[k].dtype != torch.float32
                           or us[k].device != dev
                           or not us[k].is_contiguous()):
            raise ValueError("int8_quantize: stochastic rounding needs "
                             "contiguous float32 uniforms shaped like each "
                             "grid on its device")
    # two allocations for every grid's codes and scales; each grid's codes
    # start 16-byte aligned (the 256-wide rows are stored 8 bytes at a time)
    starts = []
    nq = 0
    for g in gs:
        starts.append(nq)
        nq += -(-g.numel() // 16) * 16
    codes = torch.empty(nq, dtype=torch.int8, device=dev)
    scales = torch.empty(sum(g.shape[0] * g.shape[1] for g in gs),
                         dtype=torch.float32, device=dev)
    out, cs = [], 0
    for g, cq in zip(gs, starts):
        ns = g.shape[0] * g.shape[1]
        out.append((codes[cq:cq + g.numel()].view(g.shape),
                    scales[cs:cs + ns].view(g.shape[:2])))
        cs += ns
    vp = ctypes.c_void_p * n
    args = (vp(*(g.data_ptr() for g in gs)),
            vp(*(u.data_ptr() for u in us)) if stochastic else None,
            vp(*(q.data_ptr() for q, _ in out)),
            vp(*(s.data_ptr() for _, s in out)),
            (ctypes.c_longlong * n)(*(g.shape[0] * g.shape[1] for g in gs)),
            (ctypes.c_int * n)(*(g.shape[2] for g in gs)))
    fn = _int8_entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, n, int(stochastic), stream)
    cuda_build.check(err, "int8_quantize launch")
    registry.count_launch(INT8_QUANTIZE)
    return out


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


def _topk_cuda(x: torch.Tensor, *, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/topk_select.cu``: a radix select that reads each row twice
    (a histogram of the key's leading 12 bits, then a filter that keeps
    the keys above the threshold bin and collects the bin's candidates in
    index order), refined over the candidates only, then a stable LSD radix
    sort of the k survivors; a memset and 20 kernels per call. The scratch
    is one ``torch.empty`` buffer of ``bcfl_topk_scratch_words`` 32-bit
    words (histograms, per-row state and look-back flags, which the C entry
    zeroes; a candidate buffer of N entries per row, so a row whose keys
    all share one bin fits; two key/index sort buffers of k per row; the
    sort's per-tile digit counts)."""
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
    lib = cuda_build.load(TOPK_SELECT.source)
    words_fn = lib.bcfl_topk_scratch_words
    words_fn.argtypes = [ctypes.c_longlong] * 3
    words_fn.restype = ctypes.c_longlong
    words = words_fn(R, N, k)
    val = torch.empty((R, k), dtype=torch.float32, device=dev)
    idx = torch.empty((R, k), dtype=torch.int32, device=dev)
    work = torch.empty((words,), dtype=torch.int32, device=dev)
    fn = lib.bcfl_topk_select
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), val.data_ptr(), idx.data_ptr(), R, N, k,
                 work.data_ptr(), words, stream)
    cuda_build.check(err, "topk_select launch")
    registry.count_launch(TOPK_SELECT)
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
    name="int8_quantize", torch=int8_quantize_grids_ref, cuda=_int8_cuda,
    bench_shapes=(
        {"label": "bert-attn-768x768", "C": 8, "N": 589824, "chunk": 256},
        {"label": "bert-mlp-768x3072", "C": 8, "N": 2359296, "chunk": 256},
        {"label": "bert-vec-768", "C": 8, "N": 768, "chunk": 256},
        {"label": "lora-r2-1536", "C": 8, "N": 1536, "chunk": 256},
        {"label": "lora-r4-3072", "C": 8, "N": 3072, "chunk": 256},
        {"label": "lora-r8-6144", "C": 8, "N": 6144, "chunk": 256},
    ),
    replaces="bcfl_tpu/ops/pallas_codec.py:75 (_int8_kernel)",
    source="int8_quantize"))

TOPK_SELECT = registry.register_op(registry.KernelOp(
    name="topk_select", torch=topk_select_ref, cuda=_topk_cuda,
    bench_shapes=(
        {"label": "bert-attn-768x768", "R": 8, "N": 589824},
        {"label": "bert-vec-768", "R": 96, "N": 768},
        {"label": "lora-r2-1536", "R": 96, "N": 1536},
        {"label": "lora-r4-3072", "R": 96, "N": 3072},
        {"label": "lora-r8-6144", "R": 96, "N": 6144},
    ),
    replaces="bcfl_tpu/ops/pallas_codec.py:136 (_topk_kernel)",
    source="topk_select"))

INT8_DEQUANT = registry.register_op(registry.KernelOp(
    name="int8_dequant", torch=int8_dequant))

TOPK_SCATTER = registry.register_op(registry.KernelOp(
    name="topk_scatter", torch=topk_scatter))
