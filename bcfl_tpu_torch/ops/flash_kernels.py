"""Flash-attention kernels: port of ``bcfl_tpu/ops/pallas_flash.py``.

Three ops, registered with :mod:`bcfl_tpu_torch.ops.registry`, and the
autograd function that joins them (the JAX ``custom_vjp``):

- ``flash_fwd`` — plain version :func:`flash_fwd_ref`, CUDA kernel
  ``csrc/flash_fwd.cu`` (replaces ``pallas_flash.py::_fwd_kernel``):
  ``(q, k, v, key_bias, causal) -> (out, lse [B, H, Sq])``;
- ``flash_bwd_dkv`` — :func:`flash_bwd_dkv_ref`, ``csrc/flash_bwd_dkv.cu``
  (replaces ``_bwd_dkv_kernel``): ``-> (dk, dv, db_h [B, H, Sk])``;
- ``flash_bwd_dq`` — :func:`flash_bwd_dq_ref`, ``csrc/flash_bwd_dq.cu``
  (replaces ``_bwd_dq_kernel``): ``-> dq``;
- :class:`FlashAttentionFn` — forward through ``flash_fwd``, backward
  through ``flash_bwd_dkv`` then ``flash_bwd_dq``.

Shapes keep the JAX layout: q ``[B, H, Sq, D]``, k/v ``[B, H, Sk, D]``,
bf16, fp16 or float32 (the same for all three), and an additive key-side
bias ``[B, Sk]`` float32 (the encoders' -1e9 and Llama's -1e30 overflow
fp16, so the bias never takes the inputs' dtype). Scores are
``q k^T / sqrt(D) + bias``; with ``causal`` query ``i`` sits at key
position ``Sk - Sq + i`` (suffix alignment) and sees keys up to it. A masked score is ``NEG_INF`` and its
probability is zeroed after the exp. The casts of the Pallas kernels are
kept: ``p`` is cast to ``v``'s dtype before ``p v`` and to ``dO``'s for
``dv``, ``ds`` to ``q``'s for ``dk`` and to ``k``'s for ``dq``; every
product accumulates in float32.

The plain versions repeat that arithmetic over the whole ``[Sq, Sk]``
score block; the kernels walk it tile by tile, so the two agree to the
float32 rounding of another summation order (and, in bf16 or fp16, to a
rounding of a probability that lands on the other side of a tie).
Parity is therefore a tolerance per dtype, :func:`parity_for`: ``parity``
on each op is the bf16 contract of ``tests/test_pallas_kernels.py``,
:data:`FP16_PARITY` and :data:`F32_PARITY` the fp16 and float32 ones; in
bf16 and fp16, dk and dq also take :func:`ds_slack`, nonzero only on rows
whose keys are all padded.
Each dtype launches its own kernel instance (bf16 and fp16 their
tensor-core ``wgmma`` instances, float32 its FMA one); no dtype is cast to
another's. The CUDA wrappers check shapes, dtype, head dim, a unit
stride in D and 16-byte aligned rows, allocate their outputs with
``torch.empty``, launch on the current stream, raise on a non-zero
``cudaGetLastError()`` and add one to their op's ``launches`` (and to
``launches_by[dtype]``). They read q, k, v, out and dO through their
(b, h, s) strides, so a ``view(B, S, H, D).transpose(1, 2)`` needs no
copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from bcfl_tpu_torch.ops import cuda_build, registry

NEG_INF = -1e30  # large-negative, not -inf: exp underflows to 0 without NaNs
#: head dims the CUDA kernels are built for (template instances)
SUPPORTED_HEAD_DIMS = (32, 64, 128)
#: float32 inputs: both sides compute in float32 and differ only in the
#: order of sums of up to Sk (or Sq) products, a few float32 roundings of
#: the largest partial sum; 1e-4 absolute and relative covers sums of 2048
#: terms of unit-variance inputs with room to spare
F32_PARITY = "allclose:atol=1e-4,rtol=1e-4"
#: bf16 inputs: the JAX contract (tests/test_pallas_kernels.py, 2e-2
#: absolute) plus one bf16 ulp of the value (2**-7 relative): the outputs
#: are stored in bf16, so two float32 sums that differ in their last bits
#: can round one ulp apart, and past magnitude 4 one ulp exceeds 2e-2.
#: dk and dq add :func:`ds_slack`, zero on every row that sees a live key.
#: Its derivation: both sides round ds to the inputs' dtype before
#: ``dq = scale ds k`` and ``dk = scale ds^T q``, from float32 values of
#: ds that differ by the rounding of another summation order. Where the
#: two float32 values straddle a rounding boundary of ds they round one
#: ulp apart, and that flip moves dq[i] by ulp(ds[i, j]) |k[j]| scale. On
#: a live row p sums to 1 and ds is small, so a flip moves dq by far less
#: than 2e-2. On a row whose keys are all padded, every score is the
#: padding bias (-1e9, float32 ulp 64; Llama's -1e30), s - lse rounds to
#: 0 and p = 1 on every key, so ds is as large as dO . v (up to ~50) and
#: one flip moves dq by up to 0.05 at D = 128 (``scripts/flash_contract.py``
#: measured 0.0394, 0.0256 and 0.0486 over 20 draws). Any entry of such a
#: row may flip, each by at most one ulp of the row's largest |ds|, so
#: there dq may move by ulp(max_j |ds[i, j]|) sum_j |k[j]| scale, and dk[j]
#: by ulp(max_i |ds[i, j]|) sum_i |q[i]| scale over the all-padded rows i.
BF16_PARITY = "allclose:atol=2e-2,rtol=7.8125e-3"
#: fp16 inputs: one fp16 ulp of the value (2**-10) for outputs stored in
#: fp16 that round one ulp apart, and an absolute term for the rounding of
#: ds to fp16. Scaled from bf16's 2e-2 by fp16's 3 more bits that term
#: would be 2.5e-3, which holds wherever p is small; on a row whose keys
#: are all padded the flips of ds move a row of dq or dk by 2**-6 |k|
#: scale (up to 7.8e-3 for |k| <= 4 at D = 64; 60 draws on an H100
#: needed at most 6.7e-3), so the term is 1e-2. dk and dq add
#: :func:`ds_slack` as bf16 does, with fp16's ulp: the same derivation.
FP16_PARITY = "allclose:atol=1e-2,rtol=9.765625e-4"
#: a row whose log-sum-exp is at or below this sees only padded keys (a
#: live key's score is O(10)): the rows :func:`ds_slack` covers
PADDED_LSE = -1e8
#: mantissa bits of the 16-bit dtypes, for :func:`ulp`
_MANTISSA = {torch.bfloat16: 7, torch.float16: 10}

#: the C entries' dtype codes (``DtypeCode`` in ``csrc/flash_common.cuh``)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPES = tuple(_DTYPE_CODES)
_PARITY = {torch.bfloat16: BF16_PARITY, torch.float16: FP16_PARITY,
           torch.float32: F32_PARITY}


def parity_for(dtype: torch.dtype) -> str:
    """The contract that holds a kernel to its plain version on inputs of
    ``dtype``."""
    return _PARITY[dtype]


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ``dtype`` ulp at ``|x|``, in float32: ``2**(e - mantissa)`` for
    ``|x|`` in ``[2**e, 2**(e+1))``, the smallest normal's below it."""
    e = torch.floor(torch.log2(
        x.abs().float().clamp_min(torch.finfo(dtype).tiny)))
    return torch.exp2(e - _MANTISSA[dtype])


def ds_slack(q, k, v, key_bias, out, do, lse, causal: bool) -> tuple:
    """The per-element term the 16-bit contract adds to the backward
    outputs, lined up with ``(dk, dv, db_h, dq)``: ``(dk_slack, None,
    None, dq_slack)`` (derivation at :data:`BF16_PARITY`), from the plain
    version's float32 ds. Rows whose ``lse`` is above :data:`PADDED_LSE`
    see a live key and add exactly 0; an all-padded row adds one ulp of
    its largest ``|ds|`` times ``sum_j |k[j]|`` times the scale to dq, and
    each key adds one ulp of its largest ``|ds|`` over those rows times
    their ``sum_i |q[i]|`` times the scale to dk. All None for float32
    inputs, whose ds is never rounded."""
    if q.dtype not in _MANTISSA:
        return None, None, None, None
    padded = (lse <= PADDED_LSE).float()[..., None]  # [B, H, Sq, 1]
    _, ds = _probs_and_ds(q, k, v, key_bias, out, do, lse, causal)
    ads = ds.abs() * padded
    del ds
    scale = _scale(q.shape[3])
    dq = (ulp(ads.amax(dim=-1, keepdim=True), q.dtype) * padded
          * k.float().abs().sum(dim=-2, keepdim=True) * scale)
    dk = (ulp(ads.amax(dim=-2)[..., None], q.dtype)
          * (q.float().abs() * padded).sum(dim=-2, keepdim=True) * scale)
    return dk, None, None, dq


def _normalize_bias(bias: Optional[torch.Tensor], B: int, Sk: int,
                    device) -> torch.Tensor:
    """``None`` / ``[B, Sk]`` / ``[B, 1, 1, Sk]`` -> ``[B, Sk]`` float32
    (``pallas_flash._normalize_bias``); any other shape raises."""
    if bias is None:
        return torch.zeros((B, Sk), dtype=torch.float32, device=device)
    if bias.dim() == 4:
        if bias.shape[1] != 1 or bias.shape[2] != 1:
            raise ValueError("flash attention supports key-side bias only "
                             f"([B,1,1,Sk]); got {tuple(bias.shape)}")
        bias = bias[:, 0, 0, :]
    if tuple(bias.shape) != (B, Sk):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(B, Sk)}")
    return bias.to(torch.float32).contiguous()


def _scale(D: int) -> float:
    return 1.0 / (D ** 0.5)


# ------------------------------------------------------------ plain versions


def _scores(q, k, key_bias, causal):
    """Scores ``q k^T * scale + bias`` in float32 and the causal dead mask
    (``None`` when nothing is masked)."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(D)
    s = s + key_bias[:, None, None, :]
    dead = None
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        dead = torch.arange(Sk, device=q.device)[None, :] > qpos
    return s, dead


def flash_fwd_ref(q, k, v, key_bias, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fwd_kernel`` over the whole score block:
    ``(out like q, lse [B, H, Sq] f32)``."""
    s, dead = _scores(q, k, key_bias, causal)
    if dead is not None:
        s = s.masked_fill(dead, NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    if dead is not None:
        p = p.masked_fill(dead, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / torch.clamp(l, min=1e-9)).to(q.dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-30))).squeeze(-1)
    return out, lse


def _probs_and_ds(q, k, v, key_bias, out, do, lse, causal):
    """``p = exp(s - lse)`` and ``ds = p (dO v^T - rowsum(dO o))``, both
    zero where masked."""
    s, dead = _scores(q, k, key_bias, causal)
    p = torch.exp(s - lse[..., None])
    dsum = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - dsum)
    if dead is not None:
        p = p.masked_fill(dead, 0.0)
        ds = ds.masked_fill(dead, 0.0)
    return p, ds


def flash_bwd_dkv_ref(q, k, v, key_bias, out, do, lse, causal: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_bwd_dkv_kernel``: ``(dk like k, dv like v, db_h [B, H, Sk] f32)``
    with ``db_h`` the per-head key-bias gradient (summed over queries)."""
    p, ds = _probs_and_ds(q, k, v, key_bias, out, do, lse, causal)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * _scale(q.shape[3])
    return dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=-2)


def flash_bwd_dq_ref(q, k, v, key_bias, out, do, lse, causal: bool
                     ) -> torch.Tensor:
    """``_bwd_dq_kernel``: ``dq like q``."""
    _, ds = _probs_and_ds(q, k, v, key_bias, out, do, lse, causal)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * _scale(q.shape[3])
    return dq.to(q.dtype)


# ------------------------------------------------------------ CUDA wrappers


def _check(name: str, q, k, v, key_bias, out=None, do=None, lse=None):
    """Raise ``ValueError`` on anything the kernels do not take: shapes,
    dtype, head dim and D stride first (so a bad call fails before any
    build), then device and alignment."""
    named = [("q", q), ("k", k), ("v", v)]
    named += [(n, t) for n, t in (("out", out), ("do", do)) if t is not None]
    for n, t in named:
        if t.dim() != 4:
            raise ValueError(f"{name}: {n} must be [B, H, S, D], got "
                             f"{tuple(t.shape)}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for _, t in named):
        raise ValueError(f"{name}: q, k, v (and out, do) must share one "
                         f"dtype of bf16/fp16/float32, got "
                         f"{[str(t.dtype) for _, t in named]}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if tuple(k.shape) != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    for n, t in named[3:]:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {n} shape {tuple(t.shape)} != q "
                             f"{tuple(q.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} is not supported (one of "
                         f"{SUPPORTED_HEAD_DIMS})")
    for n, t in named:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {n} needs a unit stride in D, got "
                             f"strides {t.stride()}")
    if (tuple(key_bias.shape) != (B, Sk) or key_bias.dtype != torch.float32
            or not key_bias.is_contiguous()):
        raise ValueError(f"{name}: key_bias must be a contiguous float32 "
                         f"[B, Sk] = {[B, Sk]} tensor, got {key_bias.dtype} "
                         f"{tuple(key_bias.shape)}")
    if lse is not None and (tuple(lse.shape) != (B, H, Sq)
                            or lse.dtype != torch.float32
                            or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be a contiguous float32 "
                         f"[B, H, Sq] tensor, got {tuple(lse.shape)}")
    tensors = [t for _, t in named] + [key_bias] + (
        [] if lse is None else [lse])
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    for n, t in named:
        # each thread loads 8 consecutive elements of a row as 16-byte words
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"{name}: {n} rows must start on 16-byte "
                             f"boundaries, got strides {t.stride()}")
    if B * H > 65535:
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid's 65535")


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _entry(op: registry.KernelOp, n_ptrs: int):
    """The C entry ``bcfl_<source>``: ``n_ptrs`` device pointers, then
    B, H, Sq, Sk, D, the dtype code, the (b, h, s) strides, scale, causal
    and the stream."""
    fn = getattr(cuda_build.load(op.source), f"bcfl_{op.source}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(op: registry.KernelOp, ptrs, q, Sk, strides, causal) -> None:
    B, H, Sq, D = q.shape
    fn = _entry(op, len(ptrs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype], strides,
                 _scale(D), int(causal), stream)
    cuda_build.check(err, f"{op.name} launch")
    op.launches += 1
    key = str(q.dtype).split(".")[-1]
    op.launches_by[key] = op.launches_by.get(key, 0) + 1


def _flash_fwd_cuda(q, k, v, key_bias, causal: bool):
    _check("flash_fwd", q, k, v, key_bias)
    B, H, Sq, D = q.shape
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch(FLASH_FWD, [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        key_bias.data_ptr(), out.data_ptr(), lse.data_ptr()],
            q, k.shape[2], _strides(q, k, v), causal)
    return out, lse


def _flash_bwd_dkv_cuda(q, k, v, key_bias, out, do, lse, causal: bool):
    _check("flash_bwd_dkv", q, k, v, key_bias, out, do, lse)
    B, H, Sk, D = k.shape
    dk = torch.empty((B, H, Sk, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, H, Sk, D), dtype=v.dtype, device=v.device)
    db_h = torch.empty((B, H, Sk), dtype=torch.float32, device=k.device)
    _launch(FLASH_BWD_DKV,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
             out.data_ptr(), do.data_ptr(), lse.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), db_h.data_ptr()],
            q, Sk, _strides(q, k, v, out, do), causal)
    return dk, dv, db_h


def _flash_bwd_dq_cuda(q, k, v, key_bias, out, do, lse, causal: bool):
    _check("flash_bwd_dq", q, k, v, key_bias, out, do, lse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(FLASH_BWD_DQ,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
             out.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr()],
            q, k.shape[2], _strides(q, k, v, out, do), causal)
    return dq


# ------------------------------------------------------------ registration

# bench_shapes: a copy of the JAX FLASH_ATTENTION.bench_shapes
# (bcfl_tpu/ops/flash.py), plus the main path's bert-base call at 32 x 512
FLASH_BENCH_SHAPES = (
    {"label": "bert-base-B4-S512", "B": 4, "H": 12, "S": 512, "D": 64},
    {"label": "llama-decode-B1-S2048", "B": 1, "H": 8, "S": 2048, "D": 64},
    {"label": "bert-base-B32-S512", "B": 32, "H": 12, "S": 512, "D": 64},
)

FLASH_FWD = registry.register_op(registry.KernelOp(
    name="flash_fwd", torch=flash_fwd_ref, cuda=_flash_fwd_cuda,
    parity=BF16_PARITY, bench_shapes=FLASH_BENCH_SHAPES,
    replaces="bcfl_tpu/ops/pallas_flash.py:78 (_fwd_kernel)",
    source="flash_fwd"))

FLASH_BWD_DKV = registry.register_op(registry.KernelOp(
    name="flash_bwd_dkv", torch=flash_bwd_dkv_ref, cuda=_flash_bwd_dkv_cuda,
    parity=BF16_PARITY, bench_shapes=FLASH_BENCH_SHAPES,
    replaces="bcfl_tpu/ops/pallas_flash.py:192 (_bwd_dkv_kernel)",
    source="flash_bwd_dkv"))

FLASH_BWD_DQ = registry.register_op(registry.KernelOp(
    name="flash_bwd_dq", torch=flash_bwd_dq_ref, cuda=_flash_bwd_dq_cuda,
    parity=BF16_PARITY, bench_shapes=FLASH_BENCH_SHAPES,
    replaces="bcfl_tpu/ops/pallas_flash.py:256 (_bwd_dq_kernel)",
    source="flash_bwd_dq"))


# ------------------------------------------------------------ autograd


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, bias, causal) -> out``: the JAX ``custom_vjp`` of
    ``pallas_flash.flash_attention``. The backward returns a bias
    gradient (``db_h`` summed over heads, in the bias's shape and dtype)
    only when autograd asks for one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        key_bias = _normalize_bias(bias, q.shape[0], k.shape[2], q.device)
        out, lse = FLASH_FWD(q, k, v, key_bias, causal)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.causal = causal
        ctx.bias_meta = None if bias is None else (bias.shape, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            # an expanded gradient (of a .sum(), stride 0) is made dense;
            # the model's incoming gradient has a unit stride and is read
            # in place
            do = do.contiguous()
        dk, dv, db_h = FLASH_BWD_DKV(q, k, v, key_bias, out, do, lse,
                                     ctx.causal)
        dq = FLASH_BWD_DQ(q, k, v, key_bias, out, do, lse, ctx.causal)
        db = None
        if ctx.needs_input_grad[3]:
            shape, dtype = ctx.bias_meta
            db = db_h.sum(dim=1).to(dtype).reshape(shape)
        return dq, dk, dv, db, None

