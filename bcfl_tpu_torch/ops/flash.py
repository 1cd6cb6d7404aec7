"""Blockwise (flash) attention: port of ``bcfl_tpu/ops/flash.py``.

- :func:`flash_attention_blockwise` — plain port of
  ``flash_attention_xla``: an online-softmax scan over KV blocks with the
  key-side bias kept ``[B, Sk]``, a dense-bias branch, and causal suffix
  alignment. It is the CPU oracle of the tests and runs nowhere on the
  card.
- :func:`flash_attention` — the model's entry:
  :class:`~bcfl_tpu_torch.ops.flash_kernels.FlashAttentionFn`, i.e. the
  hand-written kernels on a CUDA tensor and their plain versions on a CPU
  tensor. The JAX dispatcher's warn-once fallback to XLA is not ported: a
  bias that is not key-side, or a head dim the kernels are not built for,
  raises ``ValueError`` before anything launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from bcfl_tpu_torch.ops.flash_kernels import (
    NEG_INF,
    SUPPORTED_HEAD_DIMS,
    FlashAttentionFn,
)

DEFAULT_BLOCK = 512


def flash_attention_blockwise(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              block_size: int = DEFAULT_BLOCK,
                              causal: bool = False) -> torch.Tensor:
    """``[B, H, S, D]`` x3 (+ bias broadcastable to ``[B, H, S, Sk]``) ->
    ``[B, H, S, D]``: the FlashAttention recurrence over KV blocks of
    ``block_size`` (one block when Sk does not tile evenly)."""
    B, H, S, D = q.shape
    Sk = k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    nb = max(Sk // block_size, 1)
    bs = Sk // nb
    if Sk % nb:
        nb, bs = 1, Sk
    key_side = bias is not None and (
        bias.dim() == 2
        or (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1))
    if bias is None:
        full = None
    elif key_side:
        kb = bias if bias.dim() == 2 else bias[:, 0, 0, :]
        full = torch.broadcast_to(kb, (B, Sk)).float()[:, None, None, :]
    else:
        full = torch.broadcast_to(bias, (B, H, S, Sk)).float()
    qf = q.float() * scale.to(q.device)
    qpos = (Sk - S) + torch.arange(S, device=q.device)[:, None]
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=q.device)
    for j in range(nb):
        blk = slice(j * bs, (j + 1) * bs)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k[:, :, blk].float())
        if full is not None:
            s = s + full[..., blk]
        if causal:
            kpos = j * bs + torch.arange(bs, device=q.device)[None, :]
            s = torch.where(kpos > qpos, NEG_INF, s)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         v[:, :, blk].float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-9)).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """``[B, H, S, D]`` x3 with a key-side bias (``[B, Sk]`` or
    ``[B, 1, 1, Sk]``) -> ``[B, H, S, D]``, differentiable in q, k, v and
    the bias."""
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {q.shape[-1]} is not "
                         f"supported (one of {SUPPORTED_HEAD_DIMS})")
    return FlashAttentionFn.apply(q, k, v, bias, causal)
