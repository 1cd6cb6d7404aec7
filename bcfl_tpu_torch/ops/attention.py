"""Dense attention: port of ``bcfl_tpu/ops/attention.py``.

Shapes keep the JAX layout ``[batch, heads, seq, head_dim]`` with an
additive bias (0 keep, -1e9 drop). The two products are plain large matrix
products and go to ``torch.matmul``; the softmax is taken in float32 as in
the reference. (Flash attention, the ``use_flash`` path, is not ported
yet.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e9  # large-negative instead of -inf keeps all-padding rows finite


def attention_bias_from_mask(mask: torch.Tensor,
                             dtype=torch.float32) -> torch.Tensor:
    """[batch, seq] 0/1 padding mask -> [batch, 1, 1, seq] additive bias."""
    keep = mask[:, None, None, :] > 0
    return torch.where(keep, 0.0, NEG_INF).to(dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d) + bias) V; scores in float32, the
    probabilities cast back to q's dtype for the second product."""
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    scores = scores / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores)
    probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-9)
    return torch.matmul(probs.to(q.dtype), v)
