"""Llama-family decoder (RMSNorm, RoPE, SwiGLU, GQA): port of
``bcfl_tpu/models/llama.py`` (``LlamaConfig``, ``RMSNorm``, ``rope``,
``LlamaAttention``, ``LlamaMLP``, ``LlamaLayer``, ``causal_bias``,
``LlamaModel``, ``LlamaClassifier``, ``LlamaLM``, ``LORA_TARGETS``).

Numerically the flax model:

- bf16 compute over f32 parameters; every projection is a bias-free dense
  layer whose input and weight are cast to the compute dtype
  (:func:`bcfl_tpu_torch.models.bert.dense`);
- RMSNorm takes the mean of squares in float32 and multiplies by
  ``1 / sqrt(var + eps)`` (the flax module's ``reciprocal(sqrt(...))``,
  not ``rsqrt``, which rounds differently), then scales and casts back;
- RoPE rotates INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])`` in
  float32 and restacks them on the last axis (the JAX layout, not HF's
  ``rotate_half``);
- grouped-query attention repeats each K/V head ``num_heads / kv_heads``
  times along the head axis before attention (``jnp.repeat``: head ``h``
  reads kv head ``h // rep``);
- attention is causal: from ``flash_min_seq`` tokens the flash kernels
  with ``causal=True`` and a ``[B, S]`` key bias of -1e30 on padding,
  below it dense attention with the ``[B, 1, S, S]`` :func:`causal_bias`;
- :class:`LlamaClassifier` pools the last non-pad token into a float32
  ``classifier`` without bias; :class:`LlamaLM`'s ``lm_head`` computes in
  float32;
- ``remat`` recomputes each layer in the backward (``nn.remat``); the
  model has no dropout, so there is no generator to rewind.

``attention_override`` swaps the attention op after the GQA repeat (the
causal ring of sequence parallelism, which needs no dense bias);
:func:`tp_specs` names the megatron split that
:mod:`bcfl_tpu_torch.parallel.tp_linear` applies: on a tensor-parallel base
each shard runs RoPE, the GQA repeat and attention (the flash kernels at
``num_heads / tp`` heads a launch) over its own contiguous head group.

Module names are the flax names, so :mod:`bcfl_tpu_torch.models.convert`
maps the trees by path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from bcfl_tpu_torch.ops.attention import dot_product_attention
from bcfl_tpu_torch.ops.flash import flash_attention
from bcfl_tpu_torch.parallel import tp_linear as tp
from bcfl_tpu_torch.parallel.tp_linear import dense

# lm_head is a LoRA target, not a fully trained head: on llama2-7b it holds
# 131 M parameters; the small classifier head trains in full
# (bcfl_tpu_torch.models.lora.HEAD_MODULES)
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                "gate_proj", "up_proj", "down_proj", "lm_head")
#: the masked-score value of the causal and key-padding biases
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None = MHA; < num_heads = GQA
    intermediate_size: int = 11008
    max_position: int = 4096
    num_labels: int = 2
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    use_flash: bool = True  # causal flash attention from flash_min_seq
    flash_min_seq: int = 512  # below this, dense attention
    # sequence parallelism hook: a callable (q, k, v, key_bias, causal=...)
    # -> out replacing the attention op, e.g. ring attention over a 'seq'
    # mesh axis (bcfl_tpu_torch.parallel.sp.ring_config)
    attention_override: Optional[Callable] = None
    remat: bool = False
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def rms_norm(x: torch.Tensor, norm: nn.RMSNorm) -> torch.Tensor:
    """The flax ``RMSNorm``: float32 mean of squares, times the reciprocal
    of ``sqrt(var + eps)``, times the float32 scale, cast back to x's
    dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(var + norm.eps))
    return (y * norm.weight.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding over ``[B, H, S, D]`` with positions ``[B, S]`` or
    ``[S]``, rotating interleaved pairs in float32."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, None, :, :]  # [B, 1, S, D/2]
    sin = torch.sin(angles)[:, None, :, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def causal_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Causal + key-padding additive bias ``[B, 1, S, S]`` from a
    ``[B, S]`` mask: 0 where query ``i`` may see key ``j <= i`` that is
    not padding, -1e30 elsewhere."""
    S = mask.shape[-1]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=mask.device))
    ok = causal[None, :, :] & (mask[:, None, :] > 0)
    return torch.where(ok, 0.0, NEG_INF).to(dtype)[:, None, :, :]


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.num_heads * hd,
                                bias=False)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.kv_heads * hd,
                                bias=False)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.kv_heads * hd,
                                bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * hd, cfg.hidden_size,
                                bias=False)

    def forward(self, x, bias, key_bias, positions):
        """``bias`` is the dense ``[B, 1, S, S]`` bias (None on the flash
        and override paths); ``key_bias`` ``[B, S]`` is their padding
        bias. On a tensor-parallel base each of the ``n`` shards attends
        over its own ``num_heads / n`` heads and ``kv_heads / n`` kv heads
        (tp_linear)."""
        c = self.cfg
        B, S, _ = x.shape
        hd = c.head_dim
        n = tp.ways(self.q_proj)
        H, KV = c.num_heads // n, c.kv_heads // n
        xs = tp.replicate(x, self.q_proj)
        parts = []
        for i in range(n):
            dev = tp.device_of(self.q_proj, i, x.device)
            pos = positions.to(dev)

            def heads(layer, h):  # [B, S, h*hd] -> [B, h, S, hd]
                return tp.column(xs[i], layer, i, n, c.dtype).view(
                    B, S, h, hd).transpose(1, 2)

            q = rope(heads(self.q_proj, H), pos, c.rope_theta)
            k = rope(heads(self.k_proj, KV), pos, c.rope_theta)
            v = heads(self.v_proj, KV)
            if KV != H:  # GQA: head h reads kv head h // rep
                k = k.repeat_interleave(H // KV, dim=1)
                v = v.repeat_interleave(H // KV, dim=1)
            if c.attention_override is not None:
                out = c.attention_override(q, k, v, key_bias.to(dev),
                                           causal=True)
            elif bias is None:
                out = flash_attention(q, k, v, key_bias.to(dev), causal=True)
            else:
                out = dot_product_attention(q, k, v, bias.to(dev))
            parts.append(out.transpose(1, 2).reshape(B, S, H * hd))
        return tp.row(parts, self.o_proj, c.dtype)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                   bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                 bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   bias=False)

    def forward(self, x):
        dt = self.cfg.dtype
        n = tp.ways(self.gate_proj)
        xs = tp.replicate(x, self.gate_proj)
        parts = []
        for i in range(n):
            gate = torch.nn.functional.silu(
                tp.column(xs[i], self.gate_proj, i, n, dt))
            parts.append(gate * tp.column(xs[i], self.up_proj, i, n, dt))
        return tp.row(parts, self.down_proj, dt)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_norm = nn.RMSNorm(cfg.hidden_size, eps=cfg.rms_eps)
        self.attention = LlamaAttention(cfg)
        self.post_attention_norm = nn.RMSNorm(cfg.hidden_size,
                                              eps=cfg.rms_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, bias, key_bias, positions):
        h = rms_norm(x, self.input_norm)
        x = x + self.attention(h, bias, key_bias, positions)
        return x + self.mlp(rms_norm(x, self.post_attention_norm))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", LlamaLayer(cfg))
        self.final_norm = nn.RMSNorm(cfg.hidden_size, eps=cfg.rms_eps)

    def forward(self, ids, mask):
        c = self.cfg
        S = ids.shape[1]
        x = self.embed(ids).to(c.dtype)
        # flash and override (ring) paths: the causal triangle and the
        # padding are applied blockwise; the dense [B, 1, S, S] bias exists
        # only below flash_min_seq
        blockwise = ((c.use_flash and S >= c.flash_min_seq)
                     or c.attention_override is not None)
        bias = None if blockwise else causal_bias(mask)
        key_bias = torch.where(mask > 0, 0.0, NEG_INF).to(torch.float32)
        positions = torch.arange(S, device=ids.device)
        remat = c.remat and torch.is_grad_enabled()
        for i in range(c.num_layers):
            layer = getattr(self, f"layer_{i}")
            if remat:
                x = tp.checkpoint(layer, x, bias, key_bias, positions)
            else:
                x = layer(x, bias, key_bias, positions)
        return rms_norm(x, self.final_norm)


class LlamaClassifier(nn.Module):
    """Decoder + last-non-pad-token float32 classifier: the forward
    signature of :class:`bcfl_tpu_torch.models.bert.TextClassifier`,
    ``model(ids, mask) -> [B, num_labels]`` float32 logits."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels,
                                    bias=False)
        if cfg.param_dtype != torch.float32:
            self.to(cfg.param_dtype)

    def forward(self, ids, mask, type_ids=None, deterministic=True,
                generator=None):
        x = self.model(ids, mask)
        last = torch.clamp(mask.sum(dim=-1) - 1, min=0).long()
        pooled = x[torch.arange(x.shape[0], device=x.device), last]
        return dense(pooled, self.classifier, torch.float32)


class LlamaLM(nn.Module):
    """Decoder + float32 ``lm_head``: ``model(ids, mask) -> [B, S, vocab]``
    float32 logits."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        if cfg.param_dtype != torch.float32:
            self.to(cfg.param_dtype)

    def forward(self, ids, mask, type_ids=None, deterministic=True,
                generator=None):
        return dense(self.model(ids, mask), self.lm_head, torch.float32)


def tp_specs(params, axis: str = "tp"):
    """Megatron tensor parallelism: ``{flax path: the dimension of the
    torch tensor that the tp axis splits, or None}`` for the flax paths
    that key ``params``. Column-parallel q/k/v/gate/up split their
    ``[out, in]`` weight's outputs (heads, FFN width), dim 0; row-parallel
    o_proj/down split its input side, dim 1; everything else stays whole.
    The JAX package's ``PartitionSpec`` tree names the flax dimension
    instead (``axis`` is its mesh axis; the port has the one ``tp``
    axis)."""
    COL = {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"}
    ROW = {"o_proj", "down_proj"}

    def spec(path):
        names = path.split("/")
        mod = names[-2] if len(names) >= 2 else ""
        return 0 if mod in COL else 1 if mod in ROW else None

    return {path: spec(path) for path in params}
