"""BERT/ALBERT encoder + classification head: port of
``bcfl_tpu/models/bert.py``.

One configurable ``nn.Module`` family, numerically the flax model:

- post-LayerNorm encoder layers, exact-erf GELU, LayerNorm eps 1e-12,
  a tanh pooler over [CLS], dropout 0.1;
- ALBERT = the same encoder with ``share_layers`` (one layer applied
  ``num_layers`` times) and factorized embeddings (``embedding_size``);
- bf16 compute over f32 params the way flax does it: every dense layer
  casts its input, weight and bias to the compute dtype; LayerNorm takes its
  statistics in float32 and casts back; the classifier stays float32;
- parameters held in ``param_dtype`` (float32, bfloat16 or float16), the
  embedding sum in that dtype, as flax's ``param_dtype``;
- ``remat``: each encoder layer is recomputed in the backward instead of
  storing its activations (``nn.remat(EncoderLayer)``), with its dropout
  masks replayed (:func:`checkpointed_layer`).

``attention_override`` swaps the attention op (ring attention, sequence
parallelism); :func:`tp_specs` names the megatron split of the
parameters, which :mod:`bcfl_tpu_torch.parallel.tp_linear` applies.

Weights are PyTorch-layout ``nn.Linear``/``nn.Embedding``/``nn.LayerNorm``
parameters whose module names are the flax names, so
:mod:`bcfl_tpu_torch.models.convert` maps between the two trees by path.
Dropout draws from an explicit ``torch.Generator`` passed to ``forward``
(the flax ``rngs={"dropout": key}``). With ``use_flash`` a sequence of at
least ``flash_min_seq`` tokens takes the flash-attention path
(:func:`bcfl_tpu_torch.ops.flash.flash_attention`, hand-written kernels on
the card) with the same ``[B, 1, 1, S]`` padding bias as dense attention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bcfl_tpu_torch.ops.attention import (
    attention_bias_from_mask,
    dot_product_attention,
)
from bcfl_tpu_torch.ops.flash import flash_attention
from bcfl_tpu_torch.parallel import tp_linear as tp
from bcfl_tpu_torch.parallel.tp_linear import dense


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 8192
    hidden_size: int = 128
    num_layers: int = 2
    num_heads: int = 2
    intermediate_size: int = 512
    max_position: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12
    share_layers: bool = False
    embedding_size: Optional[int] = None
    use_flash: bool = False  # flash attention for long sequences
    flash_min_seq: int = 512  # below this, dense attention is faster
    # sequence-parallelism hook: a callable (q, k, v, key_bias,
    # causal=False) -> out replacing the attention op, e.g. ring attention
    # over a 'seq' mesh axis (bcfl_tpu_torch.parallel.sp); padding rides
    # the [B, S] key bias
    attention_override: Optional[Callable] = None
    # recompute each layer's activations in the backward (less memory per
    # client for about a third more FLOPs)
    remat: bool = False
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype
               ) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: float32 statistics and affine (the
    scale and bias promoted), output in dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout``: keep with probability 1-rate, scale by 1/(1-rate)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a generator when not deterministic")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        self.query = nn.Linear(cfg.hidden_size, inner)
        self.key = nn.Linear(cfg.hidden_size, inner)
        self.value = nn.Linear(cfg.hidden_size, inner)
        self.out = nn.Linear(inner, cfg.hidden_size)

    def forward(self, x, bias, deterministic, generator):
        """``bias`` is the ``[B, 1, 1|S, S]`` attention bias, or the
        ``[B, S]`` key bias under ``attention_override``. On a
        tensor-parallel base each of the ``n`` shards attends over its own
        ``num_heads / n`` heads (tp_linear)."""
        c = self.cfg
        B, S, _ = x.shape
        n = tp.ways(self.query)
        H = c.num_heads // n
        xs = tp.replicate(x, self.query)
        parts = []
        for i in range(n):
            dev = tp.device_of(self.query, i, x.device)

            def heads(layer):  # [B, S, H*D] -> [B, H, S, D]
                return tp.column(xs[i], layer, i, n, c.dtype).view(
                    B, S, H, c.head_dim).transpose(1, 2)

            q, k, v = heads(self.query), heads(self.key), heads(self.value)
            b = bias.to(dev)
            if c.attention_override is not None:
                out = c.attention_override(q, k, v, b, causal=False)
            elif c.use_flash and S >= c.flash_min_seq:
                out = flash_attention(q, k, v, b)
            else:
                out = dot_product_attention(q, k, v, b)
            parts.append(out.transpose(1, 2).reshape(B, S, H * c.head_dim))
        out = tp.row(parts, self.out, c.dtype)
        return dropout(out, c.dropout_rate, deterministic, generator)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg)
        self.attention_norm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)
        self.mlp_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.mlp_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, bias, deterministic, generator):
        c = self.cfg
        a = self.attention(x, bias, deterministic, generator)
        x = layer_norm(x + a, self.attention_norm, c.dtype)
        n = tp.ways(self.mlp_in)
        xs = tp.replicate(x, self.mlp_in)
        h = tp.row([F.gelu(tp.column(xs[i], self.mlp_in, i, n, c.dtype),
                           approximate="none") for i in range(n)],
                   self.mlp_out, c.dtype)
        h = dropout(h, c.dropout_rate, deterministic, generator)
        return layer_norm(x + h, self.mlp_norm, c.dtype)


def checkpointed_layer(layer: nn.Module, x, bias, deterministic,
                       generator: Optional[torch.Generator]):
    """``layer(x, bias, deterministic, generator)`` under
    ``torch.utils.checkpoint`` (:func:`tp_linear.checkpoint`, the
    reentrant form): its activations are recomputed in the backward.
    ``checkpoint`` restores only the global RNG states, and dropout draws
    from the explicit ``generator``, which the rest of the forward has
    advanced by then: the recomputation rewinds
    the generator to where the layer started, so it draws the same masks,
    and puts it back afterwards, so later draws are the ones a run without
    remat makes."""
    start = (None if deterministic or generator is None
             else generator.get_state())
    calls = []

    def fn(x, bias):
        if not calls or start is None:
            calls.append(1)
            return layer(x, bias, deterministic, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return layer(x, bias, deterministic, generator)
        finally:
            generator.set_state(now)

    return tp.checkpoint(fn, x, bias)


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embedding_size or cfg.hidden_size
        self.word = nn.Embedding(cfg.vocab_size, e)
        self.position = nn.Embedding(cfg.max_position, e)
        # the flax name "type" is also the method nn.Module.type(), which
        # add_module refuses and attribute lookup would find first: the
        # submodule goes into _modules directly and is reached through it
        self._modules["type"] = nn.Embedding(cfg.type_vocab_size, e)
        self.norm = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        self.projection = (nn.Linear(e, cfg.hidden_size)
                           if e != cfg.hidden_size else None)

    def forward(self, ids, type_ids, deterministic, generator):
        c = self.cfg
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        # every position reads one of the few token-type rows: as a one-hot
        # product (the same rows, exactly) their gradient is a matmul,
        # where CUDA's embedding backward sums thousands of repeats of one
        # row in a different order from call to call
        types = self._modules["type"].weight
        one_hot = F.one_hot(type_ids.long(), types.shape[0])
        type_x = one_hot.to(types.dtype) @ types
        x = (self.word(ids) + self.position(pos) + type_x).to(c.dtype)
        x = layer_norm(x, self.norm, c.dtype)
        x = dropout(x, c.dropout_rate, deterministic, generator)
        if self.projection is not None:
            x = dense(x, self.projection, c.dtype)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        if cfg.share_layers:
            self.layer_shared = EncoderLayer(cfg)
        else:
            for i in range(cfg.num_layers):
                self.add_module(f"layer_{i}", EncoderLayer(cfg))

    def layers(self):
        c = self.cfg
        if c.share_layers:
            return [self.layer_shared] * c.num_layers
        return [getattr(self, f"layer_{i}") for i in range(c.num_layers)]

    def forward(self, ids, mask, type_ids=None, deterministic=True,
                generator=None):
        if type_ids is None:
            type_ids = torch.zeros_like(ids)
        x = self.embeddings(ids, type_ids, deterministic, generator)
        # override (ring) path: padding rides the [B, S] key bias, so the
        # dense bias is never built
        bias = (attention_bias_from_mask(mask)
                if self.cfg.attention_override is None
                else torch.where(mask > 0, 0.0, -1e30).to(torch.float32))
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers():
            if remat:
                x = checkpointed_layer(layer, x, bias, deterministic,
                                       generator)
            else:
                x = layer(x, bias, deterministic, generator)
        return x


class TextClassifier(nn.Module):
    """Encoder + tanh pooler over [CLS] + float32 classifier:
    ``model(ids, mask) -> [B, num_labels]`` float32 logits."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)
        if cfg.param_dtype != torch.float32:
            self.to(cfg.param_dtype)

    def forward(self, ids, mask, type_ids=None, deterministic=True,
                generator=None):
        c = self.cfg
        x = self.encoder(ids, mask, type_ids, deterministic, generator)
        pooled = torch.tanh(dense(x[:, 0], self.pooler, c.dtype))
        pooled = dropout(pooled, c.dropout_rate, deterministic, generator)
        return dense(pooled, self.classifier, torch.float32)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh init with flax's initializers: dense kernels lecun-normal
    (truncated normal, std sqrt(1/fan_in)/0.8796, cut at 2 std), biases 0,
    embeddings normal(0, 1/sqrt(features)), LayerNorm scale 1 / bias 0,
    RMSNorm scale 1.
    The draws are PyTorch's, not threefry's, taken in float32 and cast to
    the params' dtype."""

    def drawn(w, init):
        x = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        init(x)
        w.copy_(x)

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            std = math.sqrt(1.0 / mod.in_features) / .87962566103423978
            drawn(mod.weight, lambda x: nn.init.trunc_normal_(
                x, std=std, a=-2 * std, b=2 * std, generator=generator))
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            drawn(mod.weight, lambda x: nn.init.normal_(
                x, std=math.sqrt(1.0 / mod.embedding_dim),
                generator=generator))
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.RMSNorm):
            nn.init.ones_(mod.weight)


def tp_specs(params, axis: str = "tp"):
    """Megatron tensor parallelism of the encoder family: ``{flax path:
    the dimension of the torch tensor that the tp axis splits, or None}``
    for the flax paths that key ``params``. Column-parallel
    query/key/value (heads) and mlp_in (the FFN width) split their
    ``[out, in]`` weight and their bias along dim 0; row-parallel
    out/mlp_out split the weight's input side, dim 1, and keep the bias
    whole (added once after the partial sums); embeddings, norms, pooler
    and classifier stay whole. The JAX package's ``PartitionSpec`` tree
    names the flax dimension instead (``axis`` is its mesh axis; the port
    has the one ``tp`` axis). ``tp`` must divide ``num_heads`` and
    ``intermediate_size``."""
    COL = {"query", "key", "value", "mlp_in"}
    ROW = {"out", "mlp_out"}

    def spec(path):
        names = path.split("/")
        mod = names[-2] if len(names) >= 2 else ""
        if mod in COL:
            return 0
        if mod in ROW and names[-1] != "bias":
            return 1
        return None

    return {path: spec(path) for path in params}
