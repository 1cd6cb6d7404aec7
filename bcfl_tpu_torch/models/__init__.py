"""Model registry: port of ``bcfl_tpu/models/__init__.py`` (the encoder
family and the Llama family; ``build(head="lm")`` builds the causal-LM
variant of a Llama model; ``tp_param_specs`` dispatches the megatron
split on the built model's family)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from bcfl_tpu_torch.models import lora
from bcfl_tpu_torch.models.bert import EncoderConfig, TextClassifier
from bcfl_tpu_torch.models.llama import (LORA_TARGETS, LlamaClassifier,
                                         LlamaConfig, LlamaLM)

_CONFIGS: Dict[str, EncoderConfig] = {
    # test/bench scale-downs
    "tiny-bert": EncoderConfig(vocab_size=8192, hidden_size=128, num_layers=2,
                               num_heads=2, intermediate_size=512),
    "tiny-albert": EncoderConfig(vocab_size=8192, hidden_size=128,
                                 num_layers=2, num_heads=2,
                                 intermediate_size=512, share_layers=True,
                                 embedding_size=64),
    "small-bert": EncoderConfig(vocab_size=30522, hidden_size=512,
                                num_layers=4, num_heads=8,
                                intermediate_size=2048),
    # BERT-base family (biobert-v1.1 is a cased BERT-base, vocab 28996)
    "bert-base": EncoderConfig(vocab_size=30522, hidden_size=768,
                               num_layers=12, num_heads=12,
                               intermediate_size=3072),
    "biobert-base": EncoderConfig(vocab_size=28996, hidden_size=768,
                                  num_layers=12, num_heads=12,
                                  intermediate_size=3072),
    "albert-base": EncoderConfig(vocab_size=30000, hidden_size=768,
                                 num_layers=12, num_heads=12,
                                 intermediate_size=3072, share_layers=True,
                                 embedding_size=128),
    "clinical-bert": EncoderConfig(vocab_size=28996, hidden_size=768,
                                   num_layers=12, num_heads=12,
                                   intermediate_size=3072),
}

_LLAMA_CONFIGS: Dict[str, LlamaConfig] = {
    # test scale-down (GQA exercised: 4 heads, 2 kv heads)
    "tiny-llama": LlamaConfig(vocab_size=8192, hidden_size=128, num_layers=2,
                              num_heads=4, num_kv_heads=2,
                              intermediate_size=384, max_position=512),
    # Llama-2-7B (the LoRA federated fine-tune configuration)
    "llama2-7b": LlamaConfig(vocab_size=32000, hidden_size=4096,
                             num_layers=32, num_heads=32,
                             intermediate_size=11008, max_position=4096),
}


def get_config(name: str, **overrides):
    if name in _CONFIGS:
        return dataclasses.replace(_CONFIGS[name], **overrides)
    if name in _LLAMA_CONFIGS:
        return dataclasses.replace(_LLAMA_CONFIGS[name], **overrides)
    raise KeyError(f"unknown model {name!r}; have {list_models()}")


def list_models():
    return sorted(_CONFIGS) + sorted(_LLAMA_CONFIGS)


def build(name: str, head: str = "classifier", **overrides) -> nn.Module:
    """Build the named model; both families share the forward signature
    ``model(ids, mask, deterministic=..., generator=...) -> logits``.
    ``head="lm"`` builds the causal-LM variant (``[B, S, vocab]`` logits;
    Llama family only: an encoder sees every token, so next-token training
    would leak the target)."""
    cfg = get_config(name, **overrides)
    if name not in _CONFIGS:
        return LlamaLM(cfg) if head == "lm" else LlamaClassifier(cfg)
    if head == "lm":
        raise ValueError(
            f"model {name!r} is an encoder: causal-LM training needs a "
            "decoder (llama family)")
    return TextClassifier(cfg)


def lora_targets(name: str):
    """Module names whose kernels get LoRA adapters, per model family."""
    if name not in _CONFIGS and name in _LLAMA_CONFIGS:
        return LORA_TARGETS
    return lora.DEFAULT_TARGETS


def tp_param_specs(model, params, axis: str = "tp"):
    """Megatron tensor-parallel specs for ``params`` (keyed by flax path:
    ``{path: torch dim or None}``, see :func:`bcfl_tpu_torch.models.llama.
    tp_specs`), dispatched on the BUILT model's family. Pass the model
    instance, not a registry name: an ``hf_checkpoint`` run always builds
    an encoder even when the config names a llama model."""
    if isinstance(model, str):
        raise TypeError(
            "tp_param_specs takes the built model instance, not a name: "
            "a name cannot see through hf_checkpoint overrides")
    if isinstance(model, TextClassifier):
        from bcfl_tpu_torch.models.bert import tp_specs

        return tp_specs(params, axis=axis)
    from bcfl_tpu_torch.models.llama import tp_specs

    return tp_specs(params, axis=axis)


def full_float32_matmuls() -> None:
    """The port's float32 policy on the card, set once by whoever runs a
    model there (``FedEngine``): float32 matrix products and convolutions
    run in full float32, so ``allow_tf32`` is False for both
    ``torch.backends.cuda.matmul`` and ``torch.backends.cudnn`` (the latter
    defaults to True). bf16 compute is unaffected; the float32 classifier
    and any float32-compute run keep the JAX package's float32 arithmetic.
    The flags are process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
