"""Model registry: port of ``bcfl_tpu/models/__init__.py`` (encoder family;
the Llama configs are not ported yet)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from bcfl_tpu_torch.models.bert import EncoderConfig, TextClassifier

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

_NOT_PORTED = ("tiny-llama", "llama2-7b")


def get_config(name: str, **overrides) -> EncoderConfig:
    if name in _CONFIGS:
        return dataclasses.replace(_CONFIGS[name], **overrides)
    if name in _NOT_PORTED:
        raise ValueError(f"model={name!r} is not ported yet (Llama family)")
    raise KeyError(f"unknown model {name!r}; have {list_models()}")


def list_models():
    return sorted(_CONFIGS)


def build(name: str, head: str = "classifier", **overrides) -> TextClassifier:
    """Build the named encoder classifier (``head="lm"`` needs a decoder,
    and the Llama family is not ported yet)."""
    if head != "classifier":
        raise ValueError(f"head={head!r} is not ported yet")
    return TextClassifier(get_config(name, **overrides))


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
