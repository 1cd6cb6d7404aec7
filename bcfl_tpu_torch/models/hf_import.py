"""HF checkpoint import: port of ``bcfl_tpu/models/hf_import.py``.

Maps a HF torch ``state_dict`` (``BertForSequenceClassification``,
``BertModel``, ``AlbertForSequenceClassification``, ``AlbertModel``) onto
the encoder's parameter tree in the JAX package's layout: a nested numpy
``{"params": ...}`` tree, leaf for leaf what JAX's ``import_state_dict``
builds. :func:`bcfl_tpu_torch.models.convert.from_flax` turns it into the
port's model (:func:`load_into`).

A label-count mismatch between the checkpoint's classifier and the config
is a hard error unless ``reinit_classifier=True`` is passed, which keeps
the encoder and draws a fresh classifier (normal / sqrt(hidden), zero
bias) from a seeded ``torch.Generator`` — the same law as JAX's draw, not
its numbers. :func:`import_pretrained` with a hub name or a directory
needs ``transformers`` (not needed for a state dict the caller holds).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from bcfl_tpu_torch.models.bert import EncoderConfig
from bcfl_tpu_torch.models.convert import from_flax


def config_from_hf(hf_config, num_labels: Optional[int] = None
                   ) -> EncoderConfig:
    """An :class:`EncoderConfig` from a HF Bert/Albert config object (or
    anything with its attribute names)."""
    is_albert = hf_config.model_type == "albert"
    emb = getattr(hf_config, "embedding_size", None)
    return EncoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        num_labels=num_labels or getattr(hf_config, "num_labels", 2),
        layer_norm_eps=hf_config.layer_norm_eps,
        share_layers=is_albert,
        embedding_size=emb if (emb and emb != hf_config.hidden_size) else None,
    )


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _dense(sd: Dict, prefix: str):
    """torch Linear [out, in] -> flax kernel [in, out] + bias [out]."""
    return {"kernel": _t(sd[prefix + ".weight"]).T,
            "bias": _t(sd[prefix + ".bias"])}


def _qkv(sd: Dict, prefix: str, heads: int, head_dim: int):
    w = _t(sd[prefix + ".weight"]).T  # [in, out]
    b = _t(sd[prefix + ".bias"])
    return {"kernel": w.reshape(w.shape[0], heads, head_dim),
            "bias": b.reshape(heads, head_dim)}


def _outproj(sd: Dict, prefix: str, heads: int, head_dim: int):
    w = _t(sd[prefix + ".weight"]).T  # [in (= heads * head_dim), out]
    return {"kernel": w.reshape(heads, head_dim, w.shape[1]),
            "bias": _t(sd[prefix + ".bias"])}


def _ln(sd: Dict, prefix: str):
    return {"scale": _t(sd[prefix + ".weight"]),
            "bias": _t(sd[prefix + ".bias"])}


def _layer_from_bert(sd, p, h, d):
    return {
        "attention": {
            "query": _qkv(sd, f"{p}.attention.self.query", h, d),
            "key": _qkv(sd, f"{p}.attention.self.key", h, d),
            "value": _qkv(sd, f"{p}.attention.self.value", h, d),
            "out": _outproj(sd, f"{p}.attention.output.dense", h, d),
        },
        "attention_norm": _ln(sd, f"{p}.attention.output.LayerNorm"),
        "mlp_in": _dense(sd, f"{p}.intermediate.dense"),
        "mlp_out": _dense(sd, f"{p}.output.dense"),
        "mlp_norm": _ln(sd, f"{p}.output.LayerNorm"),
    }


def _layer_from_albert(sd, p, h, d):
    return {
        "attention": {
            "query": _qkv(sd, f"{p}.attention.query", h, d),
            "key": _qkv(sd, f"{p}.attention.key", h, d),
            "value": _qkv(sd, f"{p}.attention.value", h, d),
            "out": _outproj(sd, f"{p}.attention.dense", h, d),
        },
        "attention_norm": _ln(sd, f"{p}.attention.LayerNorm"),
        "mlp_in": _dense(sd, f"{p}.ffn"),
        "mlp_out": _dense(sd, f"{p}.ffn_output"),
        "mlp_norm": _ln(sd, f"{p}.full_layer_layer_norm"),
    }


def import_state_dict(sd: Dict, cfg: EncoderConfig,
                      num_labels: Optional[int] = None,
                      reinit_classifier: bool = False,
                      generator: Optional[torch.Generator] = None) -> Dict:
    """The full ``{"params": ...}`` tree (numpy leaves, JAX layout) from a
    HF torch state dict; ``generator`` draws a re-initialized classifier
    (default: seeded with 0)."""
    sd = {k.removeprefix("bert.").removeprefix("albert."): v
          for k, v in sd.items()}
    is_albert = cfg.share_layers
    h, d = cfg.num_heads, cfg.head_dim

    emb = {
        "word": {"embedding": _t(sd["embeddings.word_embeddings.weight"])},
        "position": {
            "embedding": _t(sd["embeddings.position_embeddings.weight"])},
        "type": {"embedding": _t(sd["embeddings.token_type_embeddings.weight"])},
        "norm": _ln(sd, "embeddings.LayerNorm"),
    }
    if is_albert:
        emb["projection"] = _dense(sd, "encoder.embedding_hidden_mapping_in")

    encoder = {"embeddings": emb}
    if is_albert:
        encoder["layer_shared"] = _layer_from_albert(
            sd, "encoder.albert_layer_groups.0.albert_layers.0", h, d)
    else:
        for i in range(cfg.num_layers):
            encoder[f"layer_{i}"] = _layer_from_bert(
                sd, f"encoder.layer.{i}", h, d)

    params = {"encoder": encoder}
    if "pooler.dense.weight" in sd:
        params["pooler"] = _dense(sd, "pooler.dense")
    elif "pooler.weight" in sd:  # ALBERT names the pooler directly
        params["pooler"] = _dense(sd, "pooler")
    else:
        raise KeyError("no pooler weights in state_dict")

    want_labels = num_labels or cfg.num_labels
    if "classifier.weight" in sd and not reinit_classifier:
        have = _t(sd["classifier.weight"]).shape[0]
        if have != want_labels:
            raise ValueError(
                f"checkpoint has {have} labels, config wants {want_labels}; "
                "pass reinit_classifier=True to keep the encoder and re-init "
                "the head (the reference silently ignores this with "
                "ignore_mismatched_sizes)")
        params["classifier"] = _dense(sd, "classifier")
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        scale = 1.0 / np.sqrt(cfg.hidden_size)
        kernel = torch.randn((cfg.hidden_size, want_labels),
                             generator=generator, dtype=torch.float32)
        params["classifier"] = {
            "kernel": (kernel * scale).numpy(),
            "bias": np.zeros((want_labels,), np.float32),
        }
    return {"params": params}


def load_into(model: nn.Module, params: Dict) -> None:
    """Copy an imported ``params`` tree into ``model`` (the encoder's
    parameters, in their own dtype and device)."""
    sd = from_flax(params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(sd[name].to(p.dtype))


def import_pretrained(name_or_model, num_labels: Optional[int] = None,
                      reinit_classifier: bool = False):
    """Load a HF model (a hub name, a local directory, or a HF torch model
    already built) and return ``(EncoderConfig, variables)``; a name or a
    directory needs ``transformers``."""
    if isinstance(name_or_model, str):
        from transformers import AutoModelForSequenceClassification

        model = AutoModelForSequenceClassification.from_pretrained(
            name_or_model)
    else:
        model = name_or_model
    cfg = config_from_hf(model.config, num_labels=num_labels)
    params = import_state_dict(model.state_dict(), cfg,
                               num_labels=num_labels,
                               reinit_classifier=reinit_classifier)
    return cfg, params
