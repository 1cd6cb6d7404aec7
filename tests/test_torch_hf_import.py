"""HF checkpoint import (``bcfl_tpu_torch/models/hf_import.py``) and the HF
tokenizer adapter against the JAX package and ``transformers`` itself.

Tiny ``BertForSequenceClassification`` / ``AlbertForSequenceClassification``
models are built here from configs the test writes (no download); the
port's imported tree must equal JAX's ``import_state_dict`` leaf for leaf,
bit for bit, and the port's float32 logits the HF model's at rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from bcfl_tpu.data.tokenizer import HFTokenizerAdapter as JHFTok  # noqa: E402
from bcfl_tpu.models import hf_import as jhf  # noqa: E402
from bcfl_tpu_torch.data.tokenizer import (  # noqa: E402
    HFTokenizerAdapter,
    get_tokenizer,
)
from bcfl_tpu_torch.models import hf_import as thf  # noqa: E402
from bcfl_tpu_torch.models.bert import TextClassifier  # noqa: E402


def _bert(labels=3, seed=0):
    torch.manual_seed(seed)
    cfg = transformers.BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, num_labels=labels)
    return transformers.BertForSequenceClassification(cfg).eval()


def _albert(labels=3, seed=0):
    torch.manual_seed(seed)
    cfg = transformers.AlbertConfig(
        vocab_size=120, embedding_size=16, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, num_labels=labels)
    return transformers.AlbertForSequenceClassification(cfg).eval()


MODELS = {"bert": _bert, "albert": _albert}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, np.asarray(v)


@pytest.mark.parametrize("family", sorted(MODELS))
def test_imported_tree_equals_jax_bit_for_bit(family):
    hf = MODELS[family]()
    sd = hf.state_dict()
    tcfg = thf.config_from_hf(hf.config)
    jcfg = jhf.config_from_hf(hf.config)
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "max_position", "type_vocab_size",
              "num_labels", "layer_norm_eps", "share_layers",
              "embedding_size"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    got = dict(_flat(thf.import_state_dict(sd, tcfg)["params"]))
    want = dict(_flat(jhf.import_state_dict(sd, jcfg)["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("family", sorted(MODELS))
def test_port_logits_equal_hf_float32(family):
    hf = MODELS[family](seed=1)
    cfg, variables = thf.import_pretrained(hf)
    model = TextClassifier(dataclasses.replace(cfg, dtype=torch.float32))
    thf.load_into(model, variables["params"])
    model.eval()
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 120, (3, 16), generator=g)
    mask = torch.ones(3, 16, dtype=torch.long)
    mask[1, 10:] = 0
    mask[2, 4:] = 0
    with torch.no_grad():
        got = model(ids, mask)
        want = hf(input_ids=ids, attention_mask=mask).logits
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("family", sorted(MODELS))
def test_label_mismatch_raises_as_in_jax(family):
    hf = MODELS[family](labels=3)
    sd = hf.state_dict()
    cfg = thf.config_from_hf(hf.config, num_labels=5)
    jcfg = jhf.config_from_hf(hf.config, num_labels=5)
    with pytest.raises(ValueError) as te:
        thf.import_state_dict(sd, cfg)
    with pytest.raises(ValueError) as je:
        jhf.import_state_dict(sd, jcfg)
    assert str(te.value) == str(je.value)
    assert "reinit_classifier=True" in str(te.value)


@pytest.mark.parametrize("family", sorted(MODELS))
def test_reinit_classifier_keeps_encoder_and_draws_a_fresh_head(family):
    hf = MODELS[family](labels=3)
    sd = hf.state_dict()
    cfg = thf.config_from_hf(hf.config, num_labels=5)
    got = thf.import_state_dict(sd, cfg, reinit_classifier=True)["params"]
    want = jhf.import_state_dict(sd, jhf.config_from_hf(
        hf.config, num_labels=5), reinit_classifier=True)["params"]
    # the encoder and pooler are the checkpoint's, bit for bit
    for k, v in _flat({"encoder": want["encoder"], "pooler": want["pooler"]}):
        a = dict(_flat({"encoder": got["encoder"], "pooler": got["pooler"]}))
        np.testing.assert_array_equal(a[k], v, err_msg=k)
    # the head: JAX's law (normal / sqrt(hidden), zero bias), the port's
    # own seeded draw
    kern, bias = got["classifier"]["kernel"], got["classifier"]["bias"]
    assert kern.shape == np.asarray(want["classifier"]["kernel"]).shape
    assert kern.dtype == np.float32
    np.testing.assert_array_equal(bias, np.zeros((5,), np.float32))
    np.testing.assert_array_equal(np.asarray(want["classifier"]["bias"]),
                                  bias)
    assert 0.05 < kern.std() * np.sqrt(cfg.hidden_size) < 3.0
    again = thf.import_state_dict(sd, cfg, reinit_classifier=True)["params"]
    np.testing.assert_array_equal(again["classifier"]["kernel"], kern)


def test_missing_pooler_raises():
    sd = {k: v for k, v in _bert().state_dict().items()
          if "pooler" not in k}
    with pytest.raises(KeyError, match="no pooler"):
        thf.import_state_dict(sd, thf.config_from_hf(_bert().config))


def test_import_pretrained_from_a_directory(tmp_path):
    hf = _bert(labels=4, seed=3)
    hf.save_pretrained(tmp_path)
    cfg, variables = thf.import_pretrained(str(tmp_path))
    jcfg, jvars = jhf.import_pretrained(str(tmp_path))
    assert cfg.num_labels == jcfg.num_labels == 4
    got = dict(_flat(variables["params"]))
    for k, v in _flat(jvars["params"]):
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    model = TextClassifier(cfg)
    thf.load_into(model, variables["params"])
    np.testing.assert_array_equal(
        model.encoder.embeddings.word.weight.detach().numpy(),
        hf.bert.embeddings.word_embeddings.weight.detach().numpy())


def _vocab_dir(tmp_path):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "patient",
             "has", "a", "fever", "and", "cough", "##s", "no", "history",
             ".", ",", "of"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    tok = transformers.BertTokenizerFast(
        vocab_file=str(tmp_path / "vocab.txt"), do_lower_case=True)
    tok.save_pretrained(tmp_path)
    return str(tmp_path)


def test_hf_tokenizer_adapter_equals_jax(tmp_path):
    path = _vocab_dir(tmp_path)
    texts = ["The patient has a fever and coughs.", "",
             "No history of cough, fever", "unknown wordz here " * 20]
    tok = get_tokenizer(path)
    assert isinstance(tok, HFTokenizerAdapter)
    jtok = JHFTok(path)
    assert tok.vocab_size == jtok.vocab_size == 18
    for seq_len in (4, 16, 64):
        ids, mask = tok.encode_batch(texts, seq_len)
        jids, jmask = jtok.encode_batch(texts, seq_len)
        assert ids.dtype == mask.dtype == np.int32
        assert ids.shape == (len(texts), seq_len)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)


def test_engine_seeds_from_hf_checkpoint(tmp_path):
    """``hf_checkpoint`` (a directory on disk) seeds the engine's encoder
    as JAX's engine does (fresh classifier head), and a round runs."""
    from bcfl_tpu_torch.config import FedConfig, PartitionConfig
    from bcfl_tpu_torch.fed.engine import FedEngine
    from bcfl_tpu_torch.models.convert import to_flax

    hf = _bert(labels=2, seed=4)
    hf.save_pretrained(tmp_path / "ckpt")
    path = _vocab_dir(tmp_path)
    cfg = FedConfig(model="tiny-bert", dataset="synthetic", num_clients=2,
                    num_rounds=1, seq_len=16, batch_size=4,
                    max_local_batches=1, max_eval_batches=1,
                    partition=PartitionConfig(kind="iid", iid_samples=8),
                    hf_checkpoint=str(tmp_path / "ckpt"), tokenizer=path)
    eng = FedEngine(cfg, device="cpu")
    assert eng.model.cfg.hidden_size == 32  # the checkpoint's architecture
    got = to_flax(eng.model)
    want = jhf.import_pretrained(str(tmp_path / "ckpt"), num_labels=2,
                                 reinit_classifier=True)[1]["params"]
    for k, v in _flat({"encoder": want["encoder"]}):
        np.testing.assert_array_equal(
            dict(_flat({"encoder": got["encoder"]}))[k], v, err_msg=k)
    result = eng.run()
    assert np.isfinite(result.metrics.rounds[0].train_loss)
