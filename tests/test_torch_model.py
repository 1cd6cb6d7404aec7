"""PyTorch port (``bcfl_tpu_torch``): the BERT/ALBERT classifier against
the flax model.

Parameters come from the flax init and cross with
``convert.from_flax``; inputs are numpy draws. With float32 compute and no
dropout, logits and every gradient agree to a float32 tolerance: the two
frameworks sum the same products in other orders, so the tolerance is a
few float32 roundings of the largest term (atol 2e-5, rtol 2e-4). With
bf16 compute the gap is a few bf16 roundings (2**-8 relative) of O(1)
logits, accumulated over the layers: atol 0.03 (measured: 0.006).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bcfl_tpu.compression.codecs import _path_name
from bcfl_tpu.models import build as jbuild
from bcfl_tpu_torch.models import build as tbuild, list_models
from bcfl_tpu_torch.models import convert

ATOL, RTOL = 2e-5, 2e-4


def _inputs(B=3, S=12, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (B, S)).astype(np.int32)
    lens = rng.integers(3, S + 1, (B,))
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    labels = rng.integers(0, 3, (B,)).astype(np.int32)
    return ids, mask, labels


def _pair(name, dtype="float32"):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jm = jbuild(name, num_labels=3, vocab_size=512, dtype=jd)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(1), ids, ids)["params"]
    tm = tbuild(name, num_labels=3, vocab_size=512, dtype=td)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


@pytest.mark.parametrize("name", ["tiny-bert", "tiny-albert"])
def test_logits_match_flax(name):
    jm, params, tm = _pair(name)
    ids, mask, _ = _inputs()
    lj = np.asarray(jax.jit(jm.apply)({"params": params}, ids, mask))
    with torch.no_grad():
        lt = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert lt.dtype == np.float32 and lt.shape == lj.shape
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["tiny-bert", "tiny-albert"])
def test_grads_match_flax(name):
    jm, params, tm = _pair(name)
    ids, mask, labels = _inputs(seed=1)

    def loss_j(p):
        logits = jm.apply({"params": p}, ids, mask)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    gj = jax.jit(jax.grad(loss_j))(params)
    logits = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long()).backward()
    specs = {s.path: s for s in convert.leaf_specs(tm)}
    grads = {k: p.grad for k, p in tm.named_parameters()}
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        spec = specs[_path_name(path)]
        gt = convert.to_jax_layout(spec, grads[spec.key]).numpy()
        np.testing.assert_allclose(gt, np.asarray(g), atol=ATOL, rtol=RTOL,
                                   err_msg=spec.path)


@pytest.mark.parametrize("name", ["tiny-bert", "tiny-albert"])
def test_bf16_logits_close_to_flax(name):
    jm, params, tm = _pair(name, "bfloat16")
    ids, mask, _ = _inputs(seed=2)
    lj = np.asarray(jax.jit(jm.apply)({"params": params}, ids, mask))
    with torch.no_grad():
        lt = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert lt.dtype == np.float32
    np.testing.assert_allclose(lt, lj, atol=0.03)


@pytest.mark.parametrize("name", ["tiny-bert", "tiny-albert"])
def test_trainable_tree_is_the_flax_tree(name):
    """Same leaf paths, order, shapes and values as the flax params: the
    codec groups, keys and indexes exactly what JAX does."""
    _, params, tm = _pair(name)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    tree = convert.trainable_tree(tm)
    assert list(tree) == [_path_name(p) for p, _ in flat]
    for (path, x), (tp, t) in zip(flat, tree.items()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(x), err_msg=tp)
    # and back: to_flax inverts from_flax, load_trainable inverts the tree
    back = convert.to_flax(tm)
    for path, x in flat:
        node = back
        for part in _path_name(path).split("/"):
            node = node[part]
        np.testing.assert_array_equal(node, np.asarray(x))
    fresh = tbuild(name, num_labels=3, vocab_size=512)
    convert.load_trainable(fresh, tree)
    for (k, a), (_, b) in zip(fresh.named_parameters(),
                              tm.named_parameters()):
        assert torch.equal(a, b), k


def test_albert_shares_one_layer_and_factorizes_embeddings():
    tm = tbuild("tiny-albert")
    paths = [s.path for s in convert.leaf_specs(tm)]
    assert any(p.startswith("encoder/layer_shared/") for p in paths)
    assert not any("layer_1" in p for p in paths)
    assert tm.encoder.embeddings.word.weight.shape[1] == 64
    assert "encoder/embeddings/projection/kernel" in paths


def test_dropout_is_seeded_and_masks_in_training():
    tm = tbuild("tiny-bert", num_labels=2, vocab_size=512)
    ids, mask, _ = _inputs()
    args = (torch.from_numpy(ids), torch.from_numpy(mask))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tm(*args, deterministic=False, generator=g)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    with pytest.raises(ValueError, match="generator"):
        tm(*args, deterministic=False)


def test_registry_and_not_ported_models():
    assert {"tiny-bert", "tiny-albert", "bert-base", "albert-base"} <= set(
        list_models())
    with pytest.raises(ValueError, match="not ported yet"):
        tbuild("llama2-7b")
    flash = tbuild("tiny-bert", use_flash=True)
    assert flash.cfg.use_flash and flash.cfg.flash_min_seq == 512
