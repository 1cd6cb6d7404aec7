"""PyTorch port (``bcfl_tpu_torch``): the Llama family against the flax
model (``bcfl_tpu/models/llama.py``).

Parameters come from the flax init and cross with ``convert.from_flax``;
inputs are numpy draws. Tolerances:

- ``rope``, ``RMSNorm`` and ``causal_bias``: the same float32 arithmetic
  in both packages, so a float32 rounding or two of O(1) values (atol
  1e-6, rtol 1e-6; RMSNorm's bf16 output one bf16 ulp, rtol 2**-7);
  ``causal_bias`` exactly.
- ``LlamaClassifier`` and ``LlamaLM`` logits and every parameter's
  gradient with float32 compute: the tolerance of
  ``tests/test_torch_model.py`` (atol 2e-5, rtol 2e-4; the two frameworks
  sum the same products in other orders), on the dense path
  (``causal_bias``) and on the flash path (JAX's ``use_flash=True,
  flash_min_seq=0`` on the CPU, the port's plain kernel versions). With
  bf16 compute a few bf16 roundings of the logits: atol 0.03 for the
  classifier's O(1) logits (measured 0.016). The LM's 512 vocabulary
  logits per position carry more of the hidden state's bf16 noise: there
  the port may sit as far from JAX's bf16 logits as JAX's own bf16 logits
  sit from its float32 ones on the same inputs (measured 0.047 against
  0.055), and never past 0.06. With float16 compute on the flash path
  (causal, the port's plain kernel versions at float16 against JAX's
  flash at float16), the same bounds over 8 (fp16 keeps 3 more bits):
  0.00375 for the classifier (measured 0.0017), and for the LM JAX's own
  float16-to-float32 gap, never past 0.0075 (measured 0.0052 against
  0.0083).
- The classifier pools the last non-pad token (ragged rows, a row of
  length 1) and ``build(head="lm")`` refuses an encoder with JAX's
  message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bcfl_tpu.compression.codecs import _path_name
from bcfl_tpu.models import build as jbuild
from bcfl_tpu.models import llama as jllama
from bcfl_tpu_torch.models import build as tbuild
from bcfl_tpu_torch.models import convert, llama as tllama

ATOL, RTOL = 2e-5, 2e-4
VOCAB = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B=3, S=20, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, VOCAB, (B, S)).astype(np.int32)
    lens = rng.integers(1, S + 1, (B,))
    lens[0] = S  # one full row
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    labels = rng.integers(0, 3, (B,)).astype(np.int32)
    return ids, mask, labels


def _pair(head="classifier", dtype="float32", flash=False):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(use_flash=True, flash_min_seq=0) if flash else {}
    jm = jbuild("tiny-llama", head=head, num_labels=3, vocab_size=VOCAB,
                dtype=jd, **kw)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(1), ids, ids)["params"]
    tm = tbuild("tiny-llama", head=head, num_labels=3, vocab_size=VOCAB,
                dtype=td, **kw)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 10, 32)).astype(np.float32)
    for pos in (np.arange(10), rng.integers(0, 500, (2, 10))):
        want = np.asarray(jllama.rope(jnp.asarray(x), jnp.asarray(pos),
                                      10000.0))
        got = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos),
                          10000.0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # interleaved pairs: position 0 is the identity, and the pair (0, 1)
    # rotates together
    got = tllama.rope(torch.from_numpy(x), torch.arange(10), 10000.0)
    np.testing.assert_array_equal(got[:, :, 0].numpy(), x[:, :, 0])


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(1)
    scale = rng.standard_normal(64).astype(np.float32)
    norm = torch.nn.RMSNorm(64, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
    mod = jllama.RMSNorm(1e-5, jnp.float32)
    for dtype, jd in ((torch.float32, jnp.float32),
                      (torch.bfloat16, jnp.bfloat16)):
        x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
        xj = jnp.asarray(x).astype(jd)
        want = np.asarray(mod.apply({"params": {"scale": scale}}, xj)
                          .astype(jnp.float32))
        with torch.no_grad():
            got = tllama.rms_norm(torch.from_numpy(x).to(dtype), norm)
        assert got.dtype == dtype
        # bf16: the float32 results round to the same bf16 value, or one
        # bf16 ulp apart where they straddle a rounding boundary
        tol = 1e-6 if dtype == torch.float32 else 2 ** -7
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                                   rtol=tol)


def test_causal_bias_matches_jax():
    _, mask, _ = _inputs(B=4, S=9, seed=2)
    want = np.asarray(jllama.causal_bias(jnp.asarray(mask)))
    got = tllama.causal_bias(torch.from_numpy(mask)).numpy()
    assert got.shape == (4, 1, 9, 9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("head", ["classifier", "lm"])
def test_logits_match_flax(head, flash):
    jm, params, tm = _pair(head, flash=flash)
    ids, mask, _ = _inputs(seed=3)
    lj = np.asarray(jax.jit(jm.apply)({"params": params}, ids, mask))
    with torch.no_grad():
        lt = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert lt.dtype == np.float32 and lt.shape == lj.shape
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)


def _grads_pair(head, flash, B, S, seed):
    jm, params, tm = _pair(head, flash=flash)
    ids, mask, labels = _inputs(B=B, S=S, seed=seed)

    def loss_j(p):
        logits = jm.apply({"params": p}, ids, mask)
        if head == "lm":
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], ids[:, 1:]).mean()
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    gj = jax.jit(jax.grad(loss_j))(params)
    logits = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    if head == "lm":
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            torch.from_numpy(ids[:, 1:]).long().reshape(-1))
    else:
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(labels).long())
    loss.backward()
    specs = {s.path: s for s in convert.leaf_specs(tm)}
    grads = {k: p.grad for k, p in tm.named_parameters()}
    flat = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert [_path_name(p) for p, _ in flat] == list(specs)
    for path, g in flat:
        spec = specs[_path_name(path)]
        gt = convert.to_jax_layout(spec, grads[spec.key]).numpy()
        np.testing.assert_allclose(gt, np.asarray(g), atol=ATOL, rtol=RTOL,
                                   err_msg=spec.path)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("head", ["classifier", "lm"])
def test_grads_match_flax(head, flash):
    _grads_pair(head, flash, B=3, S=20, seed=4)


def test_flash_grads_match_flax_past_one_block():
    """The one longer flash case: 160 queries, ragged rows."""
    _grads_pair("classifier", True, B=2, S=160, seed=5)


def _low_precision_logits(head, dtype, flash, atol, cap):
    """Logits at a low-precision compute dtype against JAX's at the same
    dtype: within ``atol`` (the classifier), or (the LM) within JAX's own
    gap from its float32 logits on the same inputs, at most ``cap``."""
    jm, params, tm = _pair(head, dtype, flash=flash)
    ids, mask, _ = _inputs(seed=6)
    lj = np.asarray(jax.jit(jm.apply)({"params": params}, ids, mask))
    with torch.no_grad():
        lt = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert lt.dtype == np.float32
    if head == "lm":
        j32, _, _ = _pair(head, "float32", flash=flash)
        l32 = np.asarray(jax.jit(j32.apply)({"params": params}, ids, mask))
        atol = min(float(np.abs(lj - l32).max()), cap)
    np.testing.assert_allclose(lt, lj, atol=atol)


@pytest.mark.parametrize("head", ["classifier", "lm"])
def test_bf16_logits_close_to_flax(head):
    _low_precision_logits(head, "bfloat16", False, atol=0.03, cap=0.06)


@pytest.mark.parametrize("head", ["classifier", "lm"])
def test_fp16_flash_logits_close_to_flax(head):
    """Causal flash attention at float16 (tiny-llama's head dim 32, the
    kernels' float16 plain versions) against JAX's flash at float16."""
    _low_precision_logits(head, "float16", True, atol=0.03 / 8,
                          cap=0.06 / 8)


def test_classifier_pools_the_last_non_pad_token():
    _, _, tm = _pair()
    ids, _, _ = _inputs(B=4, S=12, seed=7)
    lens = np.array([12, 5, 1, 9])
    mask = (np.arange(12)[None, :] < lens[:, None]).astype(np.int32)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        logits = tm(ids_t, mask_t)
        hidden = tm.model(ids_t, mask_t)
        want = hidden[torch.arange(4), torch.from_numpy(lens - 1)].float() \
            @ tm.classifier.weight.t()
        # the tokens past a row's end change nothing (causal + padding)
        ids2 = ids_t.clone()
        ids2[mask_t == 0] = 7
        again = tm(ids2, mask_t)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-6)
    np.testing.assert_array_equal(again.numpy(), logits.numpy())


def test_trainable_tree_is_the_flax_tree():
    _, params, tm = _pair("lm")
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    tree = convert.trainable_tree(tm)
    assert list(tree) == [_path_name(p) for p, _ in flat]
    for (path, x), (tp, t) in zip(flat, tree.items()):
        assert tuple(t.shape) == x.shape, tp
        np.testing.assert_array_equal(t.numpy(), np.asarray(x), err_msg=tp)


def test_build_lm_refuses_encoders_with_jax_message():
    with pytest.raises(ValueError) as jerr:
        jbuild("tiny-bert", head="lm")
    with pytest.raises(ValueError) as terr:
        tbuild("tiny-bert", head="lm")
    assert str(terr.value) == str(jerr.value)
    cfg = tbuild("llama2-7b", num_layers=1, hidden_size=128, num_heads=1,
                 intermediate_size=64, vocab_size=64).cfg
    assert (cfg.head_dim, cfg.kv_heads, cfg.use_flash,
            cfg.flash_min_seq) == (128, 1, True, 512)
