"""PyTorch port (``bcfl_tpu_torch``): LoRA adapters
(``bcfl_tpu/models/lora.py``), the rank-aware and hierarchical means
(``bcfl_tpu/parallel/gspmd.py``) and the adapter tree on the wire, against
the JAX package.

Adapters come from JAX's ``init_lora`` (with ``b`` drawn nonzero, so the
merge does something) and cross with ``convert.from_flax_adapters``.
Tolerances:

- ``apply_lora``, the per-layer merge (against ``to_torch_layout`` of
  JAX's merged tree) and ``clip_adapters``/``rank_mask``/``init_lora_ranks``
  padding: the same float32 products, ``a @ b`` summed over a rank of 4
  to 16, so a float32 rounding (atol 1e-6, rtol 1e-6); masks and padding
  exactly.
- The LoRA forward and the adapters' gradients through the merged
  weights (tiny-llama and tiny-bert, float32 compute): the model tolerance
  of ``tests/test_torch_model.py`` (atol 2e-5, rtol 2e-4).
- ``effective_rank``: rtol 1e-6 (a sum of logs over the rank dims).
- ``rank_aware_weighted_mean`` and ``hierarchical_weighted_mean``
  (groups 2 and 4): rtol 1e-6, atol 1e-7 (weighted sums over 8 clients in
  another order).
- The adapter tree's leaf names and order equal
  ``jax.tree_util.tree_flatten_with_path`` of JAX's adapters, and the
  ``int8+topk`` payload over a stacked adapter delta (JAX's uniforms) is
  JAX's bit for bit, its keys in the port tree's (JAX's flatten) order.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu.fed.client_step import _merge
from bcfl_tpu.models import build as jbuild, lora as jlora
from bcfl_tpu.models import lora_targets as jtargets
from bcfl_tpu.parallel import gspmd
from bcfl_tpu_torch.compression import codecs as tcc
from bcfl_tpu_torch.core import prng
from bcfl_tpu_torch.models import build as tbuild, convert, lora
from bcfl_tpu_torch.models import lora_targets
from bcfl_tpu_torch.parallel import collectives as tpar

ATOL, RTOL = 2e-5, 2e-4
VOCAB = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jcc._path_name(p): torch.from_numpy(np.array(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_side(name, head, rank):
    jm = jbuild(name, head=head, num_labels=3, vocab_size=VOCAB,
                dtype=jnp.float32)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(1), ids, ids)["params"]
    adp = jlora.init_lora(jax.random.key(2), params, rank,
                          targets=jtargets(name))
    rng = np.random.default_rng(3)
    adp = {k: ({"a": v["a"], "b": jnp.asarray(
        rng.standard_normal(v["b"].shape).astype(np.float32) * 0.05)}
        if "b" in v else v) for k, v in adp.items()}
    return jm, params, adp


def _pair(name, head="classifier", rank=4):
    """flax params, JAX adapters (``b`` drawn nonzero), the port model
    holding the same base, the port adapter tree."""
    jm, params, adp = _jax_side(name, head, rank)
    tm = tbuild(name, head=head, num_labels=3, vocab_size=VOCAB,
                dtype=torch.float32)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    tm.requires_grad_(False)
    return jm, params, adp, tm.eval(), convert.from_flax_adapters(
        jax.tree.map(np.asarray, adp))


@pytest.mark.parametrize("name,head", [("tiny-llama", "classifier"),
                                       ("tiny-llama", "lm"),
                                       ("tiny-bert", "classifier")])
def test_adapter_tree_order_and_init_structure(name, head):
    _, params, adp, tm, tt = _pair(name, head)
    flat = jax.tree_util.tree_flatten_with_path(adp)[0]
    assert list(tt) == [jcc._path_name(p) for p, _ in flat]
    assert list(tt) == convert.adapter_order(list(tt))
    # the port's own init: JAX's keys, order and shapes; b zero, a at
    # 1/sqrt(rank), head leaves copies of the frozen ones
    mine = lora.init_lora(prng.generator("cpu", 0, prng.LORA_LANE), tm, 4,
                          lora_targets(name))
    assert list(mine) == list(tt)
    for p, x in mine.items():
        assert x.shape == tt[p].shape, p
        if p.endswith("/b"):
            assert not x.any(), p
    fparams = _flat(params)
    for p, x in mine.items():
        if p.endswith("/full"):
            np.testing.assert_array_equal(x.numpy(),
                                          fparams[p[:-5]].numpy())
    a = torch.cat([x.reshape(-1) for p, x in mine.items()
                   if p.endswith("/a")])
    assert abs(float(a.std()) * 2.0 - 1.0) < 0.05  # std 1/sqrt(4)
    # and back to JAX's nested layout
    back = convert.to_flax_adapters(tt)
    for k, v in adp.items():
        for sub, x in v.items():
            np.testing.assert_array_equal(back[k][sub], np.asarray(x))


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-bert"])
def test_apply_lora_and_per_layer_merge_match_jax(name):
    _, params, adp, tm, tt = _pair(name)
    merged_j = _flat(jlora.apply_lora(params, adp))
    merged_t = lora.apply_lora(_flat(params), tt)
    assert list(merged_t) == list(merged_j)
    for p, x in merged_j.items():
        np.testing.assert_allclose(merged_t[p].numpy(), x.numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=p)
    # the per-layer merge inside the forward: each targeted layer's weight
    # (and a head's bias) is to_torch_layout of JAX's merged leaf
    lora.attach(tm, tt)
    seen = 0
    for mod_name, mod in tm.named_modules():
        merge = mod.__dict__.get("lora")
        if merge is None:
            continue
        path = mod_name.replace(".", "/")
        w, b = merge(mod)
        want = convert.to_torch_layout(f"{path}/kernel",
                                       merged_j[f"{path}/kernel"])
        np.testing.assert_allclose(w.numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=path)
        if b is not None:
            np.testing.assert_array_equal(
                b.numpy(), convert.to_torch_layout(
                    f"{path}/bias", merged_j[f"{path}/bias"]).numpy())
        seen += 1
    lora.detach(tm)
    targets = {p.rsplit("/", 2)[0] if p.endswith("/full") else
               p.rsplit("/", 1)[0] for p in tt}
    assert seen == len(targets)
    assert all("lora" not in m.__dict__ for m in tm.modules())
    with pytest.raises(ValueError, match="match no layer"):
        lora.attach(tm, {"nowhere/a": torch.zeros(2, 2)})


@pytest.mark.parametrize("name,head", [("tiny-llama", "classifier"),
                                       ("tiny-llama", "lm"),
                                       ("tiny-bert", "classifier")])
def test_lora_forward_and_adapter_grads_match_jax(name, head):
    jm, params, adp, tm, tt = _pair(name, head)
    rng = np.random.default_rng(4)
    B, S = 3, 16
    ids = rng.integers(4, VOCAB, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.array([16, 9, 4])[:, None]).astype(
        np.int32)
    labels = rng.integers(0, 3, (B,)).astype(np.int32)

    def loss_j(a):
        logits = jm.apply({"params": _merge(a, params)}, ids, mask)
        if head == "lm":
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], ids[:, 1:]).mean()
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    gj = _flat(jax.jit(jax.grad(loss_j))(adp))
    leaves = {p: x.clone().requires_grad_(True) for p, x in tt.items()}
    with lora.attached(tm, leaves):
        logits = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    lj = np.asarray(jm.apply({"params": jlora.apply_lora(params, adp)},
                             ids, mask))
    np.testing.assert_allclose(logits.detach().numpy(), lj, atol=ATOL,
                               rtol=RTOL)
    if head == "lm":
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            torch.from_numpy(ids[:, 1:]).long().reshape(-1))
    else:
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(labels).long())
    loss.backward()
    assert list(gj) == list(leaves)
    for p, g in gj.items():
        np.testing.assert_allclose(leaves[p].grad.numpy(), g.numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=p)
    # the frozen base took no gradient
    assert all(p.grad is None for p in tm.parameters())


def test_rank_mask_clip_and_init_lora_ranks_padding():
    ranks = (2, 4, 1)
    np.testing.assert_array_equal(lora.rank_mask(ranks).numpy(),
                                  np.asarray(jlora.rank_mask(ranks)))
    _, params, adp, tm, tt = _pair("tiny-llama")
    m = lora.rank_mask((2, 4, 3, 1))
    jm = jlora.rank_mask((2, 4, 3, 1))
    for row in range(4):
        got = lora.clip_adapters(tt, m[row])
        want = _flat(jlora.clip_adapters(adp, jm[row]))
        for p, x in want.items():
            np.testing.assert_array_equal(got[p].numpy(), x.numpy())
    stacked_j = jax.tree.map(lambda x: jnp.stack([x] * 4), adp)
    got = lora.clip_stacked(convert.from_flax_adapters(
        jax.tree.map(np.asarray, stacked_j)), m)
    want = _flat(jax.vmap(jlora.clip_adapters)(stacked_j, jm))
    for p, x in want.items():
        np.testing.assert_array_equal(got[p].numpy(), x.numpy())
    # heterogeneous init: each client at its own rank, zero-padded to the
    # maximum, JAX's structure
    st = lora.init_lora_ranks(
        lambda c: prng.generator("cpu", 0, prng.LORA_LANE, c), tm,
        (2, 4, 1), lora_targets("tiny-llama"))
    sj = _flat(jlora.init_lora_ranks(jax.random.key(0), params, (2, 4, 1),
                                     targets=jtargets("tiny-llama")))
    assert list(st) == list(sj)
    for p, x in st.items():
        assert x.shape == sj[p].shape, p
        last = p.rsplit("/", 1)[-1]
        for c, r in enumerate((2, 4, 1)):
            if last == "a":
                assert not x[c, :, r:].any() and x[c, :, :r].all(), p
            elif last == "b":
                assert not x[c].any(), p


def test_effective_rank_matches_jax():
    _, _, adp, _, tt = _pair("tiny-llama")
    np.testing.assert_allclose(float(lora.effective_rank(tt)),
                               float(jlora.effective_rank(adp)), rtol=1e-6)
    zero = {"m/a": torch.eye(4), "m/b": torch.zeros(4, 4)}
    assert float(lora.effective_rank(zero)) == 0.0
    assert float(lora.effective_rank({"h/kernel/full": torch.ones(3)})) == 0.0
    eq = {"m/a": torch.eye(4), "m/b": 2.0 * torch.eye(4)}
    np.testing.assert_allclose(float(lora.effective_rank(eq)), 4.0,
                               rtol=1e-6)


def _stacked_adapters(C, seed):
    rng = np.random.default_rng(seed)
    tree = {"enc/q/a": rng.standard_normal((C, 6, 4)),
            "enc/q/b": rng.standard_normal((C, 4, 5)),
            "h/kernel/full": rng.standard_normal((C, 3, 2))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    jt = {"enc/q": {"a": jnp.asarray(tree["enc/q/a"]),
                    "b": jnp.asarray(tree["enc/q/b"])},
          "h/kernel": {"full": jnp.asarray(tree["h/kernel/full"])}}
    return {k: torch.from_numpy(v) for k, v in tree.items()}, jt


@pytest.mark.parametrize("weights", [[1, 3, 0, 2, 1, 1, 2, 5],
                                     [0, 0, 0, 0, 0, 0, 0, 0],
                                     [1, 0, 0, 0, 0, 0, 0, 0]])
def test_rank_aware_weighted_mean_matches_gspmd(weights):
    tt, jt = _stacked_adapters(8, 5)
    ranks = (1, 2, 4, 3, 4, 2, 1, 3)
    fb_t = {k: torch.full(v.shape[1:], 9.0) for k, v in tt.items()}
    fb_j = jax.tree.map(lambda x: jnp.full(x.shape[1:], 9.0), jt)
    w = np.asarray(weights, np.float32)
    got = tpar.rank_aware_weighted_mean(tt, torch.from_numpy(w),
                                        lora.rank_mask(ranks), fb_t)
    want = _flat(gspmd.rank_aware_weighted_mean(
        jt, jnp.asarray(w), jlora.rank_mask(ranks), fallback=fb_j))
    for p, x in want.items():
        np.testing.assert_allclose(got[p].numpy(), x.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=p)
    agg = tpar.make_aggregator("mean", rank_mask=lora.rank_mask(ranks))
    again = agg(tt, torch.from_numpy(w), fb_t)
    for p in tt:
        assert torch.equal(again[p], got[p])


@pytest.mark.parametrize("groups", [2, 4])
def test_hierarchical_weighted_mean_matches_gspmd(groups):
    tt, jt = _stacked_adapters(8, 6)
    w = np.asarray([1, 3, 0, 2, 1, 1, 2, 5], np.float32)
    fb_t = {k: torch.zeros(v.shape[1:]) for k, v in tt.items()}
    fb_j = jax.tree.map(lambda x: jnp.zeros(x.shape[1:]), jt)
    got = tpar.hierarchical_weighted_mean(tt, torch.from_numpy(w), groups,
                                          fb_t)
    want = _flat(gspmd.hierarchical_weighted_mean(jt, jnp.asarray(w),
                                                  groups, fallback=fb_j))
    flat_mean = tpar.masked_weighted_mean(tt, torch.from_numpy(w), fb_t)
    for p, x in want.items():
        np.testing.assert_allclose(got[p].numpy(), x.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=p)
        np.testing.assert_allclose(got[p].numpy(), flat_mean[p].numpy(),
                                   rtol=1e-6, atol=1e-7)
    # one group (the port's one card) is the flat masked mean exactly
    one = tpar.make_aggregator("mean", hierarchical_groups=1)(
        tt, torch.from_numpy(w), fb_t)
    for p in tt:
        assert torch.equal(one[p], flat_mean[p])


def _uniforms(key):
    def draw(i, shape, device):
        u = jax.random.uniform(jax.random.fold_in(key, i), shape)
        return torch.from_numpy(np.array(u)).to(device)
    return draw


@pytest.mark.parametrize("name,head", [("tiny-llama", "classifier"),
                                       ("tiny-llama", "lm"),
                                       ("tiny-bert", "classifier")])
def test_int8_topk_payload_over_adapter_tree_bit_identical(name, head):
    _, _, adp, _, tt = _pair(name, head)
    C = 3
    rng = np.random.default_rng(7)
    delta_j = jax.tree.map(
        lambda x: jnp.asarray((rng.standard_normal((C,) + x.shape)
                               * 1e-3).astype(np.float32)), adp)
    delta_t = convert.from_flax_adapters(jax.tree.map(np.asarray, delta_j))
    assert list(delta_t) == [jcc._path_name(p) for p, _ in
                             jax.tree_util.tree_flatten_with_path(delta_j)[0]]
    comp_j = jcc.CompressionConfig(kind="int8+topk")
    comp_t = tcc.CompressionConfig(kind="int8+topk")
    key = jax.random.key(9)
    p_j = jcc.encode_tree(comp_j, delta_j, key)
    p_t = tcc.encode_tree(comp_t, delta_t, _uniforms(key))
    # the port's payload follows its tree's (JAX's flatten) order; JAX
    # returns its payload dict from a traced function, key-sorted
    assert list(p_t) == list(delta_t) and set(p_t) == set(p_j)
    for path, parts in p_j.items():
        assert set(p_t[path]) == set(parts), path
        for part, x in parts.items():
            a, b = p_t[path][part].numpy(), np.asarray(x)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(
                a.view(np.int32) if a.dtype == np.float32 else a,
                b.view(np.int32) if b.dtype == np.float32 else b,
                err_msg=f"{path}/{part}")
    assert (tcc.payload_nbytes(comp_t, tt)
            == jcc.payload_nbytes(comp_j, adp))
