"""PyTorch port (``bcfl_tpu_torch``): the hash-chained ledger and the
device-side fingerprint against the JAX package.

- bit for bit (JAX with ``use_native=False``, its hashlib route):
  ``chain_extend``, ``params_digest`` (float32, bfloat16, int8 and int32
  leaves), ``struct_digest`` of a stacked tiny-bert tree and of its
  ``int8+topk`` payload, ``entry_digest`` of given rows, the ledger's heads
  and JSON, and the ``[256, 4]`` projection the port keeps as a constant;
- ``client_fingerprint`` and ``tree_fingerprint`` of the same stacked tree
  and of the same payload: float32 sums in another order, so held at
  ``rtol = 1e-5`` plus ``atol = 1e-6 * max|fingerprint|`` (the largest
  relative error seen is 3e-6);
- inside the port: append, a tampered entry located by index, digest and
  tree authentication, JSON round trip, payload accounting; and the
  engine's ``_ledger_verify`` on a payload against a copy with ONE element
  changed authenticates every client but that one.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu.ledger import fingerprint as jfp
from bcfl_tpu.ledger import ledger as jled
from bcfl_tpu.models import build as jbuild
from bcfl_tpu_torch.compression import codecs as tcc
from bcfl_tpu_torch.config import FedConfig, LedgerConfig, PartitionConfig
from bcfl_tpu_torch.fed.engine import FedEngine
from bcfl_tpu_torch.ledger import fingerprint as tfp
from bcfl_tpu_torch.ledger import ledger as tled

RTOL = 1e-5
ATOL_OF_MAX = 1e-6


def _stacked_tiny_bert(C=3, seed=0, scale=0.02):
    """A stacked [C, ...] tree shaped like tiny-bert's flax params: the
    nested JAX form and the port's ``{path: tensor}`` form."""
    model = jbuild("tiny-bert", num_labels=2, vocab_size=512)
    ids = jnp.ones((1, 8), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), ids, ids)["params"]
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves, flat_t = [], {}
    for path, s in flat:
        x = (rng.standard_normal((C,) + s.shape) * scale).astype(np.float32)
        leaves.append(jnp.asarray(x))
        flat_t[jcc._path_name(path)] = torch.from_numpy(x)
    return jax.tree_util.tree_unflatten(treedef, leaves), flat_t


def _payloads(tree_j, tree_t):
    comp_j = jcc.CompressionConfig(kind="int8+topk", chunk=64, topk_frac=0.1)
    comp_t = tcc.CompressionConfig(kind="int8+topk", chunk=64, topk_frac=0.1)
    key = jax.random.key(5)

    def draw(i, shape, device):
        u = jax.random.uniform(jax.random.fold_in(key, i), shape)
        return torch.from_numpy(np.array(u)).to(device)

    return (jcc.encode_tree(comp_j, tree_j, key),
            tcc.encode_tree(comp_t, tree_t, draw))


def test_projection_constant_is_jax_bit_for_bit():
    want = np.asarray(jfp._projection(tfp.K))
    got = tfp.projection().numpy()
    assert got.dtype == np.float32 and got.shape == (2 * tfp.LANES, tfp.K)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match="projection"):
        tfp.projection(8)


def test_chain_extend_and_entry_digest_match_jax():
    rng = np.random.default_rng(1)
    prev = tled.GENESIS
    for n in (0, 1, 40, 1000):
        payload = rng.bytes(n)
        got = tled.chain_extend(prev, payload)
        assert got == jled.chain_extend(prev, payload, use_native=False)
        prev = got
    struct = bytes(range(32))
    for row in (np.zeros(4, np.float32), rng.standard_normal(4),
                np.array([np.nan, -0.0, np.inf, 1e-30], np.float32)):
        assert (tfp.entry_digest(struct, row)
                == jfp.entry_digest(struct, row, use_native=False))
        assert (tfp.entry_digest(struct, torch.as_tensor(row))
                == jfp.entry_digest(struct, row, use_native=False))


def test_params_digest_matches_jax_for_every_dtype():
    rng = np.random.default_rng(2)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i8 = rng.integers(-127, 128, (2, 7)).astype(np.int8)
    i32 = rng.integers(0, 1 << 30, (4,)).astype(np.int32)
    bf = jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16)
    tree_j = {"b": {"kernel": f32, "q": i8}, "a": {"i": i32, "w": bf}}
    tree_t = {"b/kernel": torch.from_numpy(f32), "b/q": torch.from_numpy(i8),
              "a/i": torch.from_numpy(i32),
              "a/w": torch.from_numpy(np.array(bf).view(np.int16)).view(
                  torch.bfloat16)}
    assert (tled.params_digest(tree_t)
            == jled.params_digest(tree_j, use_native=False))
    # numpy leaves digest the same
    assert tled.params_digest({k: v.numpy() if v.dtype != torch.bfloat16
                               else v for k, v in tree_t.items()}) \
        == tled.params_digest(tree_t)


def test_struct_digest_of_a_tree_and_of_its_payload_matches_jax():
    tree_j, tree_t = _stacked_tiny_bert()
    assert (tfp.struct_digest(tree_t)
            == jfp.struct_digest(tree_j, use_native=False))
    pj, pt = _payloads(tree_j, tree_t)
    assert tfp.struct_digest(pt) == jfp.struct_digest(pj, use_native=False)
    bf = {p: x.to(torch.bfloat16) for p, x in tree_t.items()}
    bj = jax.tree.map(lambda x: x.astype(jnp.bfloat16), tree_j)
    assert tfp.struct_digest(bf) == jfp.struct_digest(bj, use_native=False)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * np.abs(want).max())


def test_client_fingerprint_matches_jax_within_float32_order(monkeypatch):
    tree_j, tree_t = _stacked_tiny_bert()
    want = jfp.client_fingerprint(tree_j)
    _close(tfp.client_fingerprint(tree_t), want)
    # folded a few leaves per product instead of all at once
    with monkeypatch.context() as m:
        m.setattr(tfp, "_FOLD_BATCH", 3000)
        _close(tfp.client_fingerprint(tree_t), want)
    one_j = jax.tree.map(lambda x: x[1], tree_j)
    one_t = {p: x[1] for p, x in tree_t.items()}
    _close(tfp.tree_fingerprint(one_t), jfp.tree_fingerprint(one_j))
    pj, pt = _payloads(tree_j, tree_t)
    _close(tfp.client_fingerprint(pt), jfp.client_fingerprint(pj))
    # deterministic, and one changed element moves every lane of its row
    again = tfp.client_fingerprint(copy.deepcopy(tree_t))
    assert torch.equal(again, tfp.client_fingerprint(tree_t))
    p = max(tree_t, key=lambda q: tree_t[q][0].numel())
    tree_t[p][2].view(-1)[300] += 1e-3
    moved = tfp.client_fingerprint(tree_t)
    assert torch.equal(moved[:2], again[:2])
    assert bool((moved[2] != again[2]).all())
    with pytest.raises(ValueError, match="empty tree"):
        tfp.client_fingerprint({})


def test_ledger_chain_matches_jax_and_locates_tampering():
    rng = np.random.default_rng(3)
    jl, tl = jled.Ledger(use_native=False), tled.Ledger()
    digests = [rng.bytes(32) for _ in range(6)]
    for i, d in enumerate(digests):
        jl.append_digest(i // 3, i % 3, d, 1000 + i)
        tl.append_digest(i // 3, i % 3, d, 1000 + i)
    assert tl.heads == jl.heads and tl.head == jl.head and len(tl) == 6
    assert tl.to_json() == jl.to_json()
    assert tl.payload_accounting() == jl.payload_accounting()
    assert tl.verify_chain() == -1
    back = tled.Ledger.from_json(tl.to_json())
    assert back.heads == tl.heads and back.entries == tl.entries
    assert back.verify_chain() == -1
    assert tl.authenticate_digest(1, 2, digests[5])
    assert not tl.authenticate_digest(1, 2, digests[4])
    assert not tl.authenticate_digest(7, 0, digests[0])  # never committed
    # rewrite entry 4: verification names exactly that link
    e = back.entries[4]
    back.entries[4] = tled.LedgerEntry(e.round, e.client, digests[0],
                                       e.payload_bytes)
    assert back.verify_chain() == 4
    # the tree path: append digests the tree, authenticate re-digests it
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    entry = tl.append(2, 0, tree)
    assert entry.payload_bytes == 24
    assert tl.authenticate(2, 0, tree)
    assert not tl.authenticate(2, 0, {"w": tree["w"] + 1})


def _tiny_engine():
    cfg = FedConfig(dataset="synthetic", model="tiny-bert", num_clients=3,
                    num_rounds=1, seq_len=16, batch_size=4,
                    max_local_batches=1, vocab_size=512, mode="serverless",
                    partition=PartitionConfig(kind="iid", iid_samples=4),
                    ledger=LedgerConfig(enabled=True),
                    compression=tcc.CompressionConfig(kind="int8+topk"))
    return FedEngine(cfg, device="cpu")


@pytest.mark.parametrize("part", ["q", "s", "i"])
def test_tampered_payload_fails_auth_for_exactly_its_client(part):
    eng = _tiny_engine()
    rng = np.random.default_rng(4)
    delta = {p: torch.from_numpy(
        rng.standard_normal((3,) + tuple(x.shape)).astype(np.float32) * 1e-3)
        for p, x in eng.trainable0.items()}
    payload = tcc.encode_tree(eng._comp, delta, eng._uniforms(0))
    sent = {p: {k: v.clone() for k, v in parts.items()}
            for p, parts in payload.items()}
    leaf = sorted(sent)[len(sent) // 2]
    # one code, one index, or one scale moved by 1: the fingerprint folds
    # the int32 indices too, so its sums run to ~1e6 and a change far below
    # one float32 ulp of them would not register (the JAX fingerprint's
    # cooperative-audit caveat)
    sent[leaf][part][1].view(-1)[0] += 1
    # a clean round authenticates every client
    assert eng._ledger_verify(0, payload, kind="payload").tolist() == [1.0] * 3
    auth = eng._ledger_verify(1, payload, sent=sent, kind="payload")
    assert auth.tolist() == [1.0, 0.0, 1.0]
    assert eng.ledger.verify_chain() == -1 and len(eng.ledger) == 6
