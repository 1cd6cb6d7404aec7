"""The port's ledger fork and state-commitment API
(``bcfl_tpu_torch/ledger/ledger.py``) against the JAX ledger: the same
forked pair of chains built in both packages from numpy-seeded trees, then
``fork_point``, ``verify_segment`` on tampered rows, ``merge_rows``,
``adopt_merge``, ``commit_state`` and ``find_state_commitment``, each held
to JAX's rows, heads and merged segments byte for byte (they cross the
wire between peers). Mirrors ``tests/test_ledger.py``'s fork tests."""

import json

import numpy as np
import pytest
import torch

from bcfl_tpu.ledger import ledger as jl
from bcfl_tpu_torch.ledger import ledger as tl


def _tree(i: int):
    rng = np.random.default_rng(i)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


def _ttree(i: int):
    return {k: torch.from_numpy(v) for k, v in _tree(i).items()}


def _forked_pair(mod, tree, prefix=3, k=2):
    """Two chains sharing ``prefix`` entries, then each extended with ``k``
    entries of its own component."""
    a = mod.Ledger()
    for i in range(prefix):
        a.append(0, i, tree(i))
    b = mod.Ledger.from_json(a.to_json())
    for i in range(k):
        a.append(1 + i, 0, tree(100 + i))
        b.append(1 + i, 1, tree(200 + i))
    return a, b


@pytest.fixture
def pairs():
    return (_forked_pair(jl, _tree, k=3), _forked_pair(tl, _ttree, k=3))


def test_forked_chains_equal_jax_and_fork_point(pairs):
    (ja, jb), (ta, tb) = pairs
    assert ta.to_json() == ja.to_json() and tb.to_json() == jb.to_json()
    assert ta.head != tb.head
    for mine, theirs, jm, jt in ((ta, tb, ja, jb), (tb, ta, jb, ja)):
        assert mine.fork_point(theirs.heads) == jm.fork_point(jt.heads) == 3
    assert ta.fork_point(ta.heads) == len(ta)
    assert tl.Ledger().fork_point(ta.heads) == 0


def test_merge_and_adopt_reach_jax_consensus_head(pairs):
    (ja, jb), (ta, tb) = pairs
    fork = ta.fork_point(tb.heads)
    for seg_a, seg_b in ((ta.segment(fork), tb.segment(fork)),
                         (tb.segment(fork), ta.segment(fork))):
        merged = tl.Ledger.merge_rows(seg_a, seg_b)
        want = jl.Ledger.merge_rows(ja.segment(fork), jb.segment(fork))
        assert json.dumps(merged) == json.dumps(want)
    merged = tl.Ledger.merge_rows(ta.segment(fork), tb.segment(fork))
    assert len(merged) == 6
    jmerged = jl.Ledger.merge_rows(ja.segment(fork), jb.segment(fork))
    for t, j in ((ta, ja), (tb, jb)):
        t.adopt_merge(fork, merged)
        j.adopt_merge(fork, jmerged)
        assert t.to_json() == j.to_json()
        assert t.verify_chain() == -1
    assert ta.head == tb.head == ja.head
    with pytest.raises(ValueError):
        tl.Ledger().adopt_merge(1, merged)


@pytest.mark.parametrize("field,index,value", [
    ("digest", 1, "ff" * 32), ("head", 0, "ee" * 32),
    ("round", 2, 99), ("payload_bytes", 1, 7), ("client", 0, 5)])
def test_verify_segment_on_tampered_rows_equals_jax(pairs, field, index,
                                                    value):
    (ja, jb), (ta, tb) = pairs
    fork = ta.fork_point(tb.heads)
    seg = tb.segment(fork)
    bad = [dict(r) for r in seg]
    bad[index][field] = value
    got = tl.Ledger.verify_segment(ta.head_at(fork), bad)
    assert got == jl.Ledger.verify_segment(ja.head_at(fork), bad) == index
    assert tl.Ledger.verify_segment(ta.head_at(fork), seg) == -1
    # the native core and hashlib agree
    assert tl.Ledger.verify_segment(ta.head_at(fork), bad,
                                    use_native=False) == index


def test_merge_rows_deterministic_dedup_and_digest_ties():
    (ja, jb), (ta, tb) = (_forked_pair(jl, _tree), _forked_pair(tl, _ttree))
    fork = ta.fork_point(tb.heads)
    sa, sb = ta.segment(fork), tb.segment(fork)
    strip = lambda rows: [  # noqa: E731
        {k: v for k, v in r.items() if k != "head"} for r in rows]
    assert strip(tl.Ledger.merge_rows(sa, sb)) == strip(
        tl.Ledger.merge_rows(sb, sa))
    for segs in ((sa, sa), (sa, sb, sa), (sb,)):
        assert tl.Ledger.merge_rows(*segs) == jl.Ledger.merge_rows(*segs)
    a = {"round": 1, "client": 0, "digest": "ab" * 32,
         "payload_bytes": 10, "head": "00" * 32}
    b = dict(a, payload_bytes=20)
    c = dict(a, digest="aa" * 32, payload_bytes=30)
    for order in (([a], [b, c]), ([c, b], [a]), ([b], [a], [c])):
        got = tl.Ledger.merge_rows(*order)
        assert got == jl.Ledger.merge_rows(*order)
        assert [r["payload_bytes"] for r in got] == [30, 10, 20]


def test_commit_state_and_find_commitment_equal_jax():
    rng = np.random.default_rng(7)
    model = {"enc/w": rng.normal(size=(8, 4)).astype(np.float32),
             "enc/b": rng.normal(size=(4,)).astype(np.float32)}
    tmodel = {k: torch.from_numpy(v) for k, v in model.items()}
    j, t = jl.Ledger(), tl.Ledger()
    for led in (j, t):
        for i in range(4):
            led.append_digest(i, i % 2, bytes([i + 1]) * 32, 64)
    # the state digest the server commits: the port's over torch tensors
    # under "/"-joined names equals JAX's over the nested tree
    nested = {"enc": {"w": model["enc/w"], "b": model["enc/b"]}}
    digest = tl.params_digest(tmodel)
    assert digest == jl.params_digest(nested)
    assert digest == tl.params_digest(tmodel, use_native=False)
    for version, peer in ((3, 0), (3, 2), (5, 0)):
        t.commit_state(version, peer, digest)
        j.commit_state(version, peer, digest)
    assert t.to_json() == j.to_json()
    assert t.entries[-1].client == tl.sync_row_client(0) == -2000
    assert tl.sync_row_client(2) == jl.sync_row_client(2) == -2002
    rows = t.segment(0)
    for version, peer in ((3, 0), (3, 2), (5, 0), (4, 0), (3, 1)):
        assert (tl.Ledger.find_state_commitment(rows, version, peer)
                == jl.Ledger.find_state_commitment(rows, version, peer))
    assert tl.Ledger.find_state_commitment(rows, 3, 0) == digest
    assert tl.Ledger.find_state_commitment(rows, 4, 0) is None
    # the newest match wins
    other = bytes(32)
    t.commit_state(3, 0, other)
    assert tl.Ledger.find_state_commitment(t.segment(0), 3, 0) == other
    with pytest.raises(ValueError, match="32 bytes"):
        t.commit_state(1, 0, b"short")
