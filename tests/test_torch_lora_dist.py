"""LoRA adapters and Llama over the port's dist runtime
(``bcfl_tpu_torch/dist``), against the JAX package.

On numpy-seeded adapter trees (JAX's ``init_lora`` layout, every leaf
drawn from a seeded generator) and residuals:

- the ``int8+topk`` exchange with error feedback (``roundtrip``): payload,
  decoded delta and the new residual bit for bit, the update frame bytes
  bit for bit, and ``payload_nbytes`` equal;
- the frames that carry a tree in its own layout (the leader's broadcast
  of the global adapter, the uncompressed stacked update, a full
  parameter tree) bit for bit once the port's flat tree takes JAX's
  nesting (``wire.to_wire``, as the runtime's transport sends it), and
  read back to the port's tree, also across a JAX and a port transport;
- the ledger fingerprint rows of the payload at rtol 1e-5 (plus 1e-6 of
  the largest row, ``tests/test_torch_ledger.py``'s contract: float32
  sums in another order),
  its structure digest bit for bit;
- ``lora.effective_rank`` at rtol 1e-5;
- gossip's ``merge_states`` and ``state_digest`` on adapter trees bit for
  bit;
- the capability rows and constructions of the LoRA and Llama dist
  configurations equal to JAX's, and the peer config's JSON round trip.

Then the peers themselves, fresh interpreters over loopback TCP on the
CPU: the frozen base two peers build from the seed equal through a
digest; JAX's ``test_dist_loopback_lora_adapter_exchange`` (3 peers,
``tiny-bert``, rank 2, ``trimmed_mean``, ``buffer=3``, the ledger) with
its gates and ``effective_rank`` on every merge; 2 ``tiny-llama`` LoRA
peers with ``int8+topk`` and the ledger watched live by the ``monitor``
subcommand; a LoRA peer SIGKILLed and resumed with its adapter and
residual restored bit for bit; 3 gossip peers over adapters; and the
CLI's ``--lora-rank``, ``--fused-tamper`` and telemetry flags.
"""

import hashlib
import json
import math
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcfl_tpu import config as jconfig
from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu.dist import gossip as jg
from bcfl_tpu.dist import wire as jw
from bcfl_tpu.dist.launch import cfg_from_json as jfrom, cfg_to_json as jto
from bcfl_tpu.ledger import fingerprint as jfp
from bcfl_tpu.models import build as jbuild, lora as jlora
from bcfl_tpu.models import lora_targets as jtargets
from bcfl_tpu_torch import config as tconfig
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.compression import codecs as tcc
from bcfl_tpu_torch.dist import gossip as tg
from bcfl_tpu_torch.dist import wire as tw
from bcfl_tpu_torch.dist.launch import cfg_from_json, cfg_to_json
from bcfl_tpu_torch.ledger import fingerprint as tfp
from bcfl_tpu_torch.ledger import ledger as tl
from bcfl_tpu_torch.models import convert, lora

pytestmark = pytest.mark.dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
ATOL_OF_MAX = 1e-6
HEADER = {"type": "update", "base_version": 2, "round": 3,
          "wire_kind": "int8+topk", "n_ex": [8, 8], "digests": None}


# ------------------------------------------------------- seeded adapters


def _template(name, head, rank):
    """JAX's adapter tree of ``name`` at ``rank`` (``init_lora`` over the
    flax params), as shapes."""
    jm = jbuild(name, head=head, num_labels=3, vocab_size=256,
                dtype=jnp.float32)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jax.eval_shape(jm.init, jax.random.key(0), ids, ids)["params"]
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), params)
    return jlora.init_lora(jax.random.key(1), params, rank,
                           targets=jtargets(name)), params


def _seeded(template, seed, scale, lead=()):
    """A tree shaped like ``template`` (leading dims ``lead``) drawn from
    numpy: JAX's nested form and the port's flat form."""
    rng = np.random.default_rng(seed)
    j = jax.tree.map(lambda x: (rng.standard_normal(lead + x.shape)
                                * scale).astype(np.float32), template)
    return j, convert.from_flax_adapters(j)


CASES = [("tiny-llama", "classifier"), ("tiny-llama", "lm"),
         ("tiny-bert", "classifier")]


def _uniforms(key):
    def draw(i, shape, device):
        u = jax.random.uniform(jax.random.fold_in(key, i), shape)
        return torch.from_numpy(np.array(u)).to(device)
    return draw


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name,head", CASES, ids=[f"{n}-{h}" for n, h in CASES])
def test_adapter_update_exchange_and_frame_equal_jax(name, head):
    """One peer's update: the ``int8+topk`` exchange of a 2-client slice's
    adapter deltas with the carried residual, then the update frame."""
    adp, _ = _template(name, head, 4)
    delta_j, delta_t = _seeded(adp, 11, 1e-3, lead=(2,))
    resid_j, resid_t = _seeded(adp, 12, 1e-4, lead=(2,))
    assert list(delta_t) == [jcc._path_name(p) for p, _ in
                             jax.tree_util.tree_flatten_with_path(delta_j)[0]]
    comp_j = jcc.CompressionConfig(kind="int8+topk")
    comp_t = tcc.CompressionConfig(kind="int8+topk")
    key = jax.random.key(21)
    p_j, dec_j, res_j = jcc.roundtrip(comp_j, delta_j, resid_j, key)
    p_t, dec_t, res_t = tcc.roundtrip(comp_t, delta_t, resid_t,
                                      _uniforms(key))
    assert set(p_t) == set(p_j)
    for path, parts in p_j.items():
        assert set(p_t[path]) == set(parts), path
        for part, x in parts.items():
            got = p_t[path][part].numpy()
            assert got.dtype == np.asarray(x).dtype, (path, part)
            np.testing.assert_array_equal(_bits(got), _bits(x),
                                          err_msg=f"{path}/{part}")
    for want, got in ((dec_j, dec_t), (res_j, res_t)):
        flat = convert.from_flax_adapters(jax.tree.map(np.asarray, want))
        for p, x in flat.items():
            np.testing.assert_array_equal(_bits(got[p].numpy()), _bits(x),
                                          err_msg=p)
    # the frame a follower sends its leader, bit for bit
    frame_t = tw.pack_frame(HEADER, {"payload": p_t})
    assert frame_t == jw.pack_frame(
        HEADER, {"payload": jax.tree.map(np.asarray, p_j)})
    one_t = {p: x[0] for p, x in delta_t.items()}
    assert (tcc.payload_nbytes(comp_t, one_t)
            == jcc.payload_nbytes(comp_j, jax.tree.map(lambda x: x[0],
                                                       delta_j)))
    assert tcc.payload_tensor_nbytes(p_t) == 2 * tcc.payload_nbytes(
        comp_t, one_t)
    # read back through the port's wire, key for key
    back = tw.unpack_frame(frame_t[tw.PREFIX_LEN:])[1]["payload"]
    for path, parts in p_t.items():
        for part, x in parts.items():
            assert torch.equal(back[path][part], x), (path, part)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize("name,head", CASES, ids=[f"{n}-{h}" for n, h in CASES])
def test_adapter_fingerprint_rows_equal_jax(name, head):
    """What the ledger commits for a slice's adapter payload and for the
    raw stacked adapter tree: the per-client fingerprint rows at the
    ledger tests' tolerance, the structure digest bit for bit."""
    adp, _ = _template(name, head, 4)
    delta_j, delta_t = _seeded(adp, 31, 1e-3, lead=(3,))
    key = jax.random.key(5)
    p_j = jcc.encode_tree(jcc.CompressionConfig(kind="int8+topk"),
                          delta_j, key)
    p_t = tcc.encode_tree(tcc.CompressionConfig(kind="int8+topk"), delta_t,
                          _uniforms(key))
    _close(tfp.client_fingerprint(p_t), jfp.client_fingerprint(p_j))
    _close(tfp.client_fingerprint(delta_t), jfp.client_fingerprint(delta_j))
    assert tfp.struct_digest(p_t, use_native=False) == jfp.struct_digest(
        p_j, use_native=False)
    assert tfp.struct_digest(delta_t, use_native=False) == \
        jfp.struct_digest(delta_j, use_native=False)


@pytest.mark.parametrize("name,head", CASES, ids=[f"{n}-{h}" for n, h in CASES])
def test_model_frames_take_jax_layout(name, head):
    """The leader's broadcast of the global adapter, an uncompressed
    stacked adapter update and a full parameter tree: the port's flat tree
    through ``wire.to_wire`` writes JAX's frame bytes, and ``from_wire``
    reads it back to the port's tree in JAX's flatten order; a codec
    payload crosses as it is."""
    adp, params = _template(name, head, 4)
    glob_j, glob_t = _seeded(adp, 41, 0.02)
    header = {"type": "global", "version": 3, "healed": False,
              "chain": None}
    frame = tw.pack_frame(header, tw.to_wire(header, {"model": glob_t},
                                             adapters=True))
    assert frame == jw.pack_frame(header, {"model": glob_j})
    back = tw.from_wire(header, tw.unpack_frame(
        frame[tw.PREFIX_LEN:])[1])["model"]
    assert list(back) == list(glob_t)
    assert all(torch.equal(back[p], glob_t[p]) for p in glob_t)
    stacked = dict(HEADER, wire_kind="stacked")
    st_j, st_t = _seeded(adp, 42, 0.02, lead=(2,))
    assert tw.pack_frame(stacked, tw.to_wire(
        stacked, {"payload": st_t}, adapters=True)) == \
        jw.pack_frame(stacked, {"payload": st_j})
    rng = np.random.default_rng(43)
    full_j = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    full_t = {jcc._path_name(p): torch.from_numpy(x) for p, x in
              jax.tree_util.tree_flatten_with_path(full_j)[0]}
    frame = tw.pack_frame(header, tw.to_wire(header, {"model": full_t},
                                             adapters=False))
    assert frame == jw.pack_frame(header, {"model": full_j})
    back = tw.from_wire(header, tw.unpack_frame(
        frame[tw.PREFIX_LEN:])[1])["model"]
    assert list(back) == list(full_t)
    coded = dict(HEADER, wire_kind="payload")
    p_t = tcc.encode_tree(tcc.CompressionConfig(kind="int8+topk"),
                          st_t, _uniforms(jax.random.key(7)))
    assert tw.to_wire(coded, {"payload": p_t}, adapters=True) == \
        {"payload": p_t}
    assert tw.from_wire(coded, {"payload": p_t}) == {"payload": p_t}


def test_port_transport_sends_and_reads_adapters_in_jax_frames():
    """The runtime's transport (``adapters=True``) against JAX's over
    loopback: the port's flat global adapter arrives at JAX as JAX's
    nested tree bit for bit, and JAX's nested tree arrives at the port
    flat."""
    from bcfl_tpu.config import DistConfig as JDist
    from bcfl_tpu.dist import transport as jt
    from bcfl_tpu.dist.harness import free_ports
    from bcfl_tpu_torch.config import DistConfig
    from bcfl_tpu_torch.dist import transport as tt

    adp, _ = _template("tiny-llama", "classifier", 4)
    glob_j, glob_t = _seeded(adp, 44, 0.02)
    pol = dict(send_deadline_s=10.0, retry_base_s=0.01, retry_max_s=0.05)
    addrs = [("127.0.0.1", p) for p in free_ports(2)]
    j = jt.PeerTransport(0, addrs, policy=JDist(**pol), epoch=1)
    t = tt.PeerTransport(1, addrs, policy=DistConfig(**pol), epoch=1,
                         adapters=True)
    j.start()
    t.start()

    def recv(tr):
        for _ in range(200):
            msg = tr.recv(timeout_s=0.1)
            if msg is not None:
                return msg
        raise AssertionError("no frame arrived")

    try:
        header = {"type": "global", "version": 1, "healed": False}
        assert t.send(0, header, {"model": glob_t})
        got = recv(j)[1]["model"]
        assert jax.tree.structure(got) == jax.tree.structure(glob_j)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(glob_j)):
            assert np.asarray(a).tobytes() == b.tobytes()
        assert j.send(1, header, {"model": glob_j})
        back = recv(t)[1]["model"]
        assert list(back) == list(glob_t)
        assert all(torch.equal(back[p], glob_t[p]) for p in glob_t)
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_effective_rank_of_seeded_adapters_equals_jax(seed):
    for name, head in CASES:
        adp, _ = _template(name, head, 8)
        j, t = _seeded(adp, 50 + seed, 0.1)
        np.testing.assert_allclose(float(lora.effective_rank(t)),
                                   float(jlora.effective_rank(j)),
                                   rtol=RTOL, err_msg=name)
    # the round-0 adapters (b = 0) carry no energy: rank 0 in both
    adp, _ = _template("tiny-llama", "classifier", 8)
    zero = jax.tree.map(np.asarray, adp)
    assert float(lora.effective_rank(convert.from_flax_adapters(zero))) \
        == float(jlora.effective_rank(zero)) == 0.0


@pytest.mark.parametrize("n_items", [2, 3])
def test_gossip_merge_states_on_adapters_bit_identical(n_items):
    adp, _ = _template("tiny-llama", "classifier", 4)
    vvs = [[3, 1, 0], [2, 2, 0], [1, 1, 2]]
    items_j, items_t = [], []
    for i in range(n_items):
        j, t = _seeded(adp, 60 + i, 0.05)
        base = {"peer": i, "order": (i, 0), "vv": np.asarray(vvs[i], np.int64),
                "mass": 1.0 + i, "trust": 1.0 - 0.1 * i}
        items_j.append(dict(base, state=j))
        items_t.append(dict(base, state=t))
        assert tg.state_digest(t) == jg.state_digest(j)
    j_state, j_vv, j_w = jg.merge_states(items_j, decay=0.9)
    t_state, t_vv, t_w = tg.merge_states(items_t, decay=0.9)
    np.testing.assert_array_equal(t_vv, j_vv)
    assert t_w == j_w
    want = convert.from_flax_adapters(jax.tree.map(np.asarray, j_state))
    assert set(t_state) == set(want)
    for p, x in want.items():
        assert t_state[p].numpy().tobytes() == x.numpy().tobytes(), p
    assert tg.state_digest(t_state) == jg.state_digest(j_state)


# -------------------------------------------------- configuration rows


LORA_CFGS = [
    ("lora", dict(lora_rank=2)),
    ("lora_uniform_spec", dict(lora_ranks="4,4")),
    ("lora_hetero", dict(lora_ranks="2,4")),
    ("llama_lora_causal", dict(model="tiny-llama", task="causal_lm",
                               lora_rank=4)),
    ("llama_full", dict(model="tiny-llama")),
    ("llama_lora_flash_remat", dict(model="tiny-llama", lora_rank=8,
                                    use_flash=True, remat=True,
                                    compute_dtype="bfloat16")),
    ("lora_registry", dict(lora_rank=2, registry_size=16, sample_clients=4)),
    ("lora_trimmed_mean", dict(lora_rank=2, aggregator="trimmed_mean",
                               dist={"buffer": 4})),
    ("lora_gossip", dict(lora_rank=2, dist={"dispatch": "gossip"})),
    ("lora_gossip_codec", dict(lora_rank=2, dist={"dispatch": "gossip"},
                               compression="int8+topk")),
]


@pytest.mark.parametrize("runtime_", ["dist", "local"])
@pytest.mark.parametrize("name,over", LORA_CFGS, ids=[n for n, _ in LORA_CFGS])
def test_lora_configs_construct_or_refuse_and_rows_equal_jax(name, over,
                                                             runtime_):
    got = {}
    for pkg, mod, comp in (("port", tconfig, CompressionConfig),
                           ("jax", jconfig, jcc.CompressionConfig)):
        kw = {k: v for k, v in over.items() if k not in ("dist",
                                                          "compression")}
        dist = mod.DistConfig(peers=4, checkpoint_every_versions=0,
                              **over.get("dist", {}))
        if runtime_ == "local":
            dist = mod.DistConfig()
            kw.update(sync="sync", eval_every=1)
        try:
            cfg = mod.FedConfig(
                runtime=runtime_, num_clients=8, dist=dist,
                compression=comp(kind=over.get("compression", "none")),
                **({"sync": "async", "eval_every": 0}
                   if runtime_ == "dist" else {}), **kw)
        except ValueError as e:
            got[pkg] = str(e)
            continue
        got[pkg] = {f: (a, v) for f, a, v in mod.capability_table(cfg)}
    port, want = got["port"], got["jax"]
    if isinstance(want, str):
        assert port == want
        return
    assert not isinstance(port, str), port
    # the port leaves out the row of the field it has not
    assert set(want) - set(port) == {"buffer donation"}
    for feature, row in port.items():
        assert row == want[feature], feature


def test_lora_rows_refuse_in_jax_words():
    with pytest.raises(ValueError) as t:
        tconfig.FedConfig(runtime="dist", sync="async", eval_every=0,
                          num_clients=4, lora_ranks="2,4",
                          dist=tconfig.DistConfig(
                              peers=2, checkpoint_every_versions=0))
    with pytest.raises(ValueError) as j:
        jconfig.FedConfig(runtime="dist", sync="async", eval_every=0,
                          num_clients=4, lora_ranks="2,4",
                          dist=jconfig.DistConfig(
                              peers=2, checkpoint_every_versions=0))
    assert str(t.value) == str(j.value)
    assert "heterogeneous LoRA ranks is not supported on runtime='dist'" \
        in str(t.value)


JSON_CFGS = [
    ("lora_rank", dict(lora_rank=2, compression="topk")),
    ("llama", dict(model="tiny-llama", task="causal_lm", lora_rank=4,
                   use_flash=True, remat=True, param_dtype="bfloat16",
                   compute_dtype="bfloat16", compression="int8+topk",
                   max_eval_batches=2, vocab_size=512)),
    ("lora_ranks", dict(lora_ranks="4,4")),
]


@pytest.mark.parametrize("name,over", JSON_CFGS, ids=[n for n, _ in JSON_CFGS])
def test_peer_config_json_round_trip(name, over):
    """``lora_rank``, ``lora_ranks``, ``task`` and the Llama fields cross
    to a peer process intact. JAX's rebuild refuses a ``lora_ranks``
    config (its canonicalized ``lora_rank`` travels back beside the spec);
    the port's resets it, so a uniform spec reaches its peers."""
    cfgs = {}
    for pkg, mod, comp in (("port", tconfig, CompressionConfig),
                           ("jax", jconfig, jcc.CompressionConfig)):
        kw = dict(over, compression=comp(kind=over.get("compression",
                                                       "none")))
        cfgs[pkg] = mod.FedConfig(
            runtime="dist", sync="async", eval_every=0, num_clients=4,
            ledger=mod.LedgerConfig(enabled=True),
            dist=mod.DistConfig(peers=2, checkpoint_every_versions=0), **kw)
    cfg = cfgs["port"]
    assert cfg_from_json(cfg_to_json(cfg)) == cfg
    assert json.loads(cfg_to_json(cfg))["lora_rank"] == json.loads(
        jto(cfgs["jax"]))["lora_rank"]
    if name == "lora_ranks":
        with pytest.raises(ValueError, match="not both"):
            jfrom(jto(cfgs["jax"]))
    else:
        assert jfrom(jto(cfgs["jax"])) == cfgs["jax"]


# ------------------------------------------------------------ the peers

_BASE_DIGEST = """
import hashlib, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
# process state a peer may carry before its engine is built: the global
# generators must not reach the frozen base
torch.manual_seed(int(sys.argv[2]))
np.random.seed(int(sys.argv[2]))
from bcfl_tpu_torch.dist.launch import cfg_from_json
from bcfl_tpu_torch.dist.runtime import _peer_engine_cfg
from bcfl_tpu_torch.fed.engine import FedEngine
cfg = cfg_from_json(open(sys.argv[1]).read())
k = cfg.num_clients // cfg.dist.peers
peer = int(sys.argv[3])
eng = FedEngine(_peer_engine_cfg(cfg, k), device="cpu",
                client_ids=np.arange(peer * k, (peer + 1) * k))
h = hashlib.sha256()
for name, x in eng.model.state_dict().items():
    if "lora" in name:
        continue
    h.update(name.encode())
    h.update(x.detach().contiguous().view(-1).view(torch.uint8).numpy())
a = hashlib.sha256()
for name, x in eng.trainable0.items():
    a.update(name.encode())
    a.update(x.detach().contiguous().view(-1).view(torch.uint8).numpy())
print(h.hexdigest(), a.hexdigest())
"""


def _llama_cfg(**kw):
    base = dict(
        name="dist_llama_lora", runtime="dist", mode="server", sync="async",
        model="tiny-llama", task="causal_lm", lora_rank=4, dataset="synthetic",
        vocab_size=512, num_clients=4, num_rounds=3, seq_len=16,
        batch_size=4, max_local_batches=2, eval_every=0, seed=42,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        compression=CompressionConfig(kind="int8+topk"),
        dist=tconfig.DistConfig(peers=2, buffer=2, buffer_timeout_s=10.0,
                                idle_timeout_s=120.0, peer_deadline_s=200.0,
                                checkpoint_every_versions=1))
    base.update(kw)
    return tconfig.FedConfig(**base)


def test_frozen_base_equal_in_two_fresh_interpreters(tmp_path):
    """Two peers of one run build the same frozen base and the same
    round-0 adapters from the seed, each in its own interpreter with its
    own client slice and its own global RNG state: the ledger and the wire
    authenticate adapters only, so a base that differed between peers
    would merge adapters over different models unnoticed."""
    cfg = _llama_cfg(model="tiny-llama")
    path = tmp_path / "config.json"
    path.write_text(cfg_to_json(cfg))
    script = _BASE_DIGEST.format(repo=REPO)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = [subprocess.run([sys.executable, "-c", script, str(path), seed,
                            peer], capture_output=True, text=True,
                           timeout=300, env=env, cwd=str(tmp_path))
            for seed, peer in (("1", "0"), ("2", "1"))]
    for o in outs:
        assert o.returncode == 0, o.stderr[-3000:]
    digests = [o.stdout.split() for o in outs]
    assert digests[0] == digests[1]
    assert len(digests[0]) == 2 and all(len(d) == 64 for d in digests[0])


def _frames(col, typ):
    return [e["bytes"] for e in col["ordered"]
            if e["ev"] == "send" and e.get("ok") and e.get("type") == typ]


def test_three_peer_lora_adapter_exchange(tmp_path):
    """JAX's ``test_dist_loopback_lora_adapter_exchange`` on the port:
    3 peers, rank 2, ``trimmed_mean`` over ``buffer=3`` votes (every peer
    in every merge), the ledger. Every update frame is adapter-scale
    (under 1 MB), every chain verifies with one head, no invariant is
    violated, and every merge event carries the merged adapter's
    effective rank (0 < rank <= 2)."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate_run

    peers = (0, 1, 2)
    cfg = tconfig.FedConfig(
        name="dist_lora_smoke", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", num_clients=6, num_rounds=3,
        seq_len=16, batch_size=4, max_local_batches=2, eval_every=0,
        vocab_size=512, lora_rank=2, aggregator="trimmed_mean",
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        dist=tconfig.DistConfig(peers=3, buffer=3, buffer_timeout_s=10.0,
                                idle_timeout_s=120.0, peer_deadline_s=220.0,
                                checkpoint_every_versions=0))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=240.0,
                      device="cpu", threads=1)
    assert result["returncodes"] == {"0": 0, "1": 0, "2": 0}, \
        result["log_tails"]
    assert result["ok"], result["log_tails"]
    reports = result["reports"]
    assert all(reports[p]["final_version"] >= cfg.num_rounds for p in peers)
    assert all(reports[p]["chain_ok"] for p in peers)
    assert len({reports[p]["chain_head"] for p in peers}) == 1
    col = collate_run(result["run_dir"])
    assert col["ok"], col["violations"]
    frames = _frames(col, "update")
    assert frames, "no update frames observed"
    assert max(frames) < 1_000_000, max(frames)
    merges = [e for e in col["ordered"] if e["ev"] == "merge"]
    assert len(merges) >= cfg.num_rounds
    for m in merges:
        assert 0.0 < m["effective_rank"] <= 2.0, m
        assert m["robust"] is not None
    assert math.isfinite(reports[0]["final_eval"]["loss"])


def test_two_tiny_llama_lora_peers_watched_live(tmp_path):
    """2 ``tiny-llama`` causal-LM peers with rank-4 adapters, ``int8+topk``
    with error feedback, the ledger and a checkpoint every version, with
    the ``monitor`` subcommand watching the run directory from before the
    peers start until a stop file after they end: the gates of the card
    path (t) at tiny width."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate, read_stream

    cfg = _llama_cfg()
    run = tmp_path / "run"
    run.mkdir()
    health, summary, stop = (tmp_path / "health.jsonl",
                             tmp_path / "summary.json", tmp_path / "stop")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    mon = subprocess.Popen(
        [sys.executable, "-m", "bcfl_tpu_torch.entrypoints", "monitor",
         str(run), "--health-out", str(health), "--summary-out",
         str(summary), "--stop-file", str(stop), "--poll", "0.2",
         "--idle", "0", "--quiet"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        result = run_dist(cfg, str(run), deadline_s=220.0, device="cpu",
                          threads=1)
    finally:
        stop.write_text("")
        try:
            out, err = mon.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            mon.send_signal(signal.SIGKILL)
            out, err = mon.communicate()
    assert result["ok"], (result["returncodes"], result["log_tails"])
    reports = result["reports"]
    assert {r["chain_head"] for r in reports.values()} != {None}
    assert len({r["chain_head"] for r in reports.values()}) == 1
    assert all(r["chain_ok"] for r in reports.values())
    col = collate(result["event_streams"])
    assert col["ok"], col["violations"]
    assert mon.returncode == 0, (out, err)
    mon_sum = json.loads(summary.read_text())
    assert mon_sum["ok"] == col["ok"]
    assert mon_sum["invariants"] == col["invariants"]
    merges = [e for e in col["ordered"] if e["ev"] == "merge"]
    recs = [e for e in read_stream(str(health))[0] if e["ev"] == "health"]
    assert len(recs) == len(merges) >= cfg.num_rounds
    assert [r["round"] for r in recs] == [m["version"] for m in merges]
    for r in recs:
        assert 0.0 < r["effective_rank"] <= cfg.lora_rank, r
    # adapter-scale frames: each update is the codec payload of the
    # 2-client slice's adapter tree, plus its frame overhead
    from bcfl_tpu_torch.models import build, lora_targets

    with torch.device("meta"):
        model = build("tiny-llama", head="lm", vocab_size=cfg.vocab_size)
    adapters = lora.init_lora(None, model, cfg.lora_rank,
                              lora_targets("tiny-llama"))
    want = 2 * tcc.payload_nbytes(cfg.compression, adapters)
    ups = _frames(col, "update")
    assert ups and all(want < b < want + 64 * 1024 for b in ups), (want, ups)
    # exactly: the header JSON its send event records, then the framing
    # and index of a 2-client payload of these shapes, then that body
    stacked = {k: torch.zeros((2,) + tuple(v.shape))
               for k, v in adapters.items()}
    payload = tcc.encode_tree(cfg.compression, stacked,
                              _uniforms(jax.random.key(0)))
    assert tcc.payload_tensor_nbytes(payload) == want
    empty = len(tw.pack_frame({}, {"payload": payload})) - len(b"{}")
    sent = [(e["bytes"], e["header_bytes"]) for e in col["ordered"]
            if e["ev"] == "send" and e.get("ok")
            and e.get("type") == "update"]
    assert all(b == empty + h for b, h in sent), (empty, sent)
    base = sum(p.numel() * 4 for p in model.parameters())
    assert max(ups + _frames(col, "global")) < 0.01 * base * 10, base
    for r in reports.values():
        assert r["checkpoints"] and all(c["bytes"] < 2_000_000
                                        for c in r["checkpoints"])
    assert math.isfinite(reports[0]["final_eval"]["loss"])


def test_lora_peer_killed_and_resumed_restores_adapters_bit_for_bit(
        tmp_path):
    """A LoRA peer's checkpoint is the adapter tree and its slice's
    ``int8+topk`` residual: peer 1, SIGKILLed after its first committed
    checkpoint and restarted with ``--resume``, restores both equal to the
    kept file bit for bit and the fleet ends with one head. Quorum 1.0 and
    a 60 s buffer window park the leader while peer 1 is down, so it
    cannot reach the target before the restarted peer is back."""
    from bcfl_tpu_torch.dist import run_dist

    cfg = _llama_cfg(
        name="dist_lora_resume", model="tiny-bert", task="classification",
        lora_rank=2, num_rounds=6,
        dist=tconfig.DistConfig(peers=2, buffer=2, buffer_timeout_s=60.0,
                                quorum_frac=1.0, idle_timeout_s=150.0,
                                peer_deadline_s=220.0,
                                checkpoint_every_versions=1))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=240.0,
                      device="cpu", threads=1, kill_peer=1)
    assert result["ok"], (result["returncodes"], result["log_tails"])
    reports = result["reports"]
    assert len({r["chain_head"] for r in reports.values()}) == 1
    kill = result["kill"]
    restored = reports[1]["restored"]
    assert restored["version"] == kill["round"]
    state = torch.load(os.path.join(kill["kept"], f"round_{kill['round']:06d}",
                                    "state.pt"), weights_only=True)
    assert set(state["trainable"]) == set(lora.init_lora(
        None, _meta_tiny_bert(cfg), 2, _targets("tiny-bert")))
    assert restored["trainable_digest"] == tl.params_digest(
        state["trainable"], use_native=False).hex()
    assert restored["ef_residual_digest"] == tl.params_digest(
        state["ef_residual"], use_native=False).hex()
    assert all(x.shape[0] == 2 for x in state["ef_residual"].values())
    assert reports[1]["incarnation"] == 2


def _meta_tiny_bert(cfg):
    from bcfl_tpu_torch.models import build

    with torch.device("meta"):
        return build("tiny-bert", num_labels=cfg.num_labels,
                     vocab_size=cfg.vocab_size)


def _targets(name):
    from bcfl_tpu_torch.models import lora_targets

    return lora_targets(name)


def test_three_gossip_peers_over_adapters(tmp_path):
    """Leaderless dispatch over adapters (no codec, as JAX refuses one
    under gossip): every peer reaches its own horizon with a verifying
    chain, the pushes are adapter-scale and no invariant is violated."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate

    cfg = tconfig.FedConfig(
        name="gossip_lora", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", vocab_size=512,
        num_clients=6, num_rounds=3, seq_len=16, batch_size=4,
        max_local_batches=2, eval_every=0, seed=42, lora_rank=2,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        dist=tconfig.DistConfig(peers=3, dispatch="gossip", gossip_fanout=2,
                                buffer_timeout_s=10.0, idle_timeout_s=90.0,
                                peer_deadline_s=150.0, suspect_after=2))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=170.0,
                      device="cpu", threads=1)
    assert result["ok"], (result["returncodes"], result["log_tails"])
    for p in range(3):
        rep = result["reports"][p]
        assert rep["dispatch"] == "gossip"
        assert rep["final_version"] >= cfg.num_rounds, (p, rep)
        assert rep["chain_ok"] in (True, None)
    col = collate(result["event_streams"])
    assert col["ok"], col["violations"]
    pushes = _frames(col, "update")
    assert pushes and max(pushes) < 1_000_000, pushes
    assert sum(1 for e in col["ordered"] if e["ev"] == "gossip.merge") \
        >= 3 * cfg.num_rounds


# ------------------------------------------------------------------ CLI


def test_cli_lora_rank_with_runtime_dist(tmp_path, monkeypatch, capsys):
    """``--runtime dist --lora-rank`` with ``tiny-llama`` runs 2 peer
    processes to the target version over adapter frames."""
    from bcfl_tpu_torch.entrypoints.__main__ import (build_config,
                                                     build_parser, main)

    flags = ["--preset", "smoke", "--device", "cpu", "--runtime", "dist",
             "--peers", "2", "--clients", "4", "--rounds", "2",
             "--seq-len", "16", "--batch-size", "4", "--model", "tiny-llama",
             "--task", "causal_lm", "--lora-rank", "2", "--ledger",
             "--compress", "int8+topk", "--dist-buffer", "2",
             "--dist-run-dir", str(tmp_path / "run")]
    cfg = build_config(build_parser().parse_args(flags))
    assert (cfg.runtime, cfg.lora_rank, cfg.model, cfg.dist.buffer) == (
        "dist", 2, "tiny-llama", 2)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert main(flags) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["ok"] and summary["invariants_ok"]
    assert set(summary["final_versions"].values()) == {2}
    assert math.isfinite(summary["final_eval"]["loss"])


FUSED_MISUSE = [
    ["--fused-tamper", "0:1:5"],                       # no --ledger
    ["--ledger", "--fused-tamper", "0:1"],             # not R:C:S
    ["--ledger", "--fused-tamper", "0:x:5"],
    ["--ledger", "--fused-tamper", "0:9:5"],           # client range
    ["--ledger", "--fused-tamper", "7:1:5"],           # round range
    ["--ledger", "--fused-tamper", "0:1:5", "--runtime", "dist"],
    ["--ledger", "--fused-tamper", "0:1:5", "--sweep"],
]


@pytest.mark.parametrize("flags", FUSED_MISUSE,
                         ids=[str(i) for i in range(len(FUSED_MISUSE))])
def test_cli_refuses_fused_tamper_misuse_as_jax(flags):
    from bcfl_tpu.entrypoints.__main__ import main as jmain
    from bcfl_tpu_torch.entrypoints.__main__ import main as tmain

    argv = ["--preset", "smoke", "--clients", "4", "--rounds", "2"] + flags
    msgs = []
    for main in (tmain, jmain):
        with pytest.raises(SystemExit) as e:
            main(argv)
        msgs.append(str(e.value))
    # the dist refusal names the port's own crash/rejoin harness
    cut = " (peer crash/rejoin"
    assert msgs[0].split(cut)[0] == msgs[1].split(cut)[0]
    assert (cut in msgs[0]) == (cut in msgs[1])
    if cut not in msgs[0]:
        assert msgs[0] == msgs[1]
    assert "fused-tamper" in msgs[0]


def test_cli_fused_tamper_on_a_per_round_path_fails_loudly():
    """A well-formed request reaches the engine, whose per-round path
    cannot honor it (without --rounds-per-dispatch every round runs the
    per-round path): it raises JAX's error instead of running the demo
    vacuously."""
    from bcfl_tpu_torch.entrypoints.__main__ import main

    with pytest.raises(ValueError, match="fused_tamper requests corruption "
                       "for round 1, but this round runs the per-round"):
        main(["--preset", "smoke", "--device", "cpu", "--clients", "4",
              "--rounds", "2", "--seq-len", "16", "--max-local-batches",
              "1", "--ledger", "--fused-tamper", "1:2:5"])


TELEMETRY_FLAGS = [
    (["--telemetry-dir", "tdir"], dict(telemetry_dir="tdir")),
    (["--no-telemetry"], dict(telemetry_dir="off")),
    (["--telemetry-sample", "0.25"], dict(telemetry_sample=0.25)),
    (["--runtime", "dist", "--telemetry-sample", "0.5", "--no-telemetry"],
     dict(telemetry_dir="off", telemetry_sample=0.5)),
]


@pytest.mark.parametrize("flags,want", TELEMETRY_FLAGS,
                         ids=[str(i) for i in range(len(TELEMETRY_FLAGS))])
def test_cli_telemetry_flags_set_jax_fields(flags, want):
    from bcfl_tpu_torch.entrypoints.__main__ import (build_config,
                                                     build_parser)

    cfg = build_config(build_parser().parse_args(["--preset", "smoke"]
                                                 + flags))
    for k, v in want.items():
        assert getattr(cfg, k) == v


def test_cli_telemetry_conflict_and_local_stream(tmp_path, capsys):
    from bcfl_tpu.entrypoints.__main__ import main as jmain
    from bcfl_tpu_torch.entrypoints.__main__ import main as tmain
    from bcfl_tpu_torch.telemetry import read_stream

    argv = ["--preset", "smoke", "--no-telemetry", "--telemetry-dir", "x"]
    msgs = []
    for main in (tmain, jmain):
        with pytest.raises(SystemExit) as e:
            main(argv)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "--no-telemetry contradicts --telemetry-dir"
    tdir = tmp_path / "tele"
    assert tmain(["--preset", "smoke", "--device", "cpu", "--rounds", "1",
                  "--seq-len", "16", "--max-local-batches", "1",
                  "--telemetry-dir", str(tdir)]) == 0
    events, meta = read_stream(str(tdir / "events_engine.jsonl"))
    assert meta["corrupt_lines"] == 0
    assert any(e["ev"] == "round" for e in events)
    capsys.readouterr()
