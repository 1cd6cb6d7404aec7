"""PyTorch port (``bcfl_tpu_torch``): the clients axis across devices.

On a 1-D mesh each client shard trains and evaluates its own clients on
its own device, every shard issued from the caller's thread, and
everything after training runs on the lead device. Here the devices are
the CPU named four times, as the JAX tests name virtual host devices:

- ``ClientMesh`` lays clients out as JAX's ``client_mesh`` does (C = 10 on
  4 devices is 2 shards of 5, device-major), for several client and
  device counts;
- the engine on ``devices=["cpu"] * 4`` equals the engine on ``["cpu"]``
  bit for bit over 2 rounds with ``int8+topk`` and the ledger: the global
  tree (server FedAvg; LoRA adapters of a sampled cohort) or the stacked
  tree (serverless gossip, BC-FL async), every round's payload bytes, the
  ledger head, the per-client training stats and the per-client
  evaluation;
- the engine on 4 CPU devices against JAX's ``FedEngine`` on 4 of the
  conftest's 8 virtual CPU devices (server FedAvg, 4 clients, ``int8+topk``
  at top-k 1.0 with nearest rounding, the ledger), from JAX's initial
  parameters and batches, dropout off: the records equal, train losses at
  rtol 1e-4, the final global tree at the tolerance of
  ``tests/test_torch_bcfl_async.py``'s one-device codec run (all
  coordinates within ``2 * lr * steps`` a round plus one quantization step,
  all but 1e-4 of them within 2e-6 a round plus that step);
- a shard whose ``local_train`` raises makes the round raise, the shard
  named and the shards after it not run; a tensor that several clients
  share is copied once to each other device;
- the kernel registry's launch counters stay exact under concurrent
  increments from many threads;
- the device rules: without ``devices=`` the engine stays on one device
  (``None``, ``"cuda"``, ``"cuda:N"``; a stand-in ``torch.cuda``), an
  inner axis takes the visible cards, and the per-client dropout
  generators.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax

from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import FedConfig, LedgerConfig
from bcfl_tpu_torch.core import mesh as tmesh
from bcfl_tpu_torch.core import prng
from bcfl_tpu_torch.fed import client_step as cs
from bcfl_tpu_torch.fed.engine import FedEngine, _devices
from bcfl_tpu_torch.ops import registry

STEPS, BATCH, SEQ = 2, 4, 16
LR = 5e-5
ATOL_NONE = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several test workers with a thread per core each oversubscribe the
    # host many times over; the runs compared here share the setting
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(name="clients-axis", model="tiny-bert", dataset="synthetic",
                num_labels=2, num_clients=4, num_rounds=2, seq_len=SEQ,
                batch_size=BATCH, max_local_batches=STEPS, vocab_size=512,
                eval_every=1, compute_dtype="float32",
                compression=CompressionConfig(kind="int8+topk"),
                ledger=LedgerConfig(enabled=True))
    base.update(kw)
    return FedConfig(**base)


def _bits(t: torch.Tensor) -> torch.Tensor:
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if t.is_floating_point():
        return t.view(view[t.element_size()])
    return t


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


# ------------------------------------------------------------------ layout


@pytest.mark.parametrize("C,n", [(10, 4), (4, 4), (6, 4), (8, 4), (3, 4),
                                 (12, 8), (7, 8)])
def test_client_mesh_layout_matches_jax(C, n):
    from bcfl_tpu.core.mesh import client_mesh as jclient_mesh

    jdevs = jax.devices()[:n]
    jm = jclient_mesh(C, jdevs)
    tm = tmesh.client_mesh(C, [torch.device("cpu")] * n)
    assert tm.mesh.shape == dict(jm.mesh.shape)
    assert tm.per_device == jm.per_device
    assert len(tm.client_devices) == jm.n_devices
    # JAX's client sharding: which mesh device holds each stacked row
    arr = jax.device_put(np.arange(C), jm.client_sharding())
    where = {}
    for shard in arr.addressable_shards:
        for c in np.asarray(shard.data).tolist():
            where[c] = jdevs.index(shard.device)
    assert [tm.shard_of(c) for c in range(C)] == [where[c] for c in range(C)]
    with pytest.raises(ValueError, match="is not one of the mesh's"):
        tm.shard_of(C)


def test_client_devices_and_inner_devices():
    devs = [torch.device("cpu", i) for i in range(4)]
    one = tmesh.client_mesh(10, devs)
    assert one.client_devices == devs[:2] and one.devices == devs[:1]
    assert one.train_devices == devs[:2]
    assert [one.train_device(c) for c in (0, 4, 5, 9)] == [
        devs[0], devs[0], devs[1], devs[1]]
    # a 2-D mesh: two client shards, each training on its own row
    tp = tmesh.client_mesh(4, devs, tp=2)
    assert tp.client_devices == [devs[0], devs[2]]
    assert tp.devices == tp.row_devices(0) == devs[:2]
    assert tp.row_devices(1) == devs[2:]
    assert tp.train_devices == [devs[0], devs[2]]
    assert [tp.train_device(c) for c in range(4)] == [
        devs[0], devs[0], devs[2], devs[2]]


# ------------------------------------------------------- engine bit parity


class _Tap:
    """Per round: the payload the ledger saw and the per-client stats."""

    def __init__(self, eng):
        self.payloads, self.stats = [], []
        check, to_rec = eng._check_payload, eng._stats_to_rec

        def tap_payload(payload):
            self.payloads.append({p: {k: v.clone() for k, v in parts.items()}
                                  for p, parts in payload.items()})
            return check(payload)

        def tap_stats(rnd, stats):
            self.stats.append(stats.clone())
            return to_rec(rnd, stats)

        eng._check_payload = tap_payload
        eng._stats_to_rec = tap_stats


def _run(cfg, devices):
    eng = FedEngine(cfg, devices=devices)
    tap = _Tap(eng)
    return eng, tap, eng.run()


def _assert_same_runs(one, four):
    (e1, t1, r1), (e4, t4, r4) = one, four
    assert len(e4.local_train.bodies) == len(e4.mesh.client_devices) > 1
    assert len(e1.local_train.bodies) == 1
    assert r1.trainable.keys() == r4.trainable.keys()
    for p, x in r1.trainable.items():
        assert _same(r4.trainable[p], x), p
    rounds = len(r1.metrics.rounds)
    assert len(t1.payloads) == len(t4.payloads) == rounds
    for a, b in zip(t1.payloads, t4.payloads):
        assert a.keys() == b.keys()
        for p in a:
            for k in a[p]:
                assert _same(b[p][k], a[p][k]), (p, k)
    assert len(t1.stats) == len(t4.stats)
    for a, b in zip(t1.stats, t4.stats):
        assert _same(b, a)
    assert r1.ledger.head == r4.ledger.head and len(r1.ledger) == len(
        r4.ledger)
    for a, b in zip(r1.metrics.rounds, r4.metrics.rounds):
        assert (a.train_loss, a.train_acc, a.local_acc, a.global_loss,
                a.global_acc, a.mask, a.auth, a.bytes_on_wire) == (
            b.train_loss, b.train_acc, b.local_acc, b.global_loss,
            b.global_acc, b.mask, b.auth, b.bytes_on_wire)
    if r1.ef_residual is not None:
        for p, x in r1.ef_residual.items():
            assert _same(r4.ef_residual[p], x), p


MODES = {
    "server-int8+topk": dict(mode="server"),
    "serverless-gossip": dict(mode="serverless"),
    "bcfl-async": dict(mode="serverless", sync="async", async_buffer=2),
    # LoRA adapters over a frozen base, 4 of a 16-client registry a round
    "lora-cohort-causal-lm": dict(
        mode="server", model="tiny-llama", lora_rank=2, task="causal_lm",
        registry_size=16, sample_clients=4),
}


@pytest.mark.parametrize("case", list(MODES), ids=list(MODES))
def test_four_shards_equal_one_shard_bit_for_bit(case):
    cfg = _cfg(**MODES[case])
    one = _run(cfg, ["cpu"])
    four = _run(cfg, ["cpu"] * 4)
    assert four[0].local_train.per_device == 1
    _assert_same_runs(one, four)


def test_ten_clients_on_four_devices_are_two_shards_of_five():
    cfg = _cfg(mode="serverless", num_clients=10, num_rounds=1,
               max_local_batches=1)
    one = _run(cfg, ["cpu"])
    four = _run(cfg, ["cpu"] * 4)
    sh = four[0].local_train
    assert len(sh.bodies) == 2 and sh.per_device == 5
    assert four[0]._slot_devices == [torch.device("cpu")] * 10
    _assert_same_runs(one, four)


def test_shard_models_are_separate_copies_of_the_seeded_model():
    eng = FedEngine(_cfg(num_rounds=1), devices=["cpu"] * 4)
    assert len(eng.local_train.bodies) == 4
    ref = dict(eng.model.named_parameters())
    seen = set()
    for body in eng.local_train.bodies[1:]:
        model = next(c.cell_contents for c in body.__closure__
                     if isinstance(c.cell_contents, torch.nn.Module))
        assert model is not eng.model and id(model) not in seen
        seen.add(id(model))
        for name, p in model.named_parameters():
            assert p.data_ptr() != ref[name].data_ptr()
            assert _same(p.detach(), ref[name].detach()), name


def test_faithful_round_trains_on_the_lead_device():
    cfg = _cfg(mode="serverless", faithful=True, compression=CompressionConfig(
        kind="none"), num_rounds=1)
    one = _run(cfg, ["cpu"])
    four = _run(cfg, ["cpu"] * 4)
    for p, x in one[2].trainable.items():
        assert _same(four[2].trainable[p], x), p
    assert one[2].ledger.head == four[2].ledger.head
    assert ([r.local_acc for r in one[2].metrics.rounds]
            == [r.local_acc for r in four[2].metrics.rounds])


# ------------------------------------------------------ against JAX's mesh


def _flat(tree):
    return {jcc._path_name(p): torch.from_numpy(np.array(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_uniforms(key):
    """The port's uniforms source drawing what the JAX codec draws: leaf
    ``i`` takes ``uniform(fold_in(key, i), grid shape)``."""

    def draw(i, shape, device):
        u = jax.random.uniform(jax.random.fold_in(key, i), shape)
        return torch.from_numpy(np.array(u)).to(device)

    return draw


def _against_jax(monkeypatch, comp, rounds=2, mode="server"):
    """The port's ``mode`` engine (default server FedAvg) on 4 CPU devices
    (4 shards of 1) beside JAX's on 4 virtual devices, from JAX's initial
    parameters and batches, dropout off, the ledger on; stochastic
    rounding draws JAX's
    codec uniforms. Returns ``(JAX result, port result, the per-leaf sum
    over rounds of the largest quantization scale, the port's payloads,
    JAX's round-0 payload and post-train stack)``."""
    import bcfl_tpu.models as jmodels
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.config import FedConfig as JCfg, LedgerConfig as JLed
    from bcfl_tpu.fed.engine import FedEngine as JEngine

    kw = dict(name="clients-axis", model="tiny-bert", dataset="synthetic",
              num_labels=2, mode=mode, num_clients=4,
              num_rounds=rounds, seq_len=SEQ, batch_size=BATCH,
              max_local_batches=STEPS, vocab_size=512, eval_every=0,
              compute_dtype="float32")
    jcfg = JCfg(**kw, compression=JComp(**comp),
                ledger=JLed(enabled=True, use_native=False))
    tcfg = FedConfig(**kw, compression=CompressionConfig(**comp),
                     ledger=LedgerConfig(enabled=True))
    build = jmodels.build
    monkeypatch.setattr(jmodels, "build",
                        lambda *a, **k: build(*a, dropout_rate=0.0, **k))
    jeng = JEngine(jcfg)
    assert jeng.mesh.n_devices == 4 and jeng.mesh.per_device == 1
    assert len(jax.devices()) == 8
    jax_round0 = {}
    encode = jeng.progs.encode_deltas

    def capture(new_t, ref_t, resid, rngs):
        payload, rec, resid = encode(new_t, ref_t, resid, rngs)
        if not jax_round0:
            jax_round0["new_t"] = _flat(new_t)
            jax_round0["delta"] = jax.tree.map(
                lambda n, g: n.astype(np.float32) - g.astype(np.float32),
                new_t, ref_t)
            jax_round0["payload"] = payload
            jax_round0["rngs"] = np.asarray(rngs)
        return payload, rec, resid

    monkeypatch.setattr(jeng.progs, "encode_deltas", capture)
    jres = jeng.run()

    teng = FedEngine(tcfg, devices=["cpu"] * 4)
    assert len(teng.local_train.bodies) == 4
    teng.trainable0 = _flat(jeng.trainable0)
    batches = {}

    def round_batches(rnd):
        if rnd not in batches:
            tree, n_ex = jeng._round_batches(rnd)
            batches[rnd] = ({k: torch.from_numpy(np.array(v))
                             for k, v in tree.items()}, np.asarray(n_ex))
        return batches[rnd]

    monkeypatch.setattr(teng, "_round_batches", round_batches)
    monkeypatch.setattr(teng, "_generators", lambda rnd: [None] * 4)
    if comp.get("stochastic", True):
        monkeypatch.setattr(teng, "_uniforms", lambda rnd: _jax_uniforms(
            jcc.codec_key(jax.random.wrap_key_data(
                np.asarray(jeng._rngs(rnd))))))
    steps, payloads = {}, []
    check = teng._check_payload

    def recording(payload):
        payloads.append(payload)
        for p, parts in payload.items():
            steps[p] = steps.get(p, 0.0) + float(parts["s"].max())
        return check(payload)

    monkeypatch.setattr(teng, "_check_payload", recording)
    return jres, teng, steps, payloads, jax_round0


def _assert_global_near_jax(jres, tres, steps, rounds, frac=1e-4):
    """The final global within ``2 * lr * steps`` a round plus the sum of
    the rounds' largest quantization steps everywhere, and all but
    ``frac`` of the coordinates within 2e-6 a round plus that step."""
    assert steps
    far = total = 0
    for p, x in _flat(jres.trainable).items():
        err = np.abs(tres.trainable[p].numpy() - x.numpy())
        step = steps[p]
        assert err.max() <= rounds * 2 * LR * STEPS * 1.01 + step, p
        if not p.endswith("/key/bias"):
            far += int((err > rounds * ATOL_NONE + step).sum())
            total += err.size
    assert far <= total * frac, f"{far} of {total} coordinates past atol"


def test_four_shards_match_jax_on_four_devices(monkeypatch):
    rounds = 2
    jres, teng, steps, _, _ = _against_jax(
        monkeypatch, dict(kind="int8+topk", topk_frac=1.0, stochastic=False),
        rounds)
    tres = teng.run()
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        for field in ("mask", "auth", "bytes_on_wire", "degraded"):
            assert getattr(rt, field) == getattr(rj, field), (rt.round, field)
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    assert tres.metrics.ledger["chain_ok"] == 1.0 == jres.metrics.ledger[
        "chain_ok"]
    assert len(tres.ledger) == len(jres.ledger) == 4 * rounds
    _assert_global_near_jax(jres, tres, steps, rounds)


def test_four_shards_match_jax_with_stochastic_topk(monkeypatch):
    """Stochastic ``int8+topk`` at ``topk_frac`` 0.05 with error feedback,
    the port's uniforms JAX's codec draws. In round 0 every client hands
    its shard JAX's own post-train rows, so each shard encodes, on its
    device, exactly what JAX's ``_compress_stage`` encodes under
    ``P('clients')``: the gathered payload's bytes equal JAX's. Later
    rounds train on the port's side, and the global is held as in the
    test above, except that 5e-3 of the coordinates may pass 2e-6 a round:
    a top-k at 0.05 ships the coordinates at the k-th magnitude or above,
    the two trainings differ near 1e-7, and a coordinate at that border
    selected on one side only moves by its whole delta (1.1e-3 of them
    here)."""
    from bcfl_tpu.compression import CompressionConfig as JComp

    rounds = 2
    comp = dict(kind="int8+topk", topk_frac=0.05)
    jres, teng, steps, payloads, jax0 = _against_jax(monkeypatch, comp,
                                                     rounds)
    calls = []

    def feeding(body):
        def run(tree, batch, gen):
            t, st = body(tree, batch, gen)
            c = len(calls)
            calls.append(c)
            if c < 4:  # round 0, clients in order, shard after shard
                t = {p: jax0["new_t"][p][c].to(x.device).clone()
                     for p, x in t.items()}
            return t, st
        return run

    teng.local_train.bodies = [feeding(b) for b in teng.local_train.bodies]
    tres = teng.run()
    assert len(calls) == 4 * rounds
    got = payloads[0]
    # JAX's codec run eagerly on JAX's round-0 deltas with the round's
    # codec key: every byte equal
    key = jcc.codec_key(jax.random.wrap_key_data(jax0["rngs"]))
    want = jcc.encode_tree(JComp(**comp), jax0["delta"], key)
    # and the engine's own payload, encoded under jit: the codes and
    # indices equal, a scale at most one float32 ulp off (jit turns the
    # division by 127 into a reciprocal multiply)
    jitted = jax0["payload"]
    assert list(got) == sorted(want, key=lambda p: tuple(p.split("/")))
    for p, parts in want.items():
        assert set(got[p]) == set(parts) == set(jitted[p]), p
        for k, v in parts.items():
            assert _same(got[p][k], torch.from_numpy(np.array(v))), (p, k)
            j = torch.from_numpy(np.array(jitted[p][k]))
            if k == "s":
                ulps = (got[p][k].view(torch.int32) - j.view(torch.int32))
                assert int(ulps.abs().max()) <= 1, p
            else:
                assert _same(got[p][k], j), (p, k)
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        for field in ("mask", "auth", "bytes_on_wire", "degraded"):
            assert getattr(rt, field) == getattr(rj, field), (rt.round, field)
    assert tres.metrics.ledger["chain_ok"] == 1.0 == jres.metrics.ledger[
        "chain_ok"]
    _assert_global_near_jax(jres, tres, steps, rounds, frac=5e-3)


# -------------------------------------------------------- a shard's failure


class _Boom(RuntimeError):
    pass


def test_a_failing_shard_fails_the_round():
    eng = FedEngine(_cfg(num_rounds=1), devices=["cpu"] * 4)
    finished = []
    bodies = eng.local_train.bodies

    def failing(*args):
        raise _Boom("shard 2 lost its device")

    def tracked(s, body):
        def run(*args):
            out = body(*args)
            finished.append(s)
            return out
        return run

    eng.local_train.bodies = [tracked(0, bodies[0]), tracked(1, bodies[1]),
                              failing, tracked(3, bodies[3])]
    with pytest.raises(_Boom) as err:
        eng.run()
    assert err.value.__notes__ == ["in client shard 2 on cpu"]
    # the shards before it ran, the one after it never started
    assert finished == [0, 1]


def test_run_sharded_names_the_failing_shard_and_keeps_client_order():
    def ok(x):
        return x * 2

    def bad(x):
        raise ValueError(f"bad {int(x)}")

    ran = []

    def seen(x):
        ran.append(int(x))
        return ok(x)

    sh = cs.Sharded([ok, bad, bad, seen], [torch.device("cpu")] * 4, 1)
    with pytest.raises(ValueError, match="bad 1") as err:
        cs.run_sharded(sh, [(torch.tensor(float(c)),) for c in range(4)])
    assert err.value.__notes__ == ["in client shard 1 on cpu"]
    assert ran == []
    out = cs.run_sharded(cs.Sharded([ok] * 2, [torch.device("cpu")] * 2, 2),
                         [(torch.tensor(float(c)),) for c in range(4)])
    assert [float(x) for x in out] == [0.0, 2.0, 4.0, 6.0]


def test_run_sharded_copies_a_shared_input_once_per_device():
    got = []

    def body(tree, row, gen):
        got.append((tree["w"], row, gen))
        return row

    shared, gen = {"w": torch.ones(3)}, object()
    rows = [torch.full((2,), float(c)) for c in range(4)]
    meta = torch.device("meta")
    sh = cs.Sharded([body, body], [torch.device("cpu"), meta], 2)
    out = cs.run_sharded(sh, [(shared, rows[c], gen) for c in range(4)])
    # the lead shard's inputs pass as they are, the other's are copied
    assert got[0][0] is got[1][0] is shared["w"]
    assert got[0][1] is rows[0] and got[1][1] is rows[1]
    assert got[2][0] is got[3][0] and got[2][0].device == meta
    assert got[2][1].device == got[3][1].device == meta
    assert got[2][1] is not got[3][1]
    assert all(g is gen for _, _, g in got)
    assert [x.device for x in out] == [torch.device("cpu")] * 2 + [meta] * 2


# ------------------------------------------------------------ launch counts


def test_launch_counts_are_exact_under_threads():
    op = registry.KernelOp("clients-axis-counter", torch=lambda x: x)
    threads, each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(threads)

        def bump():
            start.wait(timeout=30)
            for i in range(each):
                registry.count_launch(op, "bfloat16" if i % 2 else None)

        workers = [threading.Thread(target=bump) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert op.launches == threads * each
    assert op.launches_by == {"bfloat16": threads * each // 2}


# ------------------------------------------------------------ device rules


def test_device_rules(monkeypatch):
    cfg = _cfg()
    cpu = torch.device("cpu")
    assert _devices(cfg, "cpu", None) == [cpu]
    assert _devices(_cfg(tp=2, lora_rank=2), "cpu", None) == [cpu, cpu]
    assert _devices(cfg, None, ["cpu"] * 3) == [cpu] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert _devices(cfg, None, None) == [torch.device("cuda")]
    assert _devices(cfg, "cuda", None) == [torch.device("cuda")]
    assert _devices(cfg, "cuda:2", None) == [torch.device("cuda", 2)]
    assert _devices(cfg, None, cards) == cards
    assert _devices(_cfg(tp=2, lora_rank=2), "cuda", None) == cards


def test_client_generators_follow_the_client_not_the_device():
    one = prng.client_round_generators(3, [5, 9, 2], 1, "cpu")
    each = prng.client_round_generators(3, [5, 9, 2], 1, ["cpu"] * 3)
    for a, b in zip(one, each):
        assert torch.equal(a.get_state(), b.get_state())
    with pytest.raises(ValueError, match="2 devices for 3 clients"):
        prng.client_round_generators(3, [5, 9, 2], 1, ["cpu"] * 2)
