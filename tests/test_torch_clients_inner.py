"""PyTorch port (``bcfl_tpu_torch``): the clients axis of a 2-D mesh,
``(clients, tp)`` and ``(clients, seq)``, with more than one client shard.

Every row of the grid is a client shard that trains its own clients on its
own row of devices, as JAX's GSPMD program gives each row of its mesh its
own clients: under ``tp`` on its own megatron split of the frozen base
over its row, under ``sp`` with its attention on its own ring over its
row. Here the devices are the CPU named several times, as the JAX tests
name virtual host devices:

- the row layout (``ClientMesh.row_devices``, ``client_devices``,
  ``train_devices``, ``train_device``) against JAX's ``client_mesh`` on the
  conftest's 8 virtual devices, device ids and the client sharding, for
  several client counts, device counts and inner axes;
- ``tp=2``: tiny-llama LoRA, 4 clients, ``int8+topk`` and the ledger, on
  ``["cpu"] * 8`` (``{"clients": 4, "tp": 2}``) equal to ``["cpu"] * 2``
  (one row) bit for bit, server and serverless: the global or stacked
  tree, every round's payload bytes, the ledger head, the per-client
  stats and evaluation;
- ``sp=2``: tiny-llama causal LM, 2 clients, on ``["cpu"] * 4`` equal to
  ``["cpu"] * 2`` bit for bit, with LoRA (the rows share the frozen base)
  and in full fine-tuning (each row owns its copy); the ring's rotations
  counted per row add up to the one row's;
- every row's model holds its split over its own row and its ring names
  its own row; a copy on other devices owns its slices (each copied from
  the lead's, the dense weight a ``meta`` placeholder) and computes the
  lead's logits bit for bit; the lead model is untouched;
- a split over devices other than the input's (``cpu:0``, ``cpu:1``, as
  two cards) replicates each block's input once, its gradients summed in
  shard order, and recomputes remat layers by the reentrant checkpoint:
  near the one-device split and bit for bit itself from run to run;
- the engine's ``tp`` and ``sp`` rounds against JAX's engine on the same
  mesh shape (asserted), at the tolerances of ``tests/test_torch_fed_tp.py``
  and ``tests/test_torch_sp.py``;
- a failing row's exception names its client shard.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

import test_torch_clients_axis as ca
from bcfl_tpu.core.mesh import client_mesh as jclient_mesh
from bcfl_tpu_torch.core import mesh as tmesh
from bcfl_tpu_torch.fed import client_step as cs
from bcfl_tpu_torch.fed.engine import FedEngine
from bcfl_tpu_torch.models import convert
from bcfl_tpu_torch.parallel import sp as tsp
from bcfl_tpu_torch.parallel import tp_linear

tra = importlib.import_module("bcfl_tpu_torch.parallel.ring_attention")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(eng):
    """The model each client shard trains on, shard by shard."""
    return [next(c.cell_contents for c in body.__closure__
                 if isinstance(c.cell_contents, torch.nn.Module))
            for body in eng.local_train.bodies]


# ------------------------------------------------------------------ layout


@pytest.mark.parametrize("C,n,inner", [
    (4, 8, dict(tp=2)), (2, 8, dict(tp=2)), (6, 8, dict(tp=2)),
    (8, 8, dict(tp=4)), (3, 8, dict(sp=2)), (4, 4, dict(sp=2)),
    (10, 8, dict(sp=2)), (5, 6, dict(tp=2))])
def test_rows_match_jax_client_mesh(C, n, inner):
    jdevs = jax.devices()[:n]
    jm = jclient_mesh(C, jdevs, **inner)
    tm = tmesh.client_mesh(C, [torch.device("cpu", i) for i in range(n)],
                           **inner)
    assert tm.mesh.shape == dict(jm.mesh.shape)
    assert tm.per_device == jm.per_device
    rows = [[jdevs.index(d) for d in row] for row in jm.mesh.devices]
    shards = len(rows)
    assert [[d.index for d in tm.row_devices(s)]
            for s in range(shards)] == rows
    assert [d.index for d in tm.train_devices] == [r[0] for r in rows]
    assert tm.train_devices == tm.client_devices
    assert tm.devices == tm.row_devices(0)
    # JAX's client sharding: each client's row, replicated over its row
    arr = jax.device_put(np.arange(C), jm.client_sharding())
    row_of = {}
    for shard in arr.addressable_shards:
        r = next(i for i, row in enumerate(rows)
                 if jdevs.index(shard.device) in row)
        for c in np.asarray(shard.data).tolist():
            assert row_of.setdefault(c, r) == r
    assert [tm.shard_of(c) for c in range(C)] == [row_of[c]
                                                   for c in range(C)]
    assert [tm.train_device(c).index for c in range(C)] == [
        rows[row_of[c]][0] for c in range(C)]


# ------------------------------------------------------- engine bit parity


def _tp_cfg(**kw):
    return ca._cfg(model="tiny-llama", lora_rank=2, tp=2, **kw)


@pytest.mark.parametrize("mode", ["server", "serverless"])
def test_tp_rows_equal_one_row_bit_for_bit(mode):
    cfg = _tp_cfg(mode=mode)
    one = ca._run(cfg, ["cpu"] * 2)
    many = ca._run(cfg, ["cpu"] * 8)
    assert one[0].mesh.mesh.shape == {"clients": 1, "tp": 2}
    assert many[0].mesh.mesh.shape == {"clients": 4, "tp": 2}
    assert many[0].local_train.per_device == 1
    ca._assert_same_runs(one, many)


def _sp_cfg(**kw):
    base = dict(model="tiny-llama", task="causal_lm", sp=2, num_clients=2,
                seq_len=32, batch_size=2)
    base.update(kw)
    return ca._cfg(**base)


@pytest.mark.parametrize("lora_rank", [2, 0], ids=["lora", "full"])
def test_sp_rows_equal_one_row_bit_for_bit(lora_rank):
    cfg = _sp_cfg(lora_rank=lora_rank)
    tsp.reset_hops()
    tra.reset_rotations()
    one = ca._run(cfg, ["cpu"] * 2)
    total = tsp.hops()
    assert total == tsp.hops(0) == tra.rotations() > 0
    assert tsp.hops(1) == 0
    tsp.reset_hops()
    many = ca._run(cfg, ["cpu"] * 4)
    assert many[0].mesh.mesh.shape == {"clients": 2, "seq": 2}
    # each row rotated its own ring; the rows' hops add up to the one's
    assert tsp.hops(0) > 0 and tsp.hops(1) > 0
    assert tsp.hops(0) + tsp.hops(1) == tsp.hops() == total
    ca._assert_same_runs(one, many)


# ---------------------------------------------------- own split, own ring


def test_every_row_holds_its_own_split_and_ring():
    eng = FedEngine(_tp_cfg(num_rounds=1), devices=["cpu"] * 8)
    models = _models(eng)
    assert len(models) == 4 and models[0] is eng.model
    lead = tp_linear.split_layers(eng.model)
    ptrs = {n: [w.data_ptr() for w in sh.weights] for n, sh in lead.items()}
    for s, m in enumerate(models):
        split = tp_linear.split_layers(m)
        assert split.keys() == lead.keys() and len(split) == 14
        assert all(sh.devices == eng.mesh.row_devices(s)
                   for sh in split.values())
        if s:
            # on the lead's own devices a frozen LoRA base is shared
            assert m is not eng.model and all(
                split[n] is lead[n] for n in lead)
    # a copy on other devices owns its slices, each copied from the
    # lead's; its dense weights hold no storage; it computes the lead's
    # logits bit for bit; the lead keeps its split
    row = [torch.device("cpu", 1), torch.device("cpu", 1)]
    rep = cs._replica(eng.model, row, share=False)
    ids = torch.randint(0, 512, (2, 16), generator=torch.Generator()
                        .manual_seed(0))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        want, got = eng.model(ids, mask), rep(ids, mask)
    assert ca._same(got, want)
    for name, sh in tp_linear.split_layers(rep).items():
        assert sh.devices == row and sh.home == row[0]
        assert rep.get_submodule(name).weight.is_meta
        for w, lw in zip(sh.weights, lead[name].weights):
            assert w.data_ptr() != lw.data_ptr() and ca._same(w, lw)
    now = tp_linear.split_layers(eng.model)
    assert now.keys() == lead.keys() and all(now[n] is lead[n] for n in lead)
    assert {n: [w.data_ptr() for w in sh.weights]
            for n, sh in lead.items()} == ptrs
    assert not any(p.is_meta for p in eng.model.parameters())
    # unshard puts the copy's weights together on its row's first device
    tp_linear.unshard(rep)
    for name in lead:
        assert ca._same(rep.get_submodule(name).weight,
                        eng.model.get_submodule(name).weight)

    eng = FedEngine(_sp_cfg(num_rounds=1), devices=["cpu"] * 4)
    models = _models(eng)
    for s, m in enumerate(models):
        ring = m.cfg.attention_override
        assert ring.keywords["row"] == s
        assert list(tsp.ring_devices(m)) == eng.mesh.row_devices(s)
        # every layer of the copy reads its own config's ring
        assert all(mod.cfg.attention_override is ring
                   for mod in m.modules() if "cfg" in mod.__dict__)
    assert eng.model.cfg.attention_override.keywords["row"] == 0


def test_programs_refuse_a_row_off_its_own_devices():
    eng = FedEngine(_tp_cfg(num_rounds=1), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="client shard 0's frozen base is "
                                         "not split over its own row"):
        cs._check_inner(eng.model, tmesh.client_mesh(
            4, [torch.device("cpu", i) for i in range(4)], tp=2), 0)
    eng = FedEngine(_sp_cfg(num_rounds=1), devices=["cpu"] * 4)
    mesh = tmesh.client_mesh(2, [torch.device("cpu", i) for i in range(4)],
                             sp=2)
    tsp.ride_ring(eng.model, tsp.ring_override(mesh.mesh, row=1))
    with pytest.raises(ValueError, match="client shard 0's ring runs over"):
        cs._check_inner(eng.model, mesh, 0)
    with pytest.raises(ValueError, match="row 2 is not one of the mesh's 2 "
                                         "client shards"):
        tsp.ring_override(mesh.mesh, row=2)


def _split_step(name, devices, remat):
    """A seeded ``name`` (float32, LoRA rank 2 with a nonzero ``b``) split
    over ``devices``: its logits and the adapters' gradients of one
    cross-entropy step."""
    from bcfl_tpu_torch.models import (build, lora, lora_targets,
                                       tp_param_specs)
    from bcfl_tpu_torch.models.bert import init_params
    from bcfl_tpu_torch.models.convert import leaf_specs

    model = build(name, num_labels=3, dtype=torch.float32, remat=remat)
    init_params(model, torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    ad = lora.init_lora(torch.Generator().manual_seed(1), model, 2,
                        lora_targets(name))
    gen = torch.Generator().manual_seed(2)
    ad = {p: (x + 0.05 * torch.randn(x.shape, generator=gen)
              ).requires_grad_(True) for p, x in ad.items()}
    tp_linear.shard_base(model, tp_param_specs(model, {
        s.path: s for s in leaf_specs(model)}), devices)
    ids = torch.randint(4, 512, (2, 16), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, 11:] = 0
    with lora.attached(model, ad):
        model.train()
        logits = model(ids, mask)
        torch.nn.functional.cross_entropy(
            logits, torch.tensor([1, 2])).backward()
    return model, logits.detach(), {p: x.grad for p, x in ad.items()}


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-bert"])
def test_a_split_over_several_devices_is_deterministic(name, monkeypatch):
    """Shards on devices other than the input's (``cpu:0`` and ``cpu:1``,
    which torch places on the one CPU, as two cards of one host): each
    block's input is replicated once for its column-parallel layers
    (``tp_linear.replicate``, the copies' gradients summed on the input's
    device in shard order, whatever order the devices' backward threads
    finish in) and, under remat, every layer is recomputed by the
    reentrant checkpoint (two devices' threads cannot both recompute it).
    Logits and adapter gradients equal the one-device split's within the
    float32 tolerances of ``tests/test_torch_fed_tp.py`` (2e-5, 1e-5
    absolute: the sums run in another order) and equal themselves bit for
    bit from run to run."""
    calls = []
    apply = tp_linear._Replicate.apply
    monkeypatch.setattr(tp_linear._Replicate, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    _, want, wgrads = _split_step(name, [CPU, CPU], remat=False)
    assert not calls
    two = [torch.device("cpu", 0), torch.device("cpu", 1)]
    runs = [_split_step(name, two, remat=True) for _ in range(2)]
    model = runs[0][0]
    assert calls and any(len(set(sh.devices)) > 1 for sh in
                         tp_linear.split_layers(model).values())
    for _, got, grads in runs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=2e-5)
        for p, g in grads.items():
            assert g is not None, p
            np.testing.assert_allclose(g.numpy(), wgrads[p].numpy(),
                                       atol=1e-5, rtol=0, err_msg=p)
    assert ca._same(runs[0][1], runs[1][1])
    for p, g in runs[0][2].items():
        assert ca._same(runs[1][2][p], g), p


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-bert"])
@pytest.mark.parametrize("ways", [1, 2])
def test_remat_under_lora_equals_no_remat_bit_for_bit(name, ways):
    """Remat is the reentrant checkpoint on every split
    (``tp_linear.checkpoint``): on one device, whole or split in two, and
    with a frozen first input (LoRA), the logits and the adapters'
    gradients equal a run without remat bit for bit."""
    _, want, wgrads = _split_step(name, [CPU] * ways, remat=False)
    _, got, grads = _split_step(name, [CPU] * ways, remat=True)
    assert ca._same(got, want)
    for p, g in grads.items():
        assert g is not None and ca._same(g, wgrads[p]), p


# ------------------------------------------------------ against JAX's mesh


def test_tp_engine_matches_jax_on_its_mesh_shape(monkeypatch):
    from bcfl_tpu.config import FedConfig as JCfg
    from bcfl_tpu.config import LedgerConfig as JLedger
    from bcfl_tpu.config import PartitionConfig as JPart
    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from test_torch_fed_tp import _tp_cfg as tp_pair_cfg
    from bcfl_tpu_torch.config import FedConfig, LedgerConfig
    from bcfl_tpu_torch.config import PartitionConfig

    lr, steps = 1e-3, 1
    jeng = JEngine(tp_pair_cfg(JCfg, JPart, JLedger))
    teng = FedEngine(tp_pair_cfg(FedConfig, PartitionConfig, LedgerConfig),
                     devices=["cpu"] * 8)
    assert teng.mesh.mesh.shape == dict(jeng.mesh.mesh.shape) == {
        "clients": 4, "tp": 2}
    assert len(teng.local_train.bodies) == 4
    # every row shares the lead's frozen base on the CPU: one load
    teng.model.load_state_dict(convert.from_flax(_np(jeng.frozen)))
    teng.trainable0 = convert.from_flax_adapters(_np(jeng.trainable0))
    monkeypatch.setattr(teng, "_generators", lambda rnd: [None] * 4)
    jres, tres = jeng.run(), teng.run()
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        assert rt.mask == rj.mask and rt.auth == rj.auth == [1.0] * 4
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    for p, x in convert.from_flax_adapters(_np(jres.trainable)).items():
        np.testing.assert_allclose(tres.trainable[p].numpy(), x.numpy(),
                                   atol=2 * lr * steps * 4 * 1.01, rtol=0,
                                   err_msg=p)


def test_sp_engine_matches_jax_on_its_mesh_shape(monkeypatch):
    from bcfl_tpu.config import FedConfig as JCfg
    from bcfl_tpu.config import PartitionConfig as JPart
    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from bcfl_tpu_torch.config import FedConfig, PartitionConfig

    lr, steps = 1e-3, 1
    part = dict(kind="contiguous", stride=12, train_span=8, test_span=4)
    base = dict(name="fed_sp", model="tiny-llama", dataset="synthetic",
                task="causal_lm", lora_rank=2, mode="server", num_clients=2,
                num_rounds=1, seq_len=32, batch_size=2,
                max_local_batches=steps, sp=2, vocab_size=512,
                eval_every=0, learning_rate=lr, compute_dtype="float32")
    jeng = JEngine(JCfg(**base, partition=JPart(**part)))
    teng = FedEngine(FedConfig(**base, partition=PartitionConfig(**part)),
                     devices=["cpu"] * 4)
    assert teng.mesh.mesh.shape == dict(jeng.mesh.mesh.shape) == {
        "clients": 2, "seq": 2}
    teng.model.load_state_dict(convert.from_flax(_np(jeng.frozen)))
    teng.trainable0 = convert.from_flax_adapters(_np(jeng.trainable0))
    monkeypatch.setattr(teng, "_generators", lambda rnd: [None] * 2)
    tsp.reset_hops()
    jres, tres = jeng.run(), teng.run()
    # one ring call per layer (2) of each client's training step, one
    # rotation each at sp=2, each client on its own row's ring
    assert tsp.hops(0) == tsp.hops(1) == 2 * steps
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        assert rt.mask == rj.mask
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    for p, x in convert.from_flax_adapters(_np(jres.trainable)).items():
        np.testing.assert_allclose(tres.trainable[p].numpy(), x.numpy(),
                                   atol=2 * lr * steps * 2 * 1.01, rtol=0,
                                   err_msg=p)


# -------------------------------------------------------- a row's failure


def test_a_failing_row_names_its_shard():
    eng = FedEngine(_tp_cfg(num_rounds=1, compression=ca.CompressionConfig(
        kind="none")), devices=["cpu"] * 8)
    row = _models(eng)[2]
    # row 2 owns a broken split: the second shard of one layer lost its
    # slice
    name, sh = next(iter(tp_linear.split_layers(row).items()))
    broken = tp_linear.Shards(sh.dim, sh.devices, sh.bounds,
                              [sh.weights[0], sh.weights[1].new_empty(0)],
                              sh.biases)
    row.get_submodule(name).__dict__["tp"] = broken
    with pytest.raises(RuntimeError) as err:
        eng.run()
    assert err.value.__notes__ == ["in client shard 2 on cpu"]
