"""PyTorch port (``bcfl_tpu_torch``): tensor parallelism (the models'
``tp_specs``, ``tp_param_specs``, the sharded forward of
``bcfl_tpu_torch/parallel/tp_linear.py``, ``parallel/fed_tp.py`` and
``FedConfig(tp=...)``) against the JAX package's megatron layout
(``bcfl_tpu/models/{bert,llama}.py::tp_specs``, ``parallel/fed_tp.py``) on
the same numpy-seeded inputs and JAX's weights.

The JAX side runs on the conftest's 8 virtual CPU devices, the port's on
lists of CPU devices; models compute in float32:

- every leaf's split, bert and llama: JAX's ``PartitionSpec`` carried
  through ``convert.from_flax`` (an array holding each element's index
  along the tp-split flax dimension) lands on the torch dimension the
  port's spec names, and the port's contiguous shard ``i`` holds exactly
  JAX's shard ``i`` (its heads ``i*H/tp ...``); replicated leaves have no
  port split;
- the tp=2 sharded forward with LoRA attached (nonzero ``b``) against
  JAX's dense forward of ``apply_lora``'s merged tree: logits within 2e-5
  (absolute and relative), the adapter gradients within 1e-5 absolute;
  the base is stored once (every shard a view of its weight);
- one ``build_fed_tp_round`` at 4 clients x tp 2 against JAX's, client 2
  masked out: stats at rtol 1e-5, adapters within ``2 * lr * steps`` (one
  AdamW step moves a coordinate by at most about ``lr``), the
  participating clients on one consensus and the masked one on its own;
- ``FedConfig(tp=2)`` server and serverless rounds with the ledger:
  ``auth == [1.0] * 4`` and a verified chain; one server round against
  the JAX engine's at the tolerances of
  ``tests/test_torch_llama_engine.py`` (loss rtol 1e-4, adapters within
  ``2 * lr * steps`` per client trained in sequence);
- the refusals in JAX's words.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from bcfl_tpu.config import FedConfig as JCfg
from bcfl_tpu.config import LedgerConfig as JLedger
from bcfl_tpu.config import PartitionConfig as JPart
from bcfl_tpu.core import mesh as jmesh
from bcfl_tpu.models import build as jbuild
from bcfl_tpu.models import lora as jlora
from bcfl_tpu.models import tp_param_specs as jtp_param_specs
from bcfl_tpu.parallel import fed_tp as jfed_tp
from bcfl_tpu_torch.config import FedConfig, LedgerConfig, PartitionConfig
from bcfl_tpu_torch.core import mesh as tmesh
from bcfl_tpu_torch.fed.engine import FedEngine
from bcfl_tpu_torch.models import build, convert, lora, tp_param_specs
from bcfl_tpu_torch.models.convert import leaf_specs
from bcfl_tpu_torch.parallel import fed_tp, tp_linear

OUT_TOL = 2e-5
GRAD_TOL = 1e-5
CPU = torch.device("cpu")
MODELS = ["tiny-bert", "tiny-llama"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(name, seed=0, B=2, S=16):
    """JAX's model and params and the port's model holding them."""
    jm = jbuild(name, num_labels=3, dtype=jnp.float32)
    ids = np.ones((B, S), np.int32)
    params = jm.init(jax.random.key(seed), ids, ids)["params"]
    tm = build(name, num_labels=3, dtype=torch.float32)
    tm.load_state_dict(convert.from_flax(_np(params)))
    return jm, params, tm


def _targets(name):
    from bcfl_tpu.models import lora_targets

    return lora_targets(name)


def _flax_paths(model):
    return {s.path: s for s in leaf_specs(model)}


@pytest.mark.parametrize("name", MODELS)
def test_every_leaf_split_matches_jax_partition_spec(name):
    tp = 2
    jm, params, tm = _pair(name)
    jspecs = jtp_param_specs(jm, params)
    flat_p = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    flat_s = dict(jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=is_spec)[0])
    index, jdims = {}, {}
    for path, leaf in flat_p.items():
        spec = tuple(flat_s[path]) + (None,) * (leaf.ndim - len(flat_s[path]))
        dims = [d for d, ax in enumerate(spec) if ax == "tp"]
        key = "/".join(p.key for p in path)
        jdims[key] = dims[0] if dims else None
        idx = np.zeros(leaf.shape, np.float32)
        if dims:
            shape = [1] * leaf.ndim
            shape[dims[0]] = leaf.shape[dims[0]]
            idx = idx + np.arange(leaf.shape[dims[0]]).reshape(shape)
        node = index
        for p in path[:-1]:
            node = node.setdefault(p.key, {})
        node[path[-1].key] = idx
    torch_idx = convert.from_flax(index)
    specs = tp_param_specs(tm, _flax_paths(tm))
    assert set(specs) == set(jdims)
    split = 0
    for path, jd in jdims.items():
        got = specs[path]
        if jd is None:
            assert got is None, path
            continue
        split += 1
        t = torch_idx[convert.torch_key(path)]
        size = flat_p[next(p for p in flat_p
                           if "/".join(x.key for x in p) == path)].shape[jd]
        for i, chunk in enumerate(t.chunk(tp, dim=got)):
            want = set(range(i * size // tp, (i + 1) * size // tp))
            assert set(chunk.unique().long().tolist()) == want, (path, i)
    assert split == sum(d is not None for d in specs.values()) > 0


def _adapters(name, params, seed=1, rank=2):
    """JAX's adapters with a nonzero ``b`` (the merge must matter)."""
    ad = jlora.init_lora(jax.random.key(seed), params, rank=rank,
                         targets=_targets(name))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        _np(ad))


@pytest.mark.parametrize("name", MODELS)
def test_sharded_forward_with_lora_matches_jax_dense(name):
    jm, params, tm = _pair(name, seed=3)
    ad = _adapters(name, params)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 8192, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    labels = np.array([1, 2], np.int32)
    import optax

    def jloss(ad):
        logits = jm.apply({"params": jlora.apply_lora(params, ad)}, ids, mask)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean(), logits

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(ad)
    n = tp_linear.shard_base(tm, tp_param_specs(tm, _flax_paths(tm)),
                             [CPU, CPU])
    assert n == (6 if name == "tiny-bert" else 7) * tm.cfg.num_layers
    for mod_name, sh in tp_linear.split_layers(tm).items():
        w = tm.get_submodule(mod_name).weight
        assert all(x.untyped_storage().data_ptr()
                   == w.untyped_storage().data_ptr() for x in sh.weights)
    tad = {p: x.clone().requires_grad_(True)
           for p, x in convert.from_flax_adapters(ad).items()}
    tm.requires_grad_(False)
    with lora.attached(tm, tad):
        got = tm(torch.tensor(ids), torch.tensor(mask))
        torch.nn.functional.cross_entropy(
            got, torch.tensor(labels).long()).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_TOL, rtol=OUT_TOL)
    jflat = convert.from_flax_adapters(_np(jgrads))
    for p, x in tad.items():
        np.testing.assert_allclose(x.grad.numpy(), jflat[p].numpy(),
                                   atol=GRAD_TOL, rtol=0, err_msg=p)
    tp_linear.unshard(tm)
    assert not tp_linear.split_layers(tm)


def _round_batches(C, steps, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "ids": rng.integers(0, 256, (C, steps, B, S)).astype(np.int32),
        "mask": np.ones((C, steps, B, S), np.int32),
        "labels": rng.integers(0, 2, (C, steps, B)).astype(np.int32),
        "example_mask": np.ones((C, steps, B), np.float32),
    }


def test_fed_tp_round_with_a_masked_client_matches_jax():
    C, TP, lr, steps = 4, 2, 1e-3, 2
    jm = jbuild("tiny-llama", num_labels=2, dtype=jnp.float32)
    ids = np.ones((2, 16), np.int32)
    frozen = jm.init(jax.random.key(0), ids, ids)["params"]
    specs = jtp_param_specs(jm, frozen)
    mesh = jmesh.fed_tp_mesh(C, TP)
    frozen = jax.device_put(frozen, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs))
    ad = jlora.init_lora(jax.random.key(1), frozen, rank=2,
                         targets=_targets("tiny-llama"))
    stacked = jfed_tp.stack_adapters(mesh, ad, C)
    batches = _round_batches(C, steps, 2, 16)
    rngs = jax.random.key_data(jax.random.split(jax.random.key(2), C))
    mask = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    jround = jfed_tp.build_fed_tp_round(jm, mesh, learning_rate=lr)
    jnew, jstats = jround(stacked, frozen, jax.tree.map(jnp.asarray, batches),
                          rngs, mask=jnp.asarray(mask))

    tm = build("tiny-llama", num_labels=2, dtype=torch.float32)
    state = convert.from_flax(_np(frozen))
    tmesh_ = tmesh.fed_tp_mesh(C, TP, [CPU] * 8)
    tm.requires_grad_(False)
    round_fn = fed_tp.build_fed_tp_round(
        tm, tmesh_, frozen_specs=tp_param_specs(tm, _flax_paths(tm)),
        learning_rate=lr)
    tstacked = fed_tp.stack_adapters(
        tmesh_, convert.from_flax_adapters(_np(ad)), C)
    tnew, tstats = round_fn(tstacked, state,
                            {k: torch.tensor(v) for k, v in batches.items()},
                            [None] * C, mask=torch.tensor(mask))
    assert len(tp_linear.split_layers(tm)) == 7 * tm.cfg.num_layers
    np.testing.assert_allclose(tstats.numpy(), np.asarray(jstats),
                               rtol=1e-5, atol=1e-6)
    want = convert.from_flax_adapters(_np(jnew))
    assert list(tnew) == list(want)
    for p, x in want.items():
        got = tnew[p].numpy()
        np.testing.assert_allclose(got, x.numpy(), atol=2 * lr * steps * 1.01,
                                   rtol=0, err_msg=p)
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], got[3])
    assert any(not np.allclose(tnew[p][2].numpy(), tnew[p][0].numpy(),
                               rtol=1e-6) for p in tnew)


def _tp_cfg(cls, part, ledger, **kw):
    base = dict(dataset="synthetic", num_labels=2, seq_len=16, batch_size=4,
                vocab_size=512, model="tiny-llama", lora_rank=2, tp=2,
                num_clients=4, num_rounds=1, learning_rate=1e-3,
                max_local_batches=1, compute_dtype="float32", eval_every=0,
                partition=part(kind="contiguous", stride=12, train_span=8,
                               test_span=4),
                ledger=ledger(enabled=True))
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("mode", ["server", "serverless"])
def test_fed_tp_engine_rounds_authenticate(mode):
    eng = FedEngine(_tp_cfg(FedConfig, PartitionConfig, LedgerConfig,
                            mode=mode, num_rounds=2), device="cpu")
    assert eng.mesh.tp == 2 and eng.mesh.mesh.shape == {"clients": 1,
                                                        "tp": 2}
    assert eng.mesh.devices == [CPU, CPU]
    assert len(tp_linear.split_layers(eng.model)) == 14
    res = eng.run()
    for r in res.metrics.rounds:
        assert r.auth == [1.0] * 4
        assert np.isfinite(r.train_loss)
    assert res.metrics.ledger["chain_ok"] == 1.0


def test_fed_tp_engine_server_round_matches_jax(monkeypatch):
    from bcfl_tpu.fed.engine import FedEngine as JEngine

    lr, steps = 1e-3, 1
    jeng = JEngine(_tp_cfg(JCfg, JPart, JLedger))
    teng = FedEngine(_tp_cfg(FedConfig, PartitionConfig, LedgerConfig),
                     device="cpu")
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


def _err(fn, exc=ValueError):
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"no {exc.__name__}")


def test_refusals_are_jax_words():
    assert (_err(lambda: _tp_cfg(FedConfig, PartitionConfig, LedgerConfig,
                                 lora_rank=0))
            == _err(lambda: _tp_cfg(JCfg, JPart, JLedger, lora_rank=0)))
    assert (_err(lambda: tmesh.client_mesh(4, [CPU], tp=2))
            == _err(lambda: jmesh.client_mesh(4, jax.devices()[:1], tp=2))
            == "tp=2 needs at least that many devices, have 1")
    assert (_err(lambda: tmesh.fed_tp_mesh(8, 2, [CPU] * 8))
            == _err(lambda: jmesh.fed_tp_mesh(8, 2)))
    assert (_err(lambda: tp_param_specs("tiny-llama", {}), TypeError)
            == _err(lambda: jtp_param_specs("tiny-llama", {}), TypeError))
    assert (_err(lambda: fed_tp.as_client_mesh(
        tmesh.fed_tp_mesh(4, 2, [CPU] * 8), 6))
            == _err(lambda: jfed_tp.as_client_mesh(jmesh.fed_tp_mesh(4, 2),
                                                   6)))
    # the engine without enough devices, as JAX's client_mesh refuses
    with pytest.raises(ValueError, match="tp=2 needs at least that many "
                                         "devices, have 1"):
        FedEngine(_tp_cfg(FedConfig, PartitionConfig, LedgerConfig),
                  devices=[CPU])
    # GQA: tp must divide the kv heads (tiny-llama has 2), or q head h
    # would not meet kv head h // rep on its shard
    tm = build("tiny-llama", num_labels=2)
    with pytest.raises(ValueError, match="tp=4 must divide num_heads=4, "
                                         "kv_heads=2"):
        tp_linear.shard_base(tm, tp_param_specs(tm, _flax_paths(tm)),
                             [CPU] * 4)
    # programs refuse a tp mesh over a base that is not split
    from bcfl_tpu_torch.fed.client_step import build_programs

    with pytest.raises(ValueError, match="split 2 ways"):
        build_programs(tm, tmesh.client_mesh(4, [CPU, CPU], tp=2),
                       adapters=True)


@pytest.mark.parametrize("flags", [["--tp", "2", "--lora-rank", "2",
                                    "--model", "tiny-llama"],
                                   ["--sp", "2"]], ids=["tp", "sp"])
def test_cli_runs_tp_and_sp_on_two_cpu_devices(flags, capsys):
    """``--tp``/``--sp`` on the CPU: the command line takes the engine's
    devices, as many CPU devices as the inner axis needs (JAX's CLI needs
    XLA's host device count flag for the same)."""
    from bcfl_tpu_torch.entrypoints.__main__ import main as cli_main

    assert cli_main(["--preset", "smoke", "--device", "cpu", "--rounds", "1",
                     "--mode", "server", "--seq-len", "16",
                     "--max-local-batches", "1"] + flags) == 0
    assert "round   0:" in capsys.readouterr().out
