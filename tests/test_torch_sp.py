"""PyTorch port (``bcfl_tpu_torch``): sequence parallelism
(``bcfl_tpu_torch/parallel/sp.py``, the models' ``attention_override``
hook, ``FedConfig(sp=...)``) against the JAX package's
(``bcfl_tpu/parallel/sp.py``) on the same numpy-seeded inputs and the
same weights (JAX's, carried across with ``convert.from_flax``).

The JAX side runs on the conftest's 8 virtual CPU devices, the port's on
a list of 8 CPU devices; both models compute in float32 with dropout off,
at the shapes of ``tests/test_sp_model.py`` (seq 64, ragged padding):

- JAX's errors, word for word: a mesh without a ``seq`` axis, a config
  without the hook, ``client_mesh``'s inner-axis checks, ``FedConfig``'s
  sp checks;
- tiny-llama LM logits under the causal ring within 2e-5 of JAX's
  (absolute and relative), the gradients of the next-token loss within
  1e-5 absolute (JAX's own ring-vs-dense tests use 2e-4 for both);
- tiny-bert classifier logits and gradients under the non-causal ring at
  the same tolerances;
- one ``make_sp_lm_train_step`` step: the loss within rtol 1e-5, the
  updated parameters within ``2 * lr`` (one AdamW step moves a
  coordinate by at most about ``lr``; one whose gradient is near zero may
  move the other way);
- one ``FedConfig(sp=2)`` engine round (tiny-llama causal-LM LoRA, 2
  clients, server FedAvg) against the JAX engine's from the same frozen
  base and adapters: the records' masks exact, the train loss at rtol
  1e-4 and the adapters within ``2 * lr * steps`` per client trained in
  sequence (the tolerances of ``tests/test_torch_llama_engine.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh as JMesh

from bcfl_tpu.models import get_config as jget_config
from bcfl_tpu.models.bert import TextClassifier as JTextClassifier
from bcfl_tpu.models.llama import LlamaLM as JLlamaLM
from bcfl_tpu.parallel import sp as jsp
from bcfl_tpu_torch.config import FedConfig, PartitionConfig
from bcfl_tpu_torch.core import mesh as tmesh
from bcfl_tpu_torch.models import convert, get_config
from bcfl_tpu_torch.models.bert import TextClassifier
from bcfl_tpu_torch.models.llama import LlamaLM
from bcfl_tpu_torch.parallel import sp as tsp

OUT_TOL = 2e-5
GRAD_TOL = 1e-5
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(axis="seq"):
    return JMesh(np.asarray(jax.devices()), (axis,))


def _tmesh(axis="seq"):
    return tmesh._mesh(CPU8, (8,), (axis,))


def _batch(seq=64, B=2, vocab=8192, pad_last=10):
    rng = np.random.default_rng(0)
    ids = rng.integers(4, vocab, (B, seq)).astype(np.int32)
    mask = np.ones((B, seq), np.int32)
    mask[1, seq - pad_last:] = 0
    return ids, mask


def _err(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_errors_are_jax_words():
    @dataclasses.dataclass(frozen=True)
    class NoHook:
        x: int = 1

    assert (_err(lambda: tsp.ring_config(NoHook(), _tmesh()))
            == _err(lambda: jsp.ring_config(NoHook(), _jmesh())))
    from bcfl_tpu.core.mesh import client_mesh as jclient_mesh

    for kw in (dict(sp=4), dict(sp=2, tp=2), dict(sp=0)):
        assert (_err(lambda: tmesh.client_mesh(2, [torch.device("cpu")],
                                               **kw))
                == _err(lambda: jclient_mesh(2, jax.devices()[:1], **kw)))
    from bcfl_tpu.config import FedConfig as JCfg

    for kw in (dict(sp=2, tp=2, lora_rank=2), dict(sp=3, seq_len=64),
               dict(sp=-1)):
        assert _err(lambda: FedConfig(**kw)) == _err(lambda: JCfg(**kw)), kw
    cfg = FedConfig(sp=4, seq_len=64)  # constructs, as JAX's does
    assert JCfg(sp=4, seq_len=64).sp == cfg.sp == 4


@pytest.mark.parametrize("fn", ["ring_override", "ring_config"])
def test_mesh_axis_error_matches_jax(fn):
    jbase, tbase = jget_config("tiny-llama"), get_config("tiny-llama")
    args = {"ring_override": ((), ()), "ring_config": ((tbase,), (jbase,))}
    got = _err(lambda: getattr(tsp, fn)(*args[fn][0], _tmesh("clients")))
    want = _err(lambda: getattr(jsp, fn)(*args[fn][1], _jmesh("clients")))
    assert got.split(":")[0] == want.split(":")[0] == (
        "mesh has no 'seq' axis")
    # JAX prints its Mesh.shape, an OrderedDict
    assert got.endswith("{'clients': 8}") and "{'clients': 8}" in want


def _llama_pair(seq=64):
    jbase = jget_config("tiny-llama", dtype=jnp.float32, use_flash=False,
                        max_position=seq)
    tbase = get_config("tiny-llama", dtype=torch.float32, use_flash=False,
                       max_position=seq)
    jm = JLlamaLM(jsp.ring_config(jbase, _jmesh()))
    tm = LlamaLM(tsp.ring_config(tbase, _tmesh()))
    return jm, tm


def _lm_loss(logits, ids, mask):
    """the next-token loss of ``tests/test_sp_model.py``, in either
    package's arrays"""
    if isinstance(logits, torch.Tensor):
        lg = logits[:, :-1]
        w = mask[:, 1:].float()
        per = torch.nn.functional.cross_entropy(
            lg.reshape(-1, lg.shape[-1]), ids[:, 1:].long().reshape(-1),
            reduction="none").view(w.shape)
        return (per * w).sum() / w.sum()
    per = optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1].astype(jnp.float32), ids[:, 1:])
    w = mask[:, 1:].astype(jnp.float32)
    return (per * w).sum() / w.sum()


def _grads_match(jgrads, model):
    flat = convert.from_flax(jax.tree.map(np.asarray, jgrads))
    for key, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat[key].numpy(),
                                   atol=GRAD_TOL, rtol=0, err_msg=key)


def test_llama_lm_forward_and_grads_under_the_ring_match_jax():
    jm, tm = _llama_pair()
    ids, mask = _batch()
    params = jm.init(jax.random.key(0), ids, mask)["params"]
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    want = jax.jit(lambda p: jm.apply({"params": p}, ids, mask))(params)
    tids, tmask = torch.tensor(ids), torch.tensor(mask)
    got = tm(tids, tmask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_TOL, rtol=OUT_TOL)
    jgrads = jax.jit(jax.grad(lambda p: _lm_loss(
        jm.apply({"params": p}, ids, mask), ids, mask)))(params)
    _lm_loss(got, tids, tmask).backward()
    _grads_match(jgrads, tm)


def test_bert_classifier_forward_and_grads_under_the_ring_match_jax():
    jbase = jget_config("tiny-bert", dtype=jnp.float32, num_labels=3)
    tbase = get_config("tiny-bert", dtype=torch.float32, num_labels=3)
    jm = JTextClassifier(jsp.ring_config(jbase, _jmesh()))
    tm = TextClassifier(tsp.ring_config(tbase, _tmesh()))
    ids, mask = _batch(vocab=jbase.vocab_size)
    labels = np.array([0, 2], np.int32)
    params = jm.init(jax.random.key(2), ids, mask)["params"]
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    want = jax.jit(lambda p: jm.apply({"params": p}, ids, mask))(params)
    tids, tmask = torch.tensor(ids), torch.tensor(mask)
    got = tm(tids, tmask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_TOL, rtol=OUT_TOL)
    ce = optax.softmax_cross_entropy_with_integer_labels
    jgrads = jax.jit(jax.grad(lambda p: ce(
        jm.apply({"params": p}, ids, mask), labels).mean()))(params)
    torch.nn.functional.cross_entropy(got, torch.tensor(labels).long()
                                      ).backward()
    _grads_match(jgrads, tm)


def test_sp_train_step_matches_jax():
    lr = 1e-3
    jm, tm = _llama_pair()
    ids, mask = _batch()
    jstep, tx = jsp.make_sp_lm_train_step(jm, _jmesh(), learning_rate=lr)
    params = jsp.init_sp_lm(jm, _jmesh(), batch=2, seq=64)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    batch = {"ids": ids, "mask": mask,
             "example_mask": np.ones((2,), np.float32)}
    new, _, jloss = jstep(params, tx.init(params),
                          jax.tree.map(jnp.asarray, batch))
    tstep, _ = tsp.make_sp_lm_train_step(tm, _tmesh(), learning_rate=lr)
    tloss = tstep({k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    flat = convert.from_flax(jax.tree.map(np.asarray, new))
    for key, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[key].numpy(),
                                   atol=2 * lr, rtol=0, err_msg=key)
    assert tsp.init_sp_lm(tm, _tmesh()) is tm
    with pytest.raises(ValueError, match="mesh has no 'seq' axis"):
        tsp.make_sp_lm_train_step(tm, _tmesh("clients"))


def test_fed_sp_engine_round_matches_jax(monkeypatch):
    from bcfl_tpu.config import FedConfig as JCfg
    from bcfl_tpu.config import PartitionConfig as JPart
    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from bcfl_tpu_torch.fed.engine import FedEngine
    import importlib

    tra = importlib.import_module("bcfl_tpu_torch.parallel.ring_attention")

    lr, steps = 1e-3, 1
    part = dict(kind="contiguous", stride=12, train_span=8, test_span=4)
    base = dict(name="fed_sp", model="tiny-llama", dataset="synthetic",
                task="causal_lm", lora_rank=2, mode="server", num_clients=2,
                num_rounds=1, seq_len=32, batch_size=2,
                max_local_batches=steps, sp=2, vocab_size=512,
                eval_every=0, learning_rate=lr, compute_dtype="float32")
    jeng = JEngine(JCfg(**base, partition=JPart(**part)))
    teng = FedEngine(FedConfig(**base, partition=PartitionConfig(**part)),
                     device="cpu")
    assert teng.mesh.mesh.shape == {"clients": 1, "seq": 2}
    assert teng.model.cfg.attention_override is not None
    assert not teng.model.cfg.use_flash
    teng.model.load_state_dict(convert.from_flax(
        jax.tree.map(np.asarray, jeng.frozen)))
    teng.trainable0 = convert.from_flax_adapters(
        jax.tree.map(np.asarray, jeng.trainable0))
    monkeypatch.setattr(teng, "_generators", lambda rnd: [None] * 2)
    tra.reset_rotations()
    jres, tres = jeng.run(), teng.run()
    # one ring call per layer (2) of each client's (2) training steps,
    # one rotation each at sp=2
    assert tra.rotations() == 2 * steps * 2
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        assert rt.mask == rj.mask
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    for p, x in convert.from_flax_adapters(
            jax.tree.map(np.asarray, jres.trainable)).items():
        np.testing.assert_allclose(tres.trainable[p].numpy(), x.numpy(),
                                   atol=2 * lr * steps * 2 * 1.01, rtol=0,
                                   err_msg=p)
