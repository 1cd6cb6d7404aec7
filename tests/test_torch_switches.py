"""PyTorch port (``bcfl_tpu_torch``): the sync-path switches and the
faithful mode against the JAX package, on the CPU.

One server round of C=4 tiny-bert clients (dropout off) from the same
flax-initialised global and the same batches, against
``build_programs(...).server_round`` with the same switch, at these
tolerances:

- ``optimizer="sgd"`` (lr 1e-2, float32): SGD is linear in the gradient,
  so every coordinate within 1e-6 of JAX's (the round moves parameters by
  up to ~1.4e-3);
- ``max_grad_norm`` with SGD and one local step, optax's rule: the bound
  half the smallest client's gradient norm (every client clips) and just
  above the largest (no client clips, and the round is bit for bit the
  unclipped one): within 1e-6; and ``clip_by_global_norm_`` against
  ``optax.clip_by_global_norm`` on random float32 and bfloat16 leaves,
  at the threshold included, to one ulp of the leaf's dtype;
- ``param_dtype="bfloat16"`` (AdamW, moments in bf16) and ``"float16"``
  (SGD: AdamW's eps of 1e-8 is 0 in float16, and both packages' float16
  AdamW rounds end in NaN): leaves in the param dtype, every coordinate
  within ``2 * lr * steps`` plus two ulps of that dtype, and all but 5%
  (bf16) or 0.1% (fp16) of them within one ulp (key biases left out: their
  exact gradient is zero). In bf16 the moments and each ``p + u`` are
  rounded to 8 bits in both packages, in their own order, so a final
  rounding flips where the updates differ by a hair (2.9% of coordinates
  past one ulp at lr 1e-3, 0.8% at 5e-5, most of them near zero);
- ``compute_dtype="float16"`` with dense attention (SGD, lr 1e-2): every
  coordinate within 2e-5, float16 activations agreeing to their own ulps;
- ``remat``: the tolerance of ``tests/test_torch_round.py``; and, in the
  port alone, remat with dropout ON gives bit for bit the gradients of no
  remat under the same generator (dense and flash attention, BERT and
  ALBERT's shared layer), the generator ending where it would.

The faithful round through both engines (C=3, 2 rounds, the JAX engine's
start and batches, ledger off and on): the same records (mask, auth,
degraded), ledger length and ``chain_ok``, and the final tree within
``C * 2 * lr * steps`` per round; an all-excluded round keeps the start
and is marked degraded in both; the faithful guards raise JAX's messages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcfl_tpu.compression.codecs import _path_name
from bcfl_tpu.config import PartitionConfig as JPart
from bcfl_tpu.core import client_mesh
from bcfl_tpu.data import HashTokenizer, Partitioner as JPartitioner
from bcfl_tpu.data import TokenCache as JTokenCache, load_dataset as jload
from bcfl_tpu.data import client_batches as jclient_batches
from bcfl_tpu.fed.client_step import build_programs, make_loss_fn as jloss
from bcfl_tpu.models import build as jbuild
from bcfl_tpu_torch.core import prng
from bcfl_tpu_torch.fed import client_step as tcs
from bcfl_tpu_torch.models import build as tbuild
from bcfl_tpu_torch.models import convert
from bcfl_tpu_torch.models.bert import init_params

C, STEPS, BATCH, SEQ = 4, 2, 4, 16
LR = 5e-5
ATOL_NONE = 2e-6
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
      "float16": jnp.float16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "float16": torch.float16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    ds = jload("synthetic", num_labels=2, n_train=256, n_test=64)
    cache = JTokenCache.build(ds, HashTokenizer(512), SEQ)
    part = JPartitioner(JPart(kind="iid", iid_samples=6), ds.n_train,
                        ds.n_test, jax.random.key(0))
    tree, n_ex = jclient_batches(cache, part, C, 0, BATCH, max_batches=STEPS)
    return {"tree": tree, "n_ex": np.asarray(n_ex, np.float32)}


def _flat(tree):
    return {_path_name(p): convert._tensor(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _models(compute="float32", param="float32", remat=False):
    jm = jbuild("tiny-bert", num_labels=2, vocab_size=512, dtype=JD[compute],
                param_dtype=JD[param], dropout_rate=0.0, remat=remat)
    ids = jnp.ones((2, SEQ), jnp.int32)
    params = jm.init(jax.random.key(1), ids, ids)["params"]
    tm = tbuild("tiny-bert", num_labels=2, vocab_size=512, dtype=TD[compute],
                param_dtype=TD[param], dropout_rate=0.0, remat=remat)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _round(setup, compute="float32", param="float32", optimizer="adamw",
           lr=LR, max_grad_norm=0.0, remat=False, steps=STEPS):
    """One server round in both packages: (JAX's tree, the port's
    ``RoundOut``, the start tree)."""
    jm, params, tm = _models(compute, param, remat)
    tree = {k: v[:, :steps] for k, v in setup["tree"].items()}
    progs = build_programs(jm, client_mesh(C), optimizer=optimizer,
                           learning_rate=lr, max_grad_norm=max_grad_norm)
    w = setup["n_ex"]
    rngs = jax.random.key_data(jax.vmap(jax.random.key)(
        jnp.arange(C, dtype=jnp.uint32)))
    g_j, stats_j = progs.server_round(params, None,
                                      jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(w), rngs)
    g0 = _flat(params)
    local = tcs.make_local_train(tm, tcs.make_loss_fn(tm), optimizer, lr,
                                 max_grad_norm)
    out = tcs.server_round(local, None, g0,
                           {k: torch.from_numpy(v) for k, v in tree.items()},
                           torch.from_numpy(w), [None] * C)
    # [loss*n, correct, n] per client: the second step's loss sees the
    # first step's low-precision rounding, so 1e-2 below float32
    low = (compute, param) != ("float32", "float32")
    np.testing.assert_allclose(out.stats.numpy(), np.asarray(stats_j),
                               rtol=1e-2 if low else 1e-4,
                               atol=1e-2 if low else 1e-4)
    flat_j = _flat(g_j)
    assert list(out.global_t) == list(flat_j)
    for p, x in out.global_t.items():
        assert x.dtype == TD[param] == flat_j[p].dtype, p
    return flat_j, out, g0


def _max_err(flat_j, out):
    return max(float((out.global_t[p].float() - x.float()).abs().max())
               for p, x in flat_j.items())


def _moved(flat_j, g0):
    return max(float((x.float() - g0[p].float()).abs().max())
               for p, x in flat_j.items())


def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """One ulp of each value of ``x`` in ``dtype`` (subnormals floored)."""
    mant, tiny = {torch.bfloat16: (7, 2.0 ** -126),
                  torch.float16: (10, 2.0 ** -14)}[dtype]
    ax = torch.clamp(x.float().abs(), min=tiny)
    return torch.exp2(torch.floor(torch.log2(ax)) - mant)


# ------------------------------------------------------------ optimizers


def test_sgd_round_matches_jax(setup):
    flat_j, out, g0 = _round(setup, optimizer="sgd", lr=1e-2)
    assert _max_err(flat_j, out) <= 1e-6
    assert _moved(flat_j, g0) > 1e-4  # the round really trained


def _grad_norms(setup):
    """Each client's global gradient norm at the start, on its first
    batch (JAX's loss)."""
    jm, params, _ = _models()
    loss = jloss(jm)
    norms = []
    for c in range(C):
        batch = {k: jnp.asarray(v[c, 0]) for k, v in setup["tree"].items()}
        g = jax.jit(jax.grad(lambda t, b: loss(t, None, b, None)[0]))(
            params, batch)
        norms.append(float(jnp.sqrt(sum(jnp.sum(x * x)
                                        for x in jax.tree.leaves(g)))))
    return norms


@pytest.mark.parametrize("where", ["active", "just-below"])
def test_clipped_round_matches_jax(setup, where):
    norms = _grad_norms(setup)
    bound = (0.5 * min(norms) if where == "active"
             else max(norms) * (1 + 1e-3))
    flat_j, out, _ = _round(setup, optimizer="sgd", lr=1e-2,
                            max_grad_norm=bound, steps=1)
    assert _max_err(flat_j, out) <= 1e-6
    _, free, _ = _round(setup, optimizer="sgd", lr=1e-2, steps=1)
    diff = max(float((free.global_t[p] - x).abs().max())
               for p, x in out.global_t.items())
    if where == "active":
        assert diff > 1e-5  # every client's step was scaled down
    else:
        assert diff == 0.0  # the gradients passed through untouched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0])
def test_clip_by_global_norm_matches_optax(dtype, scale):
    import optax

    rng = np.random.default_rng(int(scale * 10))
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((7, 3), (11,), (2, 5, 4))]
    jl = [jnp.asarray(x, JD[dtype]) for x in leaves]
    norm = float(jnp.sqrt(sum(jnp.sum(x * x) for x in jl)))
    bound = norm * scale  # scale 1.0: g == max_norm, which clips
    want, _ = optax.clip_by_global_norm(bound).update(jl, None)
    got = [torch.from_numpy(x).to(TD[dtype], copy=True) for x in leaves]
    tcs.clip_by_global_norm_(got, bound)
    for g, w in zip(got, want):
        w = convert._tensor(w)
        assert g.dtype == w.dtype
        tol = (_ulp(w, g.dtype) if dtype == "bfloat16"
               else 1e-6 * w.abs() + 1e-7)
        assert bool(((g.float() - w.float()).abs() <= tol).all())
    if scale != 1.0:  # at the threshold (t / g) * g is t to an ulp
        assert (max(float(g.float().abs().max()) for g in got)
                < max(float(np.abs(x).max()) for x in leaves)) == (scale < 1)


# ------------------------------------------------------------ dtypes


@pytest.mark.parametrize("param,optimizer,lr,frac", [
    ("bfloat16", "adamw", 1e-3, 0.05),
    ("float16", "sgd", 1e-2, 1e-3),
])
def test_low_precision_params_round_matches_jax(setup, param, optimizer, lr,
                                                frac):
    flat_j, out, g0 = _round(setup, param=param, optimizer=optimizer, lr=lr)
    dt = TD[param]
    far = total = 0
    for p, x in flat_j.items():
        err = (out.global_t[p].float() - x.float()).abs()
        ulp = _ulp(x, dt)
        assert bool((err <= 2 * lr * STEPS * 1.01 + 2 * ulp).all()), p
        if not p.endswith("/key/bias"):
            far += int((err > ulp).sum())
            total += err.numel()
    assert far <= frac * total, f"{far} of {total} coordinates past one ulp"
    assert _moved(flat_j, g0) > 1e-4


def test_adamw_moments_follow_the_param_dtype():
    tm = tbuild("tiny-bert", num_labels=2, vocab_size=512,
                dtype=torch.float32, param_dtype=torch.bfloat16)
    opt = tcs.make_optimizer(tm.parameters(), "adamw", LR)
    for p in tm.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    for state in opt.state.values():
        assert state["exp_avg"].dtype == torch.bfloat16
        assert state["exp_avg_sq"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown optimizer"):
        tcs.make_optimizer(tm.parameters(), "lamb")


def test_fp16_compute_dense_round_matches_jax(setup):
    flat_j, out, g0 = _round(setup, compute="float16", optimizer="sgd",
                             lr=1e-2)
    assert _max_err(flat_j, out) <= 2e-5
    assert _moved(flat_j, g0) > 1e-4


# ------------------------------------------------------------ remat


def test_remat_round_matches_jax(setup):
    flat_j, out, g0 = _round(setup, remat=True)
    far = total = 0
    for p, x in flat_j.items():
        err = (out.global_t[p] - x).abs()
        assert float(err.max()) <= 2 * LR * STEPS * 1.01, p
        if not p.endswith("/key/bias"):
            far += int((err > ATOL_NONE).sum())
            total += err.numel()
    assert far <= total * 1e-4
    assert _moved(flat_j, g0) > 10 * ATOL_NONE


@pytest.mark.parametrize("model,flash", [("tiny-bert", False),
                                         ("tiny-albert", False),
                                         ("tiny-bert", True)])
def test_remat_gradients_equal_no_remat_with_dropout(model, flash):
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(4, 512, (3, 24)).astype(np.int64))
    mask = torch.from_numpy(
        (np.arange(24)[None] < np.array([[24], [17], [9]])).astype(np.int32))
    grads, ends = [], []
    for remat in (False, True):
        tm = tbuild(model, num_labels=2, vocab_size=512, dtype=torch.float32,
                    remat=remat, use_flash=flash, flash_min_seq=0)
        init_params(tm, prng.generator("cpu", 3))
        g = prng.generator("cpu", 9)
        tm.train()
        for _ in range(2):  # a second step draws after the first backward
            tm.zero_grad()
            tm(ids, mask, deterministic=False, generator=g).sum().backward()
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
        ends.append(g.get_state())
    for n, x in grads[0].items():
        assert torch.equal(x, grads[1][n]), n
    assert torch.equal(ends[0], ends[1])


# ------------------------------------------------------------ faithful


def _faithful_configs(ledger, **extra):
    from bcfl_tpu.config import FedConfig as JCfg, LedgerConfig as JLed
    from bcfl_tpu_torch.config import (FedConfig as TCfg, LedgerConfig as TLed,
                                       PartitionConfig as TPart)

    kw = dict(name="faithful", model="tiny-bert", dataset="synthetic",
              num_labels=2, mode="serverless", faithful=True,
              weighted_agg=False, num_clients=3, num_rounds=2, seq_len=SEQ,
              batch_size=BATCH, max_local_batches=STEPS, vocab_size=512,
              eval_every=0, compute_dtype="float32", **extra)
    part = dict(kind="iid", iid_samples=6, resample_each_round=True)
    return (JCfg(**kw, partition=JPart(**part),
                 ledger=JLed(enabled=ledger, use_native=False)),
            TCfg(**kw, partition=TPart(**part), ledger=TLed(enabled=ledger)))


def _faithful_engines(monkeypatch, ledger):
    import bcfl_tpu.models as jmodels
    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from bcfl_tpu_torch.fed.engine import FedEngine as TEngine

    jcfg, tcfg = _faithful_configs(ledger)
    build = jmodels.build
    monkeypatch.setattr(jmodels, "build",
                        lambda *a, **k: build(*a, dropout_rate=0.0, **k))
    jeng = JEngine(jcfg)
    teng = TEngine(tcfg, device="cpu")
    teng.trainable0 = {p: x.clone() for p, x in _flat(
        jeng.trainable0).items()}
    batches = {}

    def round_batches(rnd):
        if rnd not in batches:
            tree, n_ex = jeng._round_batches(rnd)
            batches[rnd] = ({k: torch.from_numpy(np.array(v))
                             for k, v in tree.items()}, np.asarray(n_ex))
        return batches[rnd]

    monkeypatch.setattr(teng, "_round_batches", round_batches)
    monkeypatch.setattr(teng, "_generators", lambda rnd: [None] * 3)
    return jeng, teng


@pytest.mark.parametrize("ledger", [False, True], ids=["no-ledger", "ledger"])
def test_faithful_engine_matches_jax(monkeypatch, ledger):
    jeng, teng = _faithful_engines(monkeypatch, ledger)
    jres, tres = jeng.run(), teng.run()
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        for field in ("mask", "auth", "degraded", "bytes_on_wire",
                      "info_passing_sync_s", "info_passing_async_s"):
            assert getattr(rt, field) == getattr(rj, field), (rt.round, field)
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
        assert rt.auth == ([1.0] * 3 if ledger else None)
    if ledger:
        assert len(tres.ledger) == len(jres.ledger) == 3 * 2
        assert tres.metrics.ledger["chain_ok"] == 1.0 == jres.metrics.ledger[
            "chain_ok"]
        for key in ("full_weights_gb", "ledger_gb", "reduction"):
            assert tres.metrics.ledger[key] == jres.metrics.ledger[key]
    # each round's last client trained C times in sequence
    bound = 2 * 3 * 2 * LR * STEPS * 1.01
    start = teng.trainable0
    for p, x in _flat(jres.trainable).items():
        err = (tres.trainable[p] - x).abs()
        assert float(err.max()) <= bound, p
    assert max(float((tres.trainable[p] - start[p]).abs().max())
               for p in start) > 10 * ATOL_NONE


def test_faithful_all_excluded_round_keeps_the_start(monkeypatch):
    jeng, teng = _faithful_engines(monkeypatch, True)
    gate = {"mask": np.zeros(3, np.float32), "anomalies": []}
    monkeypatch.setattr(jeng, "_participation", lambda *a, **k: gate)
    monkeypatch.setattr(teng, "_participation", lambda *a, **k: gate)
    jres, tres = jeng.run(), teng.run()
    assert [r.degraded for r in tres.metrics.rounds] == [
        r.degraded for r in jres.metrics.rounds] == [True, True]
    for p, x in teng.trainable0.items():
        assert torch.equal(tres.trainable[p], x), p
    assert tres.metrics.ledger["chain_ok"] == 1.0


@pytest.mark.parametrize("kw", [
    {"aggregator": "median"},
    {"compression": "int8+topk"},
    {"aggregator": "krum", "compression": "int8"},
], ids=["aggregator", "compression", "both"])
def test_faithful_guards_match_jax(kw):
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.config import FedConfig as JCfg
    from bcfl_tpu_torch.compression import CompressionConfig as TComp
    from bcfl_tpu_torch.config import FedConfig as TCfg

    errs = []
    for cfg_cls, comp_cls in ((JCfg, JComp), (TCfg, TComp)):
        args = dict(kw, mode="serverless", faithful=True)
        if "compression" in args:
            args["compression"] = comp_cls(kind=args["compression"])
        with pytest.raises(ValueError) as e:
            cfg_cls(**args)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "faithful (host-sequential)" in errs[0]


def test_switches_run_end_to_end_on_cpu():
    """Every switch at once through ``run``: finite, the tree in bf16."""
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import FedConfig, PartitionConfig
    from bcfl_tpu_torch.entrypoints import run

    cfg = FedConfig(dataset="synthetic", model="tiny-bert", num_clients=2,
                    num_rounds=2, seq_len=16, batch_size=4,
                    max_local_batches=2, vocab_size=512, max_eval_batches=2,
                    partition=PartitionConfig(kind="iid", iid_samples=8),
                    compression=CompressionConfig(kind="int8+topk"),
                    optimizer="sgd", learning_rate=1e-2, max_grad_norm=1.0,
                    param_dtype="bfloat16", remat=True)
    res = run(cfg, device="cpu", verbose=False)
    for r in res.metrics.rounds:
        assert np.isfinite(r.train_loss) and np.isfinite(r.global_loss)
    for p, x in res.trainable.items():
        assert x.dtype == torch.bfloat16 and bool(torch.isfinite(x).all()), p
    assert dataclasses.asdict(cfg)["remat"] is True
