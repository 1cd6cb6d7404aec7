"""PyTorch port (``bcfl_tpu_torch``): serverless ring gossip and the BC-FL
async path against the JAX package.

(a) The gossip functions (``ring_shift``, ``gossip_mix``,
``gossip_mix_recv`` at steps 1 and 2 with partial masks,
``mix_with_matrix`` on a Metropolis matrix) against
``bcfl_tpu.parallel.gspmd`` on random stacked trees, at atol 1e-6.

(b) One serverless round of C=4 tiny-bert clients (float32, dropout 0,
S=16, 2 local AdamW steps), each client starting from its own row, with
and without ``int8+topk`` (``topk_frac=1.0``, ``stochastic=False``),
against ``build_programs(...).gossip_round``, at the tolerance of
``tests/test_torch_round.py`` (every coordinate within ``2 * lr * steps``
plus one quantization step, all but 1e-4 of them within 2e-6 plus one
step). Fed JAX's post-train trees and JAX's uniforms, the local-mode
encoder gives JAX's payload, reconstruction and residual bit for bit, and
``mix_recv`` JAX's mix at atol 1e-6.

The async engine, the presets and the CLI: ``tests/test_torch_bcfl_async.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcfl_tpu.compression import CompressionConfig as JComp
from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu.config import PartitionConfig as JPart
from bcfl_tpu.core import client_mesh
from bcfl_tpu.data import HashTokenizer, Partitioner as JPartitioner
from bcfl_tpu.data import TokenCache as JTokenCache, load_dataset as jload
from bcfl_tpu.data import client_batches as jclient_batches
from bcfl_tpu.fed.client_step import build_programs
from bcfl_tpu.models import build as jbuild
from bcfl_tpu.parallel import gspmd
from bcfl_tpu.topology.graph import metropolis_mixing_matrix
from bcfl_tpu_torch import parallel as tpar
from bcfl_tpu_torch.compression import CompressionConfig as TComp
from bcfl_tpu_torch.fed import client_step as cs
from bcfl_tpu_torch.models import build as tbuild

C, STEPS, BATCH, SEQ = 4, 2, 4, 16
LR = 5e-5
ATOL_MIX = 1e-6
ATOL_NONE = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ (a) gossip


def _stacked(rng, C=5):
    return {"a/w": rng.standard_normal((C, 7, 3)).astype(np.float32),
            "b": rng.standard_normal((C, 11)).astype(np.float32)}


def _j(tree):
    return {p: jnp.asarray(x) for p, x in tree.items()}


def _t(tree):
    return {p: torch.from_numpy(np.array(x)) for p, x in tree.items()}


def _assert_trees(t, j, atol=ATOL_MIX):
    assert list(t) == list(j)
    for p in j:
        np.testing.assert_allclose(t[p].numpy(), np.asarray(j[p]), rtol=0,
                                   atol=atol, err_msg=p)


MASKS = [[1, 1, 1, 1, 1], [1, 0, 1, 1, 0], [0, 0, 0, 0, 0],
         [0, 1, 1, 1, 1]]


@pytest.mark.parametrize("direction", [1, -1])
def test_ring_shift_matches_gspmd(direction):
    tree = _stacked(np.random.default_rng(direction + 2))
    _assert_trees(tpar.ring_shift(_t(tree), direction),
                  gspmd.ring_shift(_j(tree), direction), atol=0)
    with pytest.raises(ValueError):
        tpar.ring_shift(_t(tree), 2)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("mask", MASKS)
def test_gossip_mix_and_recv_match_gspmd(mask, steps):
    rng = np.random.default_rng(steps * 10 + sum(mask))
    tree, recv = _stacked(rng), _stacked(rng)
    m = np.asarray(mask, np.float32)
    _assert_trees(tpar.gossip_mix(_t(tree), torch.from_numpy(m), 0.5,
                                  steps=steps),
                  gspmd.gossip_mix(_j(tree), jnp.asarray(m), 0.5,
                                   steps=steps))
    _assert_trees(tpar.gossip_mix_recv(_t(tree), _t(recv),
                                       torch.from_numpy(m), 0.3, steps=steps),
                  gspmd.gossip_mix_recv(_j(tree), _j(recv), jnp.asarray(m),
                                        0.3, steps=steps))


@pytest.mark.parametrize("mask", MASKS)
def test_mix_with_matrix_matches_gspmd(mask):
    tree = _stacked(np.random.default_rng(7))
    W = metropolis_mixing_matrix(np.asarray(mask, np.float32))
    _assert_trees(tpar.mix_with_matrix(_t(tree), torch.from_numpy(W)),
                  gspmd.mix_with_matrix(_j(tree), jnp.asarray(W)))


@pytest.mark.parametrize("steps", [0, 1])
def test_mix_programs_match_jax_exact_mean_and_gossip(steps):
    """``mix``/``mix_recv`` (exact masked mean at ``gossip_steps=0``, ring
    gossip otherwise) and ``adopt``/``broadcast`` against the engine's
    programs."""
    jm = jbuild("tiny-bert", num_labels=2, vocab_size=64, dtype=jnp.float32)
    progs = build_programs(jm, client_mesh(5), gossip_steps=steps,
                           gossip_alpha=0.5)
    rng = np.random.default_rng(steps)
    tree, recv, start = _stacked(rng), _stacked(rng), _stacked(rng)
    m = np.asarray([1, 0, 1, 1, 0], np.float32)
    _assert_trees(cs.mix(_t(tree), torch.from_numpy(m), _t(start), 0.5, steps),
                  progs.mix_only(_j(tree), jnp.asarray(m), _j(start)))
    _assert_trees(
        cs.mix_recv(_t(tree), _t(recv), torch.from_numpy(m), _t(start), 0.5,
                    steps),
        progs.mix_recv(_j(tree), _j(recv), jnp.asarray(m), _j(start)))
    glob = {p: x[0] * 3 for p, x in tree.items()}
    pull = np.asarray([0, 1, 1, 0, 0], np.float32)
    _assert_trees(cs.adopt(_t(tree), _t(glob), torch.from_numpy(pull)),
                  progs.adopt(_j(tree), _j(glob), jnp.asarray(pull)), atol=0)
    b = cs.broadcast(_t(glob), 5)
    assert all(torch.equal(b[p][c], _t(glob)[p]) for p in b for c in range(5))


# --------------------------------------------------- (b) one gossip round


@pytest.fixture(scope="module")
def setup():
    ds = jload("synthetic", num_labels=2, n_train=256, n_test=64)
    cache = JTokenCache.build(ds, HashTokenizer(512), SEQ)
    part = JPartitioner(JPart(kind="iid", iid_samples=6), ds.n_train,
                        ds.n_test, jax.random.key(0))
    tree, _ = jclient_batches(cache, part, C, 0, BATCH, max_batches=STEPS)
    jm = jbuild("tiny-bert", num_labels=2, vocab_size=512,
                dtype=jnp.float32, dropout_rate=0.0)
    ids = jnp.ones((2, SEQ), jnp.int32)
    params = jm.init(jax.random.key(1), ids, ids)["params"]
    # each client starts from its own row: the global plus a small
    # per-client offset
    rng = np.random.default_rng(9)
    stacked = jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x)[None] + 1e-3 * rng.standard_normal(
            (C,) + x.shape).astype(np.float32)), params)
    tm = tbuild("tiny-bert", num_labels=2, vocab_size=512,
                dtype=torch.float32, dropout_rate=0.0)
    rngs = jax.random.key_data(jax.vmap(jax.random.key)(
        jnp.arange(C, dtype=jnp.uint32)))
    return {"tree": tree, "jm": jm, "stacked": stacked, "tm": tm,
            "rngs": rngs, "mask": np.asarray([1, 1, 0, 1], np.float32)}


def _flat(tree):
    return {jcc._path_name(p): torch.from_numpy(np.array(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_uniforms(key):
    def draw(i, shape, device):
        u = jax.random.uniform(jax.random.fold_in(key, i), shape)
        return torch.from_numpy(np.array(u)).to(device)
    return draw


def _codec_key(rngs):
    return jcc.codec_key(jax.random.wrap_key_data(rngs))


def _assert_round_close(flat_j, got, step_of=lambda p: 0.0):
    far = total = 0
    for p, x in flat_j.items():
        err = np.abs(got[p].numpy() - x.numpy())
        step = step_of(p)
        assert err.max() <= 2 * LR * STEPS * 1.01 + step, p
        if not p.endswith("/key/bias"):
            far += int((err > ATOL_NONE + step).sum())
            total += err.size
    assert far <= total * 1e-4, f"{far} of {total} coordinates past atol"


@pytest.mark.parametrize("codec", [False, True])
def test_gossip_round_matches_jax(setup, codec):
    jcomp = (JComp(kind="int8+topk", topk_frac=1.0, stochastic=False)
             if codec else None)
    tcomp = (TComp(kind="int8+topk", topk_frac=1.0, stochastic=False)
             if codec else None)
    progs = build_programs(setup["jm"], client_mesh(C), compression=jcomp,
                           gossip_steps=1, gossip_alpha=0.5)
    batches = jax.tree.map(jnp.asarray, setup["tree"])
    m = jnp.asarray(setup["mask"])
    if codec:
        (mixed_j, _), stats_j = progs.gossip_round(
            (setup["stacked"], progs.ef_init(
                jax.tree.map(lambda x: x[0], setup["stacked"]))),
            None, batches, m, setup["rngs"])
    else:
        mixed_j, stats_j = progs.gossip_round(setup["stacked"], None,
                                              batches, m, setup["rngs"])
    tm = setup["tm"]
    local = cs.make_local_train(tm, cs.make_loss_fn(tm))
    start = _flat(setup["stacked"])
    resid = {p: torch.zeros_like(x) for p, x in start.items()}
    out = cs.gossip_round(local, tcomp, start,
                          {k: torch.from_numpy(v)
                           for k, v in setup["tree"].items()},
                          torch.from_numpy(setup["mask"]), [None] * C, resid,
                          None, alpha=0.5, steps=1)
    np.testing.assert_allclose(out.stats.numpy(), np.asarray(stats_j),
                               rtol=1e-4, atol=1e-4)
    flat_j = _flat(mixed_j)
    assert list(out.global_t) == list(flat_j)
    step_of = ((lambda p: float(out.payload[p]["s"].max())) if codec
               else (lambda p: 0.0))
    _assert_round_close(flat_j, out.global_t, step_of)
    # the masked client kept its post-train state: it moved from its start
    moved = max(float((out.global_t[p][2] - start[p][2]).abs().max())
                for p in start)
    assert moved > 10 * ATOL_NONE


def test_local_encoder_and_mix_recv_bit_for_bit_on_jax_inputs(setup):
    """The codec stage fed JAX's own post-train trees and uniforms."""
    jcomp = JComp(kind="int8+topk")
    tcomp = TComp(kind="int8+topk")
    progs = build_programs(setup["jm"], client_mesh(C), compression=jcomp,
                           gossip_steps=1, gossip_alpha=0.5)
    batches = jax.tree.map(jnp.asarray, setup["tree"])
    new_j, _ = progs.local_updates(setup["stacked"], None, batches,
                                   setup["rngs"])
    # every third leaf of the trees, as ``{path: array}`` (the eager JAX
    # codec below compiles each op once per shape, 25 s for every leaf)
    paths = sorted(_flat(new_j))[::3]
    new_j = {p: jnp.asarray(_flat(new_j)[p].numpy()) for p in paths}
    start_j = {p: jnp.asarray(_flat(setup["stacked"])[p].numpy())
               for p in paths}
    rng = np.random.default_rng(5)
    ef_j = {p: jnp.asarray(1e-5 * rng.standard_normal(x.shape).astype(
        np.float32)) for p, x in start_j.items()}
    # the programs' codec stage (``_compress_stage`` + ``_recon``), run
    # eagerly: under jit XLA:CPU turns max|g| / 127 into a reciprocal
    # multiply (one ulp off), and the port holds to the eager form
    key = _codec_key(setup["rngs"])
    delta = jax.tree.map(jnp.subtract, new_j, start_j)
    pay_j, dec_j, res_j = jcc.roundtrip(jcomp, delta, ef_j, key)
    rec_j = jax.tree.map(jnp.add, start_j, dec_j)
    uniforms = _jax_uniforms(key)
    new_t, start = _flat(new_j), _flat(start_j)
    pay_t, rec_t, res_t = cs.encode_deltas(tcomp, new_t, start, _flat(ef_j),
                                           uniforms)
    for path, parts in pay_j.items():
        for name, x in parts.items():
            got, want = pay_t[path][name].numpy(), np.asarray(x)
            assert got.dtype == want.dtype, (path, name)
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8))
    for t_tree, j_tree in ((rec_t, rec_j), (res_t, res_j)):
        for p, x in _flat(j_tree).items():
            np.testing.assert_array_equal(t_tree[p].numpy().view(np.int32),
                                          x.numpy().view(np.int32), p)
    m = jnp.asarray(setup["mask"])
    _assert_trees(cs.mix_recv(new_t, rec_t, torch.from_numpy(setup["mask"]),
                              start, 0.5, 1),
                  _flat(progs.mix_recv(new_j, rec_j, m, start_j)))
    # async mode: recon-free encode, the merge decodes the deltas itself
    pay_a, res_a = cs.encode_deltas_async(tcomp, new_t, start, _flat(ef_j),
                                          uniforms)
    for p, x in _flat(jcc.decode_tree(jcomp, pay_j, new_j)).items():
        np.testing.assert_array_equal(
            cs.decode_delta(tcomp, pay_a, new_t)[p].numpy(), x.numpy())
