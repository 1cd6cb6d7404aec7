"""PyTorch port (``bcfl_tpu_torch``): one federated server round and the
FedAvg mean against the JAX package.

(d) One round of C=4 tiny-bert clients (float32, dropout 0, 2 local AdamW
steps) from the same flax-initialised global and the same batches (built
by the JAX data pipeline from the JAX partitioner's indices), against
``build_programs(...).server_round``:

- ``compress=none``: AdamW divides each gradient by its own running
  magnitude, so a coordinate whose gradient is near zero still moves by up
  to about ``lr`` per step, in the direction of its float32 rounding
  noise, and the two frameworks' sum orders differ in that noise. So every
  coordinate is held to the most two AdamW trajectories can part in
  ``steps`` steps, ``2 * lr * steps``, and all but one in 10^4 of them to
  atol 2e-6 against a round that moves parameters by up to ~1e-4. The
  attention key biases are left out of the count: softmax is invariant to
  a shift shared by all of a query's scores, so their exact gradient is
  zero and both frameworks train them on noise alone;
- ``int8+topk`` at ``topk_frac=1.0``, ``stochastic=False``: each
  reconstruction is rounded to its chunk's int8 grid, and a delta that
  differs by a hair can round to the neighbouring code, so each bound
  grows by one quantization step (the chunk's ``scale``).

(e) ``masked_weighted_mean`` against ``parallel.gspmd.masked_weighted_mean``
on random stacked trees with zero weights, including the all-masked
fallback (exactly the fallback tree).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcfl_tpu.compression import CompressionConfig as JComp
from bcfl_tpu.compression.codecs import _path_name
from bcfl_tpu.config import PartitionConfig as JPart
from bcfl_tpu.core import client_mesh
from bcfl_tpu.data import HashTokenizer, Partitioner as JPartitioner
from bcfl_tpu.data import TokenCache as JTokenCache, load_dataset as jload
from bcfl_tpu.data import client_batches as jclient_batches
from bcfl_tpu.fed.client_step import build_programs
from bcfl_tpu.models import build as jbuild
from bcfl_tpu.parallel import gspmd
from bcfl_tpu_torch.compression import CompressionConfig as TComp
from bcfl_tpu_torch.data import TokenCache, client_batches, load_dataset
from bcfl_tpu_torch.fed.client_step import (
    make_local_train, make_loss_fn, server_round)
from bcfl_tpu_torch.models import build as tbuild
from bcfl_tpu_torch.models import convert
from bcfl_tpu_torch.parallel import masked_weighted_mean

C, STEPS, BATCH, SEQ = 4, 2, 4, 16
ATOL_NONE = 2e-6
LR = 5e-5  # the default learning rate of both packages


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; at these tiny shapes torch's
    intra-op threads only oversubscribe the cores (a 3 s run took 30 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX's batches from JAX's partitioner, the flax init, both models."""
    ds = jload("synthetic", num_labels=2, n_train=256, n_test=64)
    cache = JTokenCache.build(ds, HashTokenizer(512), SEQ)
    part = JPartitioner(JPart(kind="iid", iid_samples=6), ds.n_train,
                        ds.n_test, jax.random.key(0))
    tree, n_ex = jclient_batches(cache, part, C, 0, BATCH, max_batches=STEPS)
    jm = jbuild("tiny-bert", num_labels=2, vocab_size=512,
                dtype=jnp.float32, dropout_rate=0.0)
    ids = jnp.ones((2, SEQ), jnp.int32)
    params = jm.init(jax.random.key(1), ids, ids)["params"]
    tm = tbuild("tiny-bert", num_labels=2, vocab_size=512,
                dtype=torch.float32, dropout_rate=0.0)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return {"ds": ds, "part": part, "tree": tree, "n_ex": n_ex, "jm": jm,
            "params": params, "tm": tm}


def test_port_pipeline_builds_the_jax_batches(setup):
    """The port's tokenizer, cache and batch stacker, fed the JAX
    partitioner's indices, build the same arrays as the JAX pipeline."""
    ds = load_dataset("synthetic", num_labels=2, n_train=256, n_test=64)
    assert ds.train_texts == setup["ds"].train_texts
    from bcfl_tpu_torch.data import HashTokenizer as THash

    cache = TokenCache.build(ds, THash(512), SEQ)
    for split in ("train", "test"):
        tree, n_ex = client_batches(cache, setup["part"], C, 0, BATCH,
                                    max_batches=STEPS, split=split)
        jtree, jn = jclient_batches(
            JTokenCache.build(setup["ds"], HashTokenizer(512), SEQ),
            setup["part"], C, 0, BATCH, max_batches=STEPS, split=split)
        np.testing.assert_array_equal(n_ex, jn)
        for k in jtree:
            np.testing.assert_array_equal(tree[k], jtree[k], err_msg=k)
            assert tree[k].dtype == jtree[k].dtype


def _run_both(setup, jcomp, tcomp):
    mesh = client_mesh(C)
    progs = build_programs(setup["jm"], mesh, compression=jcomp)
    w = np.asarray(setup["n_ex"], np.float32)
    rngs = jax.random.key_data(jax.vmap(jax.random.key)(
        jnp.arange(C, dtype=jnp.uint32)))
    batches = jax.tree.map(jnp.asarray, setup["tree"])
    params = setup["params"]
    if jcomp is None:
        g_j, stats_j = progs.server_round(params, None, batches,
                                          jnp.asarray(w), rngs)
    else:
        (g_j, _), stats_j = progs.server_round(
            (params, progs.ef_init(params)), None, batches, jnp.asarray(w),
            rngs)
    tm = setup["tm"]  # a scratch module: each client loads the global
    g0 = {_path_name(p): torch.from_numpy(np.array(x))
          for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    local = make_local_train(tm, make_loss_fn(tm))
    resid = {p: torch.zeros((C,) + tuple(x.shape)) for p, x in g0.items()}
    out = server_round(local, tcomp, g0,
                       {k: torch.from_numpy(v) for k, v in
                        setup["tree"].items()},
                       torch.from_numpy(w), [None] * C, resid)
    np.testing.assert_allclose(out.stats.numpy(), np.asarray(stats_j),
                               rtol=1e-4, atol=1e-4)
    flat_j = {_path_name(p): np.asarray(x)
              for p, x in jax.tree_util.tree_flatten_with_path(g_j)[0]}
    assert list(out.global_t) == list(flat_j)
    return flat_j, out, g0


def _assert_round_close(flat_j, out, step_of=lambda p: 0.0):
    far = total = 0
    for p, x in flat_j.items():
        t = out.global_t[p].numpy()
        err = np.abs(t - x)
        step = step_of(p)
        assert err.max() <= 2 * LR * STEPS * 1.01 + step, p
        if not p.endswith("/key/bias"):
            far += int((err > ATOL_NONE + step).sum())
            total += err.size
    assert far <= total * 1e-4, f"{far} of {total} coordinates past atol"


def test_server_round_matches_jax_uncompressed(setup):
    flat_j, out, g0 = _run_both(setup, None, None)
    _assert_round_close(flat_j, out)
    moved = max(float(np.abs(x - g0[p].numpy()).max())
                for p, x in flat_j.items())
    assert moved > 10 * ATOL_NONE  # the round really trained


def test_server_round_matches_jax_int8_topk(setup):
    jcomp = JComp(kind="int8+topk", topk_frac=1.0, stochastic=False)
    tcomp = TComp(kind="int8+topk", topk_frac=1.0, stochastic=False)
    flat_j, out, _ = _run_both(setup, jcomp, tcomp)
    _assert_round_close(flat_j, out,
                        lambda p: float(out.payload[p]["s"].max()))


def _stacked(rng, C=5):
    return {"a/w": rng.standard_normal((C, 7, 3)).astype(np.float32),
            "b": rng.standard_normal((C, 11)).astype(np.float32)}


@pytest.mark.parametrize("weights", [[1.0, 0.0, 3.0, 2.5, 0.0],
                                     [0.0, 0.0, 0.0, 0.0, 0.0],
                                     [1e-13, 0.0, 0.0, 0.0, 0.0]])
@pytest.mark.parametrize("with_fallback", [True, False])
def test_masked_weighted_mean_matches_jax(weights, with_fallback):
    rng = np.random.default_rng(len(weights) + int(with_fallback))
    tree = _stacked(rng)
    fb = ({p: x[0] * 0 + 7.0 for p, x in tree.items()} if with_fallback
          else None)
    w = np.asarray(weights, np.float32)
    out_j = gspmd.masked_weighted_mean(
        {p: jnp.asarray(x) for p, x in tree.items()}, jnp.asarray(w),
        None if fb is None else {p: jnp.asarray(x) for p, x in fb.items()})
    out_t = masked_weighted_mean(
        {p: torch.from_numpy(x) for p, x in tree.items()},
        torch.from_numpy(w),
        None if fb is None else {p: torch.from_numpy(x)
                                 for p, x in fb.items()})
    for p in tree:
        np.testing.assert_allclose(out_t[p].numpy(), np.asarray(out_j[p]),
                                   rtol=1e-6, atol=1e-7, err_msg=p)
        if w.sum() <= 1e-12 and fb is not None:  # all masked
            np.testing.assert_array_equal(out_t[p].numpy(), fb[p])
