"""PyTorch port (``bcfl_tpu_torch``): flash attention against the JAX
package.

The JAX Pallas kernels run in interpret mode on the CPU, as
``tests/test_pallas_kernels.py`` runs them; inputs are numpy draws.

(a) The plain K1 (``flash_fwd_ref``) against ``_flash_fwd_pallas``: out
    and ``lse[..., 0]`` with a ``[B,1,1,S]`` padding bias, causal at an
    uneven S=96 and suffix-causal ``Sq < Sk``; float32, atol 2e-5 (the JAX
    test's).
(b) ``FlashAttentionFn`` on the CPU (the plain K1-K3): dq, dk, dv and the
    bias gradient against ``jax.grad`` of the interpret-mode Pallas flash,
    causal with ragged padding; atol 3e-5 (the JAX backward tests'). The
    plain K3 (``flash_bwd_dq_ref``) alone against the dq of the
    interpret-mode ``_flash_bwd_pallas`` at the same atol: two key blocks
    at D = 64 with a row whose keys are all padded, suffix-causal
    ``Sq < Sk``, and causal ``Sq > Sk`` (the first queries see no key).
(c) bf16 forward at 2e-2 (the JAX contract).
(d) ``flash_attention_blockwise`` against ``flash_attention_xla``, the
    dense-bias branch included; atol 2e-5.
(e) tiny-bert and tiny-albert with ``use_flash=True, flash_min_seq=0``,
    float32, no dropout, parameters from ``convert.from_flax``: logits and
    every gradient against the flax model (which runs
    ``flash_attention_xla`` on the CPU) at ``test_torch_model.py``'s
    tolerance.
(f) One tiny-bert server round with ``use_flash=True`` against the JAX
    ``server_round``, at ``test_torch_round.py``'s tolerance.
(g) The CUDA wrappers and ``flash_attention`` reject a dense bias, an
    unsupported head dim and a non-unit D stride before anything is built.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bcfl_tpu.compression.codecs import _path_name
from bcfl_tpu.config import PartitionConfig as JPart
from bcfl_tpu.core import client_mesh
from bcfl_tpu.data import HashTokenizer, Partitioner as JPartitioner
from bcfl_tpu.data import TokenCache as JTokenCache, load_dataset as jload
from bcfl_tpu.data import client_batches as jclient_batches
from bcfl_tpu.fed.client_step import build_programs
from bcfl_tpu.models import build as jbuild
from bcfl_tpu.ops.attention import attention_bias_from_mask as jbias_from_mask
from bcfl_tpu.ops.flash import flash_attention_xla
from bcfl_tpu.ops.pallas_flash import _flash_bwd_pallas, _flash_fwd_pallas
from bcfl_tpu.ops.pallas_flash import _normalize_bias as j_normalize_bias
from bcfl_tpu.ops.pallas_flash import flash_attention as flash_pl
from bcfl_tpu_torch.fed.client_step import (
    make_local_train, make_loss_fn, server_round)
from bcfl_tpu_torch.models import build as tbuild
from bcfl_tpu_torch.models import convert
from bcfl_tpu_torch.ops import cuda_build
from bcfl_tpu_torch.ops import flash_kernels as fk
from bcfl_tpu_torch.ops.attention import attention_bias_from_mask
from bcfl_tpu_torch.ops.flash import (
    flash_attention, flash_attention_blockwise)

FWD_ATOL = 2e-5
BWD_ATOL = 3e-5
BF16_ATOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """At these tiny shapes torch's intra-op threads only oversubscribe
    the cores of the parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _ragged_mask(B, S, lens):
    return (np.arange(S)[None, :] < np.asarray(lens)[:, None]).astype(
        np.int32)


# ------------------------------------------------------------ (a) plain K1

FWD_CASES = {
    # name: (B, H, Sq, Sk, D, causal, padding lengths or None, block)
    "key-bias-padding": (2, 2, 128, 128, 32, False, (100, 50), 32),
    "causal-uneven-S96": (1, 2, 96, 96, 32, True, None, 64),
    "suffix-causal-Sq32-Sk96": (2, 2, 32, 96, 32, True, (96, 70), 32),
}


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_plain_forward_matches_pallas_kernel(name):
    B, H, Sq, Sk, D, causal, lens, block = FWD_CASES[name]
    q = _draw((B, H, Sq, D), 1)
    k, v = _draw((B, H, Sk, D), 2), _draw((B, H, Sk, D), 3)
    bias4 = None if lens is None else jbias_from_mask(
        jnp.asarray(_ragged_mask(B, Sk, lens)))
    out_j, lse_j = _flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        j_normalize_bias(bias4, B, Sk), causal, block, block)
    key_bias = fk._normalize_bias(
        None if bias4 is None else torch.from_numpy(np.array(bias4)),
        B, Sk, "cpu")
    out_t, lse_t = fk.flash_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), key_bias, causal)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               atol=FWD_ATOL, rtol=1e-6)


# ------------------------------------------- (b) the autograd function


@pytest.mark.parametrize("bias_rank", [2, 4])
def test_flash_fn_grads_match_pallas_vjp(bias_rank):
    """Causal, ragged padding (-1e9) plus a random bias, uneven blocks; a
    random cotangent so dO is a real tensor."""
    B, H, S, D = 2, 2, 96, 32
    q, k, v = (_draw((B, H, S, D), s) for s in (4, 5, 6))
    w = _draw((B, H, S, D), 7)
    mask = _ragged_mask(B, S, (96, 70))
    bias = (_draw((B, S), 8) * 0.1 + (1 - mask) * -1e9).astype(np.float32)
    shape = (B, S) if bias_rank == 2 else (B, 1, 1, S)
    bias = bias.reshape(shape)

    def loss_j(q, k, v, b):
        return (flash_pl(q, k, v, b, True, 32, 32) * w).sum()

    gj = jax.grad(loss_j, (0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    (flash_attention(*ts, causal=True) * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip(("dq", "dk", "dv", "dbias"), ts, gj):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=BWD_ATOL, err_msg=name)


DQ_CASES = {
    # name: (B, H, Sq, Sk, D, causal, padding lengths or None, block)
    "D64-two-key-blocks-ragged-all-padded-row":
        (2, 2, 64, 64, 64, False, (41, 0), 32),
    "suffix-causal-Sq32-Sk96": (1, 2, 32, 96, 32, True, (96,), 32),
    "causal-Sq96-Sk40-first-queries-see-no-key":
        (1, 2, 96, 40, 32, True, None, 32),
}


@pytest.mark.parametrize("name", list(DQ_CASES))
def test_plain_dq_matches_pallas_bwd_dq_kernel(name):
    """The forward's out and lse come from the interpret-mode Pallas
    forward and feed both backward sides; float32."""
    B, H, Sq, Sk, D, causal, lens, block = DQ_CASES[name]
    q, do = _draw((B, H, Sq, D), 21), _draw((B, H, Sq, D), 22)
    k, v = _draw((B, H, Sk, D), 23), _draw((B, H, Sk, D), 24)
    bias4 = None if lens is None else jbias_from_mask(
        jnp.asarray(_ragged_mask(B, Sk, lens)))
    key_bias_j = j_normalize_bias(bias4, B, Sk)
    out_j, lse_j = _flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_bias_j, causal,
        block, block)
    dq_j = _flash_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_bias_j, out_j,
        jnp.asarray(do), lse_j, causal, block, block)[0]
    dq_t = fk.flash_bwd_dq_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(key_bias_j)),
        torch.from_numpy(np.array(out_j)), torch.from_numpy(do),
        torch.from_numpy(np.array(lse_j)[..., 0]), causal)
    if causal and Sq > Sk:  # queries before the first key see none
        assert not np.asarray(dq_j)[:, :, :Sq - Sk].any()
        assert not dq_t[:, :, :Sq - Sk].any()
    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j),
                               atol=BWD_ATOL)


def test_flash_fn_returns_no_bias_grad_for_a_mask_bias():
    """A bias built from the mask needs no gradient and gets none; the
    expanded cotangent of a .sum() is taken as well."""
    q, k, v = (torch.from_numpy(_draw((1, 2, 40, 32), s)).requires_grad_()
               for s in (9, 10, 11))
    bias = attention_bias_from_mask(torch.from_numpy(
        _ragged_mask(1, 40, (33,))))
    flash_attention(q, k, v, bias).sum().backward()
    assert bias.grad is None
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v))


# --------------------------------------------------------------- (c) bf16


def test_bf16_forward_within_jax_contract():
    B, H, S, D = 1, 2, 128, 32
    q, k, v = (_draw((B, H, S, D), s) for s in (12, 13, 14))
    mask = _ragged_mask(B, S, (90,))
    bias4 = jbias_from_mask(jnp.asarray(mask))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    out_j = flash_pl(jq, jk, jv, bias4, False, 64, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out_t = flash_attention(tq, tk, tv, torch.from_numpy(np.array(bias4)))
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=BF16_ATOL)


# ------------------------------------------------------- (d) blockwise


BLOCKWISE_CASES = {
    # name: (Sq, Sk, block, causal, bias kind)
    "no-bias-two-blocks": (64, 64, 32, False, None),
    "key-bias-4d": (64, 64, 16, False, "key4"),
    "key-bias-2d-causal": (48, 48, 16, True, "key2"),
    "dense-bias": (32, 64, 32, False, "dense"),
    "suffix-causal-uneven": (24, 72, 32, True, "key4"),
}


@pytest.mark.parametrize("name", list(BLOCKWISE_CASES))
def test_blockwise_matches_xla(name):
    Sq, Sk, block, causal, kind = BLOCKWISE_CASES[name]
    B, H, D = 2, 3, 8
    q = _draw((B, H, Sq, D), 15)
    k, v = _draw((B, H, Sk, D), 16), _draw((B, H, Sk, D), 17)
    bias = {None: None,
            "key4": _draw((B, 1, 1, Sk), 18) * 0.5,
            "key2": _draw((B, Sk), 19) * 0.5,
            "dense": _draw((B, H, Sq, Sk), 20) * 0.5}[kind]
    out_j = flash_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), block_size=block,
        causal=causal)
    out_t = flash_attention_blockwise(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), block_size=block,
        causal=causal)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=FWD_ATOL)


# -------------------------------------------------- (e) flash models

ATOL, RTOL = 2e-5, 2e-4  # test_torch_model.py's float32 tolerance


def _flash_pair(name):
    kw = dict(num_labels=3, vocab_size=512, use_flash=True, flash_min_seq=0)
    jm = jbuild(name, dtype=jnp.float32, **kw)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(1), ids, ids)["params"]
    tm = tbuild(name, dtype=torch.float32, **kw)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


@pytest.mark.parametrize("name", ["tiny-bert", "tiny-albert"])
def test_flash_model_logits_and_grads_match_flax(name):
    jm, params, tm = _flash_pair(name)
    rng = np.random.default_rng(21)
    B, S = 3, 24
    ids = rng.integers(4, 512, (B, S)).astype(np.int32)
    mask = _ragged_mask(B, S, (24, 17, 9))
    labels = rng.integers(0, 3, (B,)).astype(np.int32)

    def loss_j(p):
        logits = jm.apply({"params": p}, ids, mask)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean(), logits

    (_, lj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    logits = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(lj),
                               atol=ATOL, rtol=RTOL)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long()).backward()
    specs = {s.path: s for s in convert.leaf_specs(tm)}
    grads = {k: p.grad for k, p in tm.named_parameters()}
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        spec = specs[_path_name(path)]
        gt = convert.to_jax_layout(spec, grads[spec.key]).numpy()
        np.testing.assert_allclose(gt, np.asarray(g), atol=ATOL, rtol=RTOL,
                                   err_msg=spec.path)


# ----------------------------------------------------- (f) server round

C, STEPS, BATCH, SEQ = 4, 2, 4, 32
LR = 5e-5
ATOL_ROUND = 2e-6  # test_torch_round.py's


def test_flash_server_round_matches_jax():
    """test_torch_round.py's uncompressed round with use_flash=True on both
    sides: every coordinate within 2 * lr * steps (AdamW's reach on a
    near-zero gradient), all but 1e-4 of them (key biases aside, whose
    exact gradient is zero) within 2e-6."""
    ds = jload("synthetic", num_labels=2, n_train=256, n_test=64)
    cache = JTokenCache.build(ds, HashTokenizer(512), SEQ)
    part = JPartitioner(JPart(kind="iid", iid_samples=6), ds.n_train,
                        ds.n_test, jax.random.key(0))
    tree, n_ex = jclient_batches(cache, part, C, 0, BATCH, max_batches=STEPS)
    kw = dict(num_labels=2, vocab_size=512, dropout_rate=0.0,
              use_flash=True, flash_min_seq=0)
    jm = jbuild("tiny-bert", dtype=jnp.float32, **kw)
    params = jm.init(jax.random.key(1), jnp.ones((2, SEQ), jnp.int32),
                     jnp.ones((2, SEQ), jnp.int32))["params"]
    progs = build_programs(jm, client_mesh(C))
    w = np.asarray(n_ex, np.float32)
    rngs = jax.random.key_data(jax.vmap(jax.random.key)(
        jnp.arange(C, dtype=jnp.uint32)))
    g_j, stats_j = progs.server_round(params, None,
                                      jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(w), rngs)
    tm = tbuild("tiny-bert", dtype=torch.float32, **kw)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    g0 = {_path_name(p): torch.from_numpy(np.array(x))
          for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    out = server_round(make_local_train(tm, make_loss_fn(tm)), None, g0,
                       {k: torch.from_numpy(v) for k, v in tree.items()},
                       torch.from_numpy(w), [None] * C)
    np.testing.assert_allclose(out.stats.numpy(), np.asarray(stats_j),
                               rtol=1e-4, atol=1e-4)
    far = total = 0
    moved = 0.0
    for p, x in jax.tree_util.tree_flatten_with_path(g_j)[0]:
        name = _path_name(p)
        x = np.asarray(x)
        err = np.abs(out.global_t[name].numpy() - x)
        moved = max(moved, float(np.abs(x - g0[name].numpy()).max()))
        assert err.max() <= 2 * LR * STEPS * 1.01, name
        if not name.endswith("/key/bias"):
            far += int((err > ATOL_ROUND).sum())
            total += err.size
    assert far <= total * 1e-4, f"{far} of {total} coordinates past atol"
    assert moved > 10 * ATOL_ROUND  # the round really trained


# ------------------------------------------------- (g) input checks


def test_flash_wrappers_reject_bad_inputs_before_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a call that must fail")

    monkeypatch.setattr(cuda_build, "load", no_build)
    B, H, S, D = 2, 2, 16, 32
    q = torch.zeros(B, H, S, D)
    key_bias = torch.zeros(B, S)
    dense = torch.zeros(B, 1, S, S)
    lse = torch.zeros(B, H, S)
    with pytest.raises(ValueError, match="key_bias"):
        fk._flash_fwd_cuda(q, q, q, dense, False)
    with pytest.raises(ValueError, match="key-side"):
        flash_attention(q, q, q, dense)
    odd = torch.zeros(B, H, S, 48)
    with pytest.raises(ValueError, match="head dim 48"):
        fk._flash_fwd_cuda(odd, odd, odd, key_bias, False)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention(odd, odd, odd)
    strided = torch.zeros(B, H, S, 2 * D)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        fk._flash_bwd_dkv_cuda(q, q, strided, key_bias, q, q, lse, False)
    with pytest.raises(ValueError, match="unit stride"):
        fk._flash_bwd_dq_cuda(q, q, q, key_bias, q, strided, lse, True)
    with pytest.raises(ValueError, match="one dtype"):
        fk._flash_fwd_cuda(q.double(), q.double(), q.double(), key_bias,
                           False)
    # a valid call on CPU tensors stops at the device check
    with pytest.raises(ValueError, match="CUDA device"):
        fk._flash_fwd_cuda(q, q, q, key_bias, False)
