"""PyTorch port (``bcfl_tpu_torch``): the update codec against the JAX
package, bit for bit.

(a) the codec ops: ``int8_quantize_ref`` against eager
``pallas_codec._int8_quantize_xla`` on shared uniforms, and
``topk_select_ref`` against ``pallas_codec._topk_select_xla`` (ties,
-0.0, k=1, k=N); the CPU dispatch of the registry. (The CUDA kernels
against their plain versions: ``tests/test_torch_kernels.py``.)

(b) the codec trees: ``encode_tree`` / ``decode_tree`` / ``roundtrip``
against the JAX codec on a tiny-bert-shaped delta tree (payload leaves bit
for bit, with JAX's own uniforms handed to the port as an operand), the
fused encoder against the per-leaf oracle, ``payload_nbytes`` and
``wire_format``.

Inputs come from numpy seeds; both sides run eagerly on the CPU (the JAX
``x / 127.0`` differs by one ULP between eager and jit on XLA:CPU, and the
port holds to the eager form).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu.models import build as jbuild
from bcfl_tpu.ops import pallas_codec
from bcfl_tpu_torch.compression import codecs as tcc
from bcfl_tpu_torch.ops import codec_kernels as ck
from bcfl_tpu_torch.ops import registry


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(a, b, msg=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, msg
    assert a.shape == b.shape, msg
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=msg)


# ------------------------------------------------------------ (a) the ops


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 16), (2, 7, 37), (1, 1, 1),
                                   (4, 3, 256)])
def test_int8_quantize_ref_matches_eager_jax(shape, stochastic):
    rng = np.random.default_rng(sum(shape) + stochastic)
    g = (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 3, shape[:2]
                                                           + (1,)))
    g = g.astype(np.float32)
    g[0, 0, :] = 0.0  # an all-zero chunk takes the 1e-30 floor
    if shape[-1] > 3:
        g[-1, -1, :3] = [0.5, -0.5, -0.0]  # half-way codes and -0.0
    u = rng.random(shape, dtype=np.float32) if stochastic else None
    q_j, s_j = pallas_codec._int8_quantize_xla(
        jnp.asarray(g), None if u is None else jnp.asarray(u),
        stochastic=stochastic)
    q_t, s_t = ck.int8_quantize_ref(
        torch.from_numpy(g), None if u is None else torch.from_numpy(u),
        stochastic=stochastic)
    _assert_bits(q_t, q_j, "codes")
    _assert_bits(s_t, s_j, "scales")


def _topk_inputs():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5, 97)).astype(np.float32)
    rows[1] = np.round(rows[1] * 2) / 2  # many magnitude ties of both signs
    rows[2] = 0.0
    rows[2, ::3] = -0.0  # zeros of both signs tie
    rows[2, 50] = -1.0
    rows[3, :40] = 0.25
    rows[3, 40:80] = -0.25
    return rows


@pytest.mark.parametrize("k", [1, 7, 48, 97])
def test_topk_select_ref_matches_lax_top_k(k):
    x = _topk_inputs()
    v_j, i_j = pallas_codec._topk_select_xla(jnp.asarray(x), k=k)
    v_t, i_t = ck.topk_select_ref(torch.from_numpy(x), k=k)
    _assert_bits(v_t, v_j, "values (sign bit included)")
    _assert_bits(i_t, i_j, "indices")


def test_registry_takes_plain_version_on_cpu():
    registry.reset_launches()
    g = torch.randn(2, 3, 8)
    q, s = ck.INT8_QUANTIZE(g, None, stochastic=False)
    q_ref, s_ref = ck.int8_quantize_ref(g, None, stochastic=False)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    ck.TOPK_SELECT(torch.randn(3, 10), k=2)
    # CPU calls never count as kernel launches
    assert registry.launch_counts() == {"int8_quantize": 0, "topk_select": 0}
    assert {op.name for op in registry.kernel_ops()} == {"int8_quantize",
                                                         "topk_select"}
    assert set(registry.list_ops()) == {"int8_quantize", "topk_select",
                                        "int8_dequant", "topk_scatter"}


# ---------------------------------------------------------- (b) the trees


def _tiny_bert_delta(C=3, seed=0):
    """A stacked [C, ...] numpy delta tree shaped like tiny-bert's flax
    params (nested, for JAX) and its ``{path: tensor}`` form (the port)."""
    model = jbuild("tiny-bert", num_labels=2, vocab_size=512)
    ids = jnp.ones((1, 8), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), ids, ids)["params"]
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves, flat_t = [], {}
    for path, s in flat:
        x = (rng.standard_normal((C,) + s.shape) * 1e-3).astype(np.float32)
        leaves.append(jnp.asarray(x))
        flat_t[jcc._path_name(path)] = torch.from_numpy(x)
    return jax.tree_util.tree_unflatten(treedef, leaves), flat_t


def _jax_uniforms(key):
    """The port's uniforms source drawing what the JAX codec draws: leaf
    ``i`` takes ``uniform(fold_in(key, i), grid shape)``."""

    def draw(i, shape, device):
        u = jax.random.uniform(jax.random.fold_in(key, i), shape)
        return torch.from_numpy(np.array(u)).to(device)

    return draw


def _assert_payloads_equal(p_t, p_j):
    assert list(p_t) == list(sorted(p_j, key=lambda p: tuple(p.split("/"))))
    for path, parts in p_j.items():
        assert set(p_t[path]) == set(parts), path
        for name, x in parts.items():
            _assert_bits(p_t[path][name], x, f"{path}/{name}")


KINDS = ["int8", "topk", "int8+topk"]


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_encode_tree_bit_identical_to_jax(kind, stochastic):
    comp_j = jcc.CompressionConfig(kind=kind, chunk=64, topk_frac=0.1,
                                   stochastic=stochastic)
    comp_t = tcc.CompressionConfig(kind=kind, chunk=64, topk_frac=0.1,
                                   stochastic=stochastic)
    tree_j, tree_t = _tiny_bert_delta()
    key = jax.random.key(5)
    p_j = jcc.encode_tree(comp_j, tree_j, key)
    p_t = tcc.encode_tree(comp_t, tree_t, _jax_uniforms(key))
    _assert_payloads_equal(p_t, p_j)
    # the fused encoder equals its per-leaf oracle
    p_u = tcc.encode_tree_unfused(comp_t, tree_t, _jax_uniforms(key))
    for path, parts in p_u.items():
        for name, x in parts.items():
            _assert_bits(p_t[path][name], x, f"{path}/{name}")
    # decode: the same dense tree
    d_j = jcc.decode_tree(comp_j, p_j, tree_j)
    d_t = tcc.decode_tree(comp_t, p_t, tree_t)
    flat_j = {jcc._path_name(p): x
              for p, x in jax.tree_util.tree_flatten_with_path(d_j)[0]}
    for path, x in flat_j.items():
        _assert_bits(d_t[path], x, path)


@pytest.mark.parametrize("error_feedback", [True, False])
def test_roundtrip_bit_identical_to_jax(error_feedback):
    comp_j = jcc.CompressionConfig(kind="int8+topk", chunk=32,
                                   topk_frac=0.2, stochastic=False,
                                   error_feedback=error_feedback)
    comp_t = tcc.CompressionConfig(kind="int8+topk", chunk=32,
                                   topk_frac=0.2, stochastic=False,
                                   error_feedback=error_feedback)
    tree_j, tree_t = _tiny_bert_delta(seed=1)
    rj, rt = _tiny_bert_delta(seed=2)  # a carried residual
    p_j, d_j, r_j = jcc.roundtrip(comp_j, tree_j, rj, jax.random.key(0))
    p_t, d_t, r_t = tcc.roundtrip(comp_t, tree_t, rt)
    _assert_payloads_equal(p_t, p_j)
    for tj, tt in ((d_j, d_t), (r_j, r_t)):
        for path, x in jax.tree_util.tree_flatten_with_path(tj)[0]:
            _assert_bits(tt[jcc._path_name(path)], x)


@pytest.mark.parametrize("kind", ["none"] + KINDS)
def test_payload_nbytes_and_wire_format_match_jax(kind):
    tree_j, tree_t = _tiny_bert_delta(C=1)
    tmpl_j = jax.tree.map(lambda x: x[0], tree_j)
    tmpl_t = {p: x[0] for p, x in tree_t.items()}
    for kw in ({}, {"chunk": 100, "topk_frac": 0.01, "stochastic": False,
                    "error_feedback": False}):
        comp_j = jcc.CompressionConfig(kind=kind, **kw)
        comp_t = tcc.CompressionConfig(kind=kind, **kw)
        assert (tcc.payload_nbytes(comp_t, tmpl_t)
                == jcc.payload_nbytes(comp_j, tmpl_j))
        assert tcc.wire_format(comp_t) == jcc.wire_format(comp_j)
        if kind != "none":
            payload = tcc.encode_tree(comp_t, tree_t,
                                      _jax_uniforms(jax.random.key(1)))
            assert (tcc.payload_tensor_nbytes(payload)
                    == tcc.payload_nbytes(comp_t, tmpl_t))


def test_compression_config_validation_matches_jax():
    for bad in ({"kind": "fp4"}, {"kind": "int8", "chunk": 0},
                {"kind": "topk", "topk_frac": 0.0},
                {"kind": "topk", "topk_frac": 1.5}):
        with pytest.raises(ValueError):
            jcc.CompressionConfig(**bad)
        with pytest.raises(ValueError):
            tcc.CompressionConfig(**bad)
    with pytest.raises(ValueError, match="uniforms"):
        tcc.encode_tree(tcc.CompressionConfig(kind="int8"),
                        {"w": torch.zeros(2, 5)})
