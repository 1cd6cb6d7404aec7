"""PyTorch port (``bcfl_tpu_torch``): ``fed/synthetic.py`` against the JAX
package's.

``synthetic_round_inputs`` draws ``ids``, ``mask``, ``labels`` and
``example_mask`` from one ``np.random.default_rng(seed)`` in JAX's order,
so the arrays equal JAX's bit for bit, dtypes included (pulled from JAX's
client mesh with ``jax.device_get``). The per-client generators are torch
streams (JAX's threefry keys cannot be reproduced), so only their count and
independence are checked. The inputs then feed one tiny-bert
``server_round`` of the port's ``build_programs`` unchanged, with and
without ``int8+topk``.
"""

import numpy as np
import pytest
import torch

import jax

from bcfl_tpu.core import client_mesh as jclient_mesh
from bcfl_tpu.fed.synthetic import synthetic_round_inputs as jsynthetic
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.compression import zero_residual
from bcfl_tpu_torch.core.mesh import client_mesh
from bcfl_tpu_torch.fed.client_step import build_programs, server_round
from bcfl_tpu_torch.fed.synthetic import synthetic_round_inputs
from bcfl_tpu_torch.models import build
from bcfl_tpu_torch.models.convert import trainable_tree

C, STEPS, BATCH, SEQ, VOCAB = 4, 2, 4, 16, 512


@pytest.mark.parametrize("seed,num_labels", [(0, 2), (7, 5)])
def test_inputs_equal_jax_bit_for_bit(seed, num_labels):
    jb, jw, jr = jsynthetic(jclient_mesh(C), STEPS, BATCH, SEQ,
                            vocab_size=VOCAB, num_labels=num_labels,
                            seed=seed)
    tb, tw, gens = synthetic_round_inputs(
        client_mesh(C, devices=["cpu"]), STEPS, BATCH, SEQ,
        vocab_size=VOCAB, num_labels=num_labels, seed=seed)
    jb = jax.device_get(jb)
    assert sorted(tb) == sorted(jb)
    for k, want in jb.items():
        got = tb[k].numpy()
        assert got.dtype == want.dtype, k
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(tw.numpy(), jax.device_get(jw))
    assert len(gens) == C == jax.device_get(jr).shape[0]
    draws = [torch.rand(8, generator=g) for g in gens]
    assert len({tuple(d.tolist()) for d in draws}) == C


def test_generators_are_seeded():
    mesh = client_mesh(C, devices=["cpu"])
    a = synthetic_round_inputs(mesh, STEPS, BATCH, SEQ, seed=3)[2]
    b = synthetic_round_inputs(mesh, STEPS, BATCH, SEQ, seed=3)[2]
    c = synthetic_round_inputs(mesh, STEPS, BATCH, SEQ, seed=4)[2]
    first = [torch.rand(4, generator=g) for g in a]
    assert all(torch.equal(x, torch.rand(4, generator=g))
               for x, g in zip(first, b))
    assert not torch.equal(first[0], torch.rand(4, generator=c[0]))


@pytest.mark.parametrize("kind", ["none", "int8+topk"])
def test_inputs_feed_a_server_round(kind):
    torch.manual_seed(0)
    mesh = client_mesh(C, devices=["cpu"])
    model = build("tiny-bert", num_labels=2, vocab_size=VOCAB,
                  dtype=torch.float32)
    comp = CompressionConfig(kind=kind)
    progs = build_programs(model, mesh, compression=comp)
    batches, weights, gens = synthetic_round_inputs(
        mesh, STEPS, BATCH, SEQ, vocab_size=VOCAB)
    g0 = {p: x.detach().clone() for p, x in trainable_tree(model).items()}
    resid = zero_residual(g0, C) if comp.enabled else None
    uniforms = None
    if comp.enabled:
        from bcfl_tpu_torch.core.prng import codec_uniforms

        uniforms = codec_uniforms(0, 0)
    out = server_round(progs.local_train, comp if comp.enabled else None,
                       g0, batches, weights, gens, resid, uniforms)
    assert out.stats.shape == (C, 3)
    assert torch.isfinite(out.stats).all()
    np.testing.assert_array_equal(out.stats[:, 2].numpy(),
                                  np.full(C, STEPS * BATCH, np.float32))
    assert list(out.global_t) == list(g0)
    moved = 0.0
    for p, x in out.global_t.items():
        assert x.shape == g0[p].shape and x.dtype == g0[p].dtype, p
        assert torch.isfinite(x).all(), p
        moved = max(moved, float((x - g0[p]).abs().max()))
    assert moved > 0.0  # the round trained
    if comp.enabled:
        assert sorted(out.payload) == sorted(g0)
        assert sorted(out.resid) == sorted(g0)
