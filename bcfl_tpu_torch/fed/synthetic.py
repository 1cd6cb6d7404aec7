"""Synthetic round inputs for benchmarks and dry runs: port of
``bcfl_tpu/fed/synthetic.py``. The stacked per-client batch tree
:func:`bcfl_tpu_torch.data.pipeline.client_batches` produces, filled with
random tokens, plus uniform weights and one dropout generator per client,
all on the mesh's device."""

from __future__ import annotations

import numpy as np
import torch

from bcfl_tpu_torch.core import prng
from bcfl_tpu_torch.core.mesh import ClientMesh


def synthetic_round_inputs(
    mesh: ClientMesh,
    steps: int,
    batch: int,
    seq: int,
    vocab_size: int = 8192,
    num_labels: int = 2,
    seed: int = 0,
):
    """Returns ``(batches, weights, generators)`` ready for a round of
    :func:`bcfl_tpu_torch.fed.client_step.build_programs`' model
    (``server_round``, ``gossip_round``).

    ``ids``, ``mask``, ``labels`` and ``example_mask`` come from the same
    ``np.random.default_rng(seed)`` draws, in the same order and dtypes,
    as JAX's, so they are JAX's arrays bit for bit. The generators are
    :func:`bcfl_tpu_torch.core.prng.client_round_generators` of root
    ``seed + 1``, round 0: JAX splits ``jax.random.key(seed + 1)`` into
    one threefry key per client, which torch cannot reproduce, so the
    dropout draws follow the same law with other numbers."""
    C = mesh.num_clients
    device = mesh.devices[0]
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_size, (C, steps, batch, seq))
    labels = rng.integers(0, num_labels, (C, steps, batch))
    batches = {
        "ids": torch.from_numpy(ids.astype(np.int32)).to(device),
        "mask": torch.ones((C, steps, batch, seq), dtype=torch.int32,
                           device=device),
        "labels": torch.from_numpy(labels.astype(np.int32)).to(device),
        "example_mask": torch.ones((C, steps, batch), dtype=torch.float32,
                                   device=device),
    }
    weights = torch.ones((C,), dtype=torch.float32, device=device)
    generators = prng.client_round_generators(seed + 1, C, 0, device)
    return batches, weights, generators
