"""Seeded generators: port of ``bcfl_tpu/core/prng.py``.

JAX folds one root key per ``(round, client)`` (``client_round_keys``) for
dropout, and per ``(round, leaf index)`` for the codec's stochastic-rounding
uniforms (``codecs.codec_key`` then ``fold_in(key, i)``). Here each such
stream is an explicit ``torch.Generator`` seeded from the same coordinates,
so every draw is deterministic and independent across clients, rounds and
leaves. The streams are PyTorch's Philox/MT draws, not threefry: they do not
reproduce the JAX numbers, which is why the parity tests hand both packages
the same inputs and noise instead.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Tuple

import torch

# lanes separating the streams derived from one seed (the JAX package folds
# 4 for the training keys, 3 for the LoRA adapter init and 0x51F7 for the
# codec lane)
TRAIN_LANE = 4
LORA_LANE = 3
CODEC_LANE = 0x51F7
#: version of the coordinate -> seed derivation below
_SCHEME = "blake2b-coords-v1"


def scheme_name(device) -> str:
    """The identity of the random streams a run on ``device`` draws: the
    seed derivation plus the device type, whose generator (Mersenne
    Twister on the CPU, Philox on CUDA) turns a seed into numbers. A
    checkpoint records it, and resuming under another scheme would change
    every later draw."""
    return f"{_SCHEME}:torch.Generator[{torch.device(device).type}]"


def stream_seed(*coords: int) -> int:
    """A 63-bit seed from integer coordinates (stable across processes)."""
    h = hashlib.blake2b(b",".join(str(int(c)).encode() for c in coords),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(device, *coords: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(*coords))
    return g


def client_round_generators(seed: int, clients, round_idx: int,
                            device) -> list:
    """One dropout generator per client for round ``round_idx``;
    ``clients`` is a count (clients ``0..n-1``) or the round's registry ids
    (cohort mode), so a client's stream follows its id, not its slot.
    ``device`` is one device for every client or a sequence of one device
    per client (each client's shard device on a clients mesh): the seed
    depends on the coordinates only, so a client's stream is the same on
    whichever card of one type it is drawn."""
    ids = (range(clients) if isinstance(clients, int)
           else [int(c) for c in clients])
    devs = (list(device) if isinstance(device, (list, tuple))
            else [device] * len(ids))
    if len(devs) != len(ids):
        raise ValueError(f"{len(devs)} devices for {len(ids)} clients")
    return [generator(d, seed, TRAIN_LANE, round_idx, c)
            for d, c in zip(devs, ids)]


def codec_uniforms(seed: int, round_idx: int, first_client: int = 0
                   ) -> Callable[[int, Tuple[int, ...], torch.device],
                                 torch.Tensor]:
    """The codec's uniforms source for one round: leaf ``i`` draws
    U[0, 1) of its grid shape from its own generator. ``first_client`` is
    the stack's first client id (JAX derives the codec key from client
    0's training key): a dist peer whose slice starts at client ``k``
    draws its own stream, and a stack starting at 0 keeps the local
    engine's."""
    extra = (int(first_client),) if first_client else ()

    def draw(i: int, shape, device) -> torch.Tensor:
        g = generator(device, seed, CODEC_LANE, round_idx, i, *extra)
        return torch.rand(shape, generator=g, device=device,
                          dtype=torch.float32)

    return draw
