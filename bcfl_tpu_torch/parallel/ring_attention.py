"""Ring attention: exact attention over a sequence split into blocks: port
of ``bcfl_tpu/parallel/ring_attention.py`` (``NEG``, ``_block``,
``_online_merge``, ``ring_attention``, ``ring_attention_sharded``,
``ring_attention_gspmd``).

The sequence axis is cut into ``n`` blocks; query block ``i`` stays put
while the key, value and key-bias blocks rotate around the ring, and each
hop folds one block's contribution into the FlashAttention online-softmax
recurrence, so the result is exact full attention. As in JAX:

- the scores are float32 (q, k and v are cast up; the block products are
  plain ``torch.einsum`` in float32, the JAX package's XLA ``einsum`` and
  never a Pallas kernel, so no hand-written kernel lies on this path;
  TF32 stays off, as ``torch.backends.cuda.matmul.allow_tf32`` is by
  default and the engine keeps it);
- causal masking comes from ring position: at hop ``t`` query block ``r``
  holds key block ``(r - t) mod n``, whose global key positions are
  ``shard * Sk + local``; no dense ``[S, S]`` mask exists;
- ``n - 1`` merge-and-rotate hops, then the last merge without a rotation;
- the output is ``acc / max(l, 1e-9)`` cast back to q's dtype.

Two forms:

- :func:`ring_attention` is JAX's per-shard body (``shard_map`` with
  ``ppermute``): each rank of a ``torch.distributed`` group holds its own
  blocks and rotates K, V and the key bias to ``(rank + 1) % n`` with
  ``dist.batch_isend_irecv`` (differentiable: the backward sends the
  gradients the other way round). It runs over CPU ``gloo`` process
  groups only: NCCL refuses two ranks on one GPU, and gloo's
  point-to-point takes CPU tensors. The tests hold it to JAX's; no card
  number is taken from it.
- :func:`ring_attention_sharded` and :func:`ring_attention_gspmd` are
  single-controller: global ``[B, H, S, D]`` tensors go in and out, block
  ``i`` lives on ``devices[i]``, and a hop moves each K/V/bias block to
  the next device (``.to(devices[(i + 1) % n], non_blocking=True)``,
  which on one card is no copy at all). The engine wires the second, as
  JAX's does; in the port the two are one loop.

Each hop of the single-controller forms adds one to :func:`rotations`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG = -1e30  # large-negative, not -inf: no NaN path on fully-masked blocks

_ROTATIONS = [0]


def rotations() -> int:
    """Hops (each moving every K/V/bias block one device on) of the
    single-controller forms since the last :func:`reset_rotations`."""
    return _ROTATIONS[0]


def reset_rotations() -> None:
    _ROTATIONS[0] = 0


def _block(q, k, v, key_bias, scale, dead):
    """One KV block's contribution: block max, normalizer, unnormalized
    out (float32). ``dead`` [1, 1, Sq, Sk] marks masked (query, key) pairs
    (None: none); a fully dead block self-corrects in the recurrence."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.float()) * scale
    s = s + key_bias[:, None, None, :].float()
    if dead is not None:
        s = torch.where(dead, NEG, s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if dead is not None:
        p = torch.where(dead, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m, l, o


def _online_merge(acc, m, l, bm, bl, bo):
    """One step of the FlashAttention online-softmax recurrence."""
    m_new = torch.maximum(m, bm)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(bm - m_new)
    return acc * alpha + bo * beta, m_new, l * alpha + bl * beta


def _dead(causal: bool, q_shard: int, k_shard: int, Sq: int, Sk: int,
          device) -> Optional[torch.Tensor]:
    """Causal mask of query block ``q_shard`` against key block
    ``k_shard`` from their global positions; None when not causal."""
    if not causal:
        return None
    qpos = q_shard * Sq + torch.arange(Sq, device=device)[:, None]
    kpos = k_shard * Sk + torch.arange(Sk, device=device)[None, :]
    return (kpos > qpos)[None, None]


def _finish(acc, l, dtype):
    return (acc / torch.clamp(l, min=1e-9)).to(dtype)


class _Rotate(torch.autograd.Function):
    """Send each tensor to ``(rank + 1) % n`` of ``group`` and receive
    the one from ``(rank - 1) % n`` (JAX's ``ppermute`` ring); the
    backward sends the gradients back the other way."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return _exchange(group, xs, 1)

    @staticmethod
    def backward(ctx, *grads):
        grads = tuple(torch.zeros_like(g) if g is None else g for g in grads)
        return (None,) + _exchange(ctx.group, grads, -1)


def _exchange(group, xs, step: int):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    r = dist.get_rank(group)

    def peer(i):
        i %= n
        return i if group is None else dist.get_global_rank(group, i)

    outs = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                 for x in xs)
    ops = []
    for x, out in zip(xs, outs):
        ops.append(dist.P2POp(dist.isend, x.contiguous(), peer(r + step),
                              group))
        ops.append(dist.P2POp(dist.irecv, out, peer(r - step), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_bias: Optional[torch.Tensor], group=None,
                   causal: bool = False) -> torch.Tensor:
    """Exact attention with this rank's ``[B, H, S/n, D]`` q, k, v blocks
    (and ``[B, S/n]`` key bias) while K, V and the bias rotate around the
    ranks of ``group`` (``None``: the default group). CPU ``gloo`` only
    (see the module docstring)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = 1.0 / (D ** 0.5)
    qf = q.float()
    if key_bias is None:
        key_bias = torch.zeros((B, Sk), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    kc, vc, bc = k, v, key_bias
    for t in range(n):
        dead = _dead(causal, r, (r - t) % n, Sq, Sk, q.device)
        acc, m, l = _online_merge(acc, m, l,
                                  *_block(qf, kc, vc, bc, scale, dead))
        if t < n - 1:  # the n-th rotation would be discarded
            kc, vc, bc = _Rotate.apply(group, kc, vc, bc)
    return _finish(acc, l, q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           key_bias: Optional[torch.Tensor],
                           devices: Sequence, causal: bool = False
                           ) -> torch.Tensor:
    """Global ``[B, H, S, D]`` q, k, v (and ``[B, S]`` key bias) ->
    ``[B, H, S, D]`` on q's device: the sequence cut into
    ``len(devices)`` blocks, block ``i`` on ``devices[i]``, the KV blocks
    rotating device to device."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    B, H, S, D = q.shape
    if S % n:
        raise ValueError(f"seq {S} not divisible by seq size {n}")
    blk = S // n
    scale = 1.0 / (D ** 0.5)
    if key_bias is None:
        key_bias = torch.zeros((B, S), dtype=torch.float32, device=q.device)

    def split(x, dim):
        return [x.narrow(dim, i * blk, blk).to(devices[i]) for i in range(n)]

    qs = [x.float() for x in split(q, 2)]
    kc, vc, bc = split(k, 2), split(v, 2), split(key_bias, 1)
    acc = [torch.zeros((B, H, blk, D), dtype=torch.float32, device=d)
           for d in devices]
    m = [torch.full((B, H, blk, 1), NEG, dtype=torch.float32, device=d)
         for d in devices]
    l = [torch.zeros((B, H, blk, 1), dtype=torch.float32, device=d)
         for d in devices]
    for t in range(n):
        for i in range(n):
            dead = _dead(causal, i, (i - t) % n, blk, blk, devices[i])
            acc[i], m[i], l[i] = _online_merge(
                acc[i], m[i], l[i],
                *_block(qs[i], kc[i], vc[i], bc[i], scale, dead))
        if t < n - 1:  # block at position i - 1 moves on to position i
            kc, vc, bc = ([x[(i - 1) % n].to(devices[i], non_blocking=True)
                           for i in range(n)] for x in (kc, vc, bc))
            _ROTATIONS[0] += 1
    return torch.cat([_finish(a, li, q.dtype).to(q.device)
                      for a, li in zip(acc, l)], dim=2)


def ring_attention_gspmd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_bias: Optional[torch.Tensor], devices: Sequence,
                         causal: bool = False) -> torch.Tensor:
    """The form the engine wires (JAX's GSPMD twin of the shard_map form):
    the same ring over ``devices``, computed by
    :func:`ring_attention_sharded`'s single-controller loop."""
    return ring_attention_sharded(q, k, v, key_bias, devices, causal)
