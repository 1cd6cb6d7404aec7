"""Update-exchange codecs: port of ``bcfl_tpu/compression/codecs.py``.

What crosses the simulated wire is each client's **delta** (post-train
params minus the round's global), compensated by the carried
error-feedback residual and encoded as ``int8`` / ``topk`` / ``int8+topk``.
The encoded payload is bit-identical to the JAX package's for the same
delta and the same stochastic-rounding uniforms: payload bytes feed ledger
digests in the reference, so "close" is not enough.

Trees here are plain ``dict``s ``{leaf path: [C, ...] tensor}``, walked in
sorted path order. For every tree the port builds that is the JAX flatten
order (sorted path tuples, see
:func:`bcfl_tpu_torch.models.convert.jax_order`), since no path segment
holds a character below ``/``; leaf ``i`` of that order is the leaf JAX
folds into its codec key as ``fold_in(key, i)``.

The stochastic-rounding uniforms are drawn OUTSIDE the kernel, one draw per
leaf of the leaf's chunk-grid shape ``[C, M, chunk]``, and passed to the
``int8_quantize`` op as an operand (``_int8_parts_batched`` in JAX). The
draw comes from a caller-supplied ``uniforms(i, shape, device)`` callable:
the engine passes :func:`bcfl_tpu_torch.core.prng.codec_uniforms`; parity
tests pass JAX's own uniforms. A client shard that encodes its own rows
takes its rows of the one-stack draw (:func:`row_uniforms`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from bcfl_tpu_torch.ops import codec_kernels as ck

Tree = Dict[str, torch.Tensor]
#: ``(leaf index, grid shape, device) -> f32 U[0, 1) tensor of that shape``
Uniforms = Callable[[int, Tuple[int, ...], torch.device], torch.Tensor]

KINDS = ("none", "int8", "topk", "int8+topk")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Port of ``codecs.CompressionConfig`` (same names and defaults). The
    JAX field ``kernel_impl`` has no counterpart: the port picks the kernel
    by the tensor's device (:mod:`bcfl_tpu_torch.ops.registry`)."""

    kind: str = "none"  # none | int8 | topk | int8+topk
    chunk: int = 256
    topk_frac: float = 0.05
    stochastic: bool = True
    error_feedback: bool = True

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown compression kind {self.kind!r} "
                             f"(one of {KINDS})")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac must be in (0, 1], got {self.topk_frac}")

    @property
    def enabled(self) -> bool:
        return self.kind != "none"


def _leaf_k(comp: CompressionConfig, n: int) -> int:
    return max(1, int(math.ceil(comp.topk_frac * n)))


def _pad_grid(y: torch.Tensor, chunk: int) -> torch.Tensor:
    """[C, N] -> zero-padded [C, M, chunk] grid (``_int8_parts``)."""
    C, N = y.shape
    pad = (-N) % chunk
    if pad:
        y = torch.nn.functional.pad(y, (0, pad))
    return y.reshape(C, (N + pad) // chunk, chunk)


def row_uniforms(uniforms: Optional[Uniforms], total: int, a: int, b: int
                 ) -> Optional[Uniforms]:
    """Rows ``[a, b)`` of ``uniforms``' draws for a stack of ``total``
    rows: each leaf is drawn at the whole stack's grid shape on the
    caller's device and cut to the rows (a draw's numbers depend on its
    shape, so a ``[b - a, ...]`` draw is not those rows). A client shard
    encoding clients ``[a, b)`` so takes the numbers the one-stack encode
    gives them."""
    if uniforms is None:
        return None

    def draw(i: int, shape, device) -> torch.Tensor:
        return uniforms(i, (total,) + tuple(shape[1:]), device)[a:b]

    return draw


def _draw(uniforms: Optional[Uniforms], i: int, shape, device) -> torch.Tensor:
    if uniforms is None:
        raise ValueError("stochastic rounding needs a uniforms source")
    u = uniforms(i, tuple(shape), device)
    if u.shape != tuple(shape) or u.dtype != torch.float32:
        raise ValueError(f"uniforms for leaf {i}: got {tuple(u.shape)} "
                         f"{u.dtype}, need {tuple(shape)} float32")
    return u.to(device)


def _int8_parts(y, chunk, i, uniforms, stochastic):
    """Per-leaf reference: [C, N] f32 -> (q int8 [C, M, chunk], s [C, M])."""
    g = _pad_grid(y, chunk)
    u = [_draw(uniforms, i, g.shape, g.device)] if stochastic else None
    return ck.INT8_QUANTIZE([g], u, stochastic=stochastic)[0]


def _encode_leaf(comp, y, i, uniforms) -> dict:
    n = y.shape[1]
    if comp.kind == "int8":
        q, s = _int8_parts(y, comp.chunk, i, uniforms, comp.stochastic)
        return {"q": q, "s": s}
    if comp.kind == "topk":
        val, idx = ck.TOPK_SELECT(y, k=_leaf_k(comp, n))
        return {"v": val, "i": idx}
    if comp.kind == "int8+topk":
        k = _leaf_k(comp, n)
        val, idx = ck.TOPK_SELECT(y, k=k)
        q, s = _int8_parts(val, min(comp.chunk, k), i, uniforms,
                           comp.stochastic)
        return {"q": q, "s": s, "i": idx}
    raise ValueError(f"unknown compression kind {comp.kind!r}")


def _decode_leaf(comp, part: dict, n: int) -> torch.Tensor:
    if comp.kind == "int8":
        return ck.INT8_DEQUANT(part["q"], part["s"], n=n)
    if comp.kind == "topk":
        return ck.TOPK_SCATTER(part["v"], part["i"], n=n)
    if comp.kind == "int8+topk":
        k = part["i"].shape[1]
        val = ck.INT8_DEQUANT(part["q"], part["s"], n=k)
        return ck.TOPK_SCATTER(val, part["i"], n=n)
    raise ValueError(f"unknown compression kind {comp.kind!r}")


def _flat(delta: Tree):
    if not delta:
        raise ValueError("cannot encode an empty tree")
    return [(p, x.reshape(x.shape[0], -1).float())
            for p, x in sorted(delta.items())]


def encode_tree_unfused(comp: CompressionConfig, delta: Tree,
                        uniforms: Optional[Uniforms] = None) -> dict:
    """Per-leaf encoder, the bit-identity oracle for :func:`encode_tree`
    (``codecs.encode_tree_unfused``)."""
    return {p: _encode_leaf(comp, y, i, uniforms)
            for i, (p, y) in enumerate(_flat(delta))}


def _int8_parts_batched(groups, stochastic, uniforms):
    """Fused int8 quantize of every group of [C, N_i] leaves sharing one
    chunk (``groups``: ``(ys, leaf indices, chunk)`` each): per-leaf padded
    grids concatenated on the chunk axis, uniforms drawn per leaf (under
    the leaf's own index) and concatenated alike (``_int8_parts_batched``),
    then ONE ``int8_quantize`` call over the groups' grids (the JAX package
    launches once per group; rows are independent, so the codes are the
    same); split back per leaf, per group."""
    grids, gs, us = [], [], []
    for ys, idxs, chunk in groups:
        leaf_grids = [_pad_grid(y, chunk) for y in ys]
        grids.append(leaf_grids)
        gs.append(torch.cat(leaf_grids, dim=1))
        if stochastic:
            us.append(torch.cat([_draw(uniforms, i, gr.shape, gr.device)
                                 for i, gr in zip(idxs, leaf_grids)], dim=1))
    parts = []
    for a in range(0, len(gs), ck.INT8_MAX_GRIDS):  # the launch's table
        b = a + ck.INT8_MAX_GRIDS
        parts += ck.INT8_QUANTIZE(gs[a:b], us[a:b] if stochastic else None,
                                  stochastic=stochastic)
    out = []
    for leaf_grids, (q, scale) in zip(grids, parts):
        group, off = [], 0
        for gr in leaf_grids:
            M = gr.shape[1]
            group.append((q[:, off:off + M], scale[:, off:off + M]))
            off += M
        out.append(group)
    return out


def _topk_parts_batched(ys, k):
    """One ``topk_select`` launch over the [L*C, N] stack of same-width
    leaves; rows are independent, so each leaf's rows equal its own call."""
    C = ys[0].shape[0]
    val, idx = ck.TOPK_SELECT(torch.cat(ys, dim=0), k=k)
    return [(val[j * C:(j + 1) * C], idx[j * C:(j + 1) * C])
            for j in range(len(ys))]


def encode_tree(comp: CompressionConfig, delta: Tree,
                uniforms: Optional[Uniforms] = None) -> dict:
    """Stacked [C, ...] delta tree -> payload ``{path: parts}``, grouped as
    ``codecs.encode_tree`` groups: one top-k launch per distinct leaf width
    and one int8 grid per distinct ``min(chunk, k)``, groups in SORTED
    order, all the grids quantized in one ``int8_quantize`` call.
    Bit-identical to :func:`encode_tree_unfused`."""
    flat = _flat(delta)
    paths = [p for p, _ in flat]
    ys = [y for _, y in flat]
    out: dict = {}
    if comp.kind in ("topk", "int8+topk"):
        by_n: dict = {}
        for i, y in enumerate(ys):
            by_n.setdefault(y.shape[1], []).append(i)
        vals = [None] * len(ys)
        idxs = [None] * len(ys)
        for n, group in sorted(by_n.items()):
            parts = _topk_parts_batched([ys[i] for i in group],
                                        _leaf_k(comp, n))
            for i, (v, ix) in zip(group, parts):
                vals[i], idxs[i] = v, ix
        if comp.kind == "topk":
            for p, v, ix in zip(paths, vals, idxs):
                out[p] = {"v": v, "i": ix}
            return out
        by_ck: dict = {}
        for i, v in enumerate(vals):
            by_ck.setdefault(min(comp.chunk, v.shape[1]), []).append(i)
        groups = sorted(by_ck.items())
        parts = _int8_parts_batched(
            [([vals[i] for i in group], group, c) for c, group in groups],
            comp.stochastic, uniforms)
        for (_, group), group_parts in zip(groups, parts):
            for i, (q, s) in zip(group, group_parts):
                out[paths[i]] = {"q": q, "s": s, "i": idxs[i]}
        return {p: out[p] for p in paths}
    if comp.kind == "int8":
        parts = _int8_parts_batched([(ys, list(range(len(ys))), comp.chunk)],
                                    comp.stochastic, uniforms)[0]
        return {p: {"q": q, "s": s} for p, (q, s) in zip(paths, parts)}
    raise ValueError(f"unknown compression kind {comp.kind!r}")


def decode_tree(comp: CompressionConfig, payload: dict, like: Tree) -> Tree:
    """payload -> stacked f32 delta tree shaped like ``like``."""
    return {p: _decode_leaf(comp, payload[p], x[0].numel()).reshape(x.shape)
            for p, x in sorted(like.items())}


def roundtrip(comp: CompressionConfig, delta: Tree, resid: Tree,
              uniforms: Optional[Uniforms] = None) -> Tuple[dict, Tree, Tree]:
    """One wire exchange with error feedback: ``(payload, decoded,
    resid')`` with ``resid' = (delta + resid) - decoded`` (zeros when
    ``error_feedback`` is off), as ``codecs.roundtrip``."""
    if comp.error_feedback:
        comp_in = {p: d.float() + resid[p]
                   for p, d in sorted(delta.items())}
    else:
        comp_in = {p: d.float() for p, d in sorted(delta.items())}
    return exchange(comp, comp_in, resid, uniforms, owned=comp.error_feedback)


def exchange(comp: CompressionConfig, comp_in: Tree, resid: Tree,
             uniforms: Optional[Uniforms] = None, owned: bool = False
             ) -> Tuple[dict, Tree, Tree]:
    """The encode/decode half of :func:`roundtrip`, from the codec's input
    ``comp_in`` (the delta with the residual already added when
    ``error_feedback`` is on). ``owned=True`` hands ``comp_in``'s tensors
    over: the new residual is computed in their memory (the same bits as
    ``comp_in - decoded``), so the round keeps one tree fewer alive."""
    payload = encode_tree(comp, comp_in, uniforms)
    decoded = decode_tree(comp, payload, comp_in)
    if comp.error_feedback:
        resid = {p: (x.sub_(decoded[p]) if owned else x - decoded[p])
                 for p, x in sorted(comp_in.items())}
    else:
        resid = {p: torch.zeros_like(r)
                 for p, r in sorted(resid.items())}
    return payload, decoded, resid


def zero_residual(trainable: Tree, num_clients: int, device=None) -> Tree:
    """Fresh [C, ...] f32 error-feedback state for an unstacked template,
    on ``device`` (default: the template's)."""
    return {p: torch.zeros((num_clients,) + tuple(x.shape),
                           dtype=torch.float32,
                           device=x.device if device is None else device)
            for p, x in sorted(trainable.items())}


def corrupt_payload(payload: dict, scales: torch.Tensor) -> dict:
    """Transport corruption of an encoded payload (``codecs.corrupt_payload``):
    the per-client scale ``scales[c]`` is added to every FLOAT part
    (quantization scales, top-k values) in that part's dtype; integer parts
    (int8 codes, indices) pass through untouched. Every codec has a float
    part per leaf, so a scheduled corruption always lands."""
    out = {}
    for p, parts in sorted(payload.items()):
        out[p] = {}
        for name, x in sorted(parts.items()):
            if x.is_floating_point():
                s = scales.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
                x = x + s
            out[p][name] = x
    return out


def wire_format(comp: Optional[CompressionConfig]) -> str:
    """Identity string of the bytes this codec puts on the wire (the same
    string ``codecs.wire_format`` returns)."""
    if comp is None or not comp.enabled:
        return "none"
    parts = [comp.kind]
    if comp.kind in ("int8", "int8+topk"):
        parts.append(f"chunk={comp.chunk}")
        parts.append(f"stochastic={int(comp.stochastic)}")
    if comp.kind in ("topk", "int8+topk"):
        parts.append(f"topk={comp.topk_frac}")
    parts.append(f"ef={int(comp.error_feedback)}")
    return ":".join(parts)


def payload_nbytes(comp: Optional[CompressionConfig], template) -> int:
    """Bytes ONE client ships per round, from leaf shapes alone.
    ``template`` maps paths to unstacked tensors (anything with ``numel``
    and ``element_size``)."""
    total = 0
    # lint: disable=determinism — an integer sum of sizes: the order
    # reaches no draw, payload or digest
    for leaf in template.values():
        n = int(leaf.numel())
        if comp is None or not comp.enabled:
            total += n * leaf.element_size()
        elif comp.kind == "int8":
            m = -(-n // comp.chunk)
            total += m * comp.chunk * 1 + m * 4
        elif comp.kind == "topk":
            total += _leaf_k(comp, n) * (4 + 4)
        elif comp.kind == "int8+topk":
            k = _leaf_k(comp, n)
            c = min(comp.chunk, k)
            m = -(-k // c)
            total += m * c * 1 + m * 4 + k * 4
    return total


def payload_tensor_nbytes(payload: dict) -> int:
    """Bytes actually held by an encoded payload's tensors (all clients)."""
    return sum(t.numel() * t.element_size()
               # lint: disable=determinism — an integer sum of sizes: the
               # order reaches no draw, payload or digest
               for parts in payload.values() for t in parts.values())
