"""Kernel registry: port of ``bcfl_tpu/ops/registry.py``.

Each :class:`KernelOp` pairs a plain PyTorch version with an optional
hand-written CUDA kernel wrapper. Selection follows the tensor, not a
flag:

- a tensor on the CPU gets the plain version;
- a CUDA tensor gets the kernel wrapper, which launches the kernel or
  raises (no ``auto`` mode, no fallback). An op without a kernel (the
  decode ops, XLA-only in JAX) is plain PyTorch on every device.

Every op carries ``launches``, a plain int that its CUDA wrapper
increments once per kernel launch and nowhere else, so a run can show that
its main path went through the kernel (:func:`reset_launches`,
:func:`launch_counts`); an op with several kernel instances also counts
each launch under its instance's kind in ``launches_by`` (the flash ops:
by dtype). ``parity`` says how a kernel is held to its plain
version, and :func:`parity_check` turns it into the check.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(eq=False)
class KernelOp:
    name: str
    torch: Callable
    cuda: Optional[Callable] = None
    #: how the kernel is held to its plain version: "bit-identical" or
    #: "allclose:atol=<x>,rtol=<y>" (:func:`parity_check`)
    parity: str = "bit-identical"
    #: the shapes the op is paid at (op-specific dicts, read by chip_smoke)
    bench_shapes: Tuple = ()
    #: the TPU kernel this op's CUDA kernel replaces (file:function)
    replaces: str = ""
    #: stem of the kernel's source, ``bcfl_tpu_torch/csrc/<source>.cu``
    source: str = ""
    launches: int = 0
    #: ``launches`` split by kernel instance (the flash ops: by dtype)
    launches_by: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __call__(self, *args, **kwargs):
        dev = _device_of(args)
        if dev.type == "cpu" or self.cuda is None:
            return self.torch(*args, **kwargs)
        if dev.type == "cuda":
            return self.cuda(*args, **kwargs)
        raise ValueError(f"op {self.name!r}: no implementation for device "
                         f"{dev}")


_ALLCLOSE = re.compile(r"allclose:atol=([0-9.eE+-]+),rtol=([0-9.eE+-]+)$")


def parity_check(parity: str) -> Callable[[torch.Tensor, torch.Tensor],
                                          Tuple[bool, float]]:
    """``check(got, want) -> (ok, max_abs_err)`` for a ``parity`` string:
    ``"bit-identical"`` (same bits, so -0.0 and NaN payloads count) or
    ``"allclose:atol=<x>,rtol=<y>"`` (``|got - want| <= atol + rtol *
    |want|`` everywhere, in float64)."""
    def err(a, b):
        return (float((a.double() - b.double()).abs().max())
                if a.numel() else 0.0)

    if parity == "bit-identical":
        def bits(a, b):
            if a.shape != b.shape or a.dtype != b.dtype:
                return False, float("inf")
            if a.is_floating_point():
                view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
                same = torch.equal(a.view(view[a.element_size()]),
                                   b.view(view[b.element_size()]))
            else:
                same = torch.equal(a, b)
            return same, err(a, b)
        return bits
    m = _ALLCLOSE.match(parity)
    if m is None:
        raise ValueError(f"unknown parity {parity!r}: 'bit-identical' or "
                         "'allclose:atol=<x>,rtol=<y>'")
    atol, rtol = float(m.group(1)), float(m.group(2))

    def close(a, b):
        if a.shape != b.shape:
            return False, float("inf")
        d = (a.double() - b.double()).abs()
        ok = bool((d <= atol + rtol * b.double().abs()).all())
        return ok, err(a, b)
    return close


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, (list, tuple)) and a:
            a = a[0]  # an op over a sequence of tensors
        if isinstance(a, torch.Tensor):
            return a.device
    raise TypeError("kernel op called without a tensor argument")


_REGISTRY: Dict[str, KernelOp] = {}


def register_op(op: KernelOp) -> KernelOp:
    prev = _REGISTRY.get(op.name)
    if prev is not None and prev is not op:
        raise ValueError(f"kernel op {op.name!r} already registered")
    _REGISTRY[op.name] = op
    return op


def list_ops() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def kernel_ops() -> Tuple[KernelOp, ...]:
    """The ops that have a hand-written kernel, by name."""
    return tuple(op for _, op in sorted(_REGISTRY.items())
                 if op.cuda is not None)


def reset_launches() -> None:
    for op in _REGISTRY.values():
        op.launches = 0
        op.launches_by.clear()


def launch_counts() -> Dict[str, int]:
    return {op.name: op.launches for op in kernel_ops()}


def kernel_sources() -> Tuple[str, ...]:
    """The ``csrc`` stems of every registered kernel op."""
    return tuple(sorted({op.source for op in kernel_ops()}))
