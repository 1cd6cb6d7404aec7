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
:func:`launch_counts`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(eq=False)
class KernelOp:
    name: str
    torch: Callable
    cuda: Optional[Callable] = None
    #: how the kernel is held to its plain version; chip_smoke.py checks
    #: "bit-identical", the only contract a kernel of the port has so far
    parity: str = "bit-identical"
    #: the shapes the op is paid at (op-specific dicts, read by chip_smoke)
    bench_shapes: Tuple = ()
    #: the TPU kernel this op's CUDA kernel replaces (file:function)
    replaces: str = ""
    launches: int = 0

    def __call__(self, *args, **kwargs):
        dev = _device_of(args)
        if dev.type == "cpu" or self.cuda is None:
            return self.torch(*args, **kwargs)
        if dev.type == "cuda":
            return self.cuda(*args, **kwargs)
        raise ValueError(f"op {self.name!r}: no implementation for device "
                         f"{dev}")


def _device_of(args) -> torch.device:
    for a in args:
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


def launch_counts() -> Dict[str, int]:
    return {op.name: op.launches for op in kernel_ops()}
