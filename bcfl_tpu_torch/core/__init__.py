"""Core helpers: device resolution, host-to-device copies, seeded
generators, the fence."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA request without a visible GPU
    raises instead of dropping to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bcfl_tpu_torch runs on the GPU by default and no CUDA "
                "device is available; pass device='cpu' (CLI: --device cpu) "
                "to run the plain PyTorch versions on the CPU")
    return dev


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A CPU tensor on ``device`` without the host waiting for the card's
    queue to drain (a plain copy from pageable memory synchronizes the
    stream): on a card through pinned memory and a non-blocking copy,
    whose pinned block is not reused before the copy has run; on the CPU
    the tensor itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
