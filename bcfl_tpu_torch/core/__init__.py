"""Core helpers: device resolution, seeded generators, the fence."""

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
