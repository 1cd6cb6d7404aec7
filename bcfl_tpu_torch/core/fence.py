"""Device-completion fence: port of ``bcfl_tpu/core/fence.py``.

PyTorch returns before the card finishes; a host clock read around work
must fence first. ``fence`` synchronizes the device of the first non-empty
tensor found in ``tree`` and then reads one of its scalars back to the host.
"""

from __future__ import annotations

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fence(tree) -> None:
    """Block the host until the device work producing ``tree`` is done."""
    for t in _tensors(tree):
        if t.numel() == 0:
            continue
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t.reshape(-1)[0].item()
        return
