"""PyTorch port (``bcfl_tpu_torch``): the robust aggregators on the card
against the same calls on the CPU.

The rules are plain PyTorch (the JAX package's are plain ``jnp`` outside
any Pallas kernel), so the card runs ``torch.sort`` and a float32 matmul
where the CPU runs its own: ``masked_median`` is held bit for bit,
``masked_trimmed_mean`` at rtol 1e-6 (its float32 sum runs row after row
on both), ``masked_krum`` to the same selected client and then bit for
bit. The tests marked ``gpu`` skip without a card. This file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_robust_gpu.py
"""

import pytest
import torch

from bcfl_tpu_torch import parallel as tpar


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card-vs-CPU comparison runs "
                    "only on the card)")
    return torch.device("cuda")


def _stacked(C, dtype, seed, corrupt=()):
    g = torch.Generator().manual_seed(seed)
    tree = {"emb": torch.randn((C, 3001, 24), generator=g),
            "kernel": torch.randn((C, 64, 48), generator=g),
            "bias": torch.randn((C, 48), generator=g)}
    for c in corrupt:
        for x in tree.values():
            x[c] += 1e6
    fb = {p: torch.randn(x.shape[1:], generator=g) for p, x in tree.items()}
    return ({p: x.to(dtype) for p, x in tree.items()},
            {p: x.to(dtype) for p, x in fb.items()})


MASKS = [[1] * 10, [1, 0, 1, 1, 1, 0, 1, 1, 1, 1], [0, 1] + [0] * 8,
         [0] * 9 + [2], [0] * 10]
MASK_IDS = ["k10", "k8", "k1", "k1w2", "none"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_median_and_trimmed_mean_card_equal_cpu(cuda_device, mask, dtype):
    tree, fb = _stacked(10, dtype, len(mask) + sum(mask), corrupt=(1, 7))
    w = torch.tensor(mask, dtype=torch.float32)
    on = {p: x.to(cuda_device) for p, x in tree.items()}
    fb_on = {p: x.to(cuda_device) for p, x in fb.items()}
    w_on = w.to(cuda_device)
    med_cpu = tpar.masked_median(tree, w, fallback=fb)
    med_gpu = tpar.masked_median(on, w_on, fallback=fb_on)
    for p in tree:
        assert med_gpu[p].dtype == dtype
        assert torch.equal(med_gpu[p].cpu(), med_cpu[p]), p
    for trim in (0.1, 0.2, 0.45):
        tm_cpu = tpar.masked_trimmed_mean(tree, w, trim, fallback=fb)
        tm_gpu = tpar.masked_trimmed_mean(on, w_on, trim, fallback=fb_on)
        for p in tree:
            torch.testing.assert_close(tm_gpu[p].cpu().float(),
                                       tm_cpu[p].float(), rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mask", MASKS[:4], ids=MASK_IDS[:4])
def test_krum_card_selects_as_cpu(cuda_device, mask):
    g = torch.Generator().manual_seed(3)
    # clients at very different distances from a shared base
    scales = torch.tensor([0.3, 2.0, 0.05, 4.0, 6.0, 0.6, 9.0, 1.1, 0.02,
                           3.0])
    base = {"a": torch.randn((257, 33), generator=g),
            "b": torch.randn((41,), generator=g)}
    tree = {p: b + scales.reshape((-1,) + (1,) * b.dim())
            * torch.randn((10,) + tuple(b.shape), generator=g)
            for p, b in base.items()}
    w = torch.tensor(mask, dtype=torch.float32)
    cpu = tpar.masked_krum(tree, w, 0.2)
    gpu = tpar.masked_krum({p: x.to(cuda_device) for p, x in tree.items()},
                           w.to(cuda_device), 0.2)
    for p in tree:
        assert torch.equal(gpu[p].cpu(), cpu[p]), p
    picks = [c for c in range(10)
             if all(torch.equal(cpu[p], tree[p][c]) for p in tree)]
    assert len(picks) == 1 and mask[picks[0]] > 0
