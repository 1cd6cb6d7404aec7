"""PyTorch port (``bcfl_tpu_torch``): the Llama LoRA path on the card
against the same calls on the CPU.

- The per-layer LoRA merge inside the forward (tiny-llama, float32
  compute, adapters with nonzero ``b``, ragged padding): logits and the
  adapters' gradients on the card equal the CPU's within float32
  summation order (atol 1e-4, rtol 1e-4; float32 products run in full
  float32 on the card, ``full_float32_matmuls``).
- The flash kernels K1-K3 at head dim 128, bf16, causal, with Llama's
  -1e30 key padding: each kernel against its plain version at the op's
  bf16 ``parity``, and each launches once per call.

The tests marked ``gpu`` skip without a card. This file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_llama_gpu.py
"""

import pytest
import torch

from bcfl_tpu_torch.core import prng
from bcfl_tpu_torch.models import (build, full_float32_matmuls, lora,
                                   lora_targets)
from bcfl_tpu_torch.models.bert import init_params
from bcfl_tpu_torch.ops import flash_kernels as fk
from bcfl_tpu_torch.ops import registry


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card-vs-CPU comparison runs "
                    "only on the card)")
    full_float32_matmuls()
    return torch.device("cuda")


def _lora_model(device, head):
    with torch.device(device):
        model = build("tiny-llama", head=head, num_labels=3, vocab_size=512,
                      dtype=torch.float32)
    init_params(model, prng.generator("cpu", 0, 2))
    model.requires_grad_(False)
    adp = lora.init_lora(prng.generator("cpu", 0, prng.LORA_LANE), model, 4,
                         lora_targets("tiny-llama"))
    g = torch.Generator().manual_seed(1)
    return model, {p: (torch.randn(x.shape, generator=g) * 0.05
                       if p.endswith("/b") else x) for p, x in adp.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("head", ["classifier", "lm"])
def test_lora_merge_forward_and_grads_card_equal_cpu(cuda_device, head):
    model, adp = _lora_model("cpu", head)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(4, 512, (3, 24), generator=g)
    mask = (torch.arange(24)[None] < torch.tensor([24, 11, 5])[:, None]).to(
        torch.int32)
    out = {}
    for dev in ("cpu", cuda_device):
        m = model.to(dev)
        leaves = {p: x.to(dev).clone().requires_grad_(True)
                  for p, x in adp.items()}
        with lora.attached(m, leaves):
            logits = m(ids.to(dev), mask.to(dev))
        logits.float().square().mean().backward()
        out[str(dev)] = (logits.detach().cpu(),
                         {p: x.grad.cpu() for p, x in leaves.items()})
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(lg, lc, atol=1e-4, rtol=1e-4)
    for p in gc:
        torch.testing.assert_close(gg[p], gc[p], atol=1e-4, rtol=1e-4,
                                   msg=p)


@pytest.mark.gpu
def test_flash_causal_head_dim_128_llama_padding(cuda_device):
    g = torch.Generator(device="cuda").manual_seed(3)
    B, H, S, D = 2, 4, 256, 128
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    keep = (torch.arange(S, device="cuda")[None]
            < torch.tensor([256, 77], device="cuda")[:, None])
    bias = torch.where(keep, 0.0, -1e30)
    check = registry.parity_check(fk.FLASH_FWD.parity)
    registry.reset_launches()
    out, lse = fk.FLASH_FWD(q, k, v, bias, True)
    ref = fk.flash_fwd_ref(q, k, v, bias, True)
    bwd = (q, k, v, bias, ref[0], do, ref[1], True)
    got = (out, lse) + tuple(fk.FLASH_BWD_DKV(*bwd)) + (fk.FLASH_BWD_DQ(*bwd),)
    want = ref + tuple(fk.flash_bwd_dkv_ref(*bwd)) + (
        fk.flash_bwd_dq_ref(*bwd),)
    torch.cuda.synchronize()
    for a, b, sl in zip(got, want, (None, None) + fk.ds_slack(*bwd)):
        ok, err = check(a, b, sl)
        assert ok, err
    counts = registry.launch_counts()
    assert [counts[n] for n in ("flash_fwd", "flash_bwd_dkv",
                                "flash_bwd_dq")] == [1, 1, 1]
