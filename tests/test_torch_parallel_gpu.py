"""PyTorch port (``bcfl_tpu_torch``): tensor and sequence parallelism on
the card against the same calls on the CPU.

- Ring attention (``ring_attention_gspmd`` over ``[cuda:0] * 4``, float32,
  causal and not, with padding): output and q, k, v gradients equal the
  CPU ring's within float32 summation order (atol 1e-4, rtol 1e-4; TF32
  off, ``full_float32_matmuls``), and 3 rotations per call.
- A tiny ``FedConfig(tp=2)`` round (tiny-llama LoRA, float32 compute) on
  ``devices=[cuda:0, cuda:0]`` against the same round on two CPU
  devices from the same weights and adapters: train loss at rtol 1e-4,
  adapters within atol 1e-4.
- The flash kernels K1-K3 on a tensor-parallel head shard (Llama-2-7B's
  16 of 32 heads at D = 128, bf16, causal, -1e30 padding; batch cut to
  2): each kernel against its plain version at the op's bf16 ``parity``,
  one launch each.
- On a host with two or more cards (skipped on one): the same ``tp=2``
  round, with flash attention at every length, on ``[cuda:0, cuda:1]``,
  where each shard owns its slice on its card and the dense weights are
  ``meta`` placeholders (the base stored once), against the CPU round at
  the same tolerances, and :func:`~bcfl_tpu_torch.parallel.tp_linear.
  unshard` putting the dense weights back on the first card; the ring over
  blocks on alternating cards against the CPU ring as above.

The tests marked ``gpu`` skip without a card. This file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_parallel_gpu.py
"""

import importlib

import pytest
import torch

from bcfl_tpu_torch.config import FedConfig, PartitionConfig
from bcfl_tpu_torch.fed.engine import FedEngine
from bcfl_tpu_torch.models import full_float32_matmuls
from bcfl_tpu_torch.ops import flash_kernels as fk
from bcfl_tpu_torch.ops import registry
from bcfl_tpu_torch.parallel import tp_linear

# the package exports the function ring_attention under the module's name
ra = importlib.import_module("bcfl_tpu_torch.parallel.ring_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card-vs-CPU comparison runs "
                    "only on the card)")
    full_float32_matmuls()
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (shards placed on separate "
                    "cards)")
    return [cuda_device, torch.device("cuda", 1)]


def _ring_against_cpu(devices, causal):
    g = torch.Generator().manual_seed(5)
    B, H, S, D = 2, 4, 256, 64
    q, k, v, w = (torch.randn((B, H, S, D), generator=g) for _ in range(4))
    keep = torch.arange(S)[None] < torch.tensor([256, 90])[:, None]
    bias = torch.where(keep, 0.0, -1e30)
    out = {}
    cpu = torch.device("cpu")
    for dev, ring in ((cpu, [cpu] * 4), (devices[0], devices)):
        leaves = [x.detach().to(dev).requires_grad_(True)
                  for x in (q, k, v)]
        ra.reset_rotations()
        o = ra.ring_attention_gspmd(*leaves, bias.to(dev), ring,
                                    causal=causal)
        assert ra.rotations() == 3
        (o * w.to(dev)).sum().backward()
        out[dev.type] = [o.detach().cpu()] + [x.grad.cpu() for x in leaves]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_on_the_card_equals_cpu(cuda_device, causal):
    _ring_against_cpu([cuda_device] * 4, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_across_cards_equals_cpu(two_cards, causal):
    _ring_against_cpu(two_cards * 2, causal)


def _tp2_round_against_cpu(devices, **kw):
    """The tp=2 round on ``devices`` against the same round on the CPU
    from the same weights and adapters; returns the card's engine."""
    cfg = FedConfig(dataset="synthetic", num_labels=2, seq_len=16,
                    batch_size=4, vocab_size=512, model="tiny-llama",
                    lora_rank=2, tp=2, num_clients=4, num_rounds=1,
                    learning_rate=1e-3, max_local_batches=2,
                    compute_dtype="float32", eval_every=0,
                    partition=PartitionConfig(kind="iid", iid_samples=16),
                    **kw)
    cpu = FedEngine(cfg, device="cpu")
    card = FedEngine(cfg, devices=devices)
    assert card.mesh.devices == devices
    # new weights go into the dense layers: the split is undone and re-taken
    specs = tp_linear.layout(card.model)
    tp_linear.unshard(card.model)
    card.model.load_state_dict(cpu.model.state_dict())
    tp_linear.shard_base(card.model, specs, devices)
    card.trainable0 = {p: x.to(devices[0])
                       for p, x in cpu.trainable0.items()}
    a, b = cpu.run(), card.run()
    torch.testing.assert_close(b.metrics.rounds[0].train_loss,
                               a.metrics.rounds[0].train_loss, rtol=1e-4,
                               atol=0)
    for p, x in a.trainable.items():
        torch.testing.assert_close(b.trainable[p].cpu(), x, atol=1e-4,
                                   rtol=0, msg=p)
    return card, cpu


@pytest.mark.gpu
def test_tp2_round_on_one_card_equals_cpu(cuda_device):
    _tp2_round_against_cpu([cuda_device] * 2)


@pytest.mark.gpu
def test_tp2_round_on_two_cards_equals_cpu(two_cards):
    registry.reset_launches()
    card, cpu = _tp2_round_against_cpu(two_cards, use_flash=True)
    assert registry.launch_counts()["flash_fwd"] > 0
    split = tp_linear.split_layers(card.model)
    assert split
    for name, sh in split.items():
        assert card.model.get_submodule(name).weight.is_meta, name
        assert [w.device for w in sh.weights] == two_cards, name
    # the frozen base comes back whole on the first card, bit for bit
    tp_linear.unshard(card.model)
    for name in split:
        got = card.model.get_submodule(name).weight
        assert got.device == two_cards[0], name
        torch.testing.assert_close(
            got.cpu(), cpu.model.get_submodule(name).weight, atol=0, rtol=0,
            msg=name)


@pytest.mark.gpu
def test_flash_on_a_tp_head_shard(cuda_device):
    g = torch.Generator(device="cuda").manual_seed(6)
    B, H, S, D = 2, 16, 512, 128
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    keep = (torch.arange(S, device="cuda")[None]
            < torch.tensor([512, 301], device="cuda")[:, None])
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
