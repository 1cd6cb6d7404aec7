"""PyTorch port (``bcfl_tpu_torch``): the hand-written CUDA kernels.

The tests marked ``gpu`` build the kernels from ``bcfl_tpu_torch/csrc``
and hold them to their plain PyTorch versions on the card, at each op's
``parity`` (bit for bit for the codec, a tolerance for flash attention);
without a card they skip. This file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py
"""

import pytest
import torch

from bcfl_tpu_torch.ops import codec_kernels as ck
from bcfl_tpu_torch.ops import flash_kernels as fk
from bcfl_tpu_torch.ops import registry


def test_cuda_wrappers_reject_bad_inputs_before_building():
    with pytest.raises(ValueError, match="float32"):
        ck._int8_cuda(torch.zeros(2, 3, 4, dtype=torch.float64), None,
                      stochastic=False)
    with pytest.raises(ValueError, match="uniforms"):
        ck._int8_cuda(torch.zeros(2, 3, 4), None, stochastic=True)
    with pytest.raises(ValueError, match="k <= N"):
        ck._topk_cuda(torch.zeros(2, 3), k=4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run "
                    "only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N,k", [(1, 1), (300, 17), (70001, 3500)])
def test_kernels_match_plain_versions_on_card(cuda_device, N, k):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(N)
    x = torch.randn((6, N), generator=gen, device=cuda_device)
    registry.reset_launches()
    v, i = ck.TOPK_SELECT(x, k=k)
    v_ref, i_ref = ck.topk_select_ref(x, k=k)
    assert torch.equal(v.view(torch.int32), v_ref.view(torch.int32))
    assert torch.equal(i, i_ref)
    g = x[:, : (N // 4) * 4 or 1].reshape(6, -1, (N // 4) or 1).contiguous()
    u = torch.rand(g.shape, generator=gen, device=cuda_device)
    for stochastic in (False, True):
        q, s = ck.INT8_QUANTIZE(g, u, stochastic=stochastic)
        q_ref, s_ref = ck.int8_quantize_ref(g, u, stochastic=stochastic)
        assert torch.equal(q, q_ref)
        assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
    counts = registry.launch_counts()
    assert (counts.pop("int8_quantize"), counts.pop("topk_select")) == (2, 1)
    assert set(counts.values()) == {0}


def test_parity_check_reads_the_op_contract():
    same = registry.parity_check("bit-identical")
    assert same(torch.tensor([0.0]), torch.tensor([0.0]))[0]
    assert not same(torch.tensor([-0.0]), torch.tensor([0.0]))[0]
    close = registry.parity_check(fk.FLASH_FWD.parity)
    a = torch.ones(3)  # 2e-2 plus one bf16 ulp of 1 (2**-7)
    assert close(a + 0.0278, a) == (True, pytest.approx(0.0278, abs=1e-6))
    assert not close(a + 0.0279, a)[0]
    assert close(a * 32 + 0.26, a * 32)[0]  # one bf16 ulp at 32 is 0.25
    assert not close(a * float("nan"), a)[0]
    with pytest.raises(ValueError, match="unknown parity"):
        registry.parity_check("allclose:2e-2")


FLASH_CASES = [
    # (B, H, Sq, Sk, D, causal, padded key lengths per batch row or None)
    (2, 3, 300, 300, 64, False, (300, 211)),
    (1, 2, 128, 512, 32, True, None),
    (2, 2, 96, 96, 128, True, (96, 0)),  # row 1: every key padded
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain_versions_on_card(cuda_device, dtype,
                                                    case):
    B, H, Sq, Sk, D, causal, lens = case
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(Sq + Sk + D)

    def draw(S):  # the model's layout: view(B, S, H, D).transpose(1, 2)
        return torch.randn((B, S, H, D), generator=gen, device=cuda_device
                           ).to(dtype).transpose(1, 2)

    q, k, v, do = draw(Sq), draw(Sk), draw(Sk), draw(Sq)
    bias = torch.zeros((B, Sk), device=cuda_device)
    if lens is not None:
        pos = torch.arange(Sk, device=cuda_device)[None, :]
        bias = torch.where(pos < torch.tensor(lens, device=cuda_device)[
            :, None], 0.0, -1e9)
    check = registry.parity_check(fk.FLASH_FWD.parity
                                  if dtype == torch.bfloat16
                                  else fk.F32_PARITY)
    registry.reset_launches()
    out, lse = fk.FLASH_FWD(q, k, v, bias, causal)
    ref = fk.flash_fwd_ref(q, k, v, bias, causal)
    got = fk.FLASH_BWD_DKV(q, k, v, bias, ref[0], do, ref[1], causal)
    got += (fk.FLASH_BWD_DQ(q, k, v, bias, ref[0], do, ref[1], causal),)
    want = fk.flash_bwd_dkv_ref(q, k, v, bias, ref[0], do, ref[1], causal)
    want += (fk.flash_bwd_dq_ref(q, k, v, bias, ref[0], do, ref[1], causal),)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dk", "dv", "db_h", "dq"),
                          (out, lse) + got, ref + want):
        ok, err = check(a, b)
        assert ok, f"{name}: max |diff| {err}"
    counts = registry.launch_counts()
    assert [counts[n] for n in ("flash_fwd", "flash_bwd_dkv",
                                "flash_bwd_dq")] == [1, 1, 1]
    # through autograd: one launch of each per forward and backward
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    fk.FlashAttentionFn.apply(*qkv, bias, causal).backward(do)
    counts = registry.launch_counts()
    assert [counts[n] for n in ("flash_fwd", "flash_bwd_dkv",
                                "flash_bwd_dq")] == [2, 2, 2]
