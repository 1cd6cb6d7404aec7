"""PyTorch port (``bcfl_tpu_torch``): the hand-written CUDA kernels.

The tests marked ``gpu`` build the kernels from ``bcfl_tpu_torch/csrc``
and hold them to their plain PyTorch versions bit for bit; without a card
they skip. This file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py
"""

import pytest
import torch

from bcfl_tpu_torch.ops import codec_kernels as ck
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
    assert registry.launch_counts() == {"int8_quantize": 2, "topk_select": 1}
