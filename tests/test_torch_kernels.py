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
        ck._int8_cuda([torch.zeros(2, 3, 4, dtype=torch.float64)], None,
                      stochastic=False)
    with pytest.raises(ValueError, match="uniforms"):
        ck._int8_cuda([torch.zeros(2, 3, 4)], None, stochastic=True)
    with pytest.raises(ValueError, match="grids per call"):
        ck._int8_cuda([torch.zeros(2, 3, 4)] * 17, None, stochastic=False)
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
        [(q, s)] = ck.INT8_QUANTIZE([g], [u], stochastic=stochastic)
        q_ref, s_ref = ck.int8_quantize_ref(g, u, stochastic=stochastic)
        assert torch.equal(q, q_ref)
        assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
    counts = registry.launch_counts()
    assert (counts.pop("int8_quantize"), counts.pop("topk_select")) == (2, 1)
    assert set(counts.values()) == {0}


def _nonfinite_grid(C, M, chunk, gen):
    """A [C, M, chunk] grid whose first rows hold NaN, -NaN, +inf, -inf
    (each one element of an otherwise Gaussian row) and a row of both
    infinities; the rest are Gaussian."""
    g = torch.randn((C, M, chunk), generator=gen, device=gen.device) * 1e-3
    flat = g.view(-1, chunk)
    specials = (float("nan"), -float("nan"), float("inf"), -float("inf"))
    for r, v in enumerate(specials[:flat.shape[0]]):
        flat[r, (7 * r) % chunk] = v
    if flat.shape[0] > 4 and chunk > 1:
        flat[4, 0], flat[4, -1] = float("inf"), -float("inf")
    return g


def _hold_int8(gs, us, stochastic):
    """One launch over the grids ``gs``, each held to its plain version."""
    got = ck.INT8_QUANTIZE(gs, us if stochastic else None,
                           stochastic=stochastic)
    for k, (q, s) in enumerate(got):
        q_ref, s_ref = ck.int8_quantize_ref(
            gs[k], us[k] if stochastic else None, stochastic=stochastic)
        assert torch.equal(q, q_ref)
        assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))


# chunk widths of every path of the kernel: groups of 1 and 2 lanes, the
# two-pass warp per row at 39, 64, 255 and 300, and the vectorised 256
INT8_WIDTHS = [1, 2, 39, 64, 255, 256, 300]


@pytest.mark.gpu
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("chunk", INT8_WIDTHS)
def test_int8_quantize_matches_plain_version_on_card(cuda_device, chunk,
                                                     stochastic):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(chunk + 1000 * stochastic)
    registry.reset_launches()
    for C, M in ((3, 1), (4, 77), (2, 1001)):
        g = torch.randn((C, M, chunk), generator=gen, device=cuda_device)
        g *= 10.0 ** torch.randint(-6, 3, (C, M, 1), generator=gen,
                                   device=cuda_device)
        g[0, 0] = 0.0  # an all-zero chunk takes the 1e-30 floor
        u = torch.rand(g.shape, generator=gen, device=cuda_device)
        _hold_int8([g], [u], stochastic)
        # the non-finite rows: NaN-propagating maximum and clip
        _hold_int8([_nonfinite_grid(C, M, chunk, gen)], [u], stochastic)
    assert registry.launch_counts()["int8_quantize"] == 6


@pytest.mark.gpu
def test_int8_quantize_on_unaligned_256_wide_rows_on_card(cuda_device):
    """256-wide rows that start 4 bytes past a 16-byte boundary cannot take
    the vector loads: the kernel runs them through its two-pass mapping,
    beside an aligned grid in the same launch."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(256)
    base = torch.randn(3 * 41 * 256 + 1, generator=gen, device=cuda_device)
    g = base[1:].view(3, 41, 256)
    assert g.data_ptr() % 16 == 4
    g[0, 3, 17] = float("nan")
    us = [torch.rand(g.shape, generator=gen, device=cuda_device)
          for _ in range(2)]
    aligned = torch.randn((3, 41, 256), generator=gen, device=cuda_device)
    for stochastic in (True, False):
        _hold_int8([g, aligned], us, stochastic)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 10])
def test_int8_quantize_on_the_main_path_grids_on_card(cuda_device, C):
    """The grids one bert-base round quantizes, in one launch: chunk 256
    over the 5% of every large leaf, and the short chunks of the small
    leaves (154, 77, 39, 2, 1), with a non-finite grid among them and an
    empty one."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(C)
    shapes = ((21404, 256), (12, 154), (2, 77), (111, 39), (1, 2), (1, 1),
              (0, 64))
    gs = [torch.randn((C, M, c), generator=gen, device=cuda_device)
          for M, c in shapes]
    gs[3] = _nonfinite_grid(C, 111, 39, gen)
    us = [torch.rand(g.shape, generator=gen, device=cuda_device) for g in gs]
    registry.reset_launches()
    for stochastic in (True, False):
        _hold_int8(gs, us, stochastic)
    assert registry.launch_counts()["int8_quantize"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 6, 4099])
def test_topk_select_on_nonfinite_rows_on_card(cuda_device, k):
    """NaN, -NaN and both infinities rank as ``lax.top_k`` and the plain
    version rank them (NaN first, then inf), values gathered with their
    sign bits."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(k)
    x = torch.randn((3, 4099), generator=gen, device=cuda_device)
    x[0, 17], x[0, 4000], x[0, 5] = float("nan"), -float("nan"), float("inf")
    x[1, 9], x[1, 3] = -float("inf"), float("inf")
    x[2, ::2] = float("nan")
    v, i = ck.TOPK_SELECT(x, k=k)
    v_ref, i_ref = ck.topk_select_ref(x, k=k)
    assert torch.equal(i, i_ref)
    assert torch.equal(v.view(torch.int32), v_ref.view(torch.int32))


def _topk_rows(kind, R, N, gen):
    """[R, N] rows for the top-k kernel: ``one-bin`` holds one magnitude of
    both signs (every key in the leading-digit bin, so the candidate
    buffer takes the whole row); ``adamw`` is shaped like a delta after two
    AdamW steps (a dense band of magnitudes in [lr, 2 lr) with exact
    repeats, then a weight-decay-only tail); ``randn`` is Gaussian."""
    dev = gen.device
    if kind == "one-bin":
        x = torch.full((R, N), 0.75, device=dev)
        x[:, ::2] = -0.75
        return x
    if kind == "adamw":
        lr = 5e-5
        band = torch.randint(0, 16, (R, N), generator=gen, device=dev)
        x = lr * (1 + band.float() / 16)
        tail = N * 3 // 4
        x[:, tail:] = lr * 0.01 * 0.02 * torch.randn(
            (R, N - tail), generator=gen, device=dev)
        sign = torch.rand((R, N), generator=gen, device=dev) < 0.5
        return torch.where(sign, -x, x)
    return torch.randn((R, N), generator=gen, device=dev)


TOPK_CASES = [
    # (rows, R, N, k)
    ("one-bin", 2, 100000, 50001),
    ("one-bin", 2, 100000, 100000),  # k = N
    ("randn", 3, 4099, 4099),  # k = N past one 4096-element tile
    ("randn", 3, 300000, 65537),  # k just above a power of two
    ("adamw", 4, 200000, 150001),  # k crosses the band into the tail
    ("randn", 96, 2359296, 117965),  # bert-base's MLP leaves, 4 clients
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_select_matches_plain_version_on_card(cuda_device, case):
    kind, R, N, k = case
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(R + N + k)
    x = _topk_rows(kind, R, N, gen)
    registry.reset_launches()
    v, i = ck.TOPK_SELECT(x, k=k)
    v_ref, i_ref = ck.topk_select_ref(x, k=k)
    assert torch.equal(i, i_ref)
    assert torch.equal(v.view(torch.int32), v_ref.view(torch.int32))
    assert registry.launch_counts()["topk_select"] == 1


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


def test_flash_parity_follows_the_dtype():
    """One contract per dtype: bf16 the ops' ``parity``, fp16 1e-2 plus
    one fp16 ulp (2**-10) of the value, float32 1e-4."""
    assert fk.parity_for(torch.bfloat16) == fk.FLASH_FWD.parity
    assert fk.parity_for(torch.float32) == fk.F32_PARITY
    assert fk.parity_for(torch.float16) == fk.FP16_PARITY
    close = registry.parity_check(fk.FP16_PARITY)
    a = torch.ones(3)  # 1e-2 plus one fp16 ulp of 1 (2**-10)
    assert close(a + 0.01097, a)[0]
    assert not close(a + 0.01098, a)[0]
    assert close(a * 32 + 0.0412, a * 32)[0]  # one fp16 ulp at 32: 2**-5
    assert not close(a * 32 + 0.0414, a * 32)[0]
    with pytest.raises(KeyError):
        fk.parity_for(torch.float64)


def test_parity_check_takes_a_slack():
    close = registry.parity_check(fk.BF16_PARITY)
    a = torch.ones(3)
    assert not close(a + 0.03, a)[0]
    assert close(a + 0.03, a, torch.full((3,), 0.003))[0]
    assert not close(a + 0.03, a, torch.tensor([0.003, 0.003, 0.0]))[0]
    with pytest.raises(ValueError, match="no slack"):
        registry.parity_check("bit-identical")(a, a, a)


def test_ulp_of_the_16bit_dtypes():
    x = torch.tensor([1.0, 1.99, 2.0, 32.0, -40.0, 0.0])
    assert fk.ulp(x, torch.bfloat16).tolist()[:5] == [
        2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 0.25, 0.25]
    assert fk.ulp(x, torch.float16).tolist()[:5] == [
        2.0 ** -10, 2.0 ** -10, 2.0 ** -9, 2.0 ** -5, 2.0 ** -5]
    assert 0.0 < fk.ulp(x, torch.bfloat16)[5] < 1e-38
    # one ulp up is the next value of the dtype; less than half rounds back
    for dtype in (torch.bfloat16, torch.float16):
        y = torch.tensor([3.0, 17.0, 0.3]).to(dtype)
        u = fk.ulp(y, dtype)
        nxt = (y.float() + u).to(dtype)
        assert bool((nxt > y).all())
        assert torch.equal((y.float() + 0.49 * u).to(dtype), y)
        assert torch.equal((nxt.float() - 0.51 * u).to(dtype), y)


def _slack_case(dtype, D, causal, seed=0, S=128):
    """Batch row 0 with live keys (its tail padded), row 1 all padded."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((2, S, 2, D), generator=g).to(dtype)
                   .transpose(1, 2) for _ in range(4))
    bias = torch.zeros((2, S))
    bias[0, S - S // 4:] = -1e9
    bias[1] = -1e9
    out, lse = fk.flash_fwd_ref(q, k, v, bias, causal)
    return (q, k, v, bias, out, do, lse, causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D,causal", [(64, False), (32, True),
                                      (128, False)])
def test_ds_slack_is_zero_on_live_rows_and_covers_an_all_padded_row(
        dtype, D, causal):
    """On rows that see a live key the slack is exactly 0, so dk and dq
    are held to the flat contract there. On the all-padded row a
    constructed flip of ds's rounding, one ulp at the entry that moves dq
    and dk the most, breaks the flat contract and stays within the
    slack."""
    bwd = _slack_case(dtype, D, causal)
    q, k, v, bias, out, do, lse, _ = bwd
    sdk, sdv, sdb, sdq = fk.ds_slack(*bwd)
    assert sdv is None and sdb is None
    assert sdq.shape == q.shape and sdk.shape == k.shape
    assert bool((lse[0] > fk.PADDED_LSE).all())
    assert bool((lse[1] <= fk.PADDED_LSE).all())
    assert torch.count_nonzero(sdq[0]) == 0
    assert torch.count_nonzero(sdk[0]) == 0
    assert bool((sdq[1] > 0).all()) and bool((sdk[1] > 0).all())
    check = registry.parity_check(fk.parity_for(dtype))
    dk_want = fk.flash_bwd_dkv_ref(*bwd)[0]
    dq_want = fk.flash_bwd_dq_ref(*bwd)
    _, ds = fk._probs_and_ds(*bwd)
    scale = D ** -0.5
    for b in (0, 1):
        # flip ds[b, 0, i, j] by one ulp where |ds ulp * k[j, d]| is
        # largest against the flat tolerance of dq[i, d]
        dsr = ds.to(dtype).float()
        step = fk.ulp(ds, dtype)[b, 0]
        kf = k[b, 0].float()
        tol = 2e-2 + 2.0 ** -7 * dq_want[b, 0].float().abs()
        gain = (step[:, :, None] * kf.abs()[None] * scale
                / tol[:, None, :])  # [i, j, d]
        i, j, _ = torch.unravel_index(gain.argmax(), gain.shape)
        dsr[b, 0, i, j] += step[i, j] * torch.sign(ds[b, 0, i, j])
        dq = (torch.matmul(dsr, k.float()) * scale).to(dtype)
        dk = (torch.matmul(dsr.transpose(-1, -2), q.float())
              * scale).to(dtype)
        live = b == 0
        assert check(dq, dq_want, sdq)[0] and check(dk, dk_want, sdk)[0]
        if not live and dtype == torch.bfloat16:
            assert not check(dq, dq_want)[0]  # past the flat contract
        if live:  # the slack adds nothing: the flat contract decides
            assert check(dq, dq_want)[0] == check(dq, dq_want, sdq)[0]


def test_ds_slack_none_for_float32():
    bwd = _slack_case(torch.float32, 64, False)
    assert fk.ds_slack(*bwd) == (None,) * 4


FLASH_CASES = [
    # (B, H, Sq, Sk, D, causal, padded key lengths per batch row or None)
    (2, 3, 300, 300, 64, False, (300, 211)),
    (1, 2, 128, 512, 32, True, None),
    (2, 2, 96, 96, 128, True, (96, 0)),  # row 1: every key padded
    # the edges of the bf16 wgmma kernels' zero-filled tiles: a single
    # query against 77 keys (not a multiple of 16 or 64), one row past a
    # tile on both sides, and D = 128 (two 128-byte swizzle atoms per row)
    (1, 2, 1, 77, 64, True, None),
    (2, 2, 513, 513, 64, False, (513, 65)),
    (2, 2, 128, 128, 128, False, (128, 50)),
    # causal with more queries than keys: the first 80 queries see no key
    (2, 2, 150, 70, 64, True, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
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
    check = registry.parity_check(fk.parity_for(dtype))
    registry.reset_launches()
    out, lse = fk.FLASH_FWD(q, k, v, bias, causal)
    ref = fk.flash_fwd_ref(q, k, v, bias, causal)
    got = fk.FLASH_BWD_DKV(q, k, v, bias, ref[0], do, ref[1], causal)
    got += (fk.FLASH_BWD_DQ(q, k, v, bias, ref[0], do, ref[1], causal),)
    want = fk.flash_bwd_dkv_ref(q, k, v, bias, ref[0], do, ref[1], causal)
    want += (fk.flash_bwd_dq_ref(q, k, v, bias, ref[0], do, ref[1], causal),)
    torch.cuda.synchronize()
    slack = (None, None) + fk.ds_slack(q, k, v, bias, ref[0], do, ref[1],
                                       causal)
    for name, a, b, sl in zip(("out", "lse", "dk", "dv", "db_h", "dq"),
                              (out, lse) + got, ref + want, slack):
        ok, err = check(a, b, sl)
        assert ok, f"{name}: max |diff| {err}"
    counts = registry.launch_counts()
    assert [counts[n] for n in ("flash_fwd", "flash_bwd_dkv",
                                "flash_bwd_dq")] == [1, 1, 1]
    key = str(dtype).split(".")[-1]  # each launch counted under its dtype
    assert [op.launches_by for op in (fk.FLASH_FWD, fk.FLASH_BWD_DKV,
                                      fk.FLASH_BWD_DQ)] == [{key: 1}] * 3
    # through autograd: one launch of each per forward and backward
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    fk.FlashAttentionFn.apply(*qkv, bias, causal).backward(do)
    counts = registry.launch_counts()
    assert [counts[n] for n in ("flash_fwd", "flash_bwd_dkv",
                                "flash_bwd_dq")] == [2, 2, 2]


@pytest.mark.gpu
def test_flash_route_follows_the_dtype_on_card(cuda_device):
    """bf16 and fp16 calls of the forward, dK/dV and dQ launch their own
    wgmma (tensor core) instances, float32 calls their float32 FMA
    instances: the check ``chip_smoke.py`` runs, which raises
    otherwise."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.flash_routes(fk)


@pytest.mark.gpu
def test_flash_entries_refuse_an_unknown_dtype_code_on_card(cuda_device):
    """A dtype code no instance is built for comes back as
    ``cudaErrorInvalidValue`` (1) from each C entry, before any launch."""
    x = torch.zeros((1, 1, 64, 64), dtype=torch.float16, device=cuda_device)
    bias = torch.zeros((1, 64), device=cuda_device)
    lse = torch.zeros((1, 1, 64), device=cuda_device)
    strides = fk._strides(x, x, x, x, x)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert 3 not in fk._DTYPE_CODES.values()
    for op, ptrs in ((fk.FLASH_FWD, [x, x, x, bias, x, lse]),
                     (fk.FLASH_BWD_DKV, [x, x, x, bias, x, x, lse, x, x,
                                         lse]),
                     (fk.FLASH_BWD_DQ, [x, x, x, bias, x, x, lse, x])):
        fn = fk._entry(op, len(ptrs))
        assert fn(*[t.data_ptr() for t in ptrs], 1, 1, 64, 64, 64, 3,
                  strides, 0.125, 0, stream) == 1, op.name
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def sm90_check(tmp_path_factory):
    """``tests/cuda/sm90_check.cu`` built with the kernels' nvcc flags."""
    import ctypes
    import subprocess
    from pathlib import Path

    from bcfl_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run "
                    "only on the card)")
    src = Path(__file__).resolve().parent / "cuda" / "sm90_check.cu"
    out = tmp_path_factory.mktemp("sm90") / "libsm90_check.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    fn = ctypes.CDLL(str(out)).bcfl_sm90_check
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("live", [64, 37])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_sm90_primitives_match_matmul_on_card(sm90_check, D, live, dtype):
    """``flash_sm90.cuh`` on one product of each form, in bf16 and fp16:
    the swizzled tile layout and its K-major and MN-major descriptors, the
    accumulator fragment packed to the dtype as a register A operand, and
    the zero-fill of the rows at or past ``live`` (the output starts as
    NaN, so a product that reads a stale row or skips an element
    fails)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(D + live)
    check = registry.parity_check(fk.F32_PARITY)
    code = fk._DTYPE_CODES[dtype]

    def draw(*shape):  # an operand in the dtype under test
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def zero_past_live(t):
        t = t.float().clone()
        t[live:] = 0.0
        return t

    a, b = draw(64, D), draw(64, D)
    c = torch.full((64, 64), float("nan"), device="cuda")
    assert sm90_check(0, D, code, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      live) == 0
    torch.cuda.synchronize()
    ok, err = check(c, a.float() @ zero_past_live(b).T)
    assert ok, f"S = Q K^T form: max |diff| {err}"

    p = torch.randn((64, 64), generator=gen, device="cuda")
    v = draw(64, D)
    c = torch.full((64, D), float("nan"), device="cuda")
    assert sm90_check(1, D, code, p.data_ptr(), v.data_ptr(), c.data_ptr(),
                      live) == 0
    torch.cuda.synchronize()
    ok, err = check(c, p.to(dtype).float() @ zero_past_live(v))
    assert ok, f"O += P V form: max |diff| {err}"
