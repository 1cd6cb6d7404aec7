#!/usr/bin/env python3
"""How much of each 16-bit flash contract the backward kernels K2
(``flash_bwd_dkv``) and K3 (``flash_bwd_dq``) use on rows whose keys are
all padded, over many draws, on one GPU.

    python3 scripts/flash_contract.py            # 20 draws per case
    python3 scripts/flash_contract.py --draws 50

On such a row every score is the padding bias (-1e9, whose float32 ulp is
64), so s - lse rounds to 0 and p = 1 on every key: ds = dO . v - Dsum is
as large as dO . v, and the rounding of ds to the inputs' dtype before
``ds k`` and ``ds^T q`` weighs as much as the outputs themselves. For
bf16 and fp16 at head dims 64, 32 (causal) and 128, on ``[2, 12, 256,
256, D]`` with batch row 1 all padded, the script prints per output (dk,
dv, db_h, dq) the absolute term the kernel needed against its plain
version at the dtype contract's relative term (the largest
``|got - want| - rtol |want|``), beside the contract's own absolute term;
and, on one draw, how many entries of ds round differently from a
float32 and a float64 evaluation of dO . v (the flips that the kernel's
summation order can produce as well). Prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import dtype_name, flash_inputs, nvidia_smi_line  # noqa: E402
from bcfl_tpu_torch.ops import cuda_build  # noqa: E402
from bcfl_tpu_torch.ops import flash_kernels as fk  # noqa: E402

#: (head dim, causal)
SHAPES = ((64, False), (32, True), (128, False))
OUTPUTS = ("dk", "dv", "db_h", "dq")


def contract(dtype):
    """``(atol, rtol)`` of the dtype's flash contract."""
    atol, rtol = re.match(r"allclose:atol=([0-9.e+-]+),rtol=([0-9.e+-]+)$",
                          fk.parity_for(dtype)).groups()
    return float(atol), float(rtol)


def needed(dtype, D, causal, draws):
    """Per output, the largest absolute term the kernels needed over
    ``draws`` draws at the contract's relative term."""
    _, rtol = contract(dtype)
    gen = torch.Generator(device="cuda")
    worst = dict.fromkeys(OUTPUTS, float("-inf"))
    for seed in range(draws):
        gen.manual_seed(seed)
        q, k, v, do, bias = flash_inputs(gen, 2, 12, 256, 256, D, dtype,
                                         (256, 0))
        out, lse = fk.flash_fwd_ref(q, k, v, bias, causal)
        args = (q, k, v, bias, out, do, lse, causal)
        got = fk.FLASH_BWD_DKV(*args) + (fk.FLASH_BWD_DQ(*args),)
        want = fk.flash_bwd_dkv_ref(*args) + (fk.flash_bwd_dq_ref(*args),)
        for name, g, w in zip(OUTPUTS, got, want):
            g, w = g.double(), w.double()
            worst[name] = max(worst[name], float(
                ((g - w).abs() - rtol * w.abs()).max()))
    return worst


def ds_flips(dtype):
    """Entries of the all-padded row's ds that round to another value of
    ``dtype`` from a float32 than from a float64 dO . v, and their count."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v, do, bias = flash_inputs(gen, 2, 12, 256, 256, 64, dtype,
                                     (256, 0))
    out, lse = fk.flash_fwd_ref(q, k, v, bias, False)
    dsum = (do.double() * out.double()).sum(-1, keepdim=True)
    dp32 = torch.matmul(do.float(), v.float().transpose(-1, -2)).double()
    dp64 = do.double() @ v.double().transpose(-1, -2)
    flips = ((dp32 - dsum).to(dtype) != (dp64 - dsum).to(dtype))[1]
    return int(flips.sum()), flips.numel()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_contract: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    cuda_build.build_all(("flash_bwd_dkv", "flash_bwd_dq"))
    for dtype in (torch.float16, torch.bfloat16):
        atol, rtol = contract(dtype)
        n, total = ds_flips(dtype)
        print(f"{dtype_name(dtype)}: all-padded row's ds, {n} of {total} "
              "entries round apart from float32 and float64 dO . v",
              flush=True)
        for D, causal in SHAPES:
            worst = needed(dtype, D, causal, args.draws)
            print(f"{dtype_name(dtype)} D={D} causal={int(causal)}, "
                  f"{args.draws} draws: absolute term needed at rtol "
                  f"{rtol:g} (contract {atol:g}): "
                  + ", ".join(f"{n} {x:.5f}" for n, x in worst.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
