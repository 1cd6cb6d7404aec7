#!/usr/bin/env python3
"""A/B the bf16 flash-attention kernels K1 (``flash_fwd``), K2
(``flash_bwd_dkv``) and K3 (``flash_bwd_dq``) of several copies of their
CUDA sources on one GPU.

    python3 scripts/flash_ab.py                       # the package's sources
    python3 scripts/flash_ab.py new=bcfl_tpu_torch/csrc old=build/old/csrc

Each ``NAME=DIR`` names a directory holding ``flash_fwd.cu``,
``flash_bwd_dkv.cu``, ``flash_bwd_dq.cu`` and the headers they include (a
copy of ``bcfl_tpu_torch/csrc``, edited). The script builds the three
sources of every copy at once, with the flags of
``bcfl_tpu_torch.ops.cuda_build``, into ``build/flash_ab/NAME/``, and
prints ptxas's registers and spills of each instance. It then holds
every copy's kernels to the plain PyTorch versions at the op's bf16
contract on a ragged, a suffix-causal, a D = 128 and a D = 32 case (it
raises on any difference past it), and times K1, K2 and K3 with CUDA
events at bert-base's seq-512 call ``[32, 12, 512, 64]`` and at the
``llama-decode-B1-S2048`` causal row, the copies in the order A B ... B
A, so that a drift of the card's clock during the run falls on both
sides. Compare copies only within one run.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (flash_inputs, nvidia_smi_line,  # noqa: E402
                        ptxas_notes, time_ms)
from bcfl_tpu_torch.ops import cuda_build, registry  # noqa: E402
from bcfl_tpu_torch.ops import flash_kernels as fk  # noqa: E402

SOURCES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
#: device pointers of each C entry
N_PTRS = {"flash_fwd": 6, "flash_bwd_dkv": 10, "flash_bwd_dq": 8}
#: (label, B, H, Sq, Sk, D, causal, padded key lengths, timed)
CASES = (
    ("ragged", 2, 3, 300, 300, 64, False, (300, 211), False),
    ("suffix-causal", 1, 2, 200, 333, 64, True, None, False),
    ("head-dim-128", 2, 2, 130, 130, 128, False, (130, 50), False),
    ("head-dim-32", 2, 2, 130, 130, 32, True, None, False),
    ("seq-512", 32, 12, 512, 512, 64, False, None, True),
    ("llama-decode", 1, 8, 2048, 2048, 64, True, None, True),
)


def build(copies):
    """``{(name, source): C entry}``, every source built at once."""
    jobs = {}
    for name, src_dir in copies.items():
        out_dir = REPO / "build" / "flash_ab" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            out = out_dir / f"lib{src}.so"
            cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                   str(out), str(Path(src_dir) / f"{src}.cu")]
            jobs[(name, src)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    entries = {}
    for (name, src), (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{src}.cu:\n{log}")
        for line in ptxas_notes({src: log}):
            print(f"{name}: {line}", flush=True)
        fn = getattr(ctypes.CDLL(str(out)), f"bcfl_{src}")
        n_ptrs = N_PTRS[src]
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[(name, src)] = fn
    return entries


def run_case(entries, names, label, B, H, Sq, Sk, D, causal, lens, timed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(Sq + Sk + D)
    q, k, v, do, bias = flash_inputs(gen, B, H, Sq, Sk, D, torch.bfloat16,
                                     lens)
    out_ref, lse_ref = fk.flash_fwd_ref(q, k, v, bias, causal)
    want = fk.flash_bwd_dkv_ref(q, k, v, bias, out_ref, do, lse_ref, causal)
    want += (fk.flash_bwd_dq_ref(q, k, v, bias, out_ref, do, lse_ref,
                                 causal),)
    out = torch.empty((B, H, Sq, D), dtype=torch.bfloat16, device="cuda")
    lse = torch.empty((B, H, Sq), device="cuda")
    dk = torch.empty((B, H, Sk, D), dtype=torch.bfloat16, device="cuda")
    dv, db = torch.empty_like(dk), torch.empty((B, H, Sk), device="cuda")
    dq = torch.empty((B, H, Sq, D), dtype=torch.bfloat16, device="cuda")
    fwd_strides = fk._strides(q, k, v)
    bwd_strides = fk._strides(q, k, v, out_ref, do)
    stream = torch.cuda.current_stream().cuda_stream
    check = registry.parity_check(fk.BF16_PARITY)
    calls = {}
    bf16 = fk._DTYPE_CODES[torch.bfloat16]  # the C entries' dtype code
    for name in names:
        f1 = entries[(name, "flash_fwd")]
        f2 = entries[(name, "flash_bwd_dkv")]
        f3 = entries[(name, "flash_bwd_dq")]
        calls[name] = (
            lambda f1=f1: cuda_build.check(f1(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D, bf16,
                fwd_strides, fk._scale(D), int(causal), stream), "K1"),
            lambda f2=f2: cuda_build.check(f2(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out_ref.data_ptr(), do.data_ptr(), lse_ref.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), db.data_ptr(), B, H, Sq, Sk, D,
                bf16, bwd_strides, fk._scale(D), int(causal), stream), "K2"),
            lambda f3=f3: cuda_build.check(f3(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out_ref.data_ptr(), do.data_ptr(), lse_ref.data_ptr(),
                dq.data_ptr(), B, H, Sq, Sk, D, bf16, bwd_strides,
                fk._scale(D), int(causal), stream), "K3"))
        for call in calls[name]:
            call()
        torch.cuda.synchronize()
        res = [check(out, out_ref), check(lse, lse_ref)] + [
            check(a, b) for a, b in zip((dk, dv, db, dq), want)]
        print(f"{label} {name}: max |diff| out, lse, dk, dv, db_h, dq "
              f"{[f'{err:.2e}' for _, err in res]}", flush=True)
        if not all(ok for ok, _ in res):
            raise RuntimeError(f"{name} differs from the plain versions past "
                               f"{fk.BF16_PARITY} at {label}")
    if not timed:
        return
    times = {name: ([], [], []) for name in names}
    for name in list(names) + list(names)[::-1]:
        for i in (0, 1, 2):
            times[name][i].append(time_ms(calls[name][i], 30))
    for name in names:
        print(f"{label} [{B},{H},{Sq},{Sk},{D}] {name}: " + ", ".join(
            f"K{i + 1} {' / '.join(f'{t:.4f}' for t in ts)} ms"
            for i, ts in enumerate(times[name])), flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    copies = dict(a.split("=", 1) for a in argv) or {
        "tree": str(cuda_build.CSRC_DIR)}
    print(nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    entries = build(copies)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for case in CASES:
        run_case(entries, list(copies), *case)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
