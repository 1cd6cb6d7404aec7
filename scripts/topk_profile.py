#!/usr/bin/env python3
"""Where the top-k kernel (K5, ``csrc/topk_select.cu``) spends its time at
bert-base's three large main-path calls, on one GPU.

    python3 scripts/topk_profile.py

For ``[96, 2359296]`` (the MLP leaves of 4 clients), ``[196, 589824]``
(the attention and pooler leaves) and ``[4, 23440896]`` (the word
embeddings), at k = 5% of the width, on Gaussian rows and on rows shaped
like a delta after two AdamW steps (three quarters of the row in a band
of magnitudes in [lr, 2 lr), the rest a weight-decay-only tail), the
script holds the kernel bit for bit to its plain version (it raises on a
difference), times the wrapper and ``torch.topk`` with CUDA events (5
launches after a warm-up), and lists the device time of each of the
call's kernels under ``torch.profiler`` (3 calls).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import nvidia_smi_line, time_ms  # noqa: E402
from bcfl_tpu_torch.ops import codec_kernels as ck  # noqa: E402
from bcfl_tpu_torch.ops import cuda_build  # noqa: E402

SHAPES = ((96, 2359296), (196, 589824), (4, 23440896))


def adamw_rows(gen, R: int, N: int) -> torch.Tensor:
    lr = 5e-5
    x = lr * (1 + torch.rand((R, N), generator=gen, device="cuda"))
    tail = N * 3 // 4
    x[:, tail:] = 1e-9 * torch.randn((R, N - tail), generator=gen,
                                     device="cuda")
    sign = torch.rand((R, N), generator=gen, device="cuda") < 0.5
    return torch.where(sign, -x, x)


def main() -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("topk_profile: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    cuda_build.build_all(["topk_select"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rows = {"gaussian": lambda R, N: torch.randn((R, N), generator=gen,
                                                  device="cuda"),
            "adamw": lambda R, N: adamw_rows(gen, R, N)}
    for label, make in rows.items():
        for R, N in SHAPES:
            x = make(R, N)
            k = -(-N * 5 // 100)
            v, i = ck.TOPK_SELECT(x, k=k)
            v_ref, i_ref = ck.topk_select_ref(x, k=k)
            if not (torch.equal(i, i_ref) and torch.equal(
                    v.view(torch.int32), v_ref.view(torch.int32))):
                raise RuntimeError(f"topk_select differs from its plain "
                                   f"version at {label} [{R}, {N}]")
            a = x.abs()
            ms = time_ms(lambda: ck.TOPK_SELECT(x, k=k), 5)
            lib = time_ms(lambda: torch.topk(a, k, dim=1), 5)
            print(f"{label} [{R},{N}] k={k}: identical, kernel {ms:.4f} ms, "
                  f"torch.topk {lib:.4f} ms", flush=True)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    ck.TOPK_SELECT(x, k=k)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            for e in sorted(events, key=lambda e: -e.self_device_time_total):
                name = e.key.replace("(anonymous namespace)::", "")
                print(f"  {e.self_device_time_total / 3e3:8.4f} ms/call "
                      f"x{e.count // 3:<2d} {name.split('(')[0]}", flush=True)
            del x, a, v, i, v_ref, i_ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
