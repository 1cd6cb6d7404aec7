#!/usr/bin/env python3
"""Where a fresh peer process's start-up goes, on the card.

    python3 scripts/peer_cold_start.py

Every peer of the dist paths of ``chip_smoke.py`` is a new interpreter,
and its first local round is the slowest. This script starts such a
process at path (m)'s width (biobert-base, 2 clients, ``int8+topk``) and
times, each interval ended by a synchronize: ``import torch``, the CUDA
context, a first bf16 matmul, the port's import, the config, the engine
build, then rounds 0-2, each split into its batches, its local
training and the exchange's encode. It runs one process alone, then five
at once (a dist phase's fleet on one card), each with
``OMP_NUM_THREADS=1`` as the phases give their peers, and prints one
``cold`` JSON line per process. The codec kernels and the corpus are
made first, as ``chip_smoke.py`` makes them before its paths.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tag: str, dataset: str) -> None:
    import numpy as np
    import torch

    t = {"import_torch": round(time.time() - T0, 3)}
    sys.path.insert(0, ROOT)

    def mark(name, t_prev):
        torch.cuda.synchronize()
        now = time.time()
        t[name] = round(now - t_prev, 3)
        return now

    now = time.time()
    torch.zeros(1, device="cuda")
    now = mark("cuda_context", now)
    a = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16)
    (a @ a).sum().item()
    now = mark("first_matmul", now)
    import chip_smoke
    from bcfl_tpu_torch.compression import codecs as cc
    from bcfl_tpu_torch.dist.runtime import _peer_engine_cfg
    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.fed.engine import FedEngine
    now = mark("import_port", now)
    cfg = chip_smoke.dist_config(dataset)
    now = mark("config", now)
    k = cfg.num_clients // cfg.dist.peers
    eng = FedEngine(_peer_engine_cfg(cfg, k), device="cuda",
                    client_ids=np.arange(k))
    eng.set_ef_residual(cc.zero_residual(eng.trainable0, k))
    now = mark("engine_build", now)
    try:
        for rnd in range(3):
            batches, _ = eng._round_batches(rnd)
            now = mark(f"r{rnd}_batches", now)
            base = cs.broadcast(eng.trainable0, k)
            post, _ = cs.local_updates(eng.local_train, base, batches,
                                       eng._generators(rnd), eng._rmask)
            now = mark(f"r{rnd}_train", now)
            eng._exchange_updates(rnd, post, base, None, mode="async",
                                  commit=False)
            now = mark(f"r{rnd}_encode", now)
    finally:
        print(f"cold {tag} {json.dumps(t)}", flush=True)


def main() -> int:
    if len(sys.argv) > 3 and sys.argv[1] == "child":
        child(sys.argv[2], sys.argv[3])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("peer_cold_start: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    # importing the kernel modules registers their ops for build_all
    from bcfl_tpu_torch.ops import codec_kernels, flash_kernels  # noqa: F401
    from bcfl_tpu_torch.ops import cuda_build

    print(f"nvcc s {json.dumps(cuda_build.build_all())}", flush=True)
    # the corpus is written once, before any child reads it
    dataset = chip_smoke.write_medical_docs()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    rc = 0
    for n in (1, 5):
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, __file__, "child",
                                   f"{n}x{i}", dataset], env=env)
                 for i in range(n)]
        rcs = [p.wait() for p in procs]
        rc |= any(rcs)
        print(f"cold batch of {n}: exit codes {rcs}, "
              f"{time.time() - t0:.1f} s", flush=True)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
