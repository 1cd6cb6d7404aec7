#!/usr/bin/env python3
"""A/B the round wall of ``chip_smoke.py``'s two main paths and of its
remat paths across checkouts of the repository, on one GPU.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/round_ab.py change=. parent=build/parent --rounds 6

Each ``NAME=DIR`` names the root of a checkout (its own ``chip_smoke.py``
and ``bcfl_tpu_torch``). In the order A B ... B A, so that a drift of the
card or the host during the run falls on both sides, the script starts one
process per checkout that builds that checkout's kernels and drives,
through ``bcfl_tpu_torch.entrypoints.run``, for ``--rounds`` rounds each:
``chip_smoke.main_config`` (seq 128, dense attention),
``chip_smoke.flash_config`` (seq 512, flash attention, the long-document
corpus), ``chip_smoke.lowp_config`` (path (g): the seq-512 path with
remat, bf16 parameters and SGD), and ``chip_smoke.llama_config`` with
LoRA rank 8 (llama2-7b at full width and depth, remat, flash), on one
card and at ``tp=2`` on ``[cuda:0] * 2`` (path (v)'s split). It prints
every round's wall, the run's peak device memory
(``torch.cuda.max_memory_allocated``, reset before each path) and a
SHA-256 of the final trainable tree's bytes, and says per path whether
every run's digest is the same. Round 0 carries first-use costs; the
summary gives the median of the later rounds per checkout and path.
Compare checkouts only within one run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# runs inside one checkout: argv = [root, rounds]
CHILD = r"""
import hashlib, json, sys
root, rounds = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import torch
import chip_smoke
from bcfl_tpu_torch.entrypoints import run
from bcfl_tpu_torch.ops import cuda_build
cuda_build.build_all()
dataset = chip_smoke.write_long_docs()
one, two = [torch.device("cuda", 0)], [torch.device("cuda", 0)] * 2
llama = dict(lora_rank=8, num_rounds=rounds)
out, peak, digest = {}, {}, {}
for path, cfg, devices in (
        ("seq-128", chip_smoke.main_config(num_rounds=rounds), one),
        ("seq-512", chip_smoke.flash_config(dataset, num_rounds=rounds), one),
        ("seq-512-remat", chip_smoke.lowp_config(dataset).replace(
            num_rounds=rounds), one),
        ("llama2-7b-remat", chip_smoke.llama_config(dataset, **llama), one),
        ("llama2-7b-remat-tp2", chip_smoke.llama_config(dataset, tp=2,
                                                        **llama), two)):
    torch.cuda.reset_peak_memory_stats()
    res = run(cfg, devices=devices)
    out[path] = [r.wall_s for r in res.metrics.rounds]
    peak[path] = torch.cuda.max_memory_allocated() / 1e9
    h = hashlib.sha256()
    for name in sorted(res.trainable):
        h.update(res.trainable[name].detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes())
    digest[path] = h.hexdigest()[:16]
    del res
    torch.cuda.empty_cache()
print("ROUNDS " + json.dumps(out), flush=True)
print("PEAK " + json.dumps(peak), flush=True)
print("DIGEST " + json.dumps(digest), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("copies", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    copies = dict(c.split("=", 1) for c in args.copies)
    names = list(copies)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    walls = {name: {} for name in names}
    digests: dict = {}
    for name in names + names[::-1]:
        root = str(Path(copies[name]).resolve())
        proc = subprocess.run([sys.executable, "-c", CHILD, root,
                               str(args.rounds)], cwd=root,
                              capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("ROUNDS ")]
        if proc.returncode != 0 or not line:
            raise RuntimeError(f"{name} failed (exit {proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        peaks, digest = (json.loads([
            ln for ln in proc.stdout.splitlines()
            if ln.startswith(key)][0][len(key):])
            for key in ("PEAK ", "DIGEST "))
        for path, ws in json.loads(line[0][len("ROUNDS "):]).items():
            walls[name].setdefault(path, []).extend(ws[1:])
            digests.setdefault(path, set()).add(digest[path])
            print(f"{name} {path} round walls (s): "
                  f"{' '.join(f'{w:.3f}' for w in ws)}; peak "
                  f"{peaks[path]:.2f} GB; trainable {digest[path]}",
                  flush=True)
    for name in names:
        for path, ws in walls[name].items():
            print(f"{name} {path}: median of rounds 1.. "
                  f"{statistics.median(ws):.3f} s over {len(ws)} rounds "
                  f"(min {min(ws):.3f}, max {max(ws):.3f})", flush=True)
    for path, seen in digests.items():
        print(f"{path}: trainable bits "
              f"{'the same in every run' if len(seen) == 1 else 'DIFFER'} "
              f"({' '.join(sorted(seen))})", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
