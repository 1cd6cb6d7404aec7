#!/usr/bin/env python3
"""A/B the round wall of ``chip_smoke.py``'s two main paths across checkouts
of the repository, on one GPU.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/round_ab.py change=. parent=build/parent --rounds 6

Each ``NAME=DIR`` names the root of a checkout (its own ``chip_smoke.py``
and ``bcfl_tpu_torch``). In the order A B ... B A, so that a drift of the
card or the host during the run falls on both sides, the script starts one
process per checkout that builds that checkout's kernels and drives its
``chip_smoke.main_config`` (seq 128, dense attention) and
``chip_smoke.flash_config`` (seq 512, flash attention, the long-document
corpus) through ``bcfl_tpu_torch.entrypoints.run`` for ``--rounds`` rounds
each, and prints every round's wall and the run's peak device memory
(``torch.cuda.max_memory_allocated``, reset before each path). Round 0
carries first-use costs; the summary gives the median of the later rounds
per checkout and path. Compare checkouts only within one run.
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
import json, sys
root, rounds = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import torch
import chip_smoke
from bcfl_tpu_torch.entrypoints import run
from bcfl_tpu_torch.ops import cuda_build
cuda_build.build_all()
dataset = chip_smoke.write_long_docs()
out, peak = {}, {}
for path, cfg in (("seq-128", chip_smoke.main_config(num_rounds=rounds)),
                  ("seq-512", chip_smoke.flash_config(dataset,
                                                      num_rounds=rounds))):
    torch.cuda.reset_peak_memory_stats()
    res = run(cfg, device="cuda")
    out[path] = [r.wall_s for r in res.metrics.rounds]
    peak[path] = torch.cuda.max_memory_allocated() / 1e9
    del res
    torch.cuda.empty_cache()
print("ROUNDS " + json.dumps(out), flush=True)
print("PEAK " + json.dumps(peak), flush=True)
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
        peaks = json.loads([ln for ln in proc.stdout.splitlines()
                             if ln.startswith("PEAK ")][0][len("PEAK "):])
        for path, ws in json.loads(line[0][len("ROUNDS "):]).items():
            walls[name].setdefault(path, []).extend(ws[1:])
            print(f"{name} {path} round walls (s): "
                  f"{' '.join(f'{w:.3f}' for w in ws)}; peak "
                  f"{peaks[path]:.2f} GB", flush=True)
    for name in names:
        for path, ws in walls[name].items():
            print(f"{name} {path}: median of rounds 1.. "
                  f"{statistics.median(ws):.3f} s over {len(ws)} rounds "
                  f"(min {min(ws):.3f}, max {max(ws):.3f})", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
