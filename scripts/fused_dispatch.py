#!/usr/bin/env python3
"""Where the fused multi-round dispatch's time goes, on one GPU.

    python3 scripts/fused_dispatch.py --rounds 8 --k 2

Runs ``chip_smoke.fused_config`` (path (b) with the ledger: bert-base at
full width and depth, 4 clients, 32 x 512 tokens with flash,
``int8+topk``) for ``--rounds`` rounds, evaluation every ``--k``, on
``cuda:0``, per round (P) and in chunks of ``--k`` rounds (F), in the
order P F F P so that a drift of the card falls on both sides. For every
run it prints:

- each round's wall (a fused round's is its chunk's wall split evenly,
  so it prints the chunk's), and the median over the later chunks;
- the peak device memory above what was allocated when the run started,
  and a SHA-256 of the final global tree;
- the synchronizing CUDA calls by source line (torch's sync debug mode,
  ``chip_smoke.syncs_inside``) inside ``FedEngine._server_round`` (P) or
  ``FedEngine._server_chunk`` (F: the chunk's issue, before its one
  read-back);
- per round, the host's seconds to issue the round (P:
  ``_server_round``, which waits for its read-backs; F: the stretch of
  the chunk's issue from one round's inputs to the next's) beside the
  card's seconds between CUDA events recorded at the same two points (a
  card span longer than the host's means the card was behind);
- the caching allocator's ``cudaMalloc`` and ``cudaFree`` calls and
  allocation retries during the run (``torch.cuda.memory_stats``), and
  the seconds the interpreter's cyclic garbage collector ran.

Compare P and F only within one run of the script.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class Spans:
    """Each round's host issue seconds and the card's milliseconds between
    events recorded where the round's issue starts and ends."""

    def __init__(self):
        self.rows = []

    def start(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return time.perf_counter(), e

    def end(self, mark):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.rows.append((time.perf_counter() - mark[0], mark[1], e))

    def read(self):
        torch.cuda.synchronize()
        return [(host, a.elapsed_time(b) / 1e3) for host, a, b in self.rows]


@contextlib.contextmanager
def spanned(spans: Spans):
    """Round spans: around ``_server_round``, and between a chunk's
    ``RoundIn``s (drawn lazily by ``_chunk_inputs`` as the chunk issues)."""
    from bcfl_tpu_torch.fed.engine import FedEngine

    server_round, chunk_inputs = (FedEngine._server_round,
                                  FedEngine._chunk_inputs)

    @functools.wraps(server_round)
    def one(self, *args, **kwargs):
        mark = spans.start()
        out = server_round(self, *args, **kwargs)
        spans.end(mark)
        return out

    @functools.wraps(chunk_inputs)
    def inputs(self, rnd, k):
        it = chunk_inputs(self, rnd, k)
        while True:
            mark = spans.start()
            try:
                rin = next(it)
            except StopIteration:
                return
            yield rin  # the chunk issues the round, then asks for the next
            spans.end(mark)

    FedEngine._server_round, FedEngine._chunk_inputs = one, inputs
    try:
        yield spans
    finally:
        FedEngine._server_round, FedEngine._chunk_inputs = (server_round,
                                                            chunk_inputs)


ALLOCATOR = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def one_run(cfg, label):
    import chip_smoke
    from bcfl_tpu_torch.fed.engine import FedEngine

    method = ("_server_chunk" if cfg.rounds_per_dispatch > 1
              else "_server_round")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    before = torch.cuda.memory_stats()
    collect = {"s": 0.0, "n": 0}

    def timer(phase, info):
        if phase == "start":
            collect["t0"] = time.perf_counter()
        else:
            collect["s"] += time.perf_counter() - collect["t0"]
            collect["n"] += 1

    gc.callbacks.append(timer)
    try:
        with chip_smoke.syncs_inside({method: {}}) as syncs, \
                spanned(Spans()) as spans:
            res = FedEngine(cfg, device="cuda").run()
    finally:
        gc.callbacks.remove(timer)
    after = torch.cuda.memory_stats()
    allocator = {k: after.get(k, 0) - before.get(k, 0) for k in ALLOCATOR}
    peak = (torch.cuda.max_memory_allocated() - start) / 1e9
    digest = hashlib.sha256(b"".join(
        x.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
        for _, x in sorted(res.trainable.items()))).hexdigest()[:16]
    walls = [r.wall_chunk_s if r.fused else r.wall_s
             for r in res.metrics.rounds]
    return {"label": label, "walls": walls, "peak_above_start_gb": peak,
            "digest": digest, "syncs": syncs[method],
            "spans": spans.read(), "allocator": allocator,
            "gc": (collect["n"], collect["s"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--k", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_dispatch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from bcfl_tpu_torch.ops import codec_kernels, cuda_build  # noqa: F401
    from bcfl_tpu_torch.ops import flash_kernels  # noqa: F401

    smi = chip_smoke.nvidia_smi_line()
    print(smi, f"torch {torch.__version__}", flush=True)
    cuda_build.build_all()
    dataset = chip_smoke.write_long_docs()
    cfg = chip_smoke.fused_config(dataset, num_rounds=args.rounds,
                                  eval_every=args.k)
    # warm the card and the allocator on the path first
    chip_smoke.drive(chip_smoke.flash_config(dataset), smi, "warm-up (b)")
    torch.cuda.empty_cache()
    runs = []
    for label in ("P", "F", "F", "P"):
        c = cfg.replace(rounds_per_dispatch=args.k if label == "F" else 1)
        out = one_run(c, label)
        runs.append(out)
        torch.cuda.empty_cache()
        print(f"{label}: walls {[round(w, 4) for w in out['walls']]} s, "
              f"peak above start {out['peak_above_start_gb']:.3f} GB, "
              f"digest {out['digest']}, "
              f"{sum(out['syncs'].values())} synchronizing calls inside "
              f"the rounds or chunks' issue {json.dumps(out['syncs'])} "
              f"({smi})", flush=True)
        print(f"  {label} allocator {out['allocator']}, garbage collector "
              f"{out['gc'][0]} passes {out['gc'][1]:.4f} s", flush=True)
        print(f"  {label} per round, host issue s / card s between its "
              f"marks: " + ", ".join(f"{h:.4f}/{d:.4f}"
                                     for h, d in out["spans"]), flush=True)
    k = args.k
    for label in ("P", "F"):
        mine = [r for r in runs if r["label"] == label]
        if label == "P":
            later = [sum(r["walls"][a:a + k])
                     for r in mine for a in range(k, args.rounds, k)]
        else:
            later = [r["walls"][a] for r in mine
                     for a in range(k, args.rounds, k)]
        print(f"{label}: median wall of {k} rounds after the first chunk "
              f"{statistics.median(later):.4f} s over {later}", flush=True)
    same = len({r["digest"] for r in runs}) == 1
    print(f"final global trees {'equal' if same else 'DIFFER'} across the "
          f"four runs", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
