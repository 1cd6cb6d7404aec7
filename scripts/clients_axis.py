#!/usr/bin/env python3
"""The clients axis across cards: path (b)'s round wall on one card and on
several (card only).

    python3 scripts/clients_axis.py

Runs ``chip_smoke.py``'s path (b) configuration (bert-base, 4 clients,
2 local steps of 32 x 512 tokens of long documents, flash attention, bf16,
``int8+topk``, server FedAvg) with the ledger on, ``ROUNDS`` rounds,
through ``bcfl_tpu_torch.entrypoints.run``:

1. on ``[cuda:0]`` against ``[cuda:0] * 4`` (4 client shards sharing one
   card), then
2. on ``[cuda:0]`` against ``[cuda:0, ..., cuda:N-1]`` for each ``N``
   of ``CARDS`` the host has (4 clients on 2 cards: 2 shards of 2; on
   4 cards: 4 shards of 1; with none, it says so and stops after 1),
3. then path (c) (biobert-base, 10 clients, serverless gossip) on
   ``[cuda:0]`` against the largest ``N`` cards (4 cards: 2 shards of 5),
   and path (k)'s model (llama2-7b, LoRA rank 8, 4 of 64 clients a round)
   with its cohort spread over them (4 cards: 4 shards of 1), the
   GPU-bound cell beside the host-bound BERT ones,
4. then :func:`thread_probe`: small tensor ops a second from 1, 2 and 4
   host threads, on the CPU and on card 0 (why the shards are issued from
   one thread).

Each pair must agree bit for bit (``chip_smoke.clients_axis_pair``: global
tree, payload bytes, ledger head, per-client stats, kernel launches). It
prints each run's round walls, the peak memory of every card it used and,
per round, the seconds of training (``train_clients`` or
``local_updates`` fenced with ``torch.cuda.synchronize()`` on every card:
the fences cost a little and are in both runs of a pair) against the rest
of the round, and each client's local train's host seconds (what issuing
its work took), then one JSON line with all of it, beside
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ROUNDS = 4
CARDS = (2, 4)


def fenced_training(times: list, bodies: list):
    """Wrap the round bodies' training calls so each records its seconds
    between two synchronizations of every card, and each client's local
    train its host seconds (unfenced: what its thread spent issuing the
    client's work)."""
    from bcfl_tpu_torch.fed import client_step as cs

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    def wrap(fn):
        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            times.append(time.perf_counter() - t0)
            return out
        return timed

    saved = cs.train_clients, cs.local_updates, cs.make_local_train
    cs.train_clients, cs.local_updates = (wrap(f) for f in saved[:2])

    def timed_bodies(*args, **kwargs):
        body = saved[2](*args, **kwargs)

        def run(*a, **k):
            t0 = time.perf_counter()
            out = body(*a, **k)
            bodies.append(time.perf_counter() - t0)
            return out
        return run

    cs.make_local_train = timed_bodies
    return saved


def pair(chip_smoke, cfg, smi, label, devices) -> dict:
    from bcfl_tpu_torch.fed import client_step as cs

    times: list = []
    bodies: list = []
    saved = fenced_training(times, bodies)
    try:
        out = chip_smoke.clients_axis_pair(cfg, smi, label, devices)
    finally:
        cs.train_clients, cs.local_updates, cs.make_local_train = saved
    rounds, C = cfg.num_rounds, cfg.num_clients
    rec = {}
    for i, key in enumerate(("one", "many")):
        launches, walls, peaks = out[key]
        train = times[i * rounds:(i + 1) * rounds]
        host = bodies[i * rounds * C:(i + 1) * rounds * C]
        rec[key] = {"round_wall_s": walls, "train_s": train,
                    "rest_s": [w - t for w, t in zip(walls, train)],
                    "client_host_s": [host[r * C:(r + 1) * C]
                                      for r in range(rounds)],
                    "peak_gb": peaks, "launches": launches}
    rec["devices"] = [str(d) for d in devices]
    rec["cards"] = len({str(d) for d in devices})
    print(f"{label}: {json.dumps(rec)}", flush=True)
    return rec


def thread_probe(device: str, threads: int, ops: int = 20000) -> float:
    """Tensor ops a second, summed over ``threads`` threads, each adding 1
    to its own one-element tensor on ``device`` ``ops`` times: what the
    interpreter's lock and the dispatcher leave of several threads issuing
    small ops (no thread waits on the device: launches are asynchronous
    and each thread syncs once, at its end)."""
    import threading

    def work():
        x = torch.zeros(1, device=device)
        for _ in range(ops):
            x = x + 1
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    workers = [threading.Thread(target=work) for _ in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    return threads * ops / (time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("clients_axis: no CUDA device", file=sys.stderr)
        return 2
    for var in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE"):
        os.environ.setdefault(var, "1")
    import chip_smoke
    from bcfl_tpu_torch.config import LedgerConfig
    from bcfl_tpu_torch.ops import codec_kernels  # noqa: F401
    from bcfl_tpu_torch.ops import cuda_build
    from bcfl_tpu_torch.ops import flash_kernels  # noqa: F401

    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    cuda_build.build_all()
    n = torch.cuda.device_count()
    lead = torch.device("cuda", 0)
    dataset = chip_smoke.write_long_docs()
    b_cfg = chip_smoke.flash_config(dataset, ledger=LedgerConfig(enabled=True),
                                    num_rounds=ROUNDS)
    out = {"smi": smi, "cards_visible": n}
    out["b_one_card_4_shards"] = pair(chip_smoke, b_cfg, smi,
                                      "(b) on [cuda:0] * 4", [lead] * 4)
    counts = [k for k in CARDS if k <= n]
    if not counts:
        print(f"clients_axis: {n} card(s) visible, {CARDS} wanted: "
              "no run across cards", flush=True)
    for k in counts:
        cards = [torch.device("cuda", i) for i in range(k)]
        out[f"b_{k}_cards"] = pair(chip_smoke, b_cfg, smi,
                                   f"(b) on {k} cards", cards)
    if counts:
        k = max(counts)
        cards = [torch.device("cuda", i) for i in range(k)]
        c_cfg = chip_smoke.gossip_config(chip_smoke.write_medical_docs(),
                                         num_rounds=ROUNDS)
        out[f"c_{k}_cards"] = pair(chip_smoke, c_cfg, smi,
                                   f"(c) on {k} cards", cards)
        # (k)'s model, its cohort spread over the cards (cohort_size 0)
        k_cfg = chip_smoke.llama_config(
            dataset, name="clients-axis-llama2-7b-lora-cohort",
            lora_rank=8, registry_size=64, sample_clients=4,
            num_rounds=ROUNDS, ledger=LedgerConfig(enabled=True))
        out[f"k_{k}_cards"] = pair(chip_smoke, k_cfg, smi,
                                   f"(k) cohort on {k} cards", cards)
    for dev in ("cpu", "cuda:0"):
        thread_probe(dev, 1, 2000)  # warm up
        out[f"thread_probe_{dev}"] = {str(t): thread_probe(dev, t)
                                      for t in (1, 2, 4)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
