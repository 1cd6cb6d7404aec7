#!/usr/bin/env python3
"""The clients axis across cards: path (b)'s round wall on one card and on
several (card only).

    python3 scripts/clients_axis.py

On a host with four or more cards it first runs the ``tp`` leg, path
(v)'s configuration (llama2-7b at full width and depth, LoRA rank 8,
``tp=2``, 4 clients, ``ROUNDS`` rounds) on ``[cuda:0, ..., cuda:3]``, a
``(clients, tp)`` mesh of 2 rows (row 1 on cards 2 and 3, with its own
split of the frozen base), against ``[cuda:0, cuda:1]``, one row: bits,
round walls, the peak memory of every card.

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
4. then, with more than one card, K4 and K5 on every card but 0 held bit
   for bit to their plain versions at (b)'s calls of one shard's rows
   (``chip_smoke.codec_on_each_card``),
5. then :func:`profile_split`: one warm round of (b) on one card and on
   the largest ``N`` cards under ``torch.profiler``, each split into the host's stages (staging,
   issuing the shards' training and codec, landing, the receiver, the
   mean) and each card's device time by kind (flash, codec, copies, the
   rest) against the round's wall,
6. then :func:`thread_probe`: small tensor ops a second from 1, 2 and 4
   host threads, on the CPU and on card 0 (why the shards are issued from
   one thread).

Each pair must agree bit for bit (``chip_smoke.clients_axis_pair``: global
tree, payload bytes, ledger head, per-client stats, K1-K3 launches equal
and K4, K5 once per shard). It prints each run's round walls, the peak
memory of every card it used, each round's bytes between the lead shard
and the others (the round's and its evaluation's) and, per round, the
seconds of training with each shard's codec stage and landing
(``train_clients`` or ``local_updates`` fenced with
``torch.cuda.synchronize()`` on every card: the fences cost a little and
are in both runs of a pair) against the rest of the round, and each
client's local train's host seconds (what issuing its work took), then
one JSON line with all of it, beside ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``.
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


def pair(chip_smoke, cfg, smi, label, devices, one=None) -> dict:
    from bcfl_tpu_torch.fed import client_step as cs

    times: list = []
    bodies: list = []
    saved = fenced_training(times, bodies)
    try:
        out = chip_smoke.clients_axis_pair(cfg, smi, label, devices, one=one)
    finally:
        cs.train_clients, cs.local_updates, cs.make_local_train = saved
    rounds, C = cfg.num_rounds, cfg.num_clients
    rec = {"shards": out["shards"]}
    for i, key in enumerate(("one", "many")):
        launches, walls, peaks, moved = out[key]
        train = times[i * rounds:(i + 1) * rounds]
        host = bodies[i * rounds * C:(i + 1) * rounds * C]
        rec[key] = {"round_wall_s": walls, "train_s": train,
                    "rest_s": [w - t for w, t in zip(walls, train)],
                    "client_host_s": [host[r * C:(r + 1) * C]
                                      for r in range(rounds)],
                    "peak_gb": peaks, "launches": launches,
                    "bytes_between_shards": moved}
    rec["devices"] = [str(d) for d in devices]
    rec["one_devices"] = [str(d) for d in one or [torch.device("cuda", 0)]]
    rec["cards"] = len({str(d) for d in devices})
    print(f"{label}: {json.dumps(rec)}", flush=True)
    chip_smoke.print_clients_axis(label, out, smi)
    return rec, out["template"]


#: K4's and K5's kernels (``csrc/int8_quantize.cu``, ``csrc/topk_select.cu``)
CODEC_KERNELS = ("int8_quantize_kernel", "hist_row_kernel", "select_kernel",
                 "compact_kernel", "hist_cand_kernel", "sort_count_kernel",
                 "sort_scan_kernel", "sort_scatter_kernel")


def _kind(name: str) -> str:
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if "flash" in name:
        return "flash"
    if any(k in name for k in CODEC_KERNELS):
        return "codec"
    return "rest"


def profile_split(cfg, devices, label) -> dict:
    """One warm round (the third) of ``cfg`` on ``devices`` under
    ``torch.profiler``, evaluation off: the host seconds of each stage
    (``stage``: the lead's copies to the shards; ``issue``: every shard's
    training and codec stage issued, ``run_sharded``; ``codec``: the
    shards' ``compress_stage``, inside ``issue``; ``land``: rows, stats
    and payload landing on the lead; ``receiver``: transport, ledger and
    decode, ``_exchange_updates``; ``aggregate``: the mean) and each
    card's device milliseconds by kind (``flash``, ``codec``, ``copies``
    between cards or within one, ``rest``: the GEMMs and elementwise
    passes of training, the codec's elementwise passes and the mean),
    against the round's host wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.fed.engine import FedEngine

    spans = {"stage": (cs.Sharded, "stage"), "land": (cs.Sharded, "land"),
             "issue": (cs, "run_sharded"), "codec": (cs, "compress_stage"),
             "land_payload": (cs.Sender, "gather"),
             "receiver": (FedEngine, "_exchange_updates"),
             "aggregate": (cs, "collapse")}

    def spanned(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    saved = {name: getattr(owner, attr)
             for name, (owner, attr) in spans.items()}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    def on_round(rec):
        if rec.round == 1:
            sync()
            prof.__enter__()
        elif rec.round == 2:
            sync()
            prof.__exit__(None, None, None)
            window["wall_s"] = rec.wall_s

    for name, (owner, attr) in spans.items():
        setattr(owner, attr, spanned(name, saved[name]))
    try:
        eng = FedEngine(cfg.replace(num_rounds=3, eval_every=0),
                        devices=devices)
        eng.run(on_round=on_round)
    finally:
        for name, (owner, attr) in spans.items():
            setattr(owner, attr, saved[name])
    host, cards = {}, {}
    events = prof.events()
    # a host range's mirror on the device spans the kernels launched
    # inside it: left out, or their time counts twice
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in spans:
            h = host.setdefault(e.name, {"ms": 0.0, "calls": 0})
            h["ms"] += e.cpu_time_total / 1e3
            h["calls"] += 1
        elif (e.device_type == DeviceType.CUDA
              and e.name not in host_names):
            c = cards.setdefault(f"cuda:{e.device_index}", {})
            kind = _kind(e.name)
            c[kind] = c.get(kind, 0.0) + e.self_device_time_total / 1e3
    wall_ms = window["wall_s"] * 1e3
    for c in cards.values():
        c["busy"] = sum(c.values())
        c["idle_share"] = 1.0 - c["busy"] / wall_ms
    out = {"round_wall_ms": wall_ms, "host_ms": host, "device_ms": cards}
    print(f"{label} profiled round: {json.dumps(out)}", flush=True)
    return out


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
    from bcfl_tpu_torch.ops import codec_kernels
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
    if n >= 4:
        cards = [torch.device("cuda", i) for i in range(4)]
        tp_cfg = chip_smoke.tp_config(dataset).replace(num_rounds=ROUNDS)
        out["tp_4_cards"], _ = pair(chip_smoke, tp_cfg, smi,
                                    "(v) on 4 cards, 2 rows of tp=2", cards,
                                    one=cards[:2])
    else:
        print(f"clients_axis: {n} card(s) visible: no tp leg across 4",
              flush=True)
    out["b_one_card_4_shards"], template = pair(
        chip_smoke, b_cfg, smi, "(b) on [cuda:0] * 4", [lead] * 4)
    counts = [k for k in CARDS if k <= n]
    if not counts:
        print(f"clients_axis: {n} card(s) visible, {CARDS} wanted: "
              "no run across cards", flush=True)
    for k in counts:
        cards = [torch.device("cuda", i) for i in range(k)]
        out[f"b_{k}_cards"], _ = pair(chip_smoke, b_cfg, smi,
                                      f"(b) on {k} cards", cards)
    if counts:
        k = max(counts)
        cards = [torch.device("cuda", i) for i in range(k)]
        c_cfg = chip_smoke.gossip_config(chip_smoke.write_medical_docs(),
                                         num_rounds=ROUNDS)
        out[f"c_{k}_cards"], _ = pair(chip_smoke, c_cfg, smi,
                                      f"(c) on {k} cards", cards)
        # (k)'s model, its cohort spread over the cards (cohort_size 0)
        k_cfg = chip_smoke.llama_config(
            dataset, name="clients-axis-llama2-7b-lora-cohort",
            lora_rank=8, registry_size=64, sample_clients=4,
            num_rounds=ROUNDS, ledger=LedgerConfig(enabled=True))
        out[f"k_{k}_cards"], _ = pair(chip_smoke, k_cfg, smi,
                                      f"(k) cohort on {k} cards", cards)
        chip_smoke.codec_on_each_card(codec_kernels, template,
                                      b_cfg.compression, 4 // k,
                                      "(b)'s shard codec")
        out["b_one_card_profile"] = profile_split(b_cfg, [lead],
                                                  "(b) on one card")
        out[f"b_{k}_cards_profile"] = profile_split(
            b_cfg, cards, f"(b) on {k} cards")
    for dev in ("cpu", "cuda:0"):
        thread_probe(dev, 1, 2000)  # warm up
        out[f"thread_probe_{dev}"] = {str(t): thread_probe(dev, t)
                                      for t in (1, 2, 4)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
