#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bcfl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # phases 1-4, paths (a)-(aa)
    python3 chip_smoke.py --profile    # phases 1-4, then 5

Phases, each of which raises (and the script exits non-zero) on failure:

1. ``build``: compile every hand-written CUDA kernel from
   ``bcfl_tpu_torch/csrc`` (one ``nvcc`` per source, all at once), and
   print ptxas's registers and spills of each flash kernel instance and
   any ``wgmma`` serialization notice; then build the native C++ cores
   (``bcfl_tpu_torch/native``: the ledger's SHA-256, the tokenizer) with
   g++ and fail unless both loaded (the Python fallback is for machines
   without a toolchain).
2. ``kernels``: hold each kernel to its plain PyTorch version on the card
   at its op's ``parity``. The codec kernels bit for bit:
   ``int8_quantize`` on its registered ``bench_shapes`` grids (stochastic
   and deterministic), ``topk_select`` on its ``bench_shapes`` rows, one
   row for each leaf width of bert-base (the 23,440,896-wide word
   embeddings included), a row of ties, a row with -0.0, and both on rows
   holding NaN, -NaN, +inf and -inf (``int8_quantize`` at chunk widths 1
   to 300, both roundings). The flash
   kernels (forward; backward dK/dV/d-bias; backward dQ): first their
   routes (under ``torch.profiler``, a bf16 call of each runs its
   ``wgmma`` instance on ``__nv_bfloat16``, an fp16 call its ``wgmma``
   instance on ``__half``, a float32 call its FMA one), then within each
   dtype's contract (``flash_kernels.parity_for``: bf16 2e-2 and fp16
   1e-2, each plus one ulp of the value, and for dk and dq the
   ``flash_kernels.ds_slack`` of rows whose keys are all padded, zero on
   every other row; float32 1e-4): the JAX bench
   rows (bert-base-B4-S512 with ragged padding, llama-decode-B1-S2048
   causal), the seq-512 path's own [32, 12, 512, 64] call with its
   padding, a ragged S=300, a suffix-causal Sq=128 / Sk=512, a row whose
   keys are all padded, head dims 32 and 128 in both dtypes, and the Llama
   paths' call [8, 32, 512, 128] bf16 causal with their own padding and
   with ragged rows, both at Llama's -1e30 key bias; then in fp16 the
   seq-512 call, the all-padded row, the suffix-causal call, head dims 32
   (causal) and 128 and the Llama call with its padding (each plain
   version timed once, on the compared call). One line per kernel and
   shape: kernel ms, plain ms, bound ms (at the tensor-core rate of 989
   TFLOP/s for bf16 and fp16) and a PyTorch yardstick the port never
   calls (``torch.topk``; ``scaled_dot_product_attention`` forward for the
   flash forward, its backward for the two flash backward kernels, in the
   call's dtype).
3. ``main``: two paths through ``bcfl_tpu_torch.entrypoints.run`` at
   bert-base's full width (random weights from the seed), each with the
   launch counts set to 0 just before it and read just after:
   (a) two rounds of 4-client FedAvg with the ``int8+topk`` codec, 2 local
   steps of 32 x 128 tokens, dense attention; (b) the same at 32 x 512
   tokens with ``use_flash=True``, on a ``csv:`` corpus of long documents
   that the script writes under ``build/``. Checks finite losses and
   parameters, that every kernel of the path launched (path (b): exactly
   rounds x clients x steps x layers launches of each flash backward
   kernel), and that the bytes on the wire equal ``payload_nbytes``;
   prints per-round wall, samples/s, compression ratio and peak memory.
   Then times each kernel at the calls one round of path (b) makes, and
   ``topk_select`` also on the stacked deltas of one real round (4 clients
   after 2 local AdamW steps of path (a)), held bit for bit and printed
   beside the Gaussian rows. Then (u), path (b) at
   ``compute_dtype="float16"``, with the counts set to 0 just before it
   and read just after: finite losses, every kernel launched, K2 and K3
   exactly rounds x clients x steps x layers times, every flash launch an
   fp16 instance; its round walls and peak beside (b)'s. Then the
   peer-to-peer paths, each with the counts set to 0 just before it and
   read just after: (c) serverless ring
   gossip, the ``serverless_noniid_medical`` preset at biobert-base's
   width (10 clients, 40 labels, 2 rounds of 2 local steps of 32 x 128
   tokens, ``int8+topk``, the ledger on) on a ``csv:`` corpus the script
   writes under ``build/``, with its ledger and the fingerprint's
   determinism on its payload; (d) BC-FL async, the
   ``bcfl_async_pagerank`` preset at albert-base's width (10 clients,
   buffer 4, PageRank gating, the ledger, 3 rounds, ``int8+topk``), its
   anomalies held to the JAX package's and a stale client required by the
   last round. Both check ``chain_ok`` and that every unmasked client
   authenticated, and print the ledger's time per round; after each, K5
   and K4 are held bit for bit to their plain versions at that path's own
   calls (its 10-client stacks and grids) and timed. Then the reference's
   run surface and the memory switches, each path with the counts set to
   0 just before it and read just after: (e) the worker sweep,
   ``run_sweep`` over 5, 10 and 20 clients of the
   ``serverless_cancer_biobert`` preset (biobert-base width, ring gossip,
   no codec) on the ``cancer`` stand-in, 2 rounds of 2 local steps of
   32 x 128 tokens, printing per count the round walls, samples/s,
   ``resources``, the peak memory and the final accuracy, then the sweep
   record; no kernel may launch; (f) the faithful serverless mode, the
   ``serverless_noniid_imdb`` preset at albert-base width (10 clients) on
   the ``imdb`` stand-in with the ledger: ``chain_ok``, one auth row per
   snapshot, every client authenticated, the ledger's time per round; (g)
   path (b) with ``remat``, bf16 parameters, SGD and ``max_grad_norm``
   1.0: K2 and K3 launch as on (b), K1 once more per training call (the
   recompute), K4 and K5 as on (b); its peak memory and round walls
   beside (b)'s; K1-K3 held to their plain versions on the q, k, v of
   (g)'s own first flash call, and K5/K4 at (g)'s codec calls. Then the
   resilience paths, each with the counts set to 0 just before it and
   read just after, and each writing its checkpoints under
   ``build/chip_smoke/checkpoints`` (it fails unless the disk holds twice
   what it writes, and deletes them when it ends), all three on
   ``CUT_LAYERS`` = 2 of their model's 12 layers at its full width: (h)
   path (b) with the ledger, 2 rounds, uninterrupted and then checkpointed every round,
   crashed by the fault plan at round 1 (``SimulatedCrash``) and resumed
   with ``run(resume=True)``: the resumed trainable tree, error-feedback
   residual, ledger and every round's records equal the uninterrupted
   run's bit for bit, the crash and resume launch each kernel exactly as
   often as the uninterrupted run, and the save and restore seconds and
   bytes on disk print; (i) the chaos matrix of
   ``tests/test_reputation.py`` at bert-base width and seq 128 (server,
   4 clients, 5 rounds, ``trimmed_mean``, ``int8+topk``, the ledger,
   reputation, a partition over rounds 1-2, churn, a flaky client),
   checkpointed every 2 rounds and crashed at round 3, so the resume
   re-enters mid-partition: the lanes fired and the resumed run, the
   reputation arrays included, equals the uninterrupted one bit for bit;
   (j) path (a) at 10 clients with clients 1 and 7 corrupting their
   updates in flight and the ledger off, one 2-round engine each for
   ``trimmed_mean``, ``median`` and ``krum``: the corruption landed, each
   rule's aggregate of the captured round lies inside the clean clients'
   range and equals the same call on the CPU (median and krum bit for
   bit, trimmed_mean to rtol 1e-6); the rules' ms per call and the peak
   memory print, and K5/K4 are held at (j)'s 10-client calls. Then the
   Llama paths at llama2-7b's full width (32 layers, hidden 4096, 32
   heads of 128, FFN 11008, vocab 32000; random weights from the seed,
   float32 base, bf16 compute, remat, 8 x 512 tokens of the long
   documents, causal flash attention, 2 local steps, 2 rounds,
   ``int8+topk`` over the adapter tree), each with the counts set to 0
   just before it and read just after: (k) the north-star configuration,
   LoRA rank 8 classification in cohort mode (a registry of 64 clients, 4
   sampled a round; seed 42 draws [6, 12, 49, 52] then [1, 6, 13, 57])
   with the ledger: the cohorts, client 6's residual row gathered in
   round 1 equal bit for bit to what round 0 scattered and nonzero,
   ``chain_ok``, the effective rank, the adapters' size against the
   base's, and K1-K3 held on the path's own first flash call; (l)
   causal-LM LoRA at per-client ranks 4, 8, 8, 16 (RBLA mean; the
   ``lm_head`` carries an adapter): every client's padded rank dims
   exactly 0 in its trained tree, its shipped delta and its residual in
   both rounds. Both check that every flash call ran the causal bf16
   D = 128 instances and the launch counts (K2 and K3 once per layer and
   step), and hold K5/K4 at their calls. Then tensor and sequence
   parallelism on (k)'s model (llama2-7b at full width and depth, float32
   base, bf16 compute, remat, LoRA rank 8), each path with the counts set
   to 0 just before it and read just after, and each passing an explicit
   device list that names the one card more than once, so the shards
   share it (the sharded arithmetic is proved, not a memory or speed
   gain): (v) ``tp=2`` on ``[cuda:0, cuda:0]``, server mode, 4 clients,
   one round of 2 local steps of 8 x 512 tokens, ``int8+topk`` over the
   adapters, the ledger on. It gates on every column- and row-parallel
   leaf split 2 ways with every shard a view of its weight (the base
   stored once) and the peak memory within (k)'s of the same run plus
   10%; on layer 0's split ops against tp=1 on client 0's first batch in
   bf16 (column shards and head-shard attention within one bf16 ulp, the
   row-parallel sums within the partials' rounding); on client 0's first
   local step at tp=2 against tp=1 on the same weights and batch (float32
   compute: loss within 1e-5 relative, adapter gradients within 1e-4 of
   their L2 norm; bf16: tp=2's logits and gradients no farther than twice
   tp=1's from the float32 step, the loss within the logits' Lipschitz
   bound); on K2 and K3 once per layer, step and
   shard, the flash calls all ``[8, 16, 512, 128]``, K1-K3 held on the
   path's first head-shard call and timed beside the full-head call's;
   on finite losses, every client authenticated and ``chain_ok``. (w)
   ``sp=4`` on ``[cuda:0] * 4``: the causal-LM task at Llama-2's
   4096-token context on a corpus of 4096-token documents the script
   writes under ``build/``, batch 1, 2 clients, one round of 2 local
   steps. It gates on 3 rotations per ring call, at least two ring calls
   per layer and training step and no flash launch; on the ring of the
   path's first attention call against dense float32 attention of the
   same q, k, v and key bias on the card (1e-4); on client 0's first
   step at sp=4 against sp=1 on the same weights and batch (bf16 against
   the flash kernels: the token loss within 1e-4 relative, the adapter
   gradients no farther than twice flash's from the float32 step;
   float32 compute against the float32 attention in one block: loss
   within 1e-5, gradients within 1e-4); on finite losses; it prints the
   peak memory and the round wall. (aa) makes every row of a 2-D mesh a
   client shard: (v)'s configuration on ``[cuda:0] * 4`` (2 rows of
   ``tp=2``, 2 clients a row) against (v)'s own one-row run, and (w)'s
   at ``sp=2`` on ``[cuda:0] * 4`` (2 rows of 1 client, each with its own
   ring) against ``[cuda:0] * 2``, each with the counts set to 0 just
   before and read just after: the global tree, every round's payload,
   the ledger head, the per-client stats and evaluation bit for bit,
   K1-K3 as often as one row's, K4 and K5 once a row, the ring's hops by
   row adding up to the one row's; walls, peaks and the bytes between the
   rows print. Then two short host-side paths: (x)
   ``python -m bcfl_tpu_torch.entrypoints lint --json`` in a fresh
   interpreter of this machine, which has no JAX: exit 0, zero failing
   findings, the six checkers; then each checker's firing fixture
   (``LINT_FIXTURES``, written under ``build/``) must exit 1 with that
   checker's findings only; (y) ``fed/synthetic.synthetic_round_inputs``
   on the card at (a)'s shape, its ids equal to a numpy regeneration of
   the draws, and one ``server_round`` of ``build_programs`` with
   ``int8+topk`` on them, the counts set to 0 just before it and read
   just after: K4 and K5 launched, a finite loss and global tree, the
   round's wall printed beside the card line; K5 and K4 then held to
   their plain versions at its calls. Then (z), the clients axis: path
   (b)'s configuration with the ledger on ``devices=[cuda:0] * 4`` (4
   client shards of 1, each with its own scratch model, on the one card),
   then path (c) on ``[cuda:0] * 4`` (2 shards of 5), each
   against the same configuration on ``[cuda:0]``, all four with the
   counts set to 0 just before and read just after: the global tree,
   every round's payload, the ledger head, the per-client stats and
   evaluation, and the launches of every kernel equal bit for bit; the
   round walls and peak memory of both print. Then (m), the multi-process
   runtime at full width: the ``server_noniid_medical`` preset
   (biobert-base, 40 labels, 10 clients; like every peer path up to (s),
   at biobert-base's width on ``CUT_LAYERS`` = 2 of its 12 layers, 37.5 M
   parameters, (o) on 4) on path (c)'s corpus as 5 peer
   processes of 2 clients each on the one card, buffered async merging
   every arrival, ``int8+topk`` with error feedback, the ledger over the
   announced digests, 3 global versions of 2 local steps of 32 x 128
   tokens (``bcfl_tpu_torch.dist.run_dist``; the peers are fresh
   interpreters started after the builds). Every peer must exit 0 at
   version 3 with ``chain_ok``, the heads must agree, no arrival may fail
   authentication, K4 and K5 must launch in every peer (the record counts
   the peers' launches), some arrival must be stale, and the collated
   event timeline must hold every invariant; it prints per peer the
   rounds, merges, chain, launches and peak memory, the staleness
   histogram, message latency p50/p99, bytes and send ms per update frame
   and per model broadcast, merge ms, each peer's contended round walls
   beside path (c)'s one-process rounds, and holds K5/K4 at a peer's
   2-client calls. Then (n), an HF import at bert-base width: a
   ``BertForSequenceClassification``-layout state dict drawn from the seed
   (HF key names; the card's machine has no ``transformers``) imported
   with ``import_state_dict``, every parameter equal to the written one,
   and one path-(a)-shaped server round from it with K4 and K5, the
   counts set to 0 just before it and read just after. Then the
   runtime's fault tolerance at (m)'s width, each path writing its peer
   checkpoints (0.62 GB a peer: the trainable tree and 2 clients'
   residual) under ``build/chip_smoke/checkpoints`` after checking the
   disk holds twice its peak, and deleting them at its end: (o)
   ``scripts/dist_async.py``'s proof, a partition over peers (0, 1) |
   (2, 3, 4) on each peer's local rounds 2-4, a checkpoint every 2
   versions (the newest kept), peer 1 SIGKILLed once its version-2
   checkpoint and meta are committed and restarted with ``--resume``, 10
   versions; it gates on every gate of ``analyze`` (all peers complete,
   a stale arrival, no invariant violation, two heads before the heal
   and a forked reconcile, the merged chain verifies, the heads agree
   after it, every chain verifies, the killed peer resumed), on K4/K5 in
   both of peer 1's incarnations and on the restored trainable and
   residual equal to the kept checkpoint file bit for bit, and prints
   the heads, the solo merges, the reconcile, the gate drops, the saves,
   the restore and the seconds from the kill to the first resumed round;
   (p) ``tests/test_storage_faults.py``'s repair, 5 versions, a checkpoint
   every version (2 kept), quorum 0.9, every peer in each merge, peer 4
   SIGKILLed, its newest meta bit-flipped while it is down and restarted
   with ``--resume --bootstrap``, the leader's first serve to it
   tampered; it gates on a ``damaged`` scrub, a refused transfer, a
   verified then adopted one, the two repair invariants and every other
   at 0, agreeing heads and K4/K5 in the repaired incarnation, and prints
   the transfer bytes, the request-to-adopt seconds and the scrub's. Then
   the runtime's adversarial half at (m)'s width: first the robust rules
   at the leader's call (5 float32 votes of (q)'s 37.5 M parameters
   from the seed, one scaled 25x), each timed on the card and
   on the host (``trimmed_mean`` at full width, the other two over the
   embeddings', first layer's and classifier's leaves), held device
   against host (the aggregate within one float32 ulp, distances and
   krum scores at rtol 1e-9, flags and krum's pick identical); then (q)
   ``scripts/dist_byzantine.py``'s byzantine and resume legs in one run:
   ``trimmed_mean`` over 5 votes (``buffer=5``), per-peer reputation
   (the outlier lane weighed 1.0, since the fingerprint cannot see a
   forged codec scale), peer 4 scaling and forging every update 25x,
   resource samples every 2 s, a checkpoint every 2 versions, the leader
   SIGKILLed after its version-2 checkpoint (past the quarantine) and
   resumed, 4 versions. It
   gates on the script's gates (peer 4 quarantined at the leader within
   half the versions and at every follower, post-ack refusals, no
   quarantined merge and no other violation across both leader
   incarnations, one verified head, the restored tracker bit for bit the
   file's and no readmission, injections at peer 4 only, ``trimmed_mean``
   on the merges), on K4/K5 in every incarnation and on ``resource`` and
   ``detector.phi`` events in every peer's stream, and prints the
   verdict's version, the leader's trust and the rule's seconds per
   merge, the restore and the kill-to-merge seconds and the final loss
   beside (m)'s. Then the chaos lanes and the leaderless dispatch at
   (m)'s width: (r) (m) under the wire lane of
   ``scripts/dist_chaos.py`` (drop, dup, reorder and delay 0.2, corrupt
   0.05) for the whole run, peer 3 limping (2 s stalls at the train seam
   and its outbound link paced at 64 MiB/s, each on 35% of its rounds)
   and peer 2's durable writes and event flushes failing with ENOSPC or
   EMFILE on the resource lane's draws (never depth 3), per-peer
   reputation, a checkpoint every version; it gates on the wire leg's
   gates (every peer exits 0, no invariant violation over a nonzero
   merge count, retries, duplicates dropped, CRC drops and reorder holds
   nonzero, a detector SUSPECT and back, one verified head), peer 3's
   stalls exactly the plan's draws and peer 3 never quarantined, peer 2's
   ``resource.inject`` events the plan's draws each followed by its
   ladder rung, and K4/K5 launched in every peer round, and prints the
   chaos counters by action, the paced seconds and the merge walls; (s)
   gossip dispatch, JAX's partition-heal loopback at full width and 5
   peers (``gossip_fanout`` 2, ``trimmed_mean``, reputation, whole float32
   states on the wire, a partition (0, 1) | (2, 3, 4) on local rounds
   2-3, 6 rounds a peer), after the merge of 3 of its states on the
   card held bit for bit to the same reduction in numpy on the host; it
   gates on every peer exiting 0 at version 6 on its own clock with a
   verified chain and its own component, no invariant violation (the
   leaderless heal included), a leaderless fork begin and heal at every
   peer, a vote-floor event on the 2-peer side, no quarantine and finite
   losses, and prints the push bytes and seconds, the merge count, the
   lag histogram and the card's and host's merge milliseconds. (m)-(r)
   print (m)'s per-peer, frame, latency and merge lines, and add every
   incarnation's launches to the record. Then (t), the paper's
   peer-to-peer federated LLM fine-tuning: (k)'s configuration (llama2-7b
   at full width, LoRA rank 8, float32 frozen base from the seed, bf16
   compute, remat, causal flash at 8 x 512 tokens) on the peer runtime,
   2 peer processes of 2 clients each on the one card after the parent
   released its cached blocks, ``buffer=2``, ``int8+topk`` with error
   feedback over the adapter tree, the ledger, a checkpoint every
   version, 3 versions, watched live by ``python -m
   bcfl_tpu_torch.entrypoints monitor`` from before the peers start
   until a stop file after the harness returns. It gates on every peer
   exiting 0 with a verifying chain and one head, zero invariant
   violations, the monitor exiting 0 with the batch collate's verdict,
   one ``health.jsonl`` record per merge with a finite effective rank in
   (0, 8], every frame below 1% of the float32 base, each update frame's
   body the codec's ``payload_nbytes`` of the adapter tree for the peer's
   clients (the frame its header, framing and index plus that body,
   exactly), per peer K2 and K3 once per layer of every training step, K1
   at least twice that, K4 once and K5 at least once a peer round, a
   finite final loss and the peers' peaks together under the card's
   memory; it prints each peer's set-up, round walls, peak and phases,
   the frames' bytes and send ms, merge and decode ms and the effective
   rank per version, the checkpoints, and the monitor's lag from a merge
   event to its health record; K5 and K4 are held to their plain
   versions at a peer's own calls (2 clients of adapter leaves) first.
4. ``reference``: on small inputs, a tiny-bert server round on the card
   against the same round on the CPU (float32, dropout off, at the
   tolerance of ``tests/test_torch_round.py``), with dense attention at
   S=16 and with flash attention at S=64, and the codec tree encode on the
   card against the CPU, payload bit for bit; a faithful run with the
   ledger card vs CPU; on the card, a server round with remat and dropout
   ON against the same round without remat (gradients and round equal to
   1e-6 of their scale); a float16-compute dense round card vs CPU.
5. ``profile`` (only with ``--profile``): one warm round of paths (a),
   (b), (c) and (k) (without its ledger) split into its stages (local
   training, codec, FedAvg mean; for (c) training, codec, ledger and
   gossip mix) on the host clock, and
   under ``torch.profiler``: the device's busy share and the kernels by
   device time.

The script prints the card's name and power limit first, and as its last
three lines the kernels' JSON record, the card line again and the result
``{"ok": true, "device": {...}}``. The flash kernels' records carry
``by_dtype``: per dtype instance, its launches on the in-process paths
(the peer processes' launches, all bf16, are in ``launches`` only), the
largest |diff| of its comparisons, and its times at the seq-512 and
Llama calls. Times are CUDA-event means over
repeated launches after a warm-up; the caches are warm. A call whose host
wrapper takes longer than its kernel reads the wrapper's rate that way,
so K4's round calls also print their kernel's device time under
``torch.profiler``, back to back and with the L2 cache flushed before
each call.
"""

from __future__ import annotations

import argparse
import copy
import csv
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense tensor-core rate
FP16_OPS_PER_S = 989e12  # H100 SXM fp16 dense tensor-core rate
TOPK_FRAC = 0.05  # the codec's default topk_frac
BUILD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"

# leaf widths of bert-base's trainable tree (vocab 30522)
BERT_BASE_WIDTHS = (23440896, 2359296, 589824, 393216, 3072, 1536, 768, 2)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` launches after one
    warm-up launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str, flush: bool = False) -> float:
    """Mean device time per launch of the kernels whose name holds
    ``kernel`` over ``iters`` calls of ``fn`` (one launch each), under
    ``torch.profiler`` (after one warm-up call): the kernel's own time,
    where ``time_ms`` of a call whose host wrapper takes longer than its
    kernel reads the wrapper's rate. The mean is over the launch records
    the trace holds, which on an H100 host has now and then lacked some.
    With ``flush``, a buffer four times the L2 cache is written before
    every call, so no call reads what the one before left in L2 (the fill
    is not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0)
    scrub = (torch.empty(4 * (l2 or 50 << 20), dtype=torch.uint8,
                         device="cuda") if flush else None)
    fn()
    torch.cuda.synchronize()
    # the profiler's device trace has come back empty on an H100 host
    # now and then (a whole window without one kernel record); such a
    # window is traced again, and three empty ones fail
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if scrub is not None:
                    scrub.zero_()
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        total = sum(e.self_device_time_total for e in mine)
        if total > 0:
            launches = sum(e.count for e in mine)
            if launches != iters:
                print(f"device_ms: {launches} of {iters} launches of "
                      f"{kernel} in the trace", flush=True)
            return total / 1e3 / launches
        print(f"device_ms: the profiler saw no device time of {kernel} "
              f"(window {attempt + 1} of 3)", flush=True)
    raise RuntimeError(f"the profiler saw no device time of {kernel}")


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """The least time for moving ``nbytes`` and doing ``ops`` operations
    at the card's peak rates (``ops_per_s``: the rate of the operations'
    type), and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_notes(logs) -> list:
    """One line per flash kernel instance from ptxas's ``-v`` report in
    the build logs (``{source: nvcc output}``): registers and spilled
    bytes; and every line that says ``wgmma`` was serialized (ptxas does
    that silently when the accumulators are touched between issue and
    wait), which costs speed, not correctness."""
    notes = []
    for src in sorted(logs):
        label = None
        for ln in logs[src].splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", ln)
            if entry:
                # the kernels are templates: <name>I<template args>E...
                m = re.search(r"(flash_[a-z_]+?(?:kernel|wgmma))I(\w+)",
                              entry.group(1))
                label = None
                if m:
                    d = re.search(r"Li(\d+)E", m.group(2))
                    args = m.group(2)
                    dtype = ("f32" if args.startswith("f") else
                             "fp16" if "__half" in args else "bf16")
                    label = (f"{m.group(1)}<{dtype}, "
                             f"{d.group(1) if d else '?'}>")
                    spill = 0
            elif label and "spill stores" in ln:
                spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
            elif label and "Used" in ln and "registers" in ln:
                regs = re.search(r"Used (\d+) registers", ln).group(1)
                notes.append(f"ptxas {label}: {regs} registers, "
                             f"{spill} bytes spilled")
                label = None
            if "serializ" in ln.lower():
                notes.append(f"ptxas WARNING ({src}): {ln.strip()}")
    return notes


def held(parity: str, pairs, slacks=None) -> tuple:
    """Hold every ``(got, want)`` pair to a ``parity`` contract
    (``registry.parity_check``), each with its per-element slack from
    ``slacks`` where given: ``(all held, max |diff|)``."""
    from bcfl_tpu_torch.ops import registry

    check = registry.parity_check(parity)
    pairs = list(pairs)
    slacks = list(slacks) if slacks is not None else [None] * len(pairs)
    results = [check(a, b, sl) for (a, b), sl in zip(pairs, slacks)]
    return all(ok for ok, _ in results), max(err for _, err in results)


# ---------------------------------------------------------------- kernels


class KernelStats:
    """What the JSON record says of one kernel. A field stays None (null in
    the record) until this run has measured it."""

    def __init__(self, op):
        self.name = op.name
        self.source = f"bcfl_tpu_torch/csrc/{op.source}.cu"
        self.replaces = op.replaces.split()[0]
        self.max_abs_err = self.launches = None
        # per-round totals over the main path's calls
        self.ms = self.plain_ms = self.bound_ms = self.library_ms = None
        self.bound_by = None
        # the flash ops, per dtype instance: launches on the in-process
        # paths, the largest |diff| of its comparisons, and its times at
        # the seq-512 and Llama paths' calls
        self.by_dtype = {}

    def compared(self, err: float, dtype=None):
        self.max_abs_err = max(self.max_abs_err or 0.0, err)
        if dtype is not None:
            d = self.by_dtype.setdefault(dtype_name(dtype), {})
            d["max_abs_err"] = max(d.get("max_abs_err", 0.0), err)

    def launched(self, by: dict):
        """Add one in-process path's launches per dtype instance."""
        for key, n in by.items():
            d = self.by_dtype.setdefault(key, {})
            d["launches"] = d.get("launches", 0) + n

    def add_times(self, ms, plain, bnd, by, lib=None, calls=1):
        self.ms = (self.ms or 0.0) + ms * calls
        self.plain_ms = (self.plain_ms or 0.0) + plain * calls
        self.bound_ms = (self.bound_ms or 0.0) + bnd * calls
        if lib is not None:
            self.library_ms = (self.library_ms or 0.0) + lib * calls
        self.bound_by = by

    def record(self):
        rec = {"name": self.name, "route": "cuda", "source": self.source,
               "replaces": self.replaces, "launches": self.launches,
               "max_abs_err": self.max_abs_err, "ms": self.ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": self.bound_by, "library_ms": self.library_ms}
        if self.by_dtype:
            rec["by_dtype"] = self.by_dtype
        return rec


#: launches per timing of the flash kernels at the Llama paths' calls (the
#: full-head call and (v)'s head-shard call)
LLAMA_ITERS = 20


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


#: the flash ops' launches per dtype instance over the in-process paths
#: (``harvest_dtypes``); the peer processes' launches (all bf16) are in
#: the record's ``launches`` only
PATH_LAUNCHES_BY_DTYPE = {}


def harvest_dtypes() -> dict:
    """The flash ops' launches per dtype instance since the counts were
    last set to 0, read at the end of an in-process path (never after a
    comparison with a plain version) and added to
    ``PATH_LAUNCHES_BY_DTYPE``."""
    from bcfl_tpu_torch.ops import registry

    by = {op.name: dict(op.launches_by) for op in registry.kernel_ops()
          if op.name in FLASH_OPS}
    for name, counts in by.items():
        total = PATH_LAUNCHES_BY_DTYPE.setdefault(name, {})
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
    return by


def int8_case(ck, st, gen, shapes, stochastic, label, iters, device=False):
    """One ``int8_quantize`` call over the grids ``shapes`` ([C, M, chunk]
    each; a round's calls pass all of its grids at once), held bit for bit
    and timed against the plain version; with ``device``, also the
    kernel's device time under the profiler."""
    gs = [torch.randn(sh, generator=gen, device="cuda") * 1e-3
          for sh in shapes]
    us = ([torch.rand(sh, generator=gen, device="cuda") for sh in shapes]
          if stochastic else None)
    got = ck.INT8_QUANTIZE(gs, us, stochastic=stochastic)
    want = ck.int8_quantize_grids_ref(gs, us, stochastic=stochastic)
    torch.cuda.synchronize()
    same, err = held(ck.INT8_QUANTIZE.parity,
                     [(a, b) for pa, pb in zip(got, want)
                      for a, b in zip(pa, pb)])
    st.compared(err)
    ms = time_ms(lambda: ck.INT8_QUANTIZE(gs, us, stochastic=stochastic),
                 iters)
    plain = time_ms(lambda: ck.int8_quantize_grids_ref(
        gs, us, stochastic=stochastic), iters)
    n = sum(C * M * c for C, M, c in shapes)
    rows = sum(C * M for C, M, _ in shapes)
    nbytes = n * (4 + (4 if stochastic else 0) + 1) + rows * 4
    bnd, by = bound_ms(nbytes, 6 * n)
    grids = " + ".join(f"[{C},{M},{c}]" for C, M, c in shapes)
    dev = ""
    if device:
        call = functools.partial(ck.INT8_QUANTIZE, gs, us,
                                 stochastic=stochastic)
        t = device_ms(call, iters, "int8_quantize_kernel")
        cold = device_ms(call, iters, "int8_quantize_kernel", flush=True)
        dev = (f", device time {t:.4f} ms back to back, {cold:.4f} ms with "
               f"L2 flushed before each call ({bnd / cold:.1%} of the bound)")
    print(f"int8_quantize {label} {grids} stochastic={int(stochastic)}: "
          f"kernel {ms:.4f} ms{dev}, plain {plain:.4f} ms, bound {bnd:.4f} "
          f"ms ({by}), {'identical' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise RuntimeError(f"int8_quantize differs from its plain version "
                           f"at {label} stochastic={stochastic}")
    return ms, plain, bnd, by


def nonfinite_rows(ck, gen):
    """K4 and K5 on rows holding NaN, -NaN, +inf and -inf, bit for bit
    against their plain versions: a NaN anywhere in a chunk makes its
    scale NaN and its codes 0, an inf makes the scale inf (the plain
    version's ``amax`` and ``clamp`` keep a NaN); top-k ranks NaN first,
    then inf, values gathered with their sign bits."""
    specials = (float("nan"), -float("nan"), float("inf"), -float("inf"))
    for chunk in (1, 2, 39, 64, 255, 256, 300):
        g = torch.randn((3, 7, chunk), generator=gen, device="cuda") * 1e-3
        flat = g.view(-1, chunk)
        for r, v in enumerate(specials):
            flat[r, (5 * r) % chunk] = v
        if chunk > 1:
            flat[4, 0], flat[4, -1] = float("inf"), -float("inf")
        u = torch.rand(g.shape, generator=gen, device="cuda")
        for stochastic in (True, False):
            uu = u if stochastic else None
            [got] = ck.INT8_QUANTIZE([g], None if uu is None else [uu],
                                     stochastic=stochastic)
            want = ck.int8_quantize_ref(g, uu, stochastic=stochastic)
            torch.cuda.synchronize()
            same, _ = held(ck.INT8_QUANTIZE.parity, zip(got, want))
            if not same:
                raise RuntimeError(f"int8_quantize differs from its plain "
                                   f"version on non-finite rows, chunk "
                                   f"{chunk} stochastic={stochastic}")
    x = torch.randn((3, 4099), generator=gen, device="cuda")
    x[0, 17], x[0, 4000], x[0, 5] = specials[0], specials[1], specials[2]
    x[1, 9], x[1, 3] = specials[3], specials[2]
    x[2, ::2] = specials[0]
    for k in (1, 3, 6, 4099):
        got = ck.TOPK_SELECT(x, k=k)
        want = ck.topk_select_ref(x, k=k)
        torch.cuda.synchronize()
        same, _ = held(ck.TOPK_SELECT.parity, zip(got, want))
        if not same:
            raise RuntimeError(f"topk_select differs from its plain version "
                               f"on non-finite rows, k={k}")
    print("int8_quantize (chunks 1-300, both roundings) and topk_select "
          "(k = 1, 3, 6, N) on NaN, -NaN, +inf, -inf rows: identical",
          flush=True)


def topk_case(ck, st, x, k, label, iters):
    val, idx = ck.TOPK_SELECT(x, k=k)
    val_ref, idx_ref = ck.topk_select_ref(x, k=k)
    torch.cuda.synchronize()
    same, err = held(ck.TOPK_SELECT.parity, ((val, val_ref), (idx, idx_ref)))
    st.compared(err)
    ms = time_ms(lambda: ck.TOPK_SELECT(x, k=k), iters)
    plain = time_ms(lambda: ck.topk_select_ref(x, k=k), iters)
    a = x.abs()
    lib = time_ms(lambda: torch.topk(a, k, dim=1), iters)
    R, N = x.shape
    bnd, by = bound_ms(R * N * 4 + R * k * 8, R * N)
    print(f"topk_select {label} [{R},{N}] k={k}: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}), torch.topk "
          f"{lib:.4f} ms, {'identical' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise RuntimeError(f"topk_select differs from its plain version at "
                           f"{label}")
    return ms, plain, bnd, by, lib


def leaf_k(n: int) -> int:
    return max(1, int(math.ceil(TOPK_FRAC * n)))


# ------------------------------------------------------- flash attention

FLASH_OPS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def flash_inputs(gen, B, H, Sq, Sk, D, dtype, lens, neg=-1e9):
    """q, k, v, dO in the model's layout (``view(B, S, H, D)
    .transpose(1, 2)``, not contiguous) and the ``[B, Sk]`` padding bias
    (``neg`` past each row's length in ``lens``: the encoders' -1e9, or
    Llama's -1e30; none when ``lens`` is None)."""
    def draw(S):
        return torch.randn((B, S, H, D), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)

    q, k, v, do = draw(Sq), draw(Sk), draw(Sk), draw(Sq)
    bias = torch.zeros((B, Sk), device="cuda")
    if lens is not None:
        keep = (torch.arange(Sk, device="cuda")[None, :]
                < torch.tensor(lens, device="cuda")[:, None])
        bias = torch.where(keep, 0.0, neg)
    return q, k, v, do, bias


def flash_cost(B, H, Sq, Sk, D, elt, causal):
    """Per kernel: (bytes each input read once and each output written
    once, matmul FLOPs: 4, 8 and 6 B H Sq Sk D, halved for causal)."""
    nq, nk = B * H * Sq * D * elt, B * H * Sk * D * elt
    bias, lse, db = B * Sk * 4, B * H * Sq * 4, B * H * Sk * 4
    flops = B * H * Sq * Sk * D * (0.5 if causal else 1.0)
    return {"flash_fwd": (2 * nq + 2 * nk + bias + lse, 4 * flops),
            "flash_bwd_dkv": (3 * nq + 4 * nk + bias + lse + db, 8 * flops),
            "flash_bwd_dq": (4 * nq + 2 * nk + bias + lse, 6 * flops)}


def sdpa_ms(q, k, v, do, bias, causal, iters):
    """``scaled_dot_product_attention`` with the same float mask: forward
    ms, and backward ms as forward+backward minus forward. A yardstick
    only; the port never calls it."""
    import torch.nn.functional as F

    Sq, Sk = q.shape[2], k.shape[2]
    mask = bias[:, None, None, :].to(q.dtype)
    if causal:
        dead = (torch.arange(Sk, device="cuda")[None, :]
                > torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq))
        mask = torch.where(dead, float("-inf"), mask)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def both():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        torch.autograd.grad(out, (qg, kg, vg), do)

    fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters)
    return fwd, time_ms(both, iters) - fwd


def flash_case(fk, stats, gen, label, B, H, Sq, Sk, D, dtype, causal, lens,
               iters, neg=-1e9):
    """Hold the three flash kernels to their plain versions (out and lse;
    dk, dv and db_h; dq) at their dtype's contract (``fk.parity_for``:
    bf16 2e-2 and fp16 1e-2, each plus one ulp of the value, dk and dq
    plus ``fk.ds_slack``; float32 1e-4), and time them. Returns ``{op: (ms, plain, bound, bound_by,
    sdpa)}``. The fp16 cases time each plain version once, on the call
    that is compared (at the Llama call one takes about a second)."""
    q, k, v, do, bias = flash_inputs(gen, B, H, Sq, Sk, D, dtype, lens, neg)
    return flash_hold(fk, stats, label, q, k, v, do, bias, causal, iters,
                      plain_once=dtype == torch.float16)


def timed_once(fn):
    """``(fn(), its CUDA-event ms)``: one call, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def flash_hold(fk, stats, label, q, k, v, do, bias, causal, iters,
               plain_once=False):
    """``flash_case`` on given inputs: q, k, v, dO ``[B, H, S, D]`` and the
    ``[B, Sk]`` key bias."""
    B, H, Sq, D = q.shape
    Sk, dtype = k.shape[2], q.dtype
    parity = fk.parity_for(dtype)
    ref = fk.flash_fwd_ref(q, k, v, bias, causal)
    bwd = (q, k, v, bias, ref[0], do, ref[1], causal)
    calls = {
        "flash_fwd": (lambda: fk.FLASH_FWD(q, k, v, bias, causal),
                      lambda: fk.flash_fwd_ref(q, k, v, bias, causal)),
        "flash_bwd_dkv": (lambda: fk.FLASH_BWD_DKV(*bwd),
                          lambda: fk.flash_bwd_dkv_ref(*bwd)),
        "flash_bwd_dq": (lambda: (fk.FLASH_BWD_DQ(*bwd),),
                         lambda: (fk.flash_bwd_dq_ref(*bwd),)),
    }
    slack = fk.ds_slack(*bwd)
    slacks = {"flash_fwd": None, "flash_bwd_dkv": slack[:3],
              "flash_bwd_dq": slack[3:]}
    lib_fwd, lib_bwd = sdpa_ms(q, k, v, do, bias, causal, iters)
    cost = flash_cost(B, H, Sq, Sk, D, q.element_size(), causal)
    rate = {torch.bfloat16: BF16_OPS_PER_S, torch.float16: FP16_OPS_PER_S,
            torch.float32: F32_OPS_PER_S}[dtype]
    out, bad = {}, []
    for name, (kernel, plain) in calls.items():
        got = kernel()
        torch.cuda.synchronize()
        want, once_ms = timed_once(plain)
        ok, err = held(parity, zip(got, want), slacks[name])
        stats[name].compared(err, dtype)
        ms = time_ms(kernel, iters)
        plain_ms = (once_ms if plain_once
                    else time_ms(plain, max(1, iters // 2)))
        bnd, by = bound_ms(*cost[name], rate)
        lib = lib_fwd if name == "flash_fwd" else lib_bwd
        print(f"{name} {label} [{B},{H},{Sq},{Sk},{D}] "
              f"{str(dtype).split('.')[-1]} causal={int(causal)}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms "
              f"({by}), sdpa {'fwd' if name == 'flash_fwd' else 'bwd'} "
              f"{lib:.4f} ms, max |diff| {err:.3e} "
              f"{'within' if ok else 'PAST'} {parity}", flush=True)
        if not ok:
            bad.append(name)
        out[name] = (ms, plain_ms, bnd, by, lib)
    if bad:
        raise RuntimeError(f"{bad} differ from their plain versions past "
                           f"{parity} at {label}")
    return out


#: the kernel instance each dtype must launch: (route, element type as
#: the profiler's demangled name spells the first template argument)
FLASH_INSTANCES = {torch.bfloat16: ("wgmma", "__nv_bfloat16"),
                   torch.float16: ("wgmma", "__half"),
                   torch.float32: ("kernel", "float")}


def flash_instance(name: str, op: str):
    """``(route, element type)`` of a profiled kernel ``name`` that is an
    instance of flash ``op`` (``void flash::...::flash_fwd_wgmma<__half,
    64>(...)``), or None."""
    for route in ("wgmma", "kernel"):
        head = f"{op}_{route}<"
        if head in name:
            return route, name.split(head, 1)[1].split(",")[0].strip()
    return None


def flash_routes(fk):
    """Hold the C entries' routes by dtype: under ``torch.profiler``, a
    bf16 call of K1, K2 and K3 must launch their ``wgmma`` instances on
    ``__nv_bfloat16``, an fp16 call their ``wgmma`` instances on ``__half``
    and a float32 call their float32 FMA instances, and no other
    instance."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for dtype, want in FLASH_INSTANCES.items():
        q, k, v, do, bias = flash_inputs(gen, 1, 2, 128, 128, 64, dtype, None)
        names = []
        for _ in range(3):  # an empty device trace is traced again
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out, lse = fk.FLASH_FWD(q, k, v, bias, False)
                fk.FLASH_BWD_DKV(q, k, v, bias, out, do, lse, False)
                fk.FLASH_BWD_DQ(q, k, v, bias, out, do, lse, False)
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]
            if names:
                break
        for op in FLASH_OPS:
            mine = [(n, flash_instance(n, op)) for n in names
                    if flash_instance(n, op)]
            ran = [n for n, inst in mine if inst == want]
            wrong = [n for n, inst in mine if inst != want]
            if not ran or wrong:
                raise RuntimeError(f"{op} {dtype}: launched {wrong or names}, "
                                   f"not its {want} instance")
            print(f"route {op} {dtype_name(dtype)}: {ran[0][:90]}",
                  flush=True)


def phase_flash_kernels(fk, stats, main_lens, llama_lens):
    """Every flash case; returns the times of the seq-512 path's call and
    of the Llama paths' call ((k), (l): [8, 32, 512, 128] bf16, causal,
    their own padded lengths at -1e30), in bf16. Those two calls' times in
    each 16-bit dtype go into the record's ``by_dtype``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    rows = {sh["label"]: sh for sh in fk.FLASH_FWD.bench_shapes}
    bert4, llama, main = (rows["bert-base-B4-S512"],
                          rows["llama-decode-B1-S2048"],
                          rows["bert-base-B32-S512"])
    cases = [
        # (label, B, H, Sq, Sk, D, dtype, causal, padded lengths)
        ("bert-base-B4-S512", *(bert4[x] for x in "BHSSD"), bf16, False,
         (512, 377, 200, 65)),
        ("bert-base-B4-S512", *(bert4[x] for x in "BHSSD"), f32, False,
         (512, 377, 200, 65)),
        ("llama-decode-B1-S2048", *(llama[x] for x in "BHSSD"), bf16, True,
         None),
        ("seq-512-path", *(main[x] for x in "BHSSD"), bf16, False,
         main_lens),
        ("ragged-S300", 2, 12, 300, 300, 64, bf16, False, (300, 157)),
        ("ragged-S300", 2, 12, 300, 300, 64, f32, False, (300, 157)),
        ("suffix-causal", 2, 12, 128, 512, 64, bf16, True, None),
        ("suffix-causal", 2, 12, 128, 512, 64, f32, True, None),
        ("all-keys-padded", 2, 12, 256, 256, 64, bf16, False, (256, 0)),
        ("all-keys-padded", 2, 12, 256, 256, 64, f32, False, (256, 0)),
        ("head-dim-32", 2, 4, 200, 200, 32, bf16, True, (200, 120)),
        ("head-dim-32", 2, 4, 200, 200, 32, f32, True, (200, 120)),
        ("head-dim-128", 2, 4, 200, 200, 128, bf16, False, (200, 120)),
        ("head-dim-128", 2, 4, 200, 200, 128, f32, False, (200, 120)),
        # the fp16 instances, path (u)'s call first
        ("seq-512-path", *(main[x] for x in "BHSSD"), f16, False,
         main_lens),
        ("all-keys-padded", 2, 12, 256, 256, 64, f16, False, (256, 0)),
        ("suffix-causal", 2, 12, 128, 512, 64, f16, True, None),
        ("head-dim-32", 2, 4, 200, 200, 32, f16, True, (200, 120)),
        ("head-dim-128", 2, 4, 200, 200, 128, f16, False, (200, 120)),
    ]
    flash_routes(fk)
    per = {}
    for label, B, H, Sq, Sk, D, dtype, causal, lens in cases:
        main = label == "seq-512-path"
        per[label, dtype] = flash_case(fk, stats, gen, label, B, H, Sq, Sk,
                                       D, dtype, causal, lens,
                                       20 if main else 5)
    # the Llama paths' call with their own padding at Llama's -1e30, and
    # a ragged batch at that bias (the long documents fill 512 positions)
    for dtype in (bf16, f16):
        per["llama-path", dtype] = flash_case(
            fk, stats, gen, "llama-path", 8, 32, 512, 512, 128, dtype, True,
            llama_lens, LLAMA_ITERS, neg=-1e30)
    flash_case(fk, stats, gen, "llama-ragged", 8, 32, 512, 512, 128, bf16,
               True, (512, 377, 200, 65, 1, 300, 511, 450), 5, neg=-1e30)
    for (label, dtype), times in per.items():
        if label in ("seq-512-path", "llama-path") and dtype != f32:
            for name, (ms, plain, bnd, by, lib) in times.items():
                stats[name].by_dtype.setdefault(dtype_name(dtype), {})[
                    label] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                              "bound_by": by, "library_ms": lib}
    return per["seq-512-path", bf16], per["llama-path", bf16]


def phase_kernels(ck, fk, stats, main_lens, llama_lens):
    """Returns the flash kernels' times at the seq-512 path's call and at
    the Llama paths' call."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    s4, s5 = stats["int8_quantize"], stats["topk_select"]
    for sh in ck.INT8_QUANTIZE.bench_shapes:
        M = -(-sh["N"] // sh["chunk"])
        for stochastic in (True, False):
            int8_case(ck, s4, gen, [(sh["C"], M, sh["chunk"])], stochastic,
                      sh["label"], 20)
    rows = [(sh["label"], sh["R"], sh["N"])
            for sh in ck.TOPK_SELECT.bench_shapes]
    rows += [(f"bert-base-width-{n}", 1, n) for n in BERT_BASE_WIDTHS]
    for label, R, N in rows:
        x = torch.randn((R, N), generator=gen, device="cuda")
        topk_case(ck, s5, x, leaf_k(N), label, 5 if R * N > 1 << 22 else 20)
    # ties: few distinct magnitudes of both signs, so the k-th value is
    # shared by many entries and the lower-index-first rule decides
    x = (torch.randint(-3, 4, (4, 100003), generator=gen, device="cuda")
         .float() * 0.5)
    for k in (1, 777, 50001, 100003):
        topk_case(ck, s5, x, k, f"ties-k{k}", 5)
    # -0.0 must come back as -0.0 (sign bit kept), zeros of both signs tie
    x = torch.zeros((2, 4099), device="cuda")
    x[0, ::3] = -0.0
    x[1, 5::7] = -0.0
    x[1, 11] = -2.5
    x[0, 4000] = 1.0
    for k in (1, 3, 4099):
        topk_case(ck, s5, x, k, f"negzero-k{k}", 5)
    nonfinite_rows(ck, gen)
    return phase_flash_kernels(fk, stats, main_lens, llama_lens)


def main_path_calls(template, comp, C):
    """The kernel calls ``encode_tree`` makes in one round, from the
    template's leaf widths: top-k once per distinct width over the
    ``[L*C, N]`` stack; int8 once over the grids, one per distinct
    ``min(chunk, k)`` of the concatenated values."""
    from bcfl_tpu_torch.compression.codecs import _leaf_k

    widths = {}
    for x in template.values():
        widths[x.numel()] = widths.get(x.numel(), 0) + 1
    topk = [(cnt * C, n, _leaf_k(comp, n)) for n, cnt in sorted(widths.items())]
    grids = {}
    for n, cnt in widths.items():
        k = _leaf_k(comp, n)
        c = min(comp.chunk, k)
        grids[c] = grids.get(c, 0) + cnt * -(-k // c)
    int8 = [(C, M, c) for c, M in sorted(grids.items())]
    return topk, int8


def codec_calls(ck, stats, template, comp, C, label, device=False):
    """K5 and K4 at one path's own calls (random inputs of those shapes),
    each held bit for bit to its plain version and timed. Returns the
    ``topk_case`` times of each top-k call, the ``int8_case`` times of the
    round's one int8 call, and that call's grids."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    topk, int8 = main_path_calls(template, comp, C)
    s4, s5 = stats["int8_quantize"], stats["topk_select"]
    times = []
    for R, N, k in topk:
        x = torch.randn((R, N), generator=gen, device="cuda")
        times.append(topk_case(ck, s5, x, k, label,
                               3 if R * N > 1 << 24 else 10))
        del x
    print(f"topk_select per round at {label}'s calls on Gaussian rows: "
          f"kernel {sum(t[0] for t in times):.4f} ms, torch.topk "
          f"{sum(t[4] for t in times):.4f} ms", flush=True)
    return times, int8_case(ck, s4, gen, int8, comp.stochastic, label, 20,
                            device=device), int8


def time_main_path_shapes(ck, stats, template, comp, C):
    """Per-round kernel, plain, bound and library times of the codec
    kernels summed over one round's own calls (both server paths make the
    same calls)."""
    topk, int8, grids = codec_calls(ck, stats, template, comp, C,
                                    "main-path", device=True)
    for t in topk:
        stats["topk_select"].add_times(*t)
    stats["int8_quantize"].add_times(*int8)
    # the large grid alone: its share of the bound
    int8_case(ck, stats["int8_quantize"], torch.Generator(device="cuda"),
              [max(grids, key=lambda sh: sh[1] * sh[2])], comp.stochastic,
              "main-path-large-grid", 20, device=True)


def real_delta_topk(ck, stats, cfg):
    """``topk_select`` at one round's own calls on that round's deltas:
    the clients train from the global as ``phase_profile``'s round does,
    ``new_t - g`` as ``compress_stage`` forms it (the residual is zero in
    round 0), stacked by leaf width as ``encode_tree`` groups it. After
    two AdamW steps most coordinates with a gradient have moved by about
    lr to 2 lr, and the embeddings of unused tokens only by weight decay,
    so the threshold bins hold other shares of a row than on Gaussian
    rows. Held bit for bit; returns the per-round kernel and ``torch.topk``
    ms."""
    from bcfl_tpu_torch.compression import codecs as cc
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.fed.engine import FedEngine

    eng = FedEngine(cfg.replace(num_rounds=1, eval_every=0), device="cuda")
    g = eng.trainable0
    batches, _ = eng._round_batches(0)
    gens = prng.client_round_generators(cfg.seed, cfg.num_clients, 0,
                                        eng.device)
    new_t, _ = cs.train_clients(eng.local_train, g, batches, gens)
    ys = [y for _, y in cc._flat({p: new_t[p].float() - g[p].float()
                                   for p in new_t})]
    del eng, batches, new_t
    by_n = {}
    for y in ys:
        by_n.setdefault(y.shape[1], []).append(y)
    total = lib_total = 0.0
    for n, group in sorted(by_n.items()):
        x = torch.cat(group, dim=0)
        ms, _, _, _, lib = topk_case(ck, stats["topk_select"], x,
                                     leaf_k(n), "real-delta",
                                     3 if x.numel() > 1 << 24 else 10)
        total, lib_total = total + ms, lib_total + lib
        del x
    print(f"topk_select per round on one real round's deltas: kernel "
          f"{total:.4f} ms, torch.topk {lib_total:.4f} ms", flush=True)
    return total, lib_total


def add_main_path_flash(stats, per, cfg, model_cfg):
    """Per-round kernel, plain, bound and library times of the three flash
    kernels: their times at the seq-512 path's call (``per``, from the
    kernel phase: its [B, H, S, D], bf16, its padding) times the calls one
    round's training makes of each, clients x local steps x layers."""
    calls = cfg.num_clients * cfg.max_local_batches * model_cfg.num_layers
    for name, (ms, plain, bnd, by, lib) in per.items():
        stats[name].add_times(ms, plain, bnd, by, lib, calls=calls)
    return calls


# ------------------------------------------------------------ main path


def main_config(**kw):
    """bert-base at full width (vocab 30522), 4 clients, 2 local steps of
    32 x 128 tokens, the int8+topk codec at its defaults."""
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import FedConfig

    base = dict(
        name="chip-smoke-bert-base", model="bert-base", mode="server",
        num_clients=4, num_rounds=2, seq_len=128, batch_size=32,
        max_local_batches=2, dataset="synthetic", vocab_size=30522,
        compression=CompressionConfig(kind="int8+topk"))
    base.update(kw)
    return FedConfig(**base)


def flash_config(dataset: str, **kw):
    """The seq-512 path: ``main_config`` at 32 x 512 tokens of long
    documents, flash attention on, 4 evaluation batches."""
    base = dict(name="chip-smoke-bert-base-s512-flash", seq_len=512,
                use_flash=True, dataset=dataset, max_eval_batches=4)
    base.update(kw)
    return main_config(**base)


def write_long_docs(seed: int = 0, n_train: int = 2048, n_test: int = 256,
                    min_words: int = 600, name: str = "long_docs") -> str:
    """A ``csv:`` corpus of long documents under ``build/chip_smoke/``
    (``<name>_train.csv``, ``<name>_test.csv``): ``n_train`` + ``n_test``
    rows of ``min_words`` to ``min_words + 99`` words from a 200-word
    vocabulary, 2 labels, each label drawing 60% of its words from its own
    half of the vocabulary. Every document fills 512 positions by default.
    Returns the dataset spec ``csv:<train>::<test>``."""
    import numpy as np

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = np.array([f"term{i}" for i in range(200)])
    paths = []
    for split, n in (("train", n_train), ("test", n_test)):
        labels = rng.integers(0, 2, n)
        path = BUILD_DIR / f"{name}_{split}.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["text", "labels"])
            for y in labels:
                L = int(rng.integers(min_words, min_words + 100))
                own = rng.random(L) < 0.6
                idx = rng.integers(0, 100, L) + 100 * (own == bool(y))
                w.writerow([" ".join(vocab[idx]), int(y)])
        paths.append(str(path))
    return "csv:" + "::".join(paths)


def main_padding(dataset: str, cfg) -> tuple:
    """Key lengths of the seq-512 path's first batch of documents."""
    from bcfl_tpu_torch.data import get_tokenizer, load_dataset

    ds = load_dataset(dataset, num_labels=cfg.num_labels,
                      text_col=cfg.text_col, label_col=cfg.label_col)
    _, mask = get_tokenizer(cfg.tokenizer, cfg.vocab_size).encode_batch(
        ds.train_texts[:cfg.batch_size], cfg.seq_len)
    return tuple(int(n) for n in mask.sum(1))


def drive(cfg, smi, label, devices=None):
    """One main path through ``run`` (on ``devices``, the mesh's device
    list, when given) with the launch counts set to 0 just before it and
    read just after; checks its losses, parameters and bytes on the wire.
    Returns ``(result, launches, peak GB)``."""
    from bcfl_tpu_torch.compression import payload_nbytes
    from bcfl_tpu_torch.entrypoints import run
    from bcfl_tpu_torch.ops import registry

    print(smi, flush=True)
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    result = run(cfg, device=None if devices else "cuda", devices=devices)
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    harvest_dtypes()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: {wall:.2f} s incl. set-up, launches {launches}, "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    want = payload_nbytes(cfg.compression, result.trainable) * cfg.num_clients
    samples = cfg.num_clients * cfg.max_local_batches * cfg.batch_size
    for r in result.metrics.rounds:
        print(f"{label} round {r.round}: wall {r.wall_s:.3f} s, "
              f"{samples / r.wall_s:.1f} samples/s, compression ratio "
              f"{r.compression_ratio:.3f}, train_loss {r.train_loss:.5f}, "
              f"global_loss {r.global_loss}", flush=True)
        evaluated = cfg.eval_every and (
            (r.round + 1) % cfg.eval_every == 0
            or r.round == cfg.num_rounds - 1)
        if not (math.isfinite(r.train_loss) and (not evaluated or (
                r.global_loss is not None and math.isfinite(r.global_loss)))):
            raise RuntimeError(f"{label} round {r.round}: non-finite loss")
        if r.bytes_on_wire != want:
            raise RuntimeError(f"{label} round {r.round}: bytes_on_wire "
                               f"{r.bytes_on_wire} != payload_nbytes {want}")
    for p, t in result.trainable.items():
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{label}: non-finite parameter {p}")
    return result, launches, peak_gb


def count_launches(stats, launches):
    """Add one path's launch counts to the record's ``launches``: the
    record sums the main paths' counts."""
    for name, n in launches.items():
        stats[name].launches = (stats[name].launches or 0) + n


def phase_main(ck, stats, smi, dataset, flash_per):
    """Path (a), seq 128 with dense attention, then path (b), seq 512
    with flash attention; then each kernel's per-round time at path (b)'s
    calls; then path (u), path (b) at float16 compute."""
    cfg = main_config()
    _, launches, _ = drive(cfg, smi, "seq-128 path")
    for name, n in launches.items():
        ran = n > 0
        if ran != (name not in FLASH_OPS):
            raise RuntimeError(f"seq-128 path: kernel {name} launched {n} "
                               "times")
    count_launches(stats, launches)
    cfg = flash_config(dataset)
    result, launches, peak = drive(cfg, smi, "seq-512 flash path")
    count_launches(stats, launches)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} never launched on the seq-512 "
                               "path")
    layers = result.model.cfg.num_layers
    want = cfg.num_rounds * cfg.num_clients * cfg.max_local_batches * layers
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        if launches[name] != want:
            raise RuntimeError(f"{name} launched {launches[name]} times on "
                               f"the seq-512 path, not rounds x clients x "
                               f"steps x layers = {want}")
    b_path = {"launches": launches, "peak_gb": peak,
              "walls": [r.wall_s for r in result.metrics.rounds],
              "training_calls": want}
    time_main_path_shapes(ck, stats, result.trainable, cfg.compression,
                          cfg.num_clients)
    real_delta_topk(ck, stats, main_config())
    calls = add_main_path_flash(stats, flash_per, cfg, result.model.cfg)
    print(f"per-round kernel times: the codec's calls, and {calls} calls of "
          f"each flash kernel", flush=True)
    del result
    torch.cuda.empty_cache()
    path_fp16_flash(stats, smi, dataset, b_path)
    return b_path


def path_fp16_flash(stats, smi, dataset, b_path):
    """Path (u): path (b) at ``compute_dtype="float16"``, through the same
    entry point. Its losses finite, K2 and K3 exactly rounds x clients x
    steps x layers launches as on (b), K1-K5 all launched, and every flash
    launch an fp16 instance (the kernel phase held those instances at
    (u)'s own [32, 12, 512, 64] call and padding within ``FP16_PARITY``
    before this path runs); its walls and peak beside (b)'s."""
    cfg = flash_config(dataset, compute_dtype="float16")
    label = "seq-512 fp16 flash path (u)"
    result, launches, peak = drive(cfg, smi, label)
    count_launches(stats, launches)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} never launched on {label}")
    layers = result.model.cfg.num_layers
    want = cfg.num_rounds * cfg.num_clients * cfg.max_local_batches * layers
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        if launches[name] != want:
            raise RuntimeError(f"{name} launched {launches[name]} times on "
                               f"{label}, not rounds x clients x steps x "
                               f"layers = {want}")
    from bcfl_tpu_torch.ops import registry

    for op in registry.kernel_ops():
        if op.name in FLASH_OPS and op.launches_by != {
                "float16": launches[op.name]}:
            raise RuntimeError(f"{label}: {op.name} launched "
                               f"{op.launches_by}, not only its fp16 "
                               "instance")
    if not all("seq-512-path" in stats[n].by_dtype.get("float16", {})
               for n in FLASH_OPS):
        raise RuntimeError(f"{label}: the fp16 seq-512-path case was not "
                           "held")
    walls = [round(r.wall_s, 4) for r in result.metrics.rounds]
    print(f"{label}: round walls {walls} s against path (b)'s "
          f"{[round(w, 4) for w in b_path['walls']]} s; peak memory "
          f"{peak:.2f} GB against {b_path['peak_gb']:.2f} GB; launches "
          f"{launches} (path (b): {b_path['launches']})", flush=True)
    del result
    torch.cuda.empty_cache()


# --------------------------------------------------- peer-to-peer paths

#: PageRank's anomalies on the reference 10-node latency graph, the JAX
#: package's value (``tests/test_torch_topology.py`` pins it on the CPU)
PAGERANK_ANOMALIES = [0, 4, 7, 9]


def write_medical_docs(seed: int = 1, n_train: int = 5000, n_test: int = 400,
                       labels: int = 40) -> str:
    """A ``csv:`` corpus shaped like the medical-transcriptions split
    (which is not in the repository) under ``build/chip_smoke/``:
    ``n_train`` + ``n_test`` notes of 60-159 words from a 2,000-word
    vocabulary over ``labels`` specialties, each specialty drawing half its
    words from its own 50-word slice. Returns ``csv:<train>::<test>``."""
    import numpy as np

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = np.array([f"w{i}" for i in range(2000)])
    paths = []
    for split, n in (("train", n_train), ("test", n_test)):
        path = BUILD_DIR / f"medical_{split}.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["text", "labels"])
            for y in rng.integers(0, labels, n):
                L = int(rng.integers(60, 160))
                own = rng.random(L) < 0.5
                idx = np.where(own, 50 * y + rng.integers(0, 50, L),
                               rng.integers(0, 2000, L))
                w.writerow([" ".join(vocab[idx]), int(y)])
        paths.append(str(path))
    return "csv:" + "::".join(paths)


def gossip_config(dataset: str, **kw):
    """Path (c): the ``serverless_noniid_medical`` preset at its published
    shape (biobert-base widths, vocab 28,996, 10 clients, 40 labels,
    unweighted mean, ring gossip of one step at alpha 0.5, contiguous
    partition of stride 500, train 400, fixed test 400) with the
    ``int8+topk`` codec at its defaults and the ledger on; cut to 2 rounds
    of 2 local steps of 32 x 128 tokens, 4 evaluation batches."""
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import LedgerConfig
    from bcfl_tpu_torch.entrypoints.presets import get_preset

    base = dict(name="chip-smoke-serverless-noniid-medical", dataset=dataset,
                vocab_size=28996, num_rounds=2, max_local_batches=2,
                max_eval_batches=4,
                compression=CompressionConfig(kind="int8+topk"),
                ledger=LedgerConfig(enabled=True))
    base.update(kw)
    return get_preset("serverless_noniid_medical").replace(**base)


def async_config(**kw):
    """Path (d): the ``bcfl_async_pagerank`` preset as it stands
    (albert-base widths, vocab 30,000, 10 clients on the reference graph,
    buffer 4, staleness decay 0.5, PageRank gating, the ledger, IID 100
    resampled each round) with the ``int8+topk`` codec, on the synthetic
    corpus (imdb needs the hub); cut to 3 rounds of 2 local steps of 32 x
    128 tokens, 4 evaluation batches."""
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.entrypoints.presets import get_preset

    base = dict(name="chip-smoke-bcfl-async-pagerank", dataset="synthetic",
                vocab_size=30000, num_rounds=3, max_local_batches=2,
                max_eval_batches=4,
                compression=CompressionConfig(kind="int8+topk"))
    base.update(kw)
    return get_preset("bcfl_async_pagerank").replace(**base)


def check_ledger(result, label):
    """``chain_ok`` 1, every unmasked client authenticated in every round;
    prints the ledger's host time per round."""
    m = result.metrics
    if m.ledger.get("chain_ok") != 1.0:
        raise RuntimeError(f"{label}: ledger chain_ok {m.ledger}")
    for r in m.rounds:
        bad = [c for c, (a, k) in enumerate(zip(r.auth, r.mask))
               if k > 0 and a != 1.0]
        if bad:
            raise RuntimeError(f"{label} round {r.round}: clients {bad} "
                               "failed authentication in a clean round")
    ph = m.phases["ledger"]
    print(f"{label}: ledger {ph['total_s'] / len(m.rounds) * 1e3:.1f} ms per "
          f"round (fingerprint of the payload, commit and auth; "
          f"{ph['count']} calls), {len(result.ledger)} entries, "
          f"chain_ok {m.ledger['chain_ok']}", flush=True)


def fingerprint_determinism(result, cfg):
    """The ledger authenticates by recomputing fingerprint bits: the same
    payload (path (c)'s shapes, 10 clients) fingerprints to the same bits
    twice on the card, the second time from a copy."""
    from bcfl_tpu_torch.compression import encode_tree
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.ledger import client_fingerprint

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    delta = {p: torch.randn((cfg.num_clients,) + tuple(x.shape),
                            generator=gen, device="cuda") * 1e-3
             for p, x in result.trainable.items()}
    payload = encode_tree(cfg.compression, delta,
                          prng.codec_uniforms(cfg.seed, 0))
    del delta
    a = client_fingerprint(payload)
    b = client_fingerprint({p: {k: v.clone() for k, v in parts.items()}
                            for p, parts in payload.items()})
    if not held("bit-identical", [(a, b)])[0]:
        raise RuntimeError("the fingerprint of path (c)'s payload differs "
                           "between two computations on the card")
    print(f"fingerprint of a path-(c)-shaped payload ({len(payload)} leaves, "
          f"{cfg.num_clients} clients): the same bits twice", flush=True)


def phase_p2p(ck, stats, smi, dataset):
    """Path (c), serverless ring gossip, and path (d), BC-FL async, each
    with the launch counts set to 0 just before it and read just after;
    after each, K5 and K4 held to their plain versions at its calls."""
    cfg = gossip_config(dataset)
    result, launches, _ = drive(cfg, smi, "serverless gossip path")
    count_launches(stats, launches)
    for name in ("int8_quantize", "topk_select"):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} never launched on the serverless "
                               "gossip path")
    check_ledger(result, "serverless gossip path")
    fingerprint_determinism(result, cfg)
    c_walls = [r.wall_s for r in result.metrics.rounds]
    template = result.trainable
    del result
    torch.cuda.empty_cache()
    codec_calls(ck, stats, template, cfg.compression, cfg.num_clients,
                "serverless-path", device=True)
    del template
    torch.cuda.empty_cache()
    cfg = async_config()
    result, launches, _ = drive(cfg, smi, "bcfl async path")
    count_launches(stats, launches)
    for name in ("int8_quantize", "topk_select"):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} never launched on the bcfl async "
                               "path")
    check_ledger(result, "bcfl async path")
    for r in result.metrics.rounds:
        print(f"bcfl async path round {r.round}: anomalies {r.anomalies}, "
              f"staleness {r.staleness}, alpha {r.async_alpha}, info "
              f"passing sync {r.info_passing_sync_s:.4f} s async "
              f"{r.info_passing_async_s:.4f} s", flush=True)
        if r.anomalies != PAGERANK_ANOMALIES:
            raise RuntimeError(f"bcfl async path: anomalies {r.anomalies}, "
                               f"the JAX package's {PAGERANK_ANOMALIES}")
    if max(result.metrics.rounds[-1].staleness) <= 0:
        raise RuntimeError("bcfl async path: no stale client by the last "
                           "round")
    template = result.trainable
    del result
    torch.cuda.empty_cache()
    codec_calls(ck, stats, template, cfg.compression, cfg.num_clients,
                "bcfl-async-path")
    return c_walls


# ------------------------------------------- the multi-process runtime


# the depth of the resilience paths (h)-(j) and the peer paths (m)-(s):
# their models' full width (hidden 768, 12 heads, FFN 3072) on 2 of their
# 12 layers (biobert-base: 37.5 M parameters of 108.3 M). Checkpoints,
# frames, digests, host-side rules and steps all scale with it; at 12
# layers these paths took 966 of the script's 1177 s on an H100, at 4
# layers 675 of 1007 s on a slower one (PERF.md sections 5 and 7)
CUT_LAYERS = 2
#: path (o)'s depth: its SIGKILLed peer must come back (a fresh
#: interpreter and first step, 20-30 s) before the others finish their 10
#: versions, and at 2 layers they finished first on an H100
PARTITION_KILL_LAYERS = 4


def model_template(cfg):
    """``cfg``'s trainable tree on the meta device (shapes only)."""
    from bcfl_tpu_torch.models import build
    from bcfl_tpu_torch.models.convert import trainable_tree

    depth = {"num_layers": cfg.num_layers} if cfg.num_layers else {}
    with torch.device("meta"):
        return trainable_tree(build(cfg.model, num_labels=cfg.num_labels,
                                    vocab_size=cfg.vocab_size, **depth))


def dist_config(dataset: str, **kw):
    """Path (m): the ``server_noniid_medical`` preset at its published
    shape (biobert-base widths, vocab 28,996, 40 labels, 10 clients,
    contiguous partition of stride 500, train 400, fixed test 400) on the
    multi-process runtime: 5 peer processes of 2 clients each, buffered
    async with a merge on every arrival (``buffer=0``), ``int8+topk`` with
    error feedback, the ledger on; cut to ``CUT_LAYERS`` of biobert-base's
    12 layers and to 3 global versions of 2 local steps of 32 x 128
    tokens, 4 evaluation batches at the end, no checkpoints."""
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import DistConfig, LedgerConfig
    from bcfl_tpu_torch.entrypoints.presets import get_preset

    base = dict(name="chip-smoke-dist-noniid-medical", dataset=dataset,
                vocab_size=28996, num_layers=CUT_LAYERS, runtime="dist",
                sync="async", num_rounds=3, max_local_batches=2, max_eval_batches=4,
                eval_every=0,
                compression=CompressionConfig(kind="int8+topk"),
                ledger=LedgerConfig(enabled=True),
                dist=DistConfig(peers=5, buffer=0, peer_deadline_s=300.0,
                                idle_timeout_s=120.0,
                                checkpoint_every_versions=0))
    base.update(kw)
    return get_preset("server_noniid_medical").replace(**base)


def _pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q)) if xs else None


def message_stats(ordered):
    """Per message type (``update``, ``global``, ...) over a collated
    timeline: the frame bytes, header JSON bytes and send wall of each
    delivered send, and its latency from the send's start to the accepted
    receive."""
    sends, out = {}, {}
    for e in ordered:
        if e.get("ev") == "send" and e.get("ok"):
            key = (e.get("peer"), e.get("to"), e.get("msg_epoch"),
                   e.get("msg_id"))
            sends[key] = e
            row = out.setdefault(e.get("type"), {"bytes": [], "header": [],
                                                 "send_s": [],
                                                 "latency_s": []})
            row["bytes"].append(e.get("bytes"))
            row["header"].append(e.get("header_bytes"))
            row["send_s"].append(e.get("wall_s"))
        elif (e.get("ev") == "recv" and e.get("disposition") == "accepted"
              and e.get("msg_id") is not None):
            snd = sends.get((e.get("src"), e.get("peer"), e.get("msg_epoch"),
                             e.get("msg_id")))
            if snd is not None:
                out[snd.get("type")]["latency_s"].append(
                    max(e["t_wall"] - snd["t_wall"], 0.0))
    return out


def check_dist_peers(label, cfg, result, reports=None):
    """Every peer of a dist run: exit 0 at the target version with
    ``chain_ok``, no arrival failing authentication, K4 and K5 launched in
    its newest incarnation; prints one line per peer and returns the
    launch counts summed over every incarnation of every peer."""
    reports = reports or result["reports"]
    if not result["ok"]:
        raise RuntimeError(f"{label}: not every peer ended ok "
                           f"{result['returncodes']}: {result['log_tails']}")
    launches = {}
    for p in range(cfg.dist.peers):
        r = reports[p]
        rejected = sum(len(m["rejected"]) for m in r["merges"])
        bad = sum(1 for m in r["merges"] for a in m["arrivals"]
                  if 0.0 in (a.get("auth") or []))
        kl = r["kernel_launches"]
        phases = {k: (v["count"], round(v["mean_s"], 4))
                  for k, v in r["phases"].items()}
        print(f"{label} peer {p}: exit {result['returncodes'][str(p)]}, "
              f"incarnation {r['incarnation']}, local rounds "
              f"{r['local_rounds']}, merges {len(r['merges'])} (solo "
              f"{r['solo_merges']}), final_version {r['final_version']}, "
              f"chain_ok {r['chain_ok']}, chain {r['chain_len']} entries "
              f"head {r['chain_head'][:16]}, auth rejections {bad}, "
              f"rejected {rejected}, launches int8_quantize "
              f"{kl['int8_quantize']} topk_select {kl['topk_select']}, peak "
              f"{r['peak_gb']:.2f} GB, arrivals shed {r['buffer_shed']}, "
              f"dropped_by_gate {r['dropped_by_gate']}, phases (count, mean "
              f"s) {json.dumps(phases)}", flush=True)
        if r["final_version"] < cfg.num_rounds or not r["chain_ok"]:
            raise RuntimeError(f"{label} peer {p}: final_version "
                               f"{r['final_version']}, chain_ok "
                               f"{r['chain_ok']}")
        if bad:
            raise RuntimeError(f"{label} peer {p}: {bad} arrivals failed "
                               "authentication")
        for name in ("int8_quantize", "topk_select"):
            if kl[name] <= 0:
                raise RuntimeError(f"{label} peer {p}: {name} never "
                                   f"launched in incarnation "
                                   f"{r['incarnation']}")
        for rr in [r] + result["incarnation_reports"].get(p, []):
            for name, n in rr["kernel_launches"].items():
                launches[name] = launches.get(name, 0) + n
    heads = {reports[p]["chain_head"] for p in range(cfg.dist.peers)}
    if len(heads) != 1:
        raise RuntimeError(f"{label}: the chain heads differ {heads}")
    return launches


def print_dist_timeline(label, result, col, wall):
    """The collated run: merges, staleness, frames by type, latency and
    the leader's merge ms, and each peer's local round walls."""
    tl = col["timeline"]
    reports = result["reports"]
    msgs = message_stats(col["ordered"])
    rounds = {}
    for e in col["ordered"]:
        if e.get("ev") == "round":
            rounds.setdefault(e.get("peer"), []).append(e["wall_s"])
    merge_ms = [m["wall_s"] * 1e3 for m in reports[0]["merges"]]
    print(f"{label}: {wall:.2f} s wall incl. the interpreters and set-up, "
          f"{tl['merges']['count']} merges of {tl['merges']['arrivals']} "
          f"arrivals, staleness {tl['staleness']}, invariant violations "
          f"{col['invariant_violations_total']}", flush=True)
    for kind, row in sorted(msgs.items(), key=lambda kv: str(kv[0])):
        lat = row["latency_s"]
        print(f"{label} {kind} frames: {len(row['bytes'])} sent, bytes "
              f"per frame mean {sum(row['bytes']) / len(row['bytes']):.0f} "
              f"max {max(row['bytes'])}, send ms per frame mean "
              f"{sum(row['send_s']) / len(row['send_s']) * 1e3:.1f} max "
              f"{max(row['send_s']) * 1e3:.1f}, latency p50 "
              f"{_pct(lat, 50)} s p99 {_pct(lat, 99)} s", flush=True)
    lat = [x for row in msgs.values() for x in row["latency_s"]]
    print(f"{label} message latency (all types): p50 {_pct(lat, 50)} s, "
          f"p99 {_pct(lat, 99)} s over {len(lat)} messages; merge ms "
          f"per merge mean {sum(merge_ms) / max(len(merge_ms), 1):.1f} max "
          f"{max(merge_ms, default=0.0):.1f}", flush=True)
    for p, ws in sorted(rounds.items()):
        print(f"{label} peer {p} local round walls (every incarnation; the "
              f"peers share the card): {[round(w, 3) for w in ws]}",
              flush=True)
    return msgs


def collate_checked(label, result):
    from bcfl_tpu_torch.telemetry import collate

    col = collate(result["event_streams"])
    if not col["ok"]:
        raise RuntimeError(f"{label}: invariant violations "
                           f"{col['violations']}")
    tl = col["timeline"]
    if tl["merges"]["arrivals"] != tl["merges"]["unique_update_ids"]:
        raise RuntimeError(f"{label}: merge lineage {tl['merges']}")
    return col


def phase_dist(ck, stats, smi, dataset, c_walls):
    """Path (m): the multi-process runtime at full width. The peers are
    fresh interpreters started after the kernels and the native cores
    were built; each runs K4 and K5 in its own CUDA context on the one
    card. Checks every peer's exit, version, chain and K4/K5 launches,
    the auth rejections and the collated invariants; prints the
    staleness, latency, frame and merge numbers. Then K5 and K4 held to
    their plain versions at a peer's own calls (2 clients)."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.models import build
    from bcfl_tpu_torch.models.convert import trainable_tree

    cfg = dist_config(dataset)
    run_dir = BUILD_DIR / "dist_m"
    shutil.rmtree(run_dir, ignore_errors=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    # one CPU thread per peer: 5 processes share the host's 8 cores, and
    # each peer's math runs on the card (on an H100 host, with torch's
    # default intra-op pool per peer the run took 180 s and every arrival
    # merged fresh, staleness 0; with one, 107 s and 24 of 51 stale)
    result = run_dist(cfg, str(run_dir), deadline_s=360.0, device="cuda",
                      threads=1)
    wall = time.perf_counter() - t0
    launches = check_dist_peers("dist path", cfg, result)
    rejected = sum(len(m["rejected"]) for r in result["reports"].values()
                   for m in r["merges"])
    if rejected:
        raise RuntimeError(f"dist path: {rejected} updates rejected")
    count_launches(stats, launches)
    col = collate_checked("dist path", result)
    if not any(int(k) > 0 for k in col["timeline"]["staleness"]):
        raise RuntimeError(f"dist path: no stale arrival "
                           f"{col['timeline']['staleness']}")
    print_dist_timeline("dist path", result, col, wall)
    print(f"one-process 10-client round of the serverless gossip path in "
          f"this call: {[round(w, 3) for w in c_walls]}", flush=True)
    template = model_template(cfg)
    k = cfg.num_clients // cfg.dist.peers
    codec_calls(ck, stats, template, cfg.compression, k, "dist-peer")
    shutil.rmtree(run_dir, ignore_errors=True)
    return (result["reports"][0].get("final_eval") or {}).get("loss")


# ------------------------------ the runtime's fault-tolerance half


def peer_checkpoint_gb(cfg) -> float:
    """One peer checkpoint of ``cfg`` in GB: the float32 trainable tree
    and the error-feedback residual of the peer's clients."""
    k = cfg.num_clients // cfg.dist.peers
    return checkpoint_gb(cfg, stacked=False) / (1 + cfg.num_clients) * (1 + k)


def first_round_after(col, peer, pid, t_wall):
    """Seconds from ``t_wall`` to the first local round the incarnation
    ``pid`` of ``peer`` finished (its ``round`` event), or None."""
    ts = [e["t_wall"] for e in col["ordered"]
          if e.get("ev") == "round" and e.get("peer") == peer
          and e.get("pid") == pid]
    return min(ts) - t_wall if ts else None


def print_checkpoints(label, reports):
    """Each peer's checkpoint saves (this incarnation's): bytes on disk
    and seconds per save, the state's fsync and digest included."""
    for p, r in sorted(reports.items()):
        secs = [c["save_s"] for c in r["checkpoints"]]
        print(f"{label} peer {p} checkpoints: {len(secs)} saves of "
              f"{max((c['bytes'] for c in r['checkpoints']), default=0)} "
              f"bytes, save s mean {sum(secs) / max(len(secs), 1):.3f} max "
              f"{max(secs, default=0.0):.3f} each "
              f"{[round(x, 3) for x in secs]}", flush=True)


def phase_partition_kill(stats, smi, dataset):
    """Path (o): ``scripts/dist_async.py``'s proof at (m)'s full width on
    ``PARTITION_KILL_LAYERS`` of its layers. A
    partition over peers (0, 1) | (2, 3, 4) on each peer's local rounds
    2-4, checkpoints every 2 versions (the newest kept), peer 1 SIGKILLed
    once its version-2 checkpoint is committed and restarted with
    --resume, 10 versions (the leader merges about once per own round, so
    the margin covers the restarted interpreter). Gates on every gate of
    ``analyze``: all peers
    complete, a stale arrival, zero invariant violations, two distinct
    heads before the heal and a forked reconcile, the merged chain
    verifies, the heads agree after it, every chain verifies, the killed
    peer resumed; and on K4/K5 in every incarnation and the restored
    trainable and residual equal to the kept checkpoint file bit for
    bit."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.ledger.ledger import params_digest

    base = dist_config(dataset)
    cfg = base.replace(
        name="chip-smoke-dist-partition-kill", num_rounds=10,
        num_layers=PARTITION_KILL_LAYERS,
        faults=FaultPlan(partition_groups=((0, 1), (2, 3, 4)),
                         partition_rounds=(2, 3, 4)),
        dist=dataclasses.replace(base.dist, checkpoint_every_versions=2,
                                 checkpoint_keep_last=1,
                                 peer_deadline_s=420.0))
    label = "partition-kill path (o)"
    # peak on disk: each peer's kept round and one in flight, plus the
    # killed peer's hard-linked round
    check_disk(peer_checkpoint_gb(cfg) * (2 * cfg.dist.peers + 1), label)
    run_dir = CKPT_DIR / "o"
    shutil.rmtree(run_dir, ignore_errors=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    result = run_dist(cfg, str(run_dir), deadline_s=480.0, device="cuda",
                      threads=1, kill_peer=1, kill_after_version=2)
    wall = time.perf_counter() - t0
    reports = result["reports"]
    kill = result["kill"]
    if kill is None:
        raise RuntimeError(f"{label}: the kill never fired "
                           f"{result['log_tails']}")
    launches = check_dist_peers(label, cfg, result)
    col = collate_checked(label, result)
    tl = col["timeline"]
    heads = {p: (r.get("fork") or {}).get("head_before_heal")
             for p, r in reports.items() if r.get("fork")}
    rec = reports[0].get("reconcile") or {}
    gates = {
        "all_peers_completed": result["ok"] and len(reports) == 5,
        "staleness_measured_nonzero": any(
            int(k) > 0 and v > 0 for k, v in tl["staleness"].items()),
        "zero_invariant_violations": col["ok"],
        "ledger_forked_two_heads": (
            len({h for h in heads.values() if h}) >= 2
            and bool(rec.get("forked"))),
        "reconcile_merged_chain_verifies": bool(
            rec.get("chain_ok") and rec.get("segment_rejected_at") is None),
        "post_heal_heads_agree": len({r["chain_head"]
                                      for r in reports.values()}) == 1,
        "chains_verify": all(r.get("chain_ok") in (True, None)
                             for r in reports.values()),
        "killed_peer_resumed_from_checkpoint": bool(
            reports[1].get("resumed")) and reports[1]["status"] == "ok",
    }
    solo = {p: r["solo_merges"] for p, r in reports.items()}
    print(f"{label} gates: {json.dumps(gates)}", flush=True)
    print(f"{label}: heads before the heal "
          f"{ {p: (h or '')[:16] for p, h in heads.items()} }, solo merges "
          f"per peer {solo}, reconcile fork_point {rec.get('fork_point')} "
          f"merged_entries {rec.get('merged_entries')} wall_s "
          f"{rec.get('wall_s')} healed_version {rec.get('healed_version')}",
          flush=True)
    if not all(gates.values()):
        raise RuntimeError(f"{label}: gates failed {gates}")
    if not (solo[0] > 0 and solo[2] > 0):
        raise RuntimeError(f"{label}: a component committed no solo "
                           f"merge {solo}")
    # the killed incarnation launched K4/K5 too (its last report)
    dead = result["incarnation_reports"].get(1, [])
    if not dead or any(d["kernel_launches"][n] <= 0 for d in dead
                       for n in ("int8_quantize", "topk_select")):
        raise RuntimeError(f"{label}: the killed incarnation's launches "
                           f"{[d['kernel_launches'] for d in dead]}")
    print(f"{label} peer 1 launches per incarnation: "
          f"{[d['kernel_launches'] for d in dead]} then "
          f"{reports[1]['kernel_launches']}", flush=True)
    count_launches(stats, launches)
    # the resumed trainable and residual against the file it restored
    restored = reports[1]["restored"]
    if restored["version"] != kill["round"]:
        raise RuntimeError(f"{label}: restored version {restored['version']}"
                           f", the kill left round {kill['round']}")
    state = torch.load(Path(kill["kept"]) / f"round_{kill['round']:06d}"
                       / "state.pt", map_location="cpu", weights_only=True)
    for key in ("trainable", "ef_residual"):
        want = params_digest(state[key], use_native=False).hex()
        if restored[f"{key}_digest"] != want:
            raise RuntimeError(f"{label}: the restored {key} differs from "
                               f"the checkpoint file")
    del state
    back = first_round_after(col, 1, reports[1]["pid"],
                             kill["killed_at_wall"])
    print(f"{label}: peer 1 killed at {kill['killed_at_s']:.2f} s after its "
          f"round-{kill['round']} checkpoint, restored version "
          f"{restored['version']} in {restored['restore_s']:.3f} s (scrub "
          f"{restored['scrub_s']:.3f} s), trainable and residual equal to "
          f"the file bit for bit, first resumed round {back} s after the "
          "kill", flush=True)
    print_checkpoints(label, reports)
    print_dist_timeline(label, result, col, wall)
    shutil.rmtree(run_dir, ignore_errors=True)


def phase_storage_repair(stats, smi, dataset):
    """Path (p): ``tests/test_storage_faults.py``'s repair at (m)'s full
    width, cut to 5 versions: a checkpoint every version (the newest 2
    kept), quorum 0.9, peer 4 SIGKILLed at its first committed checkpoint
    (version 1), its newest meta sidecar bit-flipped while it is down and
    restarted with --resume --bootstrap; the leader tampers its first
    serve to peer 4. The updates peer 4 sent before it died can still
    fill the leader's merges up to version 3, so versions 4 and 5 are the
    ones that wait for the repaired peer. With 3 versions and a kill
    after 30 s, a leader that finished first once left peer 4 repaired
    at the target with no leader to stop it. Gates on a ``damaged``
    scrub, a refused transfer, a verified one then the adopt,
    ``repair_authenticated`` and ``no_rollback_readmission`` at 0 and no
    violation at all, every peer ok with agreeing heads, and K4/K5 in
    the repaired incarnation."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.faults import FaultPlan

    base = dist_config(dataset)
    # buffer=5 with a long timeout: the leader merges only with every
    # peer's update, so the fleet waits for the repaired peer
    cfg = base.replace(
        name="chip-smoke-dist-storage-repair", num_rounds=5,
        faults=FaultPlan(sync_tamper=((0, 4),)),
        dist=dataclasses.replace(base.dist, buffer=5,
                                 buffer_timeout_s=120.0,
                                 checkpoint_every_versions=1,
                                 checkpoint_keep_last=2, quorum_frac=0.9,
                                 suspect_after=1, peer_deadline_s=420.0))
    label = "storage-repair path (p)"
    check_disk(peer_checkpoint_gb(cfg) * 3 * cfg.dist.peers, label)
    run_dir = CKPT_DIR / "p"
    shutil.rmtree(run_dir, ignore_errors=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    result = run_dist(cfg, str(run_dir), deadline_s=480.0, device="cuda",
                      threads=1,
                      churn={"peer": 4, "cycles": 1, "period_s": 10.0,
                             "downtime_s": 2.0, "stop_after_s": 200.0,
                             "damage": ["meta_flip"], "bootstrap": True})
    wall = time.perf_counter() - t0
    reports = result["reports"]
    if not result["churn"]:
        raise RuntimeError(f"{label}: the kill never fired "
                           f"{result['log_tails']}")
    launches = check_dist_peers(label, cfg, result)
    col = collate_checked(label, result)
    evs = col["ordered"]
    r4 = reports[4]
    mine = [e for e in evs if e.get("peer") == 4 and e.get("pid") == r4["pid"]]
    scrubs = [e for e in mine if e["ev"] == "scrub"]
    verifies = [e for e in mine if e["ev"] == "state.sync.verify"]
    refusals = [e for e in mine if e["ev"] == "state.sync.refuse"]
    adopts = [e for e in mine if e["ev"] == "state.sync.adopt"]
    requests = [e for e in mine if e["ev"] == "state.sync.request"]
    gates = {
        "scrub_damaged": any(e.get("status") == "damaged" for e in scrubs),
        "tampered_transfer_refused": bool(refusals),
        "verified_then_adopted": bool(
            adopts and any(v.get("ok") and v["t_wall"] <= adopts[0]["t_wall"]
                           for v in verifies)),
        "repair_authenticated": col["invariants"]["repair_authenticated"]
        == 0,
        "no_rollback_readmission":
            col["invariants"]["no_rollback_readmission"] == 0,
        "zero_invariant_violations": col["ok"],
    }
    print(f"{label} gates: {json.dumps(gates)}; churn {result['churn']}; "
          f"refusals {[e.get('reason') for e in refusals]}, repaired "
          f"{r4['repaired']}", flush=True)
    if not all(gates.values()):
        raise RuntimeError(f"{label}: gates failed {gates}")
    count_launches(stats, launches)
    serves = [e for e in evs if e.get("ev") == "send"
              and e.get("type") == "state_sync" and e.get("ok")]
    print(f"{label}: transfer bytes {[e.get('bytes') for e in serves]}, "
          f"send s {[round(e.get('wall_s') or 0.0, 3) for e in serves]}, "
          f"sync request to adopt "
          f"{adopts[0]['t_wall'] - requests[0]['t_wall']:.3f} s, scrub "
          f"{r4['restored']['scrub_s']:.3f} s, restore "
          f"{r4['restored'].get('restore_s')} s, peer 4 launches in the "
          f"repaired incarnation {r4['kernel_launches']}", flush=True)
    print_checkpoints(label, reports)
    print_dist_timeline(label, result, col, wall)
    shutil.rmtree(run_dir, ignore_errors=True)


# ---------------------------------------- the runtime's adversarial half

BYZ_ADVERSARY = 4


def byzantine_config(dataset: str):
    """Path (q): (m)'s preset and width under ``trimmed_mean`` (trim 0.2,
    so t = 1 of 5 votes) with ``buffer=5`` (every merge wants every
    sender), per-peer reputation (quarantine longer than the run), peer 4
    adversarial at every round (``scale`` and ``digest_forge`` at 25x,
    chaos seed 11, whose draw opens with two forgeries), resource samples
    every 2 s, a checkpoint every 2 versions (the newest kept); 4
    versions (cut from the script's 8). The outlier lane weighs 1.0
    (``w_anomaly``; default 0.5): under ``int8+topk`` the ledger
    fingerprint, JAX's design, cannot see a forged 25x of the codec's per-chunk scales at fine-tuning delta
    sizes (the codes and indices dominate its float32 folds), so both
    behaviors reach the tracker only as outliers of the robust merge, and
    at 0.5 a pure outlier parks at SUSPECT (trust's fixed point 0.5)."""
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.reputation import ReputationConfig

    base = dist_config(dataset)
    return base.replace(
        name="chip-smoke-dist-byzantine", num_rounds=4,
        aggregator="trimmed_mean", aggregator_trim=0.2,
        reputation=ReputationConfig(enabled=True, quarantine_rounds=100_000,
                                    w_anomaly=1.0),
        faults=FaultPlan(seed=11, byz_peers=(BYZ_ADVERSARY,), byz_prob=1.0,
                         byz_behaviors=("scale", "digest_forge"),
                         byz_scale=25.0),
        dist=dataclasses.replace(base.dist, buffer=5, buffer_timeout_s=60.0,
                                 resource_sample_s=2.0,
                                 checkpoint_every_versions=2,
                                 checkpoint_keep_last=1,
                                 idle_timeout_s=180.0,
                                 peer_deadline_s=420.0))


def quarantine_version(ordered, adversary: int):
    """The version of the leader's quarantine verdict: the last merge
    before the first fresh ``rep.transition -> quarantined`` of the
    adversary in peer 0's stream (``scripts/dist_byzantine.py``'s
    measurement; a restored re-declaration is no verdict)."""
    last = None
    for e in ordered:
        if e.get("peer") != 0:
            continue
        if e.get("ev") == "merge":
            last = e.get("version")
        elif (e.get("ev") == "rep.transition" and e.get("scope") == "peer"
              and e.get("client") == adversary
              and e.get("to") == "quarantined"
              and e.get("from") != "restored"):
            return last
    return None


def robust_rule_at_width(smi, cfg):
    """The robust rules at (q)'s leader call: 5 float32 votes of
    ``cfg``'s trainable tree (biobert-base's width at (q)'s depth, 37.5 M
    parameters, random from the seed, vote 4 scaled 25x). Each rule is timed on the card; ``trimmed_mean``,
    the rule (q) runs, also on the host at full width, the other two on
    the host over the embeddings', first layer's and classifier's leaves.
    Each host result is held against the card's on the same leaves (the
    aggregate within one float32 ulp, distances and krum scores at rtol
    1e-9, flags and krum's pick identical). The leader runs the rules on
    its device."""
    from bcfl_tpu_torch.dist.robust import RULES, robust_merge

    template = model_template(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    votes = [{p: torch.randn(x.shape, generator=gen, device="cuda") * 1e-3
              for p, x in template.items()} for _ in range(5)]
    votes[BYZ_ADVERSARY] = {p: v * 25.0
                            for p, v in votes[BYZ_ADVERSARY].items()}
    part = [p for p in template if not p.startswith("encoder/layer_")
            or p.startswith("encoder/layer_0/")]
    w = [4.0] * 5
    width = sum(x.numel() for x in template.values())
    print(smi, flush=True)
    out = {}
    for rule in RULES:
        robust_merge(votes, w, rule)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        robust_merge(votes, w, rule)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        extra_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        keys = list(template) if rule == "trimmed_mean" else part
        sub = [{p: v[p] for p in keys} for v in votes]
        agg_d, flags_d, info_d = robust_merge(sub, w, rule)
        host = [{p: v.cpu() for p, v in vote.items()} for vote in sub]
        t0 = time.perf_counter()
        agg_h, flags_h, info_h = robust_merge(host, w, rule)
        host_s = time.perf_counter() - t0
        n = sum(template[p].numel() for p in keys)
        err = max(float((agg_d[p].cpu() - agg_h[p]).abs().max())
                  for p in keys)
        ulp_ok = all(torch.allclose(agg_d[p].cpu(), agg_h[p], rtol=2 ** -23,
                                    atol=0) for p in keys)
        same = (flags_d == flags_h
                and info_d.get("krum_selected") == info_h.get("krum_selected")
                and info_d["k"] == info_h["k"]
                and info_d.get("trim_t") == info_h.get("trim_t"))
        for key in ("distances", "krum_scores"):
            if key in info_h:
                a = torch.tensor(info_d[key], dtype=torch.float64)
                b = torch.tensor(info_h[key], dtype=torch.float64)
                same = same and torch.allclose(a, b, rtol=1e-9, atol=0)
        print(f"robust rule {rule} at (q)'s leader call (5 votes of "
              f"{width} float32): device {dev_s * 1e3:.1f} ms "
              f"(+{extra_gb:.2f} GB peak over the votes); over {n} of them "
              f"host {host_s * 1e3:.1f} ms, device vs host max |diff| "
              f"{err:.3g}, within one float32 ulp {ulp_ok}, flags "
              f"{flags_d}, krum pick {info_d.get('krum_selected')}",
              flush=True)
        if not (ulp_ok and same and flags_d[BYZ_ADVERSARY]
                and sum(flags_d) == 1):
            raise RuntimeError(f"robust rule {rule}: device {info_d} "
                               f"{flags_d} against host {info_h} {flags_h}")
        out[rule] = (dev_s, host_s, n)
        del agg_d, agg_h, sub, host
    del votes
    torch.cuda.empty_cache()
    return out


def phase_byzantine(stats, smi, dataset, m_loss):
    """Path (q): ``scripts/dist_byzantine.py``'s byzantine and resume
    legs in one run at (m)'s width (``byzantine_config``), the leader
    (peer 0) SIGKILLed once its version-2 checkpoint and meta are
    committed (past the quarantine: the merge commits its transitions
    before it checkpoints) and restarted with --resume. Gates on
    the script's gates: every peer completes; peer 4 quarantined at the
    leader within half the versions and at every follower; post-ack
    refusals; no ``no_quarantined_merge`` and no other violation over
    both leader incarnations; one head and every chain verified; the
    leader killed and resumed with its restored tracker bit for bit the
    checkpoint file's and peer 4 never readmitted; peer 4's injections
    > 0 and every honest peer's 0; ``trimmed_mean`` on the merges. And on
    K4/K5 in every incarnation, ``resource`` and ``detector.phi`` events
    in every peer's stream. Prints the verdict's version and the first
    gated merge, the leader's trust per merge, the rule's seconds per
    merge beside the merge wall, the checkpoint save and restore
    seconds, the kill-to-first-merge seconds, (m)'s lines, and the final
    loss beside (m)'s."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.reputation.lifecycle import STATE_NAMES

    cfg = byzantine_config(dataset)
    label = "byzantine path (q)"
    adv = BYZ_ADVERSARY
    # peak on disk: each peer's kept round and one in flight, plus the
    # killed leader's hard-linked round
    check_disk(peer_checkpoint_gb(cfg) * (2 * cfg.dist.peers + 1), label)
    rule_s = robust_rule_at_width(smi, cfg)
    run_dir = CKPT_DIR / "q"
    shutil.rmtree(run_dir, ignore_errors=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    result = run_dist(cfg, str(run_dir), deadline_s=480.0, device="cuda",
                      threads=1, kill_peer=0, kill_after_version=2)
    wall = time.perf_counter() - t0
    reports = result["reports"]
    kill = result["kill"]
    if kill is None:
        raise RuntimeError(f"{label}: the kill never fired "
                           f"{result['log_tails']}")
    launches = check_dist_peers(label, cfg, result)
    col = collate_checked(label, result)
    evs = col["ordered"]
    leader = reports[0]
    dead = result["incarnation_reports"].get(0, [])
    states = {p: (r.get("reputation") or {}).get("state") or []
              for p, r in reports.items()}
    byz = {p: (r.get("byzantine") or {}).get("total", 0)
           for p, r in reports.items()}
    q_at = quarantine_version(evs, adv)
    first_gated = next(
        (m["version"] for r in dead + [leader] for m in r["merges"]
         if adv in ((m.get("quorum") or {}).get("quarantined") or [])),
        None)
    restored = leader.get("restored_reputation") or {}
    bit_identical = False
    if restored and leader.get("restored_from_version") == kill["round"]:
        state = torch.load(Path(kill["kept"]) / f"round_{kill['round']:06d}"
                           / "state.pt", map_location="cpu",
                           weights_only=True)
        bit_identical = (
            restored["trust_hex"] == [float(t).hex() for t in
                                      state["rep_trust"].tolist()]
            and restored["state"] == [STATE_NAMES[int(x)]
                                      for x in state["rep_state"]]
            and restored["timer"] == [int(x) for x in state["rep_timer"]]
            and restored["quarantine_events"] == [
                int(x) for x in state["rep_quarantine_events"]])
        del state
    rules = {(m.get("robust") or {}).get("rule")
             for r in list(reports.values()) + dead for m in r["merges"]}
    streams = {p: {e["ev"] for e in evs if e.get("peer") == p}
               for p in range(cfg.dist.peers)}
    gates = {
        "completed_within_deadline": (result["ok"]
                                      and len(reports) == cfg.dist.peers),
        "adversary_injected": byz.get(adv, 0) > 0,
        "honest_peers_injected_nothing": all(
            byz.get(p, 0) == 0 for p in range(cfg.dist.peers) if p != adv),
        "adversary_quarantined_at_leader": (
            len(states[0]) > adv and states[0][adv] == "quarantined"),
        "quarantined_within_budget": (
            q_at is not None and q_at <= max(cfg.num_rounds // 2, 3)),
        "followers_inherited_quarantine": all(
            len(states[p]) > adv and states[p][adv] == "quarantined"
            for p in range(1, cfg.dist.peers)),
        "post_ack_refusals_fired": (
            (leader.get("reputation") or {}).get("quarantine_drops", 0) > 0),
        "zero_no_quarantined_merge":
            col["invariants"].get("no_quarantined_merge") == 0,
        "zero_invariant_violations": col["ok"],
        "consensus_head_verifies": (
            len({r["chain_head"] for r in reports.values()}) == 1
            and all(r.get("chain_ok") in (True, None)
                    for r in reports.values())),
        "leader_killed_and_resumed": (
            kill["restarted"] and leader.get("resumed") is True
            and leader.get("status") == "ok"),
        "restore_recorded": bool(restored),
        "tracker_restored_bit_identical": bit_identical,
        "no_readmission_of_quarantined_peer": (
            bool(restored) and restored["state"][adv] == "quarantined"
            and states[0][adv] == "quarantined"),
        "trimmed_mean_on_the_merges": "trimmed_mean" in rules,
        "k4_k5_in_every_incarnation": bool(dead) and all(
            d["kernel_launches"][n] > 0 for d in dead
            for n in ("int8_quantize", "topk_select")),
        "resource_and_phi_in_every_stream": all(
            {"resource", "detector.phi"} <= streams[p]
            for p in range(cfg.dist.peers)),
    }
    print(f"{label} gates: {json.dumps(gates)}", flush=True)
    print(f"{label}: peer {adv} quarantined at the leader's version {q_at} "
          f"(budget {max(cfg.num_rounds // 2, 3)}), first merge gated "
          f"without it {first_gated}, states per peer "
          f"{ {p: (s[adv] if len(s) > adv else None) for p, s in states.items()} }"
          f", quarantine drops at the leader "
          f"{(leader.get('reputation') or {}).get('quarantine_drops')}, "
          f"injections {byz} by behavior "
          f"{(reports[adv].get('byzantine') or {}).get('injected')}",
          flush=True)
    if not all(gates.values()):
        raise RuntimeError(f"{label}: gates failed {gates}")
    count_launches(stats, launches)
    print(f"{label} peer 0 launches per incarnation: "
          f"{[d['kernel_launches'] for d in dead]} then "
          f"{leader['kernel_launches']}", flush=True)
    for e in evs:
        if e.get("ev") == "merge" and e.get("peer") == 0:
            rb = e.get("robust") or {}
            print(f"{label} merge v{e['version']} (leader pid {e['pid']}): "
                  f"wall {e['wall_s']:.3f} s, rule {rb.get('rule')} on "
                  f"{rb.get('rule_device')} {rb.get('rule_s')} s over "
                  f"{rb.get('k')} votes, robust_degraded "
                  f"{e.get('robust_degraded')}, trust {e.get('trust')}",
                  flush=True)
    back = [e["t_wall"] for e in evs if e.get("ev") == "merge"
            and e.get("peer") == 0 and e.get("pid") == leader["pid"]]
    rr = leader["restored"]
    print(f"{label}: leader killed at {kill['killed_at_s']:.2f} s after its "
          f"round-{kill['round']} checkpoint, restored version "
          f"{rr['version']} in {rr['restore_s']:.3f} s (scrub "
          f"{rr['scrub_s']:.3f} s), tracker bit for bit the file's, first "
          f"resumed merge {min(back) - kill['killed_at_wall'] if back else None}"
          f" s after the kill; robust rule at width (device s, host s, "
          f"host parameters) "
          f"{ {k: (round(a, 4), round(b, 4), n) for k, (a, b, n) in rule_s.items()} }",
          flush=True)
    print_checkpoints(label, reports)
    print_dist_timeline(label, result, col, wall)
    loss = (leader.get("final_eval") or {}).get("loss")
    print(f"{label}: final loss {loss} beside (m)'s adversary-free "
          f"{m_loss} (printed, not gated: the mean over (m)'s versions "
          f"there, trimmed_mean with a quarantined peer over "
          f"{cfg.num_rounds} versions here)", flush=True)
    if loss is None or not math.isfinite(loss):
        raise RuntimeError(f"{label}: final loss {loss}")
    shutil.rmtree(run_dir, ignore_errors=True)


# ------------------------------- the chaos lanes and gossip dispatch

CHAOS_RESOURCE_PEER = 2
CHAOS_LIMP_PEER = 3
#: the chaos seed of path (r), chosen on the host from the plan's draws
#: (``chaos_seed_ok``): the one seed of 0-1999 meeting its conditions at
#: 4 versions (its ledger draws fault chain lengths 2 and 22 too)
CHAOS_SEED = 140


def chaos_lanes(seed: int) -> dict:
    """Path (r)'s fault-plan fields for ``seed``: ``scripts/dist_chaos.py``'s
    wire leg (drop, dup, reorder and delay 0.2, corrupt 0.05, holds of
    0.2 s, delays under 0.1 s) for the whole run; peer 3 limping (stall
    2 s at the train seam with probability 0.35, its outbound link paced
    at 64 MiB/s on the same draw rate); peer 2's durable writes and event
    flushes failing on every due counter (``resource_prob`` 1.0) of
    ``resource_rounds``: every counter whose ledger draw (and, up to 16,
    checkpoint draw) is depth 1 or 2. A depth-3 fault would exit the peer
    with the durability code, so those counters are left out."""
    from bcfl_tpu_torch.faults import FaultPlan

    lanes = dict(seed=seed, wire_drop_prob=0.2, wire_dup_prob=0.2,
                 wire_reorder_prob=0.2, wire_reorder_hold_s=0.2,
                 wire_delay_prob=0.2, wire_delay_s=0.1,
                 wire_corrupt_prob=0.05,
                 limp_peers=(CHAOS_LIMP_PEER,), limp_prob=0.35,
                 limp_stall_s=2.0, limp_oneway=True,
                 limp_throttle_bps=float(64 << 20),
                 resource_peers=(CHAOS_RESOURCE_PEER,), resource_prob=1.0)
    probe = FaultPlan(**lanes)

    def depth(seam, c):
        return probe.resource_action(seam, c, CHAOS_RESOURCE_PEER)["depth"]

    due = tuple(c for c in range(4096) if depth("ledger", c) <= 2
                and (c > 16 or depth("checkpoint", c) <= 2))
    return dict(lanes, resource_rounds=due)


def chaos_seed_ok(plan, rounds: int) -> bool:
    """The conditions path (r)'s seed meets, read off the plan's draws:
    peer 3 stalls and is paced in at least two of its first ``rounds``
    rounds; peer 2's first event flush fails; its checkpoint writes at
    versions 1..``rounds`` that are due fail at depth 1 twice or more and
    at depth 2 twice or more (so the durable ladder's both remedies run
    whichever versions it adopts)."""
    stalls = [r for r in range(rounds)
              if plan.limp_action(r, CHAOS_LIMP_PEER) is not None]
    paced = [r for r in range(rounds)
             if plan.limp_throttle(r, CHAOS_LIMP_PEER, 0) is not None]
    ck = [plan.resource_action("checkpoint", v, CHAOS_RESOURCE_PEER)
          for v in range(1, rounds + 1)]
    depths = [a["depth"] for a in ck if a is not None]
    return (len(stalls) >= 2 and len(paced) >= 2
            and plan.resource_action("events", 0,
                                     CHAOS_RESOURCE_PEER) is not None
            and depths.count(1) >= 2 and depths.count(2) >= 2)


def chaos_config(dataset: str, seed: int):
    """Path (r): (m)'s preset and width (biobert-base, vocab 28,996, 40
    labels, 5 peers of 2 clients, ``buffer=0``, ``int8+topk`` with error
    feedback, the ledger; 4 versions of 2 local steps of 32 x 128 tokens)
    under the three lanes of ``chaos_lanes(seed)``, per-peer reputation
    (so "never quarantined" is a verdict of the tracker, not of its
    absence), the detector SUSPECT on the first failed attempt
    (``suspect_after=1``, the chaos script's), and a checkpoint every
    version (the newest kept): the ledger seam's writes."""
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.reputation import ReputationConfig

    base = dist_config(dataset)
    return base.replace(
        name="chip-smoke-dist-chaos", num_rounds=4,
        reputation=ReputationConfig(enabled=True),
        faults=FaultPlan(**chaos_lanes(seed)),
        dist=dataclasses.replace(base.dist, suspect_after=1,
                                 checkpoint_every_versions=1,
                                 checkpoint_keep_last=1,
                                 idle_timeout_s=180.0,
                                 peer_deadline_s=420.0))


def check_resource_trail(label, plan, evs, peer):
    """Peer ``peer``'s ``resource.inject`` events against the plan's
    draws, each followed by its ladder rung: every event's class and depth
    are the draw's for its (seam, counter); a durable seam's write fails
    attempts 0..depth-1 in order, attempt 0 followed by ``gc.emergency``
    and attempt 1 by ``write.shed`` (or shedding already on); an events
    seam fault by the writer's own ``write.shed`` (or shedding already
    on). Returns ``{(seam, depth): count}`` of the faulted writes."""
    mine = [e for e in evs if e.get("peer") == peer]
    faults, shed_seen = {}, False
    for i, e in enumerate(mine):
        if e.get("ev") == "write.shed":
            shed_seen = True
        if e.get("ev") != "resource.inject":
            continue
        want = plan.resource_action(e["seam"], e["counter"], peer)
        if want is None or {k: e[k] for k in ("cls", "depth")} != want:
            raise RuntimeError(f"{label}: inject {e} is not the plan's "
                               f"draw {want}")
        rest = mine[i + 1:]
        if e["seam"] == "events":
            rung = next((x for x in rest if x.get("ev") == "write.shed"
                         and x.get("seam") == "events"), None)
            if rung is None and not shed_seen:
                raise RuntimeError(f"{label}: events fault {e} never shed")
            faults[("events", e["depth"])] = faults.get(
                ("events", e["depth"]), 0) + 1
            continue
        attempt = e["attempt"]
        if attempt == 0:
            faults[(e["seam"], e["depth"])] = faults.get(
                (e["seam"], e["depth"]), 0) + 1
            rung = next((x for x in rest if x.get("ev") == "gc.emergency"
                         and x.get("seam") == e["seam"]), None)
            if rung is None:
                raise RuntimeError(f"{label}: {e} not followed by the GC "
                                   "rung")
        elif attempt == 1:
            rung = next((x for x in rest if x.get("ev") == "write.shed"),
                        None)
            if rung is None and not shed_seen:
                raise RuntimeError(f"{label}: {e} not followed by the shed "
                                   "rung")
        if attempt >= e["depth"] or e["depth"] >= 3:
            raise RuntimeError(f"{label}: inject {e} past its depth")
    return faults


def phase_chaos(stats, smi, dataset):
    """Path (r): the wire, limp and resource lanes at (m)'s width
    (``chaos_config``, chaos seed ``CHAOS_SEED``, checked against the
    plan's draws before the run). Gates on ``scripts/dist_chaos.py``'s
    wire leg and the two other lanes: every peer exits 0 at version 4
    with one verified head; no invariant violation over a nonzero merge
    count; retries, duplicates dropped, CRC drops and reorder holds
    nonzero; a detector SUSPECT and back; peer 3's stall events exactly
    the plan's draws for the rounds it ran and peer 3 never quarantined;
    peer 2's ``resource.inject`` events the plan's draws, each followed by
    its rung, with ledger and event-stream faults among them and depth-1
    and depth-2 faults on its durable seams; K4 and K5 launched in every
    peer round. The ledger seam's counter is the chain length at each
    checkpoint, which the run decides, so the depths it meets print
    beside the gates. Prints the wall, the chaos counters by action, the
    paced seconds, the merge walls, (m)'s lines, and peer 2's event
    flushes."""
    from bcfl_tpu_torch.dist import run_dist

    cfg = chaos_config(dataset, CHAOS_SEED)
    plan = cfg.faults
    if not chaos_seed_ok(plan, cfg.num_rounds):
        raise RuntimeError(f"path (r): seed {CHAOS_SEED} no longer meets "
                           "chaos_seed_ok's conditions")
    label = "chaos path (r)"
    check_disk(peer_checkpoint_gb(cfg) * 2 * cfg.dist.peers, label)
    run_dir = CKPT_DIR / "r"
    shutil.rmtree(run_dir, ignore_errors=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    result = run_dist(cfg, str(run_dir), deadline_s=480.0, device="cuda",
                      threads=1)
    wall = time.perf_counter() - t0
    reports = result["reports"]
    for p, r in sorted(reports.items()):
        t = r["transport"]
        print(f"{label} peer {p}: status {r['status']}, final_version "
              f"{r['final_version']}, local rounds {r['local_rounds']}, "
              f"transport retries {t['retries']} send_failures "
              f"{t['send_failures']} dups_dropped {t['dups_dropped']} "
              f"crc_drops {t['crc_drops']} reorders_held "
              f"{t['reorders_held']} limp_paced {t['limp_paced']} "
              f"circuit_skips {t['circuit_skips']}, injected "
              f"{t['chaos_injected']}, checkpoints "
              f"{[c['version'] for c in r['checkpoints']]}, event flushes "
              f"{r.get('events_flushes')}", flush=True)
    launches = check_dist_peers(label, cfg, result)
    col = collate_checked(label, result)
    evs = col["ordered"]
    tot = {k: sum(r["transport"][k] for r in reports.values())
           for k in ("retries", "dups_dropped", "crc_drops",
                     "reorders_held", "limp_paced", "send_failures")}
    by_action = {}
    for r in reports.values():
        for k, v in r["transport"]["chaos_injected"].items():
            by_action[k] = by_action.get(k, 0) + v
    limp = [e for e in evs if e.get("ev") == "limp.inject"]
    stalls = sorted(e["round"] for e in limp if e.get("kind") == "stall")
    ran = reports[CHAOS_LIMP_PEER]["local_rounds"]
    want_stalls = [r for r in range(ran)
                   if plan.limp_action(r, CHAOS_LIMP_PEER) is not None]
    paced_s = sum(e["pace_s"] for e in limp if e.get("kind") == "throttle")
    quarantined = [e for e in evs if e.get("ev") == "rep.transition"
                   and e.get("to") == "quarantined"
                   and e.get("client") == CHAOS_LIMP_PEER]
    ledger_writes = [e["counter"] for e in evs
                     if e.get("ev") == "resource.inject"
                     and e.get("seam") == "ledger" and e.get("attempt") == 0]
    faults = check_resource_trail(label, plan, evs, CHAOS_RESOURCE_PEER)
    grow = {p: (r["local_rounds"], r["kernel_launches"]["int8_quantize"],
                r["kernel_launches"]["topk_select"])
            for p, r in reports.items()}
    gates = {
        "every_peer_exits_0": result["ok"],
        "zero_invariant_violations_nonzero_merges": (
            col["ok"] and col["timeline"]["merges"]["count"] > 0),
        "retries_nonzero": tot["retries"] > 0,
        "dups_dropped_nonzero": tot["dups_dropped"] > 0,
        "crc_drops_nonzero": tot["crc_drops"] > 0,
        "reorders_held_nonzero": tot["reorders_held"] > 0,
        "detector_suspect_roundtrip": (
            col["timeline"]["detector_suspect_roundtrips"] > 0),
        "one_verified_head": (
            len({r["chain_head"] for r in reports.values()}) == 1
            and all(r["chain_ok"] for r in reports.values())),
        "peer3_stalls_are_the_draws": stalls == want_stalls and bool(stalls),
        "peer3_never_quarantined": not quarantined and all(
            (r.get("reputation") or {}).get("state", [None] * 5)[
                CHAOS_LIMP_PEER] != "quarantined"
            for r in reports.values()),
        "ledger_faults": any(s == "ledger" for s, _ in faults),
        "event_stream_faults": any(s == "events" for s, _ in faults),
        "durable_depths_1_and_2": {1, 2} <= {
            d for s, d in faults if s in ("checkpoint", "ledger")},
        "k4_k5_every_round": all(k4 >= n and k5 >= n and n > 0
                                 for n, k4, k5 in grow.values()),
    }
    print(f"{label} gates: {json.dumps(gates)}", flush=True)
    print(f"{label}: {wall:.2f} s wall, chaos injected by action "
          f"{by_action}, transport {tot}, peer 3 stalls at rounds {stalls} "
          f"(the plan's {want_stalls}), {len([e for e in limp if e.get('kind') == 'throttle'])} "
          f"paced attempts {paced_s:.3f} s in all, peer 2 faults "
          f"{ {f'{s}/{d}': n for (s, d), n in sorted(faults.items())} }, "
          f"ledger writes faulted at counters (depth) "
          f"{[(c, plan.resource_action('ledger', c, CHAOS_RESOURCE_PEER)['depth']) for c in ledger_writes]}, "
          f"(local rounds, K4, K5 "
          f"launches) per peer {grow}", flush=True)
    if not all(gates.values()):
        raise RuntimeError(f"{label}: gates failed {gates}")
    count_launches(stats, launches)
    merges = [round(m["wall_s"], 3) for m in reports[0]["merges"]]
    print(f"{label} merge walls (s): {merges}", flush=True)
    print_checkpoints(label, reports)
    print_dist_timeline(label, result, col, wall)
    shutil.rmtree(run_dir, ignore_errors=True)


def gossip_dispatch_config(dataset: str):
    """Path (s): (m)'s preset, width and corpus under leaderless gossip
    dispatch: 5 peers of 2 clients, ``gossip_fanout=2`` on the epidemic
    topology, ``trimmed_mean`` (trim 0.2) over each peer's neighbor
    arrival set and itself, per-peer reputation, whole float32 states on
    the wire (``compress="none"``: gossip peers share no base to encode a
    delta against), the ledger, a partition (0, 1) | (2, 3, 4) on local
    rounds 2-3, 6 local rounds per peer."""
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.reputation import ReputationConfig

    base = dist_config(dataset)
    return base.replace(
        name="chip-smoke-dist-gossip", num_rounds=6,
        aggregator="trimmed_mean",
        aggregator_trim=0.2, reputation=ReputationConfig(enabled=True),
        compression=CompressionConfig(kind="none"),
        faults=FaultPlan(partition_groups=((0, 1), (2, 3, 4)),
                         partition_rounds=(2, 3)),
        dist=dataclasses.replace(base.dist, dispatch="gossip",
                                 gossip_fanout=2,
                                 gossip_topology="epidemic",
                                 idle_timeout_s=180.0,
                                 peer_deadline_s=420.0))


def gossip_merge_at_width(smi, cfg):
    """The gossip merge at (s)'s width and depth: 3 float32 states of
    ``cfg``'s trainable tree (37.5 M parameters each, drawn on the card
    from the seed) merged by
    ``merge_states`` on the card and by the same reduction in plain numpy
    float32 on the host (``acc = acc + leaf * w`` in canonical order);
    the two must be bit-identical. Times both (the card cold, then warm),
    and ``state_digest`` over one state."""
    import numpy as np

    from bcfl_tpu_torch.dist.gossip import merge_states, state_digest

    shapes = {p: tuple(x.shape) for p, x in model_template(cfg).items()}
    gen = torch.Generator(device="cuda").manual_seed(5)
    states = [{p: torch.randn(s, generator=gen, device="cuda")
               for p, s in shapes.items()} for _ in range(3)]
    host = [{p: v.cpu().numpy() for p, v in st.items()} for st in states]
    items = [{"peer": p, "order": (1, p), "vv": np.asarray([3 - p, p, 1, 0,
                                                           2], np.int64),
              "mass": 2.0 - 0.5 * p, "trust": 1.0 - 0.1 * p,
              "state": states[p]} for p in range(3)]
    card_ms = []
    for _ in range(3):  # the first call also allocates its outputs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card, _vv, weights = merge_states(items, 0.9)
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t0) * 1e3)
    wsum = sum(weights)
    norm = [np.float32(w / wsum) for w in weights]
    t0 = time.perf_counter()
    ref = {}
    for k in shapes:
        acc = host[0][k].astype(np.float32) * norm[0]
        for leaf, w in zip((host[1][k], host[2][k]), norm[1:]):
            acc = acc + leaf * w
        ref[k] = acc
    host_ms = (time.perf_counter() - t0) * 1e3
    same = all(np.array_equal(card[k].cpu().numpy().view(np.uint32),
                              ref[k].view(np.uint32)) for k in shapes)
    state = {k: card[k].cpu() for k in shapes}
    t0 = time.perf_counter()
    state_digest(state)
    digest_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(v.nbytes for v in host[0].values())
    print(smi, flush=True)
    print(f"gossip merge at (s)'s width and depth (3 float32 states, "
          f"{nbytes} bytes each): card {card_ms[0]:.3f} ms cold, "
          f"{min(card_ms[1:]):.3f} ms warm, host numpy {host_ms:.3f} ms, "
          f"bit-identical {same}; state_digest over one state "
          f"{digest_ms:.3f} ms", flush=True)
    if not same:
        raise RuntimeError("gossip merge: card and host numpy differ")


def phase_gossip(stats, smi, dataset):
    """Path (s): gossip dispatch at (m)'s width (``gossip_config``), JAX's
    ``test_gossip_partition_heal_loopback`` at full width and 5 peers.
    First the merge at width on the card against the host
    (``gossip_merge_at_width``). Gates: every peer exits 0 on its own
    clock at version 6 or past it, ``dispatch`` gossip, a verifying chain
    and its own seeded component in its fork record; no invariant
    violation, ``partition_heals_leaderless`` and the gossip scope of
    ``no_cross_partition_merge`` included; a leaderless ``fork.begin`` and
    ``fork.heal`` from every peer; a ``gossip.vote_floor`` event from the
    2-peer side; no quarantine; every final eval loss finite. Prints the
    bytes and seconds per push, the ``gossip.merge`` count and its lag
    histogram, the merge walls and the robust rule's seconds."""
    from bcfl_tpu_torch.dist import run_dist

    cfg = gossip_dispatch_config(dataset)
    label = "gossip path (s)"
    gossip_merge_at_width(smi, cfg)
    run_dir = BUILD_DIR / "dist_s"
    shutil.rmtree(run_dir, ignore_errors=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    result = run_dist(cfg, str(run_dir), deadline_s=480.0, device="cuda",
                      threads=1)
    wall = time.perf_counter() - t0
    reports = result["reports"]
    if not result["ok"]:
        raise RuntimeError(f"{label}: not every peer ended ok "
                           f"{result['returncodes']}: {result['log_tails']}")
    col = collate_checked(label, result)
    evs = col["ordered"]
    comps = {p: ([0, 1] if p in (0, 1) else [2, 3, 4]) for p in reports}
    forks = {p: {e["ev"] for e in evs if e.get("peer") == p
                 and e.get("ev") in ("fork.begin", "fork.heal")
                 and e.get("leaderless") is True} for p in reports}
    floors = [e for e in evs if e.get("ev") == "gossip.vote_floor"]
    gmerges = [e for e in evs if e.get("ev") == "gossip.merge"]
    lag = {}
    for e in gmerges:
        for a in e.get("arrivals") or []:
            lag[a["staleness"]] = lag.get(a["staleness"], 0) + 1
    losses = {p: (r.get("final_eval") or {}).get("loss")
              for p, r in reports.items()}
    gates = {
        "every_peer_exits_0": result["ok"] and len(reports) == 5,
        "versions_on_own_clock": all(
            r["final_version"] >= cfg.num_rounds
            for r in reports.values()),
        "dispatch_gossip": all(r.get("dispatch") == "gossip"
                               for r in reports.values()),
        "chains_verify": all(r["chain_ok"] for r in reports.values()),
        "own_component_in_fork": all(
            ((r.get("gossip") or {}).get("fork") or {}).get("component")
            == comps[p] for p, r in reports.items()),
        "zero_invariant_violations": col["ok"],
        "partition_heals_leaderless_checked":
            col["invariants"].get("partition_heals_leaderless") == 0,
        "no_cross_partition_merge_checked":
            col["invariants"].get("no_cross_partition_merge") == 0,
        "leaderless_fork_begin_and_heal": all(
            f == {"fork.begin", "fork.heal"} for f in forks.values()),
        "vote_floor_from_the_2_peer_side": any(
            e.get("peer") in (0, 1) for e in floors),
        "no_quarantine": not any(
            e.get("ev") == "rep.transition" and e.get("to") == "quarantined"
            for e in evs),
        "final_losses_finite": all(
            v is not None and math.isfinite(v) for v in losses.values()),
    }
    print(f"{label} gates: {json.dumps(gates)}", flush=True)
    if not all(gates.values()):
        raise RuntimeError(f"{label}: gates failed {gates}")
    for p, r in sorted(reports.items()):
        g = r["gossip"]
        print(f"{label} peer {p}: final_version {r['final_version']}, vv "
              f"{r['vv']}, exchanges {g['exchanges']}, auth rejects "
              f"{g['auth_rejects']}, chain merges {g['chain_merges']}, "
              f"chain {r['chain_len']} entries head {r['chain_head'][:16]}, "
              f"fork {g['fork']['component']}, rejoin graced "
              f"{g['rejoin_graced']}, final loss {losses[p]}, peak "
              f"{r['peak_gb']:.2f} GB, kernel launches "
              f"{r['kernel_launches']}", flush=True)
    msgs = message_stats(evs)
    for kind in ("update", "sync"):
        row = msgs.get(kind)
        if row:
            print(f"{label} {kind} pushes: {len(row['bytes'])}, bytes per "
                  f"push {sum(row['bytes']) / len(row['bytes']):.0f}, send "
                  f"s per push mean "
                  f"{sum(row['send_s']) / len(row['send_s']):.3f} max "
                  f"{max(row['send_s']):.3f}", flush=True)
    walls = [round(e["wall_s"], 3) for e in gmerges]
    rule = [round((e.get("robust") or {}).get("rule_s") or 0.0, 4)
            for e in gmerges if (e.get("robust") or {}).get("rule_s")]
    print(f"{label}: {wall:.2f} s wall incl. the interpreters and set-up, "
          f"{len(gmerges)} gossip.merge events, lag histogram "
          f"{dict(sorted(lag.items()))}, vote-floor events "
          f"{[(e['peer'], e['votes']) for e in floors]}, merge walls (s) "
          f"{walls}, robust rule s on the card {rule}", flush=True)
    for p in sorted(reports):
        rounds = [round(e["wall_s"], 3) for e in evs
                  if e.get("ev") == "round" and e.get("peer") == p]
        print(f"{label} peer {p} local round walls: {rounds}", flush=True)
    shutil.rmtree(run_dir, ignore_errors=True)


# ------------------------- LoRA adapters over the peer runtime (t)


def lora_dist_config(dataset: str):
    """Path (t): (k)'s configuration (``llama_config``: llama2-7b at full
    width, random weights from the seed, float32 frozen base, bf16
    compute, remat, 8 x 512 tokens of the long documents with causal
    flash attention, 2 local steps) with LoRA rank 8 on the peer runtime:
    2 peer processes of 2 clients each, the leadered async path merging
    when both peers' updates are in (``buffer=2``), ``int8+topk`` with
    error feedback over the adapter tree, the ledger, a checkpoint every
    version, 3 versions, the leader's final evaluation on 2 batches."""
    from bcfl_tpu_torch.config import DistConfig, LedgerConfig

    return llama_config(
        dataset, name="chip-smoke-llama2-7b-lora-dist", runtime="dist",
        sync="async", eval_every=0, lora_rank=8, num_rounds=3,
        ledger=LedgerConfig(enabled=True),
        dist=DistConfig(peers=2, buffer=2, buffer_timeout_s=60.0,
                        idle_timeout_s=240.0, peer_deadline_s=420.0,
                        checkpoint_every_versions=1))


def update_frame_overhead(cfg, template) -> tuple:
    """``(body, fixed)`` bytes of one peer's update frame: the body is the
    codec's ``payload_nbytes`` of the adapter tree for each of the peer's
    clients, ``fixed`` the frame's framing and tree index (everything but
    the header JSON, whose length the send event records), computed from
    the payload's part shapes."""
    from bcfl_tpu_torch.compression import codecs as cc
    from bcfl_tpu_torch.dist import wire

    comp = cfg.compression
    k = cfg.num_clients // cfg.dist.peers
    parts = {}
    for p, leaf in template.items():
        n = leaf.numel()
        kk = max(1, int(math.ceil(comp.topk_frac * n)))
        c = min(comp.chunk, kk)
        m = -(-kk // c)
        parts[p] = {"i": torch.empty((k, kk), dtype=torch.int32),
                    "q": torch.empty((k, m, c), dtype=torch.int8),
                    "s": torch.empty((k, m), dtype=torch.float32)}
    index = wire._tree_index(wire._flatten(parts))
    body = k * cc.payload_nbytes(comp, template)
    if body != cc.payload_tensor_nbytes(parts):
        raise RuntimeError(f"update body {body} != the parts' bytes "
                           f"{cc.payload_tensor_nbytes(parts)}")
    # prefix, header length word, tree count, then the one tree's name,
    # index and body length words
    fixed = (wire.PREFIX_LEN + 4 + 4 + 4 + len("payload") + 4 + len(index)
             + 8)
    return body, fixed


def start_monitor(run_dir: Path, health: Path, summary: Path, stop: Path):
    """The live monitor (``python -m bcfl_tpu_torch.entrypoints monitor``)
    over ``run_dir``, from the checkout's root, until ``stop`` exists."""
    return subprocess.Popen(
        [sys.executable, "-m", "bcfl_tpu_torch.entrypoints", "monitor",
         str(run_dir), "--health-out", str(health), "--summary-out",
         str(summary), "--stop-file", str(stop), "--poll", "0.5",
         "--idle", "0", "--quiet"],
        cwd=str(Path(__file__).resolve().parent),
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def stop_monitor(mon, stop: Path) -> tuple:
    """Touch the stop file and collect the monitor: ``(rc, out, err)``; a
    monitor that has not finalized 120 s later is killed and fails."""
    stop.write_text("")
    try:
        out, err = mon.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        mon.kill()
        out, err = mon.communicate()
        return None, out, err
    return mon.returncode, out, err


def phase_lora_dist(ck, stats, smi, dataset):
    """Path (t): the paper's peer-to-peer federated LLM fine-tuning, 2
    llama2-7b LoRA peers on the one card (``lora_dist_config``), watched
    live by the ``monitor`` subcommand from before the peers start until
    a stop file after the harness returns. Gates: every peer exits 0 at
    version 3 with a verifying chain and one common head; no invariant
    violation in the batch collate; the monitor exits 0 with the batch
    verdict; one ``health.jsonl`` record per merge, each with a finite
    effective rank in (0, 8]; every update and broadcast frame below 1%
    of the float32 base; each update frame exactly its header (the length
    its send event records), framing and index, and a body of the codec's
    ``payload_nbytes`` of the adapter tree for the peer's 2 clients; per
    peer, K2 and K3 once per layer of every training step, K1 at least
    twice that, K4 once and K5 at least once a peer round; a finite final
    loss; the two peers' peaks under the card's memory. Prints each
    peer's set-up (the 7B build in a fresh interpreter), round walls,
    peak, frame bytes and send ms, merge and ledger ms, checkpoint bytes
    and seconds, the effective rank per version and the monitor's lag
    from a merge event to its health record. Before the peers start, K5
    and K4 held to their plain versions at a peer's own calls."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.models import build, lora, lora_targets
    from bcfl_tpu_torch.telemetry import read_stream

    label = "llama LoRA dist path (t)"
    cfg = lora_dist_config(dataset)
    run_dir = BUILD_DIR / "dist_t"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    mon_dir = BUILD_DIR / "dist_t_monitor"
    shutil.rmtree(mon_dir, ignore_errors=True)
    mon_dir.mkdir(parents=True)
    health, summary, stop = (mon_dir / "health.jsonl",
                             mon_dir / "summary.json", mon_dir / "stop")
    with torch.device("meta"):
        model = build(cfg.model, num_labels=cfg.num_labels,
                      vocab_size=cfg.vocab_size)
    template = lora.init_lora(None, model, cfg.lora_rank,
                              lora_targets(cfg.model))
    base_bytes = sum(p.numel() * 4 for p in model.parameters())
    layers = model.cfg.num_layers
    del model
    body, fixed = update_frame_overhead(cfg, template)
    k = cfg.num_clients // cfg.dist.peers
    # K5 and K4 at a peer's own calls: the adapter leaves of 2 clients
    codec_calls(ck, stats, template, cfg.compression, k, "lora-dist-peer")
    torch.cuda.empty_cache()
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"{label}: the parent holds {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB allocated, {torch.cuda.memory_reserved() / 1e9:.3f} GB "
          f"reserved before the peers start; adapters "
          f"{lora.num_params(template)} parameters against the base's "
          f"{base_bytes // 4} ({base_bytes / 1e9:.3f} GB in float32)",
          flush=True)
    print(smi, flush=True)
    mon = start_monitor(run_dir, health, summary, stop)
    t0 = time.perf_counter()
    t0_wall = time.time()
    try:
        result = run_dist(cfg, str(run_dir), deadline_s=480.0,
                          device="cuda", threads=1)
    finally:
        mon_rc, mon_out, mon_err = stop_monitor(mon, stop)
    wall = time.perf_counter() - t0
    reports = result["reports"]
    launches = check_dist_peers(label, cfg, result)
    count_launches(stats, launches)
    col = collate_checked(label, result)
    evs = col["ordered"]
    mon_sum = (json.loads(summary.read_text()) if summary.exists()
               else {})
    merges = [e for e in evs if e.get("ev") == "merge"]
    recs = ([e for e in read_stream(str(health))[0] if e["ev"] == "health"]
            if health.exists() else [])
    msgs = message_stats(evs)
    steps = k * cfg.max_local_batches * layers
    per_peer = {}
    for p, r in sorted(reports.items()):
        kl, train = r["kernel_launches"], r["local_rounds"] * steps
        per_peer[p] = (
            kl["flash_bwd_dkv"] == train and kl["flash_bwd_dq"] == train
            and kl["flash_fwd"] >= 2 * train
            and kl["int8_quantize"] == r["local_rounds"]
            and kl["topk_select"] >= r["local_rounds"] and train > 0)
    upd = msgs.get("update", {"bytes": [], "header": []})
    updates, headers = upd["bytes"], upd["header"]
    globals_ = msgs.get("global", {"bytes": []})["bytes"]
    loss = (reports[0].get("final_eval") or {}).get("loss")
    peaks = {p: r["peak_gb"] for p, r in reports.items()}
    gates = {
        "every_peer_exits_0": result["ok"],
        "one_verified_head": len({r["chain_head"] for r in reports.values()})
        == 1 and all(r["chain_ok"] for r in reports.values()),
        "zero_invariant_violations": col["ok"],
        "monitor_exits_0": mon_rc == 0,
        "monitor_verdict_is_collate_verdict": (
            mon_sum.get("ok") == col["ok"]
            and mon_sum.get("invariants") == col["invariants"]),
        "one_health_record_per_merge": (
            [h["round"] for h in recs] == [m["version"] for m in merges]
            and len(merges) >= cfg.num_rounds),
        "effective_rank_in_0_8": bool(recs) and all(
            h.get("effective_rank") is not None
            and math.isfinite(h["effective_rank"])
            and 0.0 < h["effective_rank"] <= cfg.lora_rank for h in recs),
        "frames_below_1pct_of_base": bool(updates) and bool(globals_) and max(
            updates + globals_) < 0.01 * base_bytes,
        "update_body_is_payload_nbytes": bool(updates) and all(
            h is not None and b == h + fixed + body
            for b, h in zip(updates, headers)),
        "launch_counts_per_peer": all(per_peer.values()),
        "final_loss_finite": loss is not None and math.isfinite(loss),
        "peaks_under_the_card": sum(peaks.values()) < card_gb,
    }
    print(f"{label}: update body {body} bytes = {k} x payload_nbytes "
          f"{body // k} of the adapter tree, framing and index {fixed}, "
          f"header JSON {sorted(set(headers))}; largest frame "
          f"{max(updates + globals_, default=None)} bytes against 1% of "
          f"the base {0.01 * base_bytes:.0f}", flush=True)
    print(f"{label} gates: {json.dumps(gates)}", flush=True)
    if not all(gates.values()):
        raise RuntimeError(f"{label}: gates failed {gates}; monitor rc "
                           f"{mon_rc} {mon_out[-2000:]} {mon_err[-2000:]}")
    starts = {e["peer"]: e["t_wall"] for e in evs
              if e.get("ev") == "run.start"}
    for p, r in sorted(reports.items()):
        rounds = [round(e["wall_s"], 3) for e in evs
                  if e.get("ev") == "round" and e.get("peer") == p]
        ph = {n: round(v["mean_s"] * 1e3, 1) for n, v in r["phases"].items()}
        print(f"{label} peer {p}: set-up {starts[p] - t0_wall:.2f} s (spawn "
              f"to run.start: interpreter, 7B build and init, data), local "
              f"round walls {rounds}, peak {r['peak_gb']:.2f} GB, phase ms "
              f"(mean) {json.dumps(ph)}", flush=True)
    print(f"{label}: peaks {peaks} GB, together "
          f"{sum(peaks.values()):.2f} GB of the card's {card_gb:.2f} GB",
          flush=True)
    for kind, row in sorted(msgs.items(), key=lambda kv: str(kv[0])):
        print(f"{label} {kind} frames: {len(row['bytes'])}, bytes "
              f"{sorted(set(row['bytes']))}, send ms mean "
              f"{sum(row['send_s']) / len(row['send_s']) * 1e3:.1f} max "
              f"{max(row['send_s']) * 1e3:.1f}", flush=True)
    for m in merges:
        dec = [round(a.get("decode_s", 0.0) * 1e3, 1) for a in m["arrivals"]]
        print(f"{label} version {m['version']}: merge {m['wall_s'] * 1e3:.1f}"
              f" ms, arrivals {[a['peer'] for a in m['arrivals']]} at "
              f"staleness {[a['staleness'] for a in m['arrivals']]}, decode "
              f"ms {dec}, effective rank {m['effective_rank']:.6f}",
              flush=True)
    # the leader's prepare phase is the ledger's commit and refingerprint
    # of each arrival, its gates and its decode; less the decode, the
    # ledger's share
    prep = reports[0]["phases"]["merge.prepare"]
    decode = sum(a.get("decode_s", 0.0) for m in merges for a in m["arrivals"])
    print(f"{label}: the leader's ledger and gates "
          f"{(prep['mean_s'] * prep['count'] - decode) / len(merges) * 1e3:.1f}"
          f" ms a version (merge.prepare {prep['count']} x "
          f"{prep['mean_s'] * 1e3:.1f} ms less {decode * 1e3:.1f} ms of "
          f"decode, over {len(merges)} versions)", flush=True)
    lags = [round(h["t_mono"] - m["t_mono"], 3) for h, m in zip(recs, merges)]
    print(f"{label}: monitor lag from each merge event to its health record "
          f"(s, one host's monotonic clock; the peers flush their streams "
          f"every 2 s, the monitor polls every 0.5 s) {lags}; monitor "
          f"summary ok {mon_sum.get('ok')}, {mon_sum.get('events')} events, "
          f"alerts fired {mon_sum.get('alerts', {}).get('fired')}",
          flush=True)
    print_checkpoints(label, reports)
    print(f"{label}: {wall:.2f} s wall incl. the interpreters and set-up, "
          f"final loss {loss}, launches summed over the peers {launches}",
          flush=True)
    shutil.rmtree(run_dir, ignore_errors=True)
    shutil.rmtree(mon_dir, ignore_errors=True)


def hf_state_dict(seed: int, vocab: int = 30522, hidden: int = 768,
                  layers: int = 12, inter: int = 3072, labels: int = 2):
    """A ``BertForSequenceClassification``-layout state dict at bert-base
    width (the HF key names and ``[out, in]`` weights), drawn from the
    seed; the card's machine has no ``transformers``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.02

    sd = {"bert.embeddings.word_embeddings.weight": w(vocab, hidden),
          "bert.embeddings.position_embeddings.weight": w(512, hidden),
          "bert.embeddings.token_type_embeddings.weight": w(2, hidden),
          "bert.embeddings.LayerNorm.weight": 1.0 + w(hidden),
          "bert.embeddings.LayerNorm.bias": w(hidden),
          "bert.pooler.dense.weight": w(hidden, hidden),
          "bert.pooler.dense.bias": w(hidden),
          "classifier.weight": w(labels, hidden),
          "classifier.bias": w(labels)}
    for i in range(layers):
        p = f"bert.encoder.layer.{i}"
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            sd[f"{p}.{name}.weight"] = w(hidden, hidden)
            sd[f"{p}.{name}.bias"] = w(hidden)
        sd[f"{p}.intermediate.dense.weight"] = w(inter, hidden)
        sd[f"{p}.intermediate.dense.bias"] = w(inter)
        sd[f"{p}.output.dense.weight"] = w(hidden, inter)
        sd[f"{p}.output.dense.bias"] = w(hidden)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{name}.weight"] = 1.0 + w(hidden)
            sd[f"{p}.{name}.bias"] = w(hidden)
    return sd


#: HF BERT module names -> the port's (an independent statement of the
#: mapping ``hf_import`` implements; both keep HF's [out, in] weights)
HF_TO_PORT = (
    ("embeddings.word_embeddings", "encoder.embeddings.word"),
    ("embeddings.position_embeddings", "encoder.embeddings.position"),
    ("embeddings.token_type_embeddings", "encoder.embeddings.type"),
    ("embeddings.LayerNorm", "encoder.embeddings.norm"),
    ("attention.self.", "attention."),
    ("attention.output.dense", "attention.out"),
    ("attention.output.LayerNorm", "attention_norm"),
    ("intermediate.dense", "mlp_in"),
    ("output.dense", "mlp_out"),
    ("output.LayerNorm", "mlp_norm"),
    ("pooler.dense", "pooler"),
)


def hf_to_port_name(key: str) -> str:
    name = re.sub(r"encoder\.layer\.(\d+)\.", r"encoder.layer_\1.",
                  key.removeprefix("bert."))
    for hf, port in HF_TO_PORT:
        name = name.replace(hf, port)
    return name


def phase_hf(smi):
    """Path (n): an HF checkpoint at bert-base width imported into the
    port's model (``import_state_dict`` + ``load_into``), every imported
    parameter equal to the written one (transposed back to HF's layout),
    then one (a)-shaped server round from it with K4 and K5, the launch
    counts set to 0 just before it and read just after."""
    from bcfl_tpu_torch.fed.engine import FedEngine
    from bcfl_tpu_torch.models.bert import EncoderConfig
    from bcfl_tpu_torch.models.convert import trainable_tree
    from bcfl_tpu_torch.models.hf_import import import_state_dict, load_into
    from bcfl_tpu_torch.ops import registry

    sd = hf_state_dict(seed=7)
    hf_cfg = EncoderConfig(vocab_size=30522, hidden_size=768, num_layers=12,
                           num_heads=12, intermediate_size=3072,
                           num_labels=2)
    cfg = main_config(name="chip-smoke-hf-import", num_rounds=1)
    eng = FedEngine(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = import_state_dict(sd, hf_cfg)["params"]
    load_into(eng.model, params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = dict(eng.model.named_parameters())
    bad = []
    for k, v in sd.items():
        name = hf_to_port_name(k)
        if name not in got or not torch.equal(got[name].detach(), v):
            bad.append(name)
    if bad or len(sd) != len(got):
        raise RuntimeError(f"HF import: {len(bad)} leaves differ from the "
                           f"written ones ({bad[:4]}), {len(sd)} written, "
                           f"{len(got)} in the model")
    print(f"HF import path: {len(sd)} HF leaves at bert-base width imported "
          f"in {secs:.3f} s, every leaf equal to the written one", flush=True)
    eng.trainable0 = trainable_tree(eng.model)
    print(smi, flush=True)
    registry.reset_launches()
    t0 = time.perf_counter()
    result = eng.run()
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    r = result.metrics.rounds[0]
    print(f"HF import path: one 4-client server round from the imported "
          f"weights in {time.perf_counter() - t0:.2f} s (round wall "
          f"{r.wall_s:.3f} s, train_loss {r.train_loss:.5f}, global_loss "
          f"{r.global_loss}), launches {launches}", flush=True)
    for name in ("int8_quantize", "topk_select"):
        if launches[name] <= 0:
            raise RuntimeError(f"HF import path: {name} never launched")
    if not (math.isfinite(r.train_loss) and math.isfinite(r.global_loss)):
        raise RuntimeError("HF import path: non-finite loss")
    return launches


def native_status():
    """The native C++ cores (ledger SHA-256, tokenizer) built and loaded;
    the card's machine has g++, so the Python fallback is a failure."""
    from bcfl_tpu_torch import native

    st = native.status()
    print(f"native cores: {json.dumps(st)}", flush=True)
    bad = {k: v for k, v in st.items() if v != "native"}
    if bad:
        raise RuntimeError(f"native core(s) not loaded: {bad}")


# ----------------------------------------------------- run surface paths


def sweep_config(**kw):
    """Path (e): the ``serverless_cancer_biobert`` preset as published
    (biobert-base widths, vocab 28,996, 41 labels, serverless ring gossip,
    unweighted, IID 500 resampled each round, no codec) on the ``cancer``
    stand-in (the hub is unreachable); cut to 2 rounds of 2 local steps of
    32 x 128 tokens, 4 evaluation batches. ``run_sweep`` sets the client
    count."""
    from bcfl_tpu_torch.entrypoints.presets import get_preset

    base = dict(name="chip-smoke-sweep-cancer-biobert", vocab_size=28996,
                num_rounds=2, max_local_batches=2, max_eval_batches=4)
    base.update(kw)
    return get_preset("serverless_cancer_biobert").replace(**base)


def faithful_config(**kw):
    """Path (f): the ``serverless_noniid_imdb`` preset at albert-base's
    widths (vocab 30,000, 10 clients, contiguous 300 / 240 / 60 trailing,
    unweighted) on the ``imdb`` stand-in, in the reference's own faithful
    semantics with the ledger on; cut to 2 rounds of 2 local steps of
    32 x 128 tokens, 4 evaluation batches."""
    from bcfl_tpu_torch.config import LedgerConfig
    from bcfl_tpu_torch.entrypoints.presets import get_preset

    base = dict(name="chip-smoke-faithful-noniid-imdb", vocab_size=30000,
                num_rounds=2, max_local_batches=2, max_eval_batches=4,
                faithful=True, ledger=LedgerConfig(enabled=True))
    base.update(kw)
    return get_preset("serverless_noniid_imdb").replace(**base)


def lowp_config(dataset: str):
    """Path (g): path (b)'s configuration under the memory switches:
    per-layer remat, bf16 parameters, SGD with the global norm clipped at
    1.0."""
    return flash_config(dataset, name="chip-smoke-bert-base-s512-remat-bf16",
                        remat=True, param_dtype="bfloat16", optimizer="sgd",
                        max_grad_norm=1.0)


def check_finite(result, label):
    """Every round's losses and every final parameter are finite."""
    for r in result.metrics.rounds:
        if not math.isfinite(r.train_loss) or (
                r.global_loss is not None and not math.isfinite(r.global_loss)):
            raise RuntimeError(f"{label} round {r.round}: non-finite loss")
    for p, t in result.trainable.items():
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{label}: non-finite parameter {p}")


def path_sweep(smi):
    """Path (e): ``run_sweep`` over ``SWEEP_CLIENTS``, one count per call
    so the peak memory resets before each; prints per count the round
    walls, samples/s, ``resources``, the peak and the final accuracy, then
    the record ``<name>_sweep.json`` would hold. Dense attention and no
    codec: no kernel may launch."""
    import types
    import warnings

    from bcfl_tpu_torch.data import load_dataset
    from bcfl_tpu_torch.entrypoints.presets import SWEEP_CLIENTS
    from bcfl_tpu_torch.entrypoints.run import run_sweep, sweep_record
    from bcfl_tpu_torch.ops import registry

    cfg = sweep_config()
    label = "worker sweep path"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        name = load_dataset(cfg.dataset, num_labels=cfg.num_labels,
                            text_col=cfg.text_col,
                            label_col=cfg.label_col).name
    if not name.endswith(":synthetic-standin"):
        raise RuntimeError(f"{label}: dataset {name!r} is not the stand-in")
    print(f"{label}: dataset {name} ({caught[0].message if caught else ''})",
          flush=True)
    results = {}
    for n in SWEEP_CLIENTS:
        print(smi, flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = run_sweep(cfg, [n], device="cuda", out_dir=None)[n]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = registry.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not any("synthetic stand-in" in str(w.message) for w in caught):
            raise RuntimeError(f"{label} c{n}: the run did not take the "
                               "stand-in")
        if any(launches.values()):
            raise RuntimeError(f"{label} c{n}: kernels launched {launches} "
                               "on a dense, uncompressed path")
        check_finite(res, f"{label} c{n}")
        samples = n * cfg.max_local_batches * cfg.batch_size
        walls = [r.wall_s for r in res.metrics.rounds]
        acc = res.metrics.global_accuracies
        print(f"{label} c{n}: {wall:.2f} s incl. set-up, round walls "
              f"{[round(w, 4) for w in walls]} s, samples/s "
              f"{[round(samples / w, 1) for w in walls]}, resources "
              f"{json.dumps(res.metrics.resources)}, peak memory "
              f"{peak:.2f} GB, final accuracy {acc[-1]:.4f}, launches "
              f"{launches}", flush=True)
        results[n] = types.SimpleNamespace(metrics=res.metrics)
        del res
    print(f"{label} record: {json.dumps(sweep_record(cfg, results))}",
          flush=True)
    torch.cuda.empty_cache()


def path_faithful(stats, smi):
    """Path (f): the faithful serverless round at albert-base width with
    the ledger: ``chain_ok`` 1, every unmasked client authenticated, one
    auth row per snapshot, no codec kernel launched."""
    cfg = faithful_config()
    label = "faithful serverless path"
    result, launches, _ = drive(cfg, smi, label)
    count_launches(stats, launches)
    if any(launches.values()):
        raise RuntimeError(f"{label}: kernels launched {launches} on a "
                           "dense, uncompressed path")
    for r in result.metrics.rounds:
        if r.auth is None or len(r.auth) != cfg.num_clients:
            raise RuntimeError(f"{label} round {r.round}: auth {r.auth}, not "
                               f"one row per snapshot")
    if len(result.ledger) != cfg.num_clients * cfg.num_rounds:
        raise RuntimeError(f"{label}: {len(result.ledger)} ledger entries")
    check_ledger(result, label)
    del result
    torch.cuda.empty_cache()


def capture_flash_call(result, dataset, cfg):
    """q, k, v and the key bias of the first flash call one training
    forward of path (g)'s model makes on its corpus (bf16 params, bf16
    compute, under remat), with a random dO."""
    import bcfl_tpu_torch.models.bert as bert
    from bcfl_tpu_torch.data import get_tokenizer, load_dataset

    ds = load_dataset(dataset, num_labels=cfg.num_labels,
                      text_col=cfg.text_col, label_col=cfg.label_col)
    ids, mask = get_tokenizer(cfg.tokenizer, cfg.vocab_size).encode_batch(
        ds.train_texts[:cfg.batch_size], cfg.seq_len)
    seen = []
    real = bert.flash_attention

    def spy(q, k, v, bias=None, causal=False):
        if not seen:
            seen.append((q.detach(), k.detach(), v.detach(), bias))
        return real(q, k, v, bias, causal)

    bert.flash_attention = spy
    try:
        model = result.model
        model.train()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        model(torch.as_tensor(ids, device="cuda").long(),
              torch.as_tensor(mask, device="cuda"), deterministic=False,
              generator=gen).float().sum().backward()
    finally:
        bert.flash_attention = real
    q, k, v, bias = seen[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    return q, k, v, do, bias[:, 0, 0, :].float().contiguous()


def path_lowp(ck, fk, stats, smi, dataset, b_path):
    """Path (g): path (b) with remat, bf16 params, SGD and clipping. K2 and
    K3 launch as on (b), K1 once more per training call (the recompute),
    K4 and K5 as on (b); then K1-K3 held to their plain versions on the
    tensors of (g)'s own first flash call, and K5/K4 at (g)'s codec
    calls."""
    cfg = lowp_config(dataset)
    label = "low-precision remat path"
    result, launches, peak = drive(cfg, smi, label)
    count_launches(stats, launches)
    train = b_path["training_calls"]
    bl = b_path["launches"]
    want = {"flash_bwd_dkv": train, "flash_bwd_dq": train,
            "flash_fwd": bl["flash_fwd"] + train,
            "int8_quantize": bl["int8_quantize"],
            "topk_select": bl["topk_select"]}
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, expected {want} "
                           f"(path (b): {bl}, training calls {train})")
    for p, t in result.trainable.items():
        if t.dtype != torch.bfloat16:
            raise RuntimeError(f"{label}: {p} is {t.dtype}, not bfloat16")
    walls = [r.wall_s for r in result.metrics.rounds]
    print(f"{label}: peak memory {peak:.2f} GB against path (b)'s "
          f"{b_path['peak_gb']:.2f} GB; round walls "
          f"{[round(w, 4) for w in walls]} s against path (b)'s "
          f"{[round(w, 4) for w in b_path['walls']]} s; K1 {want['flash_fwd']}"
          f" launches = path (b)'s {bl['flash_fwd']} + {train} recomputes",
          flush=True)
    q, k, v, do, bias = capture_flash_call(result, dataset, cfg)
    flash_hold(fk, stats, "remat-bf16-path", q, k, v, do, bias, False, 20)
    template = result.trainable
    del result, q, k, v, do, bias
    torch.cuda.empty_cache()
    codec_calls(ck, stats, template, cfg.compression, cfg.num_clients,
                "remat-bf16-path")
    del template
    torch.cuda.empty_cache()


def phase_run_surface(ck, fk, stats, smi, dataset, b_path):
    """Paths (e) worker sweep, (f) faithful serverless and (g) path (b)
    under the memory switches, each with the launch counts set to 0 just
    before it and read just after."""
    path_sweep(smi)
    path_faithful(stats, smi)
    path_lowp(ck, fk, stats, smi, dataset, b_path)


# ------------------------------------------------------ resilience paths

CKPT_DIR = BUILD_DIR / "checkpoints"
#: the chaos matrix of ``tests/test_reputation.py``'s composition case
CHAOS_MATRIX = dict(
    seed=11, partition_groups=((0, 1), (2, 3)), partition_rounds=(1, 2),
    churn_leave=((2, 4),), churn_join=((3, 1),), flaky_clients=(1,),
    flaky_burst_len=2, flaky_on_prob=1.0)
#: the records a resumed run must repeat bit for bit
RESUME_FIELDS = ("train_loss", "train_acc", "auth", "mask", "partition",
                 "healed", "churn_alive", "dropped", "reputation_state",
                 "reputation_trust", "global_loss", "global_acc")


def checkpoint_gb(cfg, stacked: bool) -> float:
    """Reckoned size of one checkpoint of ``cfg`` in GB: the float32
    trainable tree, plus the clients' error-feedback residual under a
    codec, plus the stacked per-client view where one is carried."""
    from bcfl_tpu_torch.models import build

    depth = {"num_layers": cfg.num_layers} if cfg.num_layers else {}
    with torch.device("meta"):
        model = build(cfg.model, num_labels=cfg.num_labels,
                      vocab_size=cfg.vocab_size, **depth)
    tree = 4 * sum(p.numel() for p in model.parameters())
    copies = 1 + (cfg.num_clients if cfg.compression.enabled else 0) + (
        cfg.num_clients if stacked else 0)
    return tree * copies / 1e9


def check_disk(need_gb: float, label: str) -> None:
    """Fail, with the numbers, unless the checkpoint disk holds twice what
    the path writes."""
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_DIR).free / 1e9
    print(f"{label}: writes about {need_gb:.2f} GB of checkpoints, "
          f"{free:.1f} GB free under {CKPT_DIR}", flush=True)
    if free < 2 * need_gb:
        raise RuntimeError(f"{label}: {free:.1f} GB free, the path needs "
                           f"twice its {need_gb:.2f} GB")


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def crash_and_resume(cfg, smi, label):
    """The crashed run (its records kept as they stream) through
    ``FedEngine.run``, which must raise ``SimulatedCrash`` at the plan's
    round, then ``run(cfg, resume=True)``; the launch counts are set to 0
    just before the pair and read just after. Returns ``(records before
    the crash, resumed result, launches, peak GB, crashed run's
    checkpoint phase)``."""
    from bcfl_tpu_torch.entrypoints import run
    from bcfl_tpu_torch.faults import SimulatedCrash
    from bcfl_tpu_torch.fed.engine import FedEngine
    from bcfl_tpu_torch.ops import registry

    print(smi, flush=True)
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    recs = []
    eng = FedEngine(cfg, device="cuda")
    try:
        eng.run(on_round=recs.append)
    except SimulatedCrash as e:
        if e.round != cfg.faults.crash_at_round:
            raise RuntimeError(f"{label}: crashed at round {e.round}, the "
                               f"plan says {cfg.faults.crash_at_round}")
    else:
        raise RuntimeError(f"{label}: the plan's crash never fired")
    saved = eng.clock.summary().get("checkpoint")
    del eng
    torch.cuda.empty_cache()
    resumed = run(cfg, device="cuda", resume=True)
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    harvest_dtypes()
    peak = torch.cuda.max_memory_allocated() / 1e9
    return recs, resumed, launches, peak, saved


def check_same_run(label, ref, before, resumed) -> None:
    """The crashed run's records followed by the resumed run's equal the
    uninterrupted run's bit for bit, and so do the final trainable tree,
    the error-feedback residual, the ledger (head and entries) and the
    reputation rollup."""
    recs = before + resumed.metrics.rounds
    if [r.round for r in recs] != [r.round for r in ref.metrics.rounds]:
        raise RuntimeError(f"{label}: rounds {[r.round for r in recs]}")
    for a, b in zip(ref.metrics.rounds, recs):
        for f in RESUME_FIELDS:
            if getattr(a, f) != getattr(b, f):
                raise RuntimeError(f"{label} round {a.round}: {f} "
                                   f"{getattr(b, f)} resumed, "
                                   f"{getattr(a, f)} uninterrupted")
    for name, x, y in (("trainable", ref.trainable, resumed.trainable),
                       ("ef_residual", ref.ef_residual, resumed.ef_residual)):
        if (x is None) != (y is None) or (x is not None and any(
                not torch.equal(x[p], y[p]) for p in x)):
            raise RuntimeError(f"{label}: the resumed {name} differs from "
                               "the uninterrupted run's")
    if ref.ledger is not None and (
            ref.ledger.head != resumed.ledger.head
            or ref.ledger.to_json() != resumed.ledger.to_json()):
        raise RuntimeError(f"{label}: the resumed ledger differs")
    if ref.metrics.reputation != resumed.metrics.reputation:
        raise RuntimeError(f"{label}: reputation {resumed.metrics.reputation}"
                           f" resumed, {ref.metrics.reputation} uninterrupted")


def report_checkpoints(label, ckdir, saved, resumed) -> None:
    ph = resumed.metrics.phases
    both = [x for x in (saved, ph.get("checkpoint")) if x]
    n = sum(x["count"] for x in both)
    total = sum(x["total_s"] for x in both)
    print(f"{label}: {n} checkpoints saved in {total:.3f} s "
          f"({total / max(n, 1):.3f} s each, digest and fsync included), "
          f"restore {ph['restore']['total_s']:.3f} s, "
          f"{dir_bytes(ckdir) / 1e9:.3f} GB on disk in "
          f"{sorted(p.name for p in ckdir.iterdir())}", flush=True)


def path_crash_resume(stats, smi, dataset):
    """Path (h): path (b) (bert-base's width, seq 512, flash, ``int8+topk``,
    server FedAvg) on ``CUT_LAYERS`` layers with the ledger, 2 rounds (cut
    from 3 to keep the script's call short): uninterrupted, then checkpointed every round with the
    plan's crash at round 1 and resumed from round 0;
    bit for bit, and the crash + resume pair launches each kernel as often
    as the uninterrupted run."""
    from bcfl_tpu_torch.config import LedgerConfig
    from bcfl_tpu_torch.faults import FaultPlan

    label = "crash-resume path"
    ref_cfg = flash_config(dataset, name="chip-smoke-crash-resume-s512",
                           num_layers=CUT_LAYERS, num_rounds=2,
                           ledger=LedgerConfig(enabled=True))
    ckdir = CKPT_DIR / "h"
    shutil.rmtree(ckdir, ignore_errors=True)
    cfg = ref_cfg.replace(checkpoint_dir=str(ckdir), checkpoint_every=1,
                          faults=FaultPlan(crash_at_round=1))
    check_disk(2 * checkpoint_gb(cfg, stacked=False), label)
    try:
        ref, ref_launches, ref_peak = drive(ref_cfg, smi,
                                            f"{label} (uninterrupted)")
        count_launches(stats, ref_launches)
        before, resumed, launches, peak, saved = crash_and_resume(
            cfg, smi, label)
        count_launches(stats, launches)
        if launches != ref_launches or min(launches.values()) <= 0:
            raise RuntimeError(f"{label}: crash + resume launched {launches}"
                               f", the uninterrupted run {ref_launches}")
        check_same_run(label, ref, before, resumed)
        report_checkpoints(label, ckdir, saved, resumed)
        walls = [r.wall_s for r in before + resumed.metrics.rounds]
        print(f"{label}: resumed bit for bit (trainable, error feedback, "
              f"ledger head and {len(resumed.ledger)} entries, every "
              f"round's losses and auth); launches {launches}; round walls "
              f"{[round(w, 4) for w in walls]} s; peak memory {peak:.2f} GB "
              f"(uninterrupted {ref_peak:.2f} GB)", flush=True)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def path_chaos_matrix(stats, smi):
    """Path (i): ``tests/test_reputation.py``'s composition case at
    bert-base width on ``CUT_LAYERS`` layers and seq 128: server, 4
    clients, 5 rounds,
    ``trimmed_mean``, ``int8+topk``, the ledger, reputation (quarantine 2
    rounds), the partition of rounds 1-2, churn and a flaky client;
    uninterrupted, then checkpointed every 2 rounds with the crash at
    round 3, resumed from round 1's checkpoint (the stacked per-component
    view) mid-partition: it reruns round 2, heals in round 3, runs round
    4, bit for bit with the reputation arrays."""
    from bcfl_tpu_torch.config import LedgerConfig
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.reputation import ReputationConfig

    label = "chaos-matrix path"
    ref_cfg = main_config(
        name="chip-smoke-chaos-matrix", num_layers=CUT_LAYERS,
        num_rounds=5, eval_every=0,
        aggregator="trimmed_mean", ledger=LedgerConfig(enabled=True),
        reputation=ReputationConfig(enabled=True, quarantine_rounds=2),
        faults=FaultPlan(**CHAOS_MATRIX))
    ckdir = CKPT_DIR / "i"
    shutil.rmtree(ckdir, ignore_errors=True)
    cfg = ref_cfg.replace(checkpoint_dir=str(ckdir), checkpoint_every=2,
                          faults=FaultPlan(crash_at_round=3, **CHAOS_MATRIX))
    check_disk(checkpoint_gb(cfg, stacked=True)
               + checkpoint_gb(cfg, stacked=False), label)
    try:
        ref, ref_launches, ref_peak = drive(ref_cfg, smi,
                                            f"{label} (uninterrupted)")
        count_launches(stats, ref_launches)
        recs = ref.metrics.rounds
        fired = {
            "partition": any(r.partition for r in recs),
            "auth 0": any(r.auth and 0.0 in r.auth for r in recs),
            "quarantine": ref.metrics.reputation.get(
                "total_quarantine_events", 0) >= 1,
            "healed in round 3": recs[3].healed,
        }
        if not all(fired.values()):
            raise RuntimeError(f"{label}: lanes fired {fired}")
        before, resumed, launches, peak, saved = crash_and_resume(
            cfg, smi, label)
        count_launches(stats, launches)
        if [r.round for r in before] != [0, 1, 2] or [
                r.round for r in resumed.metrics.rounds] != [2, 3, 4]:
            raise RuntimeError(f"{label}: crashed run rounds "
                               f"{[r.round for r in before]}, resumed "
                               f"{[r.round for r in resumed.metrics.rounds]}")
        check_same_run(label, ref, before[:2], resumed)
        if before[2].train_loss != recs[2].train_loss:
            raise RuntimeError(f"{label}: the crashed run's round 2 differs")
        report_checkpoints(label, ckdir, saved, resumed)
        for r in recs:
            print(f"{label} round {r.round}: wall {r.wall_s:.3f} s, mask "
                  f"{r.mask}, auth {r.auth}, partition {r.partition}, "
                  f"healed {r.healed}, reputation {r.reputation_state}",
                  flush=True)
        print(f"{label}: lanes fired {fired}; resumed bit for bit "
              f"(reputation {resumed.metrics.reputation}); launches "
              f"{launches} (uninterrupted {ref_launches}); peak memory "
              f"{peak:.2f} GB (uninterrupted {ref_peak:.2f} GB)", flush=True)
        for name in ("int8_quantize", "topk_select"):
            if launches[name] <= 0 or ref_launches[name] <= 0:
                raise RuntimeError(f"{name} never launched on the {label}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


ROBUST_RULES = ("trimmed_mean", "median", "krum")
#: clients whose updates path (j) corrupts in flight
FLAKY = (1, 7)


def robust_config(rule: str):
    """Path (j): path (a) (bert-base's width on ``CUT_LAYERS`` layers, seq
    128, ``int8+topk``, server) at 10 clients, the ledger off so corrupted updates reach the aggregator;
    clients 1 and 7 flaky (``flaky_on_prob`` 1, scale 1e6), the rule at
    trim 0.2 (trimmed_mean: t = 2; krum: f = 2, m = 6, k >= 2f + 3)."""
    from bcfl_tpu_torch.faults import FaultPlan

    return main_config(name=f"chip-smoke-robust-{rule}",
                       num_layers=CUT_LAYERS, num_clients=10,
                       aggregator=rule, aggregator_trim=0.2,
                       faults=FaultPlan(flaky_clients=FLAKY,
                                        flaky_on_prob=1.0, flaky_scale=1e6))


def capture_first_aggregation(store):
    """Wrap the engine's aggregator so its first call's inputs (the
    stacked reconstruction of round 0, the weights and the fallback) are
    copied to the host into ``store``."""
    from bcfl_tpu_torch.fed import engine as eng_mod

    make = eng_mod.make_aggregator

    def wrapped(name, trim=0.2, **kw):
        agg = make(name, trim, **kw)

        def call(tree, w, fb):
            if not store:
                store.update(tree={p: x.cpu() for p, x in tree.items()},
                             w=w.cpu(), fb={p: x.cpu() for p, x in fb.items()},
                             agg=agg)
            return agg(tree, w, fb)

        return call

    return make, wrapped


def hold_robust_rule(rule, store, label):
    """On the captured round-0 reconstruction: the corruption landed on
    the flaky clients only, the card's aggregate lies inside the clean
    clients' range and equals the same function on the CPU (median bit for
    bit, trimmed_mean to rtol 1e-6, krum the same client and then bit for
    bit); returns the card's ms per call."""
    tree, w, fb, agg = store["tree"], store["w"], store["fb"], store["agg"]
    clean = [c for c in range(w.shape[0]) if c not in FLAKY]
    off = {c: max(float((x[c] - fb[p]).abs().max()) for p, x in tree.items())
           for c in range(w.shape[0])}
    if min(off[c] for c in FLAKY) < 1e5 or max(off[c] for c in clean) > 1e3:
        raise RuntimeError(f"{label}: reconstructions off the global by "
                           f"{off}; the flaky clients must be >= 1e5")
    on = {p: x.cuda() for p, x in tree.items()}
    w_on, fb_on = w.cuda(), {p: x.cuda() for p, x in fb.items()}
    card = agg(on, w_on, fb_on)
    ms = time_ms(lambda: agg(on, w_on, fb_on), 3)
    card = {p: x.cpu() for p, x in card.items()}
    del on, fb_on
    torch.cuda.empty_cache()
    host = agg(tree, w, fb)
    for p, x in tree.items():
        lo = x[clean].amin(dim=0)
        hi = x[clean].amax(dim=0)
        if rule == "trimmed_mean":
            # a float32 mean of values in [lo, hi] may round past an end
            slack = 1e-6 * torch.maximum(lo.abs(), hi.abs())
            lo, hi = lo - slack, hi + slack
        if not bool(torch.isfinite(card[p]).all()) or bool(
                ((card[p] < lo) | (card[p] > hi)).any()):
            raise RuntimeError(f"{label}: {p} outside the clean clients' "
                               "range")
        if rule == "trimmed_mean":
            ok = torch.allclose(card[p], host[p], rtol=1e-6, atol=0)
        else:
            ok = torch.equal(card[p], host[p])
        if not ok:
            raise RuntimeError(f"{label}: the card's {rule} of {p} differs "
                               "from the CPU's")
    if rule == "krum":
        picks = [c for c in range(w.shape[0])
                 if all(torch.equal(card[p], x[c]) for p, x in tree.items())]
        if len(picks) != 1 or picks[0] in FLAKY:
            raise RuntimeError(f"{label}: krum picked {picks}")
        print(f"{label}: krum selects client {picks[0]} on the card and "
              "on the CPU", flush=True)
    return ms


def path_robust(ck, stats, smi):
    """Path (j): one 2-round engine per robust rule, the launch counts set
    to 0 just before the three and read just after; each rule held on its
    captured round, card against CPU; then K5 and K4 held bit for bit to
    their plain versions at the path's 10-client calls."""
    from bcfl_tpu_torch.entrypoints import run
    from bcfl_tpu_torch.fed import engine as eng_mod
    from bcfl_tpu_torch.ops import registry

    label = "robust-rules path"
    print(smi, flush=True)
    registry.reset_launches()
    held_ms, peaks, stores = {}, {}, {}
    template = None
    for rule in ROBUST_RULES:
        cfg = robust_config(rule)
        store = {}
        make, wrapped = capture_first_aggregation(store)
        eng_mod.make_aggregator = wrapped
        torch.cuda.reset_peak_memory_stats()
        try:
            result = run(cfg, device="cuda")
        finally:
            eng_mod.make_aggregator = make
        torch.cuda.synchronize()
        peaks[rule] = torch.cuda.max_memory_allocated() / 1e9
        check_finite(result, f"{label} {rule}")
        walls = [round(r.wall_s, 4) for r in result.metrics.rounds]
        print(f"{label} {rule}: round walls {walls} s, peak memory "
              f"{peaks[rule]:.2f} GB, train losses "
              f"{[round(r.train_loss, 5) for r in result.metrics.rounds]}",
              flush=True)
        template = result.trainable
        del result
        torch.cuda.empty_cache()
        stores[rule] = store
    launches = registry.launch_counts()
    count_launches(stats, launches)
    for name in ("int8_quantize", "topk_select"):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} never launched on the {label}")
    for rule in ROBUST_RULES:
        held_ms[rule] = hold_robust_rule(rule, stores.pop(rule),
                                         f"{label} {rule}")
    print(f"{label}: launches {launches}; aggregator ms per call at "
          f"(j)'s width and depth, 10 clients, card: "
          f"{ {k: round(v, 3) for k, v in held_ms.items()} }; the card "
          "equals the CPU (median and krum bit for bit, trimmed_mean to "
          "rtol 1e-6)", flush=True)
    cfg = robust_config("median")
    codec_calls(ck, stats, template, cfg.compression, cfg.num_clients,
                "robust-path")


def phase_resilience(ck, stats, smi, dataset):
    """Paths (h) crash and resume of path (b), (i) the chaos matrix with a
    crash mid-partition, and (j) the robust rules at 10 clients."""
    path_crash_resume(stats, smi, dataset)
    path_chaos_matrix(stats, smi)
    path_robust(ck, stats, smi)


# ----------------------------------------------------------- llama paths

#: (k)'s cohorts with seed 42: client 6 is drawn in both rounds, so its
#: round-0 residual is gathered back in round 1
LLAMA_COHORTS = [[6, 12, 49, 52], [1, 6, 13, 57]]
#: (l)'s per-client adapter ranks
LLAMA_RANKS = "4,8,8,16"


def llama_config(dataset: str, **kw):
    """llama2-7b at full width (32 layers, hidden 4096, 32 heads of 128,
    FFN 11008, vocab 32000 through the hash tokenizer), random weights from
    the seed, float32 parameters (the frozen base is 6.74 B x 4 bytes),
    bf16 compute, remat, 8 x 512 tokens of the long documents (flash
    attention, causal: the family's default from 512 tokens), 2 local
    steps, 2 rounds, 4 clients, ``int8+topk`` over the adapter tree, 2
    evaluation batches."""
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import FedConfig

    base = dict(
        name="chip-smoke-llama2-7b-lora", model="llama2-7b", mode="server",
        num_clients=4, num_rounds=2, seq_len=512, batch_size=8,
        max_local_batches=2, dataset=dataset, vocab_size=32000,
        param_dtype="float32", compute_dtype="bfloat16", remat=True,
        max_eval_batches=2, compression=CompressionConfig(kind="int8+topk"))
    base.update(kw)
    return FedConfig(**base)


def spy_llama_flash(calls):
    """Record every flash call the Llama model makes (shape, dtype,
    causal; nothing that waits for the device) and keep the first call's
    q, k, v and key bias; returns the function that restores the real
    one."""
    import bcfl_tpu_torch.models.llama as llama

    real = llama.flash_attention

    def spy(q, k, v, bias=None, causal=False):
        calls.append((tuple(q.shape), q.dtype, causal))
        if len(calls) == 1:
            calls.append((q.detach(), k.detach(), v.detach(), bias.detach()))
        return real(q, k, v, bias, causal)

    llama.flash_attention = spy

    def restore():
        llama.flash_attention = real

    return restore


def check_llama_flash(label, calls, heads=32):
    """Every flash call of the path ran the causal bf16 D = 128 instances
    at [8, heads, 512, 128] (32 heads, or a tensor-parallel shard's;
    ``calls[1]`` holds the first call's tensors); returns the first call's
    tensors."""
    first = calls.pop(1)
    shapes = set(calls)
    want = {((8, heads, 512, 128), torch.bfloat16, True)}
    if shapes != want:
        raise RuntimeError(f"{label}: flash calls {shapes}, not {want}")
    return first


def llama_launch_check(label, cfg, launches, layers):
    """K2 and K3 launch once per layer (and tensor-parallel shard) of
    every training step; K1 once more per step for the remat recompute,
    plus the evaluation forwards; K4 once per round, K5 at least once per
    round."""
    train = (cfg.num_rounds * cfg.num_clients * cfg.max_local_batches
             * layers * cfg.tp)
    if (launches["flash_bwd_dkv"] != train or launches["flash_bwd_dq"] != train
            or launches["flash_fwd"] < 2 * train
            or launches["int8_quantize"] != cfg.num_rounds
            or launches["topk_select"] < cfg.num_rounds):
        raise RuntimeError(f"{label}: launches {launches}, training calls "
                           f"{train}")


def path_llama_cohort(ck, fk, stats, smi, dataset, llama_per):
    """Path (k): the north-star configuration, Llama-2-7B LoRA (rank 8)
    classification in cohort mode: a registry of 64 clients, 4 sampled per
    round, server FedAvg, ``int8+topk`` over the adapter tree with error
    feedback, the ledger on. The re-sampled client's residual is gathered
    back; K1-K3 held on the path's own first flash call."""
    from bcfl_tpu_torch.config import LedgerConfig
    from bcfl_tpu_torch.fed import cohort
    from bcfl_tpu_torch.models import lora

    label = "llama cohort path (k)"
    cfg = llama_config(dataset, name="chip-smoke-llama2-7b-lora-cohort",
                       lora_rank=8, registry_size=64, sample_clients=4,
                       cohort_size=4, ledger=LedgerConfig(enabled=True))
    # per round: {registry id: its residual row}, as scattered after the
    # round and as gathered before it
    rows = {"scatter": [], "gather": []}
    scatter, gather = cohort.EFRegistry.scatter, cohort.EFRegistry.gather

    def by_id(ids, stacked):
        return {int(i): {p: x[pos].detach().cpu().clone()
                         for p, x in stacked.items()}
                for pos, i in enumerate(ids)}

    def spy_scatter(reg, ids, stacked):
        scatter(reg, ids, stacked)
        rows["scatter"].append(by_id(ids, stacked))

    def spy_gather(reg, ids, device=None):
        out = gather(reg, ids, device)
        rows["gather"].append(by_id(ids, out))
        return out

    calls = []
    cohort.EFRegistry.scatter, cohort.EFRegistry.gather = (spy_scatter,
                                                           spy_gather)
    restore = spy_llama_flash(calls)
    try:
        result, launches, peak = drive(cfg, smi, label)
    finally:
        cohort.EFRegistry.scatter, cohort.EFRegistry.gather = scatter, gather
        restore()
    count_launches(stats, launches)
    recs = result.metrics.rounds
    model = result.model
    layers = model.cfg.num_layers
    llama_launch_check(label, cfg, launches, layers)
    if [r.cohort for r in recs] != LLAMA_COHORTS:
        raise RuntimeError(f"{label}: cohorts {[r.cohort for r in recs]}, "
                           f"not {LLAMA_COHORTS}")
    back, sent = rows["gather"][1][6], rows["scatter"][0][6]
    if not held("bit-identical", [(back[p], sent[p]) for p in sent])[0]:
        raise RuntimeError(f"{label}: client 6's residual gathered in round "
                           "1 differs from what round 0 scattered")
    energy = sum(float(x.abs().sum()) for x in back.values())
    if not energy > 0:
        raise RuntimeError(f"{label}: client 6's gathered residual is zero")
    if any(float(x.abs().sum()) for x in rows["gather"][0][6].values()):
        raise RuntimeError(f"{label}: client 6's round-0 residual is not "
                           "the fresh zero row")
    check_ledger(result, label)
    n_adapter = lora.num_params(result.trainable)
    n_base = sum(p.numel() for p in model.parameters())
    for r in recs:
        print(f"{label} round {r.round}: cohort {r.cohort}, wall "
              f"{r.wall_s:.3f} s, bytes on wire {r.bytes_on_wire:.0f} "
              f"(raw {r.bytes_raw:.0f}, ratio {r.compression_ratio:.3f}), "
              f"effective rank {r.effective_rank:.4f}, train loss "
              f"{r.train_loss:.5f}", flush=True)
    print(f"{label}: client 6's residual row gathered back in round 1 bit "
          f"for bit (|row|_1 {energy:.6e}); adapters {n_adapter} parameters "
          f"against the base's {n_base} ({n_adapter / n_base:.5%}); peak "
          f"memory {peak:.2f} GB; launches {launches}", flush=True)
    q, k, v, bias = check_llama_flash(label, calls)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    flash_hold(fk, stats, "llama-cohort-path-own-call", q, k, v, do,
               bias.float().contiguous(), True, 5)
    template = result.trainable
    del result, model, q, k, v, do, bias, rows
    torch.cuda.empty_cache()
    codec_calls(ck, stats, template, cfg.compression, cfg.num_clients,
                "llama-cohort-path")
    calls_per_round = cfg.num_clients * cfg.max_local_batches * layers
    for name, (ms, plain, bnd, by, lib) in llama_per.items():
        print(f"{name} per round of (k): {calls_per_round} training calls x "
              f"{ms:.4f} ms = {ms * calls_per_round:.2f} ms (bound "
              f"{bnd * calls_per_round:.2f} ms, plain "
              f"{plain * calls_per_round:.2f} ms, sdpa "
              f"{lib * calls_per_round:.2f} ms)", flush=True)
    del template
    torch.cuda.empty_cache()
    return peak


def path_llama_lm(ck, stats, smi, dataset):
    """Path (l): causal-LM LoRA at per-client ranks 4, 8, 8, 16 (RBLA
    mean), 4 clients, server, ``int8+topk``; the ``lm_head`` carries an
    adapter and computes in float32. Each client's padded rank dims stay
    exactly 0 in its trained tree, in the delta it ships and in its
    residual, in both rounds (before and after an aggregate)."""
    from bcfl_tpu_torch.fed import engine as eng_mod
    from bcfl_tpu_torch.models import lora

    label = "llama causal-LM path (l)"
    cfg = llama_config(dataset, name="chip-smoke-llama2-7b-lora-lm",
                       task="causal_lm", lora_ranks=LLAMA_RANKS)
    ranks = cfg.client_lora_ranks
    pads = []
    encode = eng_mod.cs.encode_deltas

    def padding_abs(tree):
        """max |x| over every client's padded rank dims of a stacked
        adapter tree."""
        worst = 0.0
        for p, x in tree.items():
            last = p.rsplit("/", 1)[-1]
            for c, r in enumerate(ranks):
                if last == "a":
                    worst = max(worst, float(x[c, :, r:].abs().max()
                                             if r < x.shape[-1] else 0.0))
                elif last == "b":
                    worst = max(worst, float(x[c, r:].abs().max()
                                             if r < x.shape[1] else 0.0))
        return worst

    def spy_encode(comp, new_t, ref_t, resid, uniforms, rmask=None):
        payload, recon, resid = encode(comp, new_t, ref_t, resid, uniforms,
                                       rmask)
        dec = eng_mod.cc.decode_tree(comp, payload, new_t)
        pads.append((padding_abs(new_t), padding_abs(dec),
                     padding_abs(resid)))
        return payload, recon, resid

    calls = []
    eng_mod.cs.encode_deltas = spy_encode
    restore = spy_llama_flash(calls)
    try:
        result, launches, peak = drive(cfg, smi, label)
    finally:
        eng_mod.cs.encode_deltas = encode
        restore()
    count_launches(stats, launches)
    recs = result.metrics.rounds
    llama_launch_check(label, cfg, launches, result.model.cfg.num_layers)
    check_llama_flash(label, calls)
    if len(pads) != cfg.num_rounds or any(any(v != 0.0 for v in row)
                                          for row in pads):
        raise RuntimeError(f"{label}: padded rank dims |x| max per round "
                           f"(trained, shipped, residual) {pads}, not 0")
    if type(result.model).__name__ != "LlamaLM" or not any(
            p.startswith("lm_head/") for p in result.trainable):
        raise RuntimeError(f"{label}: no lm_head adapter")
    for r in recs:
        print(f"{label} round {r.round}: wall {r.wall_s:.3f} s, token loss "
              f"{r.train_loss:.5f} (global {r.global_loss}), effective rank "
              f"{r.effective_rank:.4f}, ratio {r.compression_ratio:.3f}",
              flush=True)
    print(f"{label}: ranks {ranks}; padded rank dims exactly 0 in every "
          f"round's trained trees, shipped deltas and residuals; adapters "
          f"{lora.num_params(result.trainable)} parameters; peak memory "
          f"{peak:.2f} GB; launches {launches}", flush=True)
    template = result.trainable
    del result
    torch.cuda.empty_cache()
    codec_calls(ck, stats, template, cfg.compression, cfg.num_clients,
                "llama-lm-path")
    del template
    torch.cuda.empty_cache()


def phase_llama(ck, fk, stats, smi, dataset, llama_per):
    """Paths (k) and (l) at llama2-7b's full width, each with the launch
    counts set to 0 just before it and read just after; returns (k)'s
    peak memory in GB."""
    k_peak = path_llama_cohort(ck, fk, stats, smi, dataset, llama_per)
    path_llama_lm(ck, stats, smi, dataset)
    return k_peak


# ------------------------------------------------------ tp and sp paths

#: (v)'s gate (2a): on layer 0 of the path's model, client 0's first
#: batch and bf16 compute, each column-parallel shard's output (q, k, v,
#: gate, up) and each head shard's attention against the same slice of the
#: tp=1 op: the same float32 sums rounded to bf16 once, so every element
#: within one bf16 ulp (2**-7 of its magnitude); the row-parallel o_proj
#: and down_proj against the dense product: each shard's partial product
#: is rounded to bf16 before the float32 sum, so each element within
#: 2**-8 of the partials' magnitudes plus an ulp of its own (JAX's
#: all-reduce of bf16 partial sums rounds the same way). float32's own
#: summation order adds 2**-16 of the largest element.
TP_ULP = 2.0 ** -7
TP_PARTIAL = 2.0 ** -8
TP_F32_FLOOR = 2.0 ** -16
#: The steps of (v) and (w) against their one-shard forms on the same
#: weights and batch. In float32 compute only the sums' order differs
#: (the split sums of (v), the ring's blocks and merge of (w)): loss
#: within 1e-5 relative, adapter gradients within 1e-4 of their L2 norm.
F32_LOSS_RTOL = 1e-5
F32_GRAD_REL = 1e-4
#: In the paths' bf16 compute a rounding that lands the other way is
#: amplified through 32 random layers (on the order of 1e-2 in the
#: logits and gradients), so the sharded step is held to float32 compute
#: as the one-shard step is: its distance to the float32 step (relative
#: L2 of the adapter gradients, and for (v) of the logits) within
#: TP_BF16_FACTOR times the one-shard step's. (v)'s bf16 loss stays within
#: the logits' bound: softmax cross entropy moves by at most twice the
#: largest logit change of an example, averaged over the batch. (w)'s
#: token loss, averaged over 4095 tokens, within 1e-4 relative of flash
#: sp=1's.
TP_BF16_FACTOR = 2.0
#: (w)'s ring against dense float32 attention of the same float32 q, k, v
#: (sums over 4096 keys in another order)
SP_RING_TOL = 1e-4
SP_LOSS_RTOL = 1e-4


def write_long4k_docs() -> str:
    """(w)'s corpus: ``write_long_docs`` with documents of at least 4200
    words, so every one fills Llama-2's 4096-token context."""
    return write_long_docs(seed=5, n_train=48, n_test=8, min_words=4200,
                           name="long4k_docs")


def spy_first_call(calls):
    """Record the arguments of ``make_local_train``'s first local round
    (the client's starting adapters and its batches), on the host."""
    from bcfl_tpu_torch.fed import client_step as cs

    real = cs.make_local_train

    def make(*args, **kw):
        inner = real(*args, **kw)

        def local_train(trainable, batches, generator):
            if not calls:
                calls.append(({p: x.detach().clone()
                               for p, x in trainable.items()},
                              {k: v.clone() for k, v in batches.items()}))
            return inner(trainable, batches, generator)

        return local_train

    cs.make_local_train = make

    def restore():
        cs.make_local_train = real

    return restore


def first_step(model, task, adapters, batches, keep_output=False):
    """Loss and adapter gradients of one local step's forward and backward
    (the first batch, no dropout), and the model's float32 output when
    ``keep_output``."""
    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.models import lora

    outs = []
    hook = model.register_forward_hook(
        lambda m, a, o: outs.append(o.detach().float()) if keep_output
        else None)
    leaves = {p: x.clone().requires_grad_(True) for p, x in adapters.items()}
    try:
        with lora.attached(model, leaves):
            model.train()
            loss, _, _ = cs.make_loss_fn(model, task)(
                {k: v[0] for k, v in batches.items()}, None)
            loss.backward()
    finally:
        hook.remove()
    return (float(loss.detach()),
            {p: x.grad.detach() for p, x in leaves.items()},
            outs[0] if keep_output else None)


def set_compute_dtype(model, dtype, **kw):
    """Every model config's compute dtype (and any other field in ``kw``)."""
    for mod in model.modules():
        if "cfg" in vars(mod):
            mod.cfg = dataclasses.replace(mod.cfg, dtype=dtype, **kw)


def split_arith_check(label, model, specs, devices, adapters, ids):
    """(v)'s gate (2a): layer 0's split ops on the path's own model and
    batch against the same ops at tp=1 (``TP_ULP``, ``TP_PARTIAL``);
    returns ``{op: max |diff|}``."""
    import torch.nn.functional as F

    from bcfl_tpu_torch.models import llama as L
    from bcfl_tpu_torch.models import lora
    from bcfl_tpu_torch.parallel import tp_linear as tpl

    c = model.model.cfg
    layer = model.model.layer_0
    att, mlp = layer.attention, layer.mlp
    n, hd = len(devices), c.head_dim
    H, KV, FF = c.num_heads // n, c.kv_heads // n, c.intermediate_size // n
    B, S = ids.shape
    pos = torch.arange(S, device=ids.device)
    kb = torch.zeros((B, S), dtype=torch.float32, device=ids.device)
    widths = {"q_proj": H * hd, "k_proj": KV * hd, "v_proj": KV * hd,
              "gate_proj": FF, "up_proj": FF}
    worst, bad = {}, []

    def hold(name, got, want, partials=()):
        got, want = got.float(), want.float()
        tol = TP_ULP * want.abs() + TP_F32_FLOOR * want.abs().max()
        for p in partials:
            tol = tol + TP_PARTIAL * p.float().abs()
        diff = (got - want).abs()
        worst[name] = max(worst.get(name, 0.0), float(diff.max()))
        if not bool((diff <= tol).all()):
            bad.append(name)

    def attend(q, k, v):  # [B, S, h*hd] x3 -> [B, S, h*hd]
        def heads(t):
            return t.view(B, S, -1, hd).transpose(1, 2)

        rep = q.shape[-1] // k.shape[-1]
        out = L.flash_attention(
            L.rope(heads(q), pos, c.rope_theta),
            L.rope(heads(k), pos, c.rope_theta).repeat_interleave(rep, 1),
            heads(v).repeat_interleave(rep, 1), kb, causal=True)
        return out.transpose(1, 2).reshape(B, S, -1)

    def partials(layer, parts):
        sh = layer.__dict__["tp"]
        return [F.linear(x, sh.part(layer, i)[0].to(c.dtype))
                for i, x in enumerate(parts)]

    with torch.no_grad(), lora.attached(model, adapters):
        h = L.rms_norm(model.model.embed(ids).to(c.dtype), layer.input_norm)
        tpl.unshard(model)
        full = {nm: tpl.dense(h, getattr(att if nm in ("q_proj", "k_proj",
                                                          "v_proj") else mlp,
                                         nm), c.dtype) for nm in widths}
        attn = attend(full["q_proj"], full["k_proj"], full["v_proj"])
        ff = F.silu(full["gate_proj"]) * full["up_proj"]
        dense_out = {"o_proj": tpl.dense(attn, att.o_proj, c.dtype),
                     "down_proj": tpl.dense(ff, mlp.down_proj, c.dtype)}
        tpl.shard_base(model, specs, devices)
        shards = {"o_proj": [], "down_proj": []}
        for i in range(n):
            got = {}
            for nm, w in widths.items():
                mod = att if nm in ("q_proj", "k_proj", "v_proj") else mlp
                got[nm] = tpl.column(h, getattr(mod, nm), i, n, c.dtype)
                hold(nm, got[nm], full[nm][..., i * w:(i + 1) * w])
            cols = slice(i * H * hd, (i + 1) * H * hd)
            hold("attention", attend(got["q_proj"], got["k_proj"],
                                     got["v_proj"]), attn[..., cols])
            # the row-parallel layers read tp=1's own slices, so their
            # check sees only the split sum
            shards["o_proj"].append(attn[..., cols])
            shards["down_proj"].append(ff[..., i * FF:(i + 1) * FF])
        for nm, mod in (("o_proj", att), ("down_proj", mlp)):
            layer_ = getattr(mod, nm)
            hold(nm, tpl.row(shards[nm], layer_, c.dtype), dense_out[nm],
                 partials(layer_, shards[nm]))
    print(f"{label}: layer 0's split ops against tp=1 in bf16, max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (column and attention within {TP_ULP} relative, row within "
          f"{TP_PARTIAL} of the partials + {TP_ULP})", flush=True)
    if bad:
        raise RuntimeError(f"{label}: split ops past one bf16 rounding: "
                           f"{bad}")
    return worst


def grad_rel(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every leaf together."""
    num = sum(float((got[p].float() - x.float()).square().sum())
              for p, x in want.items())
    den = sum(float(x.float().square().sum()) for x in want.values())
    return math.sqrt(num / max(den, 1e-30))


def tp_config(dataset: str):
    """Path (v)'s configuration: (k)'s model, LoRA rank 8, one round, 4
    clients, ``tp=2``, the ledger on."""
    from bcfl_tpu_torch.config import LedgerConfig

    return llama_config(dataset, name="chip-smoke-llama2-7b-lora-tp",
                        lora_rank=8, num_rounds=1, tp=2,
                        ledger=LedgerConfig(enabled=True))


def sp_config(long4k: str, sp: int):
    """Path (w)'s configuration: (k)'s model on the causal-LM task at
    Llama-2's 4096-token context, LoRA rank 8, batch 1, 2 clients, one
    round, sequence parallelism ``sp``."""
    return llama_config(long4k, name="chip-smoke-llama2-7b-lora-sp",
                        task="causal_lm", lora_rank=8, seq_len=4096,
                        batch_size=1, num_clients=2, num_rounds=1, sp=sp,
                        max_eval_batches=1)


def path_tp(fk, stats, smi, dataset, llama_per, k_peak):
    """Path (v): tensor parallelism, (k)'s model (llama2-7b at full width
    and depth, float32 base, bf16 compute, remat, LoRA rank 8) at
    ``tp=2`` on ``devices=[cuda:0, cuda:0]``: server mode, 4 clients, one
    round of 2 local steps of 8 x 512 tokens, ``int8+topk`` over the
    adapters, the ledger on. Both shards share the one card: the sharded
    arithmetic is proved, not a memory or speed gain. Returns the run's
    :func:`kept_run`, the one-row baseline of (aa)."""
    from bcfl_tpu_torch.models import tp_param_specs
    from bcfl_tpu_torch.models.convert import leaf_specs
    from bcfl_tpu_torch.parallel import tp_linear

    label = "tensor-parallel path (v)"
    cfg = tp_config(dataset)
    devices = [torch.device("cuda", 0)] * cfg.tp
    calls, first = [], []
    restore = spy_llama_flash(calls)
    restore_step = spy_first_call(first)
    try:
        t0 = time.perf_counter()
        result, launches, payloads, client_stats, peaks, traffic, _ = (
            drive_tapped(cfg, smi, label, devices))
        wall = time.perf_counter() - t0
    finally:
        restore()
        restore_step()
    one_row = kept_run(result, launches, payloads, client_stats, peaks,
                       traffic)
    peak = peaks["cuda:0"]
    count_launches(stats, launches)
    model = result.model
    layers = model.cfg.num_layers
    llama_launch_check(label, cfg, launches, layers)
    # (1) every column- and row-parallel leaf split, each shard a view of
    # its weight: the base stored once
    specs = tp_param_specs(model, {s.path: s for s in leaf_specs(model)})
    want = {p.rsplit("/", 1)[0].replace("/", ".")
            for p, d in specs.items() if d is not None}
    split = tp_linear.split_layers(model)
    if set(split) != want:
        raise RuntimeError(f"{label}: split layers {len(split)}, the "
                           f"megatron layout names {len(want)}")
    for name, sh in split.items():
        w = model.get_submodule(name).weight
        if len(sh.weights) != cfg.tp or any(
                x.untyped_storage().data_ptr()
                != w.untyped_storage().data_ptr() for x in sh.weights):
            raise RuntimeError(f"{label}: {name} is not {cfg.tp} views of "
                               "its weight")
    base_gb = sum(p.numel() * p.element_size()
                  for p in model.parameters()) / 1e9
    print(f"{label}: {len(split)} column- and row-parallel layers split "
          f"{cfg.tp} ways, every shard a view of its weight (base "
          f"{base_gb:.2f} GB stored once); peak memory {peak:.2f} GB "
          f"against (k)'s {k_peak:.2f} GB on this run; {wall:.1f} s with "
          f"set-up; {smi}", flush=True)
    if peak > 1.1 * k_peak:
        raise RuntimeError(f"{label}: peak {peak:.2f} GB past (k)'s "
                           f"{k_peak:.2f} GB + 10%")
    # (4) the round: finite (drive), every client authenticated, the chain
    rec = result.metrics.rounds[0]
    if rec.auth != [1.0] * cfg.num_clients:
        raise RuntimeError(f"{label}: auth {rec.auth}")
    check_ledger(result, label)
    print(f"{label} round 0: wall {rec.wall_s:.3f} s, train loss "
          f"{rec.train_loss:.5f}, auth {rec.auth}; launches {launches}",
          flush=True)
    # (2) client 0's first local step at tp=2 against tp=1 on the same
    # weights (the split undone and re-taken: the shards are views) and
    # batch: (2a) layer 0's split ops, (2b) the step in the path's bf16
    # compute and in float32 compute
    adapters, batches = first[0]
    split_arith_check(label, model, specs, devices, adapters,
                      batches["ids"][0])
    steps = {}
    for dtype in (torch.bfloat16, torch.float32):
        set_compute_dtype(model, dtype)
        tp_linear.shard_base(model, specs, devices)
        steps[dtype, 2] = first_step(model, cfg.task, adapters, batches, True)
        tp_linear.unshard(model)
        steps[dtype, 1] = first_step(model, cfg.task, adapters, batches, True)
    rows = {}
    for key, (loss, g, z) in steps.items():
        ref_loss, ref_g, ref_z = steps[torch.float32, 1]
        rows[key] = (abs(loss - ref_loss) / abs(ref_loss), grad_rel(g, ref_g),
                     float((z - ref_z).norm() / ref_z.norm()))
        print(f"{label}: client 0's first step in {dtype_name(key[0])} at "
              f"tp={key[1]}: loss {loss:.6f}; against float32 tp=1: loss "
              f"relative {rows[key][0]:.3e}, adapter gradients relative L2 "
              f"{rows[key][1]:.3e}, logits relative L2 {rows[key][2]:.3e}",
              flush=True)
    bf, f32 = torch.bfloat16, torch.float32
    (l2, g2, z2), (l1, g1, z1) = steps[bf, 2], steps[bf, 1]
    # softmax cross entropy is 2-Lipschitz in the max norm of one
    # example's logits: the loss (a mean over the kept examples) can move
    # no further than this
    keep = batches["example_mask"][0].float()
    loss_bound = float(2 * ((z2 - z1).abs().amax(dim=-1) * keep).sum()
                       / keep.sum())
    print(f"{label}: bf16 tp=2 against tp=1: loss {l2:.6f} against "
          f"{l1:.6f} (|diff| {abs(l2 - l1):.3e}, the logits' bound "
          f"{loss_bound:.3e}), gradients relative L2 {grad_rel(g2, g1):.3e};"
          f" tp=2's distance to float32 within {TP_BF16_FACTOR} x tp=1's "
          f"(gradients {rows[bf, 2][1]:.3e} vs {rows[bf, 1][1]:.3e}, logits "
          f"{rows[bf, 2][2]:.3e} vs {rows[bf, 1][2]:.3e})", flush=True)
    if not (abs(l2 - l1) <= loss_bound
            and rows[bf, 2][1] <= TP_BF16_FACTOR * rows[bf, 1][1]
            and rows[bf, 2][2] <= TP_BF16_FACTOR * rows[bf, 1][2]):
        raise RuntimeError(f"{label}: tp=2's bf16 step is further from "
                           "float32 compute than tp=1's")
    print(f"{label}: float32 tp=2 against tp=1: loss relative "
          f"{rows[f32, 2][0]:.3e} (limit {F32_LOSS_RTOL}), gradients "
          f"relative L2 {rows[f32, 2][1]:.3e} (limit {F32_GRAD_REL})",
          flush=True)
    if not (rows[f32, 2][0] <= F32_LOSS_RTOL
            and rows[f32, 2][1] <= F32_GRAD_REL):
        raise RuntimeError(f"{label}: tp=2 step differs from tp=1 in "
                           "float32")
    del steps, g1, g2
    # (3) K1-K3 on the path's first head-shard call
    q, k, v, bias = check_llama_flash(label, calls,
                                      heads=32 // cfg.tp)
    del result, model, adapters, batches, first
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    # as many launches per timing as the full-head Llama call's
    shard = flash_hold(fk, stats, "llama-tp-head-shard-call", q, k, v, do,
                       bias.float().contiguous(), True, LLAMA_ITERS)
    for name, (ms, plain, bnd, by, lib) in shard.items():
        full = llama_per[name]
        print(f"{name} head-shard call [8,{32 // cfg.tp},512,512,128]: "
              f"{ms:.4f} ms (bound {bnd:.4f} ms, plain {plain:.4f} ms, sdpa "
              f"{lib:.4f} ms) beside the full-head call's {full[0]:.4f} ms; "
              f"{smi}", flush=True)
    # the kernels' own device time (torch.profiler) at the head-shard call
    # and at a full-head call of its heads twice over: at these shapes K1
    # and K3 take about as long as their host wrappers, so the event
    # timing above can read the host's rate
    bias = bias.float().contiguous()
    shard_dev = flash_device_ms(fk, q, k, v, do, bias)
    full_dev = flash_device_ms(fk, *(torch.cat([x, x], dim=1)
                                     for x in (q, k, v, do)), bias)
    for name, t in shard_dev.items():
        print(f"{name} device time (torch.profiler, {LLAMA_ITERS} "
              f"launches): head-shard call {t:.4f} ms, full-head call "
              f"[8,32,512,512,128] {full_dev[name]:.4f} ms "
              f"({t / full_dev[name]:.2f}x); {smi}", flush=True)
    del q, k, v, do, bias
    torch.cuda.empty_cache()
    return one_row


def flash_device_ms(fk, q, k, v, do, bias) -> dict:
    """K1-K3's mean device time per call (bf16, causal) on these inputs."""
    out, lse = fk.FLASH_FWD(q, k, v, bias, True)
    bwd = (q, k, v, bias, out, do, lse, True)
    calls = {"flash_fwd": lambda: fk.FLASH_FWD(q, k, v, bias, True),
             "flash_bwd_dkv": lambda: fk.FLASH_BWD_DKV(*bwd),
             "flash_bwd_dq": lambda: fk.FLASH_BWD_DQ(*bwd)}
    route = FLASH_INSTANCES[q.dtype][0]
    return {name: device_ms(fn, LLAMA_ITERS, f"{name}_{route}<")
            for name, fn in calls.items()}


def spy_ring(calls):
    """Record every ring call (its rotations), and keep the first call's
    q, k, v and key bias; returns the function that restores the real
    one."""
    import importlib

    from bcfl_tpu_torch.parallel import sp

    ra = importlib.import_module("bcfl_tpu_torch.parallel.ring_attention")
    real = sp.ring_attention_gspmd

    def spy(q, k, v, key_bias, devices, causal=False):
        if not calls:
            calls.append((q.detach().clone(), k.detach().clone(),
                          v.detach().clone(), key_bias.detach().clone(),
                          tuple(devices)))
        before = ra.rotations()
        out = real(q, k, v, key_bias, devices, causal)
        calls.append(ra.rotations() - before)
        return out

    sp.ring_attention_gspmd = spy

    def restore():
        sp.ring_attention_gspmd = real

    return restore


def dense_causal_f32(q, k, v, key_bias):
    """Dense float32 attention with a causal mask and the [B, S] key
    bias: the ring's reference on the card."""
    S, D = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D)
    s = s + key_bias[:, None, None, :]
    dead = (torch.arange(S, device=q.device)[None, :]
            > torch.arange(S, device=q.device)[:, None])
    s = s.masked_fill(dead, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def path_sp(stats, smi, long4k):
    """Path (w): sequence parallelism, (k)'s model (llama2-7b at full
    width and depth, float32 base, bf16 compute, remat, LoRA rank 8) on
    the causal-LM task at Llama-2's 4096-token context, ``sp=4`` on
    ``devices=[cuda:0] * 4``: batch 1, 2 clients, one round of 2 local
    steps. The four ring blocks share the one card: the ring's
    arithmetic is proved, not a memory or speed gain."""
    from bcfl_tpu_torch.parallel.ring_attention import ring_attention_gspmd

    label = "sequence-parallel path (w)"
    cfg = sp_config(long4k, 4)
    devices = [torch.device("cuda", 0)] * cfg.sp
    rings, first = [], []
    restore = spy_ring(rings)
    restore_step = spy_first_call(first)
    try:
        t0 = time.perf_counter()
        result, launches, peak = drive(cfg, smi, label, devices=devices)
        wall = time.perf_counter() - t0
    finally:
        restore()
        restore_step()
    count_launches(stats, launches)
    model = result.model
    layers = model.cfg.num_layers
    rec = result.metrics.rounds[0]
    q, k, v, key_bias, ring_devs = rings.pop(0)
    if set(rings) != {cfg.sp - 1}:
        raise RuntimeError(f"{label}: rotations per ring call {set(rings)}"
                           f", not {cfg.sp - 1}")
    # forward, remat recompute and evaluation: at least 2 ring calls per
    # layer of every training step
    train = cfg.num_clients * cfg.max_local_batches * layers
    if len(rings) < 2 * train or any(
            launches[n] for n in FLASH_OPS):
        raise RuntimeError(f"{label}: {len(rings)} ring calls for {train} "
                           f"training calls, flash launches {launches}")
    print(f"{label}: {wall:.1f} s with set-up, round wall {rec.wall_s:.3f} s"
          f", token loss {rec.train_loss:.5f}, peak memory {peak:.2f} GB; "
          f"{len(rings)} ring calls of {cfg.sp - 1} rotations each over "
          f"{len(ring_devs)} devices; launches {launches}; {smi}",
          flush=True)
    # (1) the ring on the path's first call against dense float32
    # attention of the same q, k, v and key bias
    qf, kf, vf = (x.float() for x in (q, k, v))
    t0 = time.perf_counter()
    got = ring_attention_gspmd(qf, kf, vf, key_bias, ring_devs, causal=True)
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    want = dense_causal_f32(qf, kf, vf, key_bias.float())
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, atol=SP_RING_TOL, rtol=SP_RING_TOL))
    print(f"{label}: ring_attention_gspmd on the first call's q, k, v "
          f"{list(q.shape)} against dense float32 attention: max |diff| "
          f"{err:.3e} (limit {SP_RING_TOL} abs + rel), {ring_s * 1e3:.1f} ms "
          "for the float32 ring", flush=True)
    if not ok:
        raise RuntimeError(f"{label}: the ring differs from dense "
                           "attention")
    del qf, kf, vf, got, want, q, k, v
    # (2) client 0's first step at sp=4 against sp=1 on the same weights
    # and batch: in the path's bf16 compute against the flash kernels
    # (K1-K3); in float32 compute against the same float32 attention in
    # one block (the ring at n = 1)
    adapters, batches = first[0]
    bf, f32 = model.cfg.dtype, torch.float32
    ring4, one = model.cfg.attention_override, ring_devs[:1]

    def ring1(q, k, v, kb, causal=False):
        return ring_attention_gspmd(q, k, v, kb, one, causal)

    steps = {}
    for dtype, name, override in ((bf, "sp=4", ring4), (f32, "sp=4", ring4),
                                  (f32, "one block", ring1),
                                  (bf, "flash", None)):
        set_compute_dtype(model, dtype, attention_override=override,
                          use_flash=override is None)
        steps[dtype, name] = first_step(model, cfg.task, adapters, batches)[:2]
    (l4, g4), (l1, g1) = steps[bf, "sp=4"], steps[bf, "flash"]
    (lf4, gf4), (lfb, gfb) = steps[f32, "sp=4"], steps[f32, "one block"]
    dloss, dloss32 = abs(l4 - l1) / abs(l1), abs(lf4 - lfb) / abs(lfb)
    rel4, rel1, rel32 = grad_rel(g4, gfb), grad_rel(g1, gfb), grad_rel(gf4, gfb)
    print(f"{label}: client 0's first step in bf16, token loss at sp=4 "
          f"{l4:.6f} and at sp=1 with flash {l1:.6f} (relative {dloss:.3e}, "
          f"limit {SP_LOSS_RTOL}), adapter gradients relative L2 "
          f"{grad_rel(g4, g1):.3e}; distance to float32 compute: sp=4 "
          f"{rel4:.3e}, flash sp=1 {rel1:.3e} (sp=4 within "
          f"{TP_BF16_FACTOR} x flash's); in float32 at sp=4 {lf4:.6f} and "
          f"in one block {lfb:.6f}: loss relative {dloss32:.3e} (limit "
          f"{F32_LOSS_RTOL}), gradients relative L2 {rel32:.3e} (limit "
          f"{F32_GRAD_REL})", flush=True)
    if not (dloss <= SP_LOSS_RTOL and rel4 <= TP_BF16_FACTOR * rel1
            and dloss32 <= F32_LOSS_RTOL and rel32 <= F32_GRAD_REL):
        raise RuntimeError(f"{label}: sp=4 step differs from sp=1")
    del result, model, adapters, batches, first, steps, g4, g1, gf4, gfb
    torch.cuda.empty_cache()


def phase_parallel(fk, stats, smi, dataset, llama_per, k_peak):
    """Paths (v) and (w), each with the launch counts set to 0 just
    before it and read just after. Returns (v)'s :func:`kept_run` and
    (w)'s corpus, for (aa)."""
    tp_one = path_tp(fk, stats, smi, dataset, llama_per, k_peak)
    long4k = write_long4k_docs()
    path_sp(stats, smi, long4k)
    return tp_one, long4k


def phase_inner_rows(stats, smi, dataset, long4k, tp_one):
    """(aa): clients x tp and clients x seq with more than one client
    shard, through :func:`clients_axis_pair`. Each leg runs on
    ``[cuda:0] * 4``, a mesh of 2 rows of 2 (every row a client shard of
    2 or 1 clients, its inner shards sharing the one card with the other
    row's), against the same configuration on ``[cuda:0] * 2``, one row:
    the global tree, the payload bytes, the ledger head, the per-client
    stats and evaluation bit for bit, K4 and K5 once per row, walls,
    peaks and bytes between the rows printed.

    - ``tp``: path (v)'s configuration; every row holds a split of the
      frozen base (on the lead row's own card, the lead's, never written)
      and runs K1-K3 on its head shards as often as the one row does in
      all. The one-row run is (v)'s own (``tp_one``).
    - ``sp``: path (w)'s configuration at ``sp=2``, full depth; every row
      rides its own ring (no kernel: the float32 ring), its hops counted
      under its row (``sp.hops``), the rows' hops adding up to the one
      row's.
    """
    from bcfl_tpu_torch.parallel import sp

    quad = [torch.device("cuda", 0)] * 4
    row = [torch.device("cuda", 0)] * 2
    label = "clients x tp (aa)"
    pair = clients_axis_pair(tp_config(dataset), smi, label, quad, one=row,
                             one_run=tp_one)
    launches = pair["many"][0]
    count_launches(stats, launches)  # the one row's counted by (v)
    if pair["shards"] != 2 or min(launches.values()) <= 0:
        raise RuntimeError(f"{label}: {pair['shards']} client shards, "
                           f"launches {launches}")
    print_clients_axis(label, pair, smi)
    torch.cuda.empty_cache()
    label = "clients x seq (aa)"
    cfg = sp_config(long4k, 2)
    sp.reset_hops()
    result, *tapped, _ = drive_tapped(cfg, smi, f"{label} on 2 device(s)",
                                      row)
    one_hops = [sp.hops(r) for r in range(2)]
    one_run = kept_run(result, *tapped)
    del result
    torch.cuda.empty_cache()
    sp.reset_hops()
    pair = clients_axis_pair(cfg, smi, label, quad, one=row, one_run=one_run)
    hops = [sp.hops(r) for r in range(2)]
    for key in ("one", "many"):
        count_launches(stats, pair[key][0])
        if any(pair[key][0][n] for n in FLASH_OPS) or min(
                pair[key][0][n] for n in SHARD_CODEC_OPS) <= 0:
            raise RuntimeError(f"{label}: launches {pair[key][0]}")
    # each row rode its own ring; the rows' hops add up to the one row's
    if (pair["shards"] != 2 or one_hops[1] or min(hops) <= 0
            or sum(hops) != one_hops[0]):
        raise RuntimeError(f"{label}: {pair['shards']} client shards, ring "
                           f"hops by row {hops} against one row's "
                           f"{one_hops}")
    print_clients_axis(label, pair, smi)
    print(f"{label}: ring hops by row {hops}, one row's {one_hops[0]}",
          flush=True)


# ------------------------------------------------- lint and synthetic inputs


#: one firing fixture per lint checker (the reference's test fixtures)
LINT_FIXTURES = {
    "guarded-by": """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0  # guarded-by: _lock

        def bump(self):
            self.n += 1
""",
    "lock-order": """
    import threading

    class C:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def ab(self):
            with self._a:
                with self._b:
                    pass

        def ba(self):
            with self._b:
                with self._a:
                    pass
""",
    "determinism": """
    import time
    import random
    import numpy as np

    def draw(d):
        t = time.time()
        r = random.random()
        g = np.random.default_rng()
        x = np.random.random()
        for k, v in d.items():
            pass
        return t, r, g, x
""",
    "telemetry-schema": """
    from bcfl_tpu import telemetry

    def report(to):
        telemetry.emit("sendd", to=to, type="ping", ok=True)
        telemetry.emit("merge", version=1)
""",
    "socket-deadline": """
    def pump(sock, view):
        data = sock.recv(4096)
        sock.recv_into(view)
        return data
""",
    "no-frame-concat": """
    from bcfl_tpu.dist.wire import pack_frame

    def ship(sock, header, trees, parts):
        frame = pack_frame(header, trees)
        body = b"".join(parts)
        sock.sendall(frame + body)
""",
}


def lint_json(argv) -> tuple:
    """``lint_main(argv + ["--json"])`` in this process: (exit code,
    parsed output)."""
    import contextlib
    import io

    from bcfl_tpu_torch.analysis import lint_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(list(argv) + ["--json"])
    return rc, json.loads(buf.getvalue())


def phase_lint():
    """(x): ``python -m bcfl_tpu_torch.entrypoints lint --json`` over the
    port in a fresh interpreter of this machine, which has no JAX, so the
    run itself shows that the lint path imports none: exit 0, zero failing
    findings, the six checkers. Then each checker's firing fixture,
    written under ``build/``, must exit 1 with that checker's findings
    only, so the clean verdict is not vacuous."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "bcfl_tpu_torch.entrypoints", "lint",
         "--json"], cwd=str(Path(__file__).resolve().parent),
        capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"lint: exit {out.returncode}\n{out.stdout[-2000:]}"
                           f"\n{out.stderr[-2000:]}")
    data = json.loads(out.stdout)
    want = sorted(LINT_FIXTURES)
    if data["counts"]["failing"] != 0 or data["checkers"] != want:
        raise RuntimeError(f"lint: {data['counts']}, checkers "
                           f"{data['checkers']} (want {want})")
    print(f"lint path: `python -m bcfl_tpu_torch.entrypoints lint --json` "
          f"exit 0 in {secs:.2f} s, counts {json.dumps(data['counts'])}, "
          f"checkers {','.join(data['checkers'])}", flush=True)
    fixdir = BUILD_DIR / "lint"
    fixdir.mkdir(parents=True, exist_ok=True)
    fired = {}
    for cid, code in LINT_FIXTURES.items():
        path = fixdir / f"{cid.replace('-', '_')}.py"
        path.write_text(textwrap.dedent(code))
        rc, res = lint_json([str(path), "--checker", cid, "--no-baseline"])
        ids = {f["checker"] for f in res["findings"]}
        if rc != 1 or ids != {cid} or res["counts"]["failing"] < 1:
            raise RuntimeError(f"lint fixture {cid}: exit {rc}, checkers "
                               f"{sorted(ids)}, counts {res['counts']}")
        fired[cid] = res["counts"]["failing"]
    print(f"lint path: every checker fires on its fixture (exit 1), "
          f"failing findings {json.dumps(fired)}", flush=True)


def path_synthetic(ck, stats, smi):
    """(y): ``fed/synthetic.synthetic_round_inputs`` on the card at path
    (a)'s shape (bert-base, its clients, 2 steps of 32 x 128 tokens, vocab
    30522), the ids equal to a numpy regeneration of the same draws, then
    one ``server_round`` of ``build_programs`` with ``int8+topk``, the
    launch counts set to 0 just before it and read just after: K4 and K5
    launched, finite losses and global tree. K5 and K4 are then held to
    their plain versions at the round's own calls."""
    import numpy as np

    from bcfl_tpu_torch.compression import zero_residual
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.core.mesh import client_mesh
    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.fed.engine import FedEngine
    from bcfl_tpu_torch.fed.synthetic import synthetic_round_inputs
    from bcfl_tpu_torch.ops import registry

    cfg = main_config(name="chip-smoke-synthetic", num_rounds=1)
    C, steps = cfg.num_clients, cfg.max_local_batches
    eng = FedEngine(cfg, device="cuda")
    mesh = client_mesh(C, devices=[eng.device])
    progs = cs.build_programs(eng.model, mesh, compression=cfg.compression)
    g0 = {p: x.detach().clone() for p, x in eng.trainable0.items()}
    del eng
    batches, weights, gens = synthetic_round_inputs(
        mesh, steps, cfg.batch_size, cfg.seq_len, vocab_size=cfg.vocab_size,
        seed=cfg.seed)
    want = np.random.default_rng(cfg.seed).integers(
        0, cfg.vocab_size, (C, steps, cfg.batch_size, cfg.seq_len))
    if not (batches["ids"].is_cuda and np.array_equal(
            batches["ids"].cpu().numpy(), want.astype(np.int32))):
        raise RuntimeError("synthetic path: ids differ from the numpy draws")
    resid = zero_residual(g0, C)
    print(smi, flush=True)
    registry.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cs.server_round(progs.local_train, cfg.compression, g0, batches,
                          weights, gens, resid,
                          prng.codec_uniforms(cfg.seed, 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launch_counts()
    stats_rows = out.stats.cpu()
    loss = float(stats_rows[:, 0].sum() / stats_rows[:, 2].sum())
    print(f"synthetic path: one {C}-client server round of build_programs "
          f"on synthetic_round_inputs ({steps} x {cfg.batch_size} x "
          f"{cfg.seq_len} tokens, int8+topk) in {wall:.3f} s wall, "
          f"train_loss {loss:.5f}, launches {launches}", flush=True)
    for name in ("int8_quantize", "topk_select"):
        if launches[name] <= 0:
            raise RuntimeError(f"synthetic path: {name} never launched")
    if not math.isfinite(loss) or not all(
            bool(torch.isfinite(x).all()) for x in out.global_t.values()):
        raise RuntimeError("synthetic path: non-finite loss or parameters")
    count_launches(stats, launches)
    del out, batches, resid
    codec_calls(ck, stats, g0, cfg.compression, C, "synthetic-path")


# ------------------------------------------------------ the clients axis


def drive_tapped(cfg, smi, label, devices):
    """``drive`` on ``devices`` with every round's codec payload and
    per-client stats captured on the device (clones, so the round walls
    keep no host copy), the peak memory of every distinct card of
    ``devices``, and each round's bytes between the lead client shard and
    the others (``Sharded.traffic``, read after the round body and after
    its evaluation: ``to_shards``, ``to_lead``, ``eval_to_shards``,
    ``eval_to_lead``). Returns ``(result, launches, payloads, stats,
    peaks, traffic, shards)``."""
    from bcfl_tpu_torch.fed.engine import FedEngine

    payloads, client_stats, marks, shards = [], [], [], []
    check, to_rec = FedEngine._check_payload, FedEngine._stats_to_rec
    evaluate = FedEngine._maybe_eval

    def tap_payload(self, payload):
        payloads.append({p: {k: v.clone() for k, v in parts.items()}
                         for p, parts in payload.items()})
        return check(self, payload)

    def tap_stats(self, rnd, st):
        # every mode lands its rows before its record reads the stats
        client_stats.append(st.clone())
        marks.append(dict(self.local_train.traffic))
        return to_rec(self, rnd, st)

    def tap_eval(self, rnd, *args):
        evaluate(self, rnd, *args)
        marks.append(dict(self.local_train.traffic))
        shards[:] = [len(self.local_train.bodies)]

    cards = sorted({torch.device(d) for d in devices}, key=str)
    torch.cuda.init()  # the allocator's per-card stats exist from here
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    FedEngine._check_payload, FedEngine._stats_to_rec = tap_payload, tap_stats
    FedEngine._maybe_eval = tap_eval
    try:
        result, launches, _ = drive(cfg, smi, label, devices=devices)
    finally:
        FedEngine._check_payload, FedEngine._stats_to_rec = check, to_rec
        FedEngine._maybe_eval = evaluate
    peaks = {str(d): torch.cuda.max_memory_allocated(d) / 1e9 for d in cards}
    traffic, last = [], {"to_shards": 0, "to_lead": 0}
    for body, after_eval in zip(marks[::2], marks[1::2]):
        traffic.append({**{k: body[k] - last[k] for k in body},
                        **{f"eval_{k}": after_eval[k] - body[k]
                           for k in body}})
        last = after_eval
    return (result, launches, payloads, client_stats, peaks, traffic,
            shards[0])


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (-0.0 and NaN payloads count)."""
    return held("bit-identical", [(a.to(b.device), b)])[0]


#: the kernels each client shard launches for its own rows (the codec's
#: sender stage): on ``n`` shards, ``n`` times one shard's launches
SHARD_CODEC_OPS = ("int8_quantize", "topk_select")


def kept_run(result, launches, payloads, client_stats, peaks, traffic):
    """What :func:`clients_axis_pair` keeps of one ``drive_tapped`` run:
    ``(compared, printed)``, the first ``(trainable, ledger head, round
    records, launches, payloads, per-client stats)``, the second
    ``(launches, round walls, peaks, per-round bytes between the lead
    shard and the others)``; not the model (a 7B base twice would not fit
    the lead card)."""
    head = result.ledger.head if result.ledger is not None else None
    return ((result.trainable, head, result.metrics.rounds, launches,
             payloads, client_stats),
            (launches, [r.wall_s for r in result.metrics.rounds], peaks,
             traffic))


def clients_axis_pair(cfg, smi, label, devices, one=None, one_run=None):
    """``cfg`` on ``one`` (default ``[cuda:0]``: one client shard) and on
    ``devices`` (one shard per device the mesh takes, or per row of a 2-D
    mesh), each through ``run`` with the launch counts set to 0 just
    before it and read just after: the global tree, every round's payload
    bytes, the ledger head, the per-client stats and evaluation bit for
    bit; K1-K3 launched as often as on one shard, K4 and K5 (each shard
    encodes its own rows) exactly ``shards`` times as often. ``one_run``,
    when given, is the one-shard run's :func:`kept_run` from a path that
    already ran that configuration on ``one``. Returns ``{"one": ...,
    "many": ..., "shards": n, "template": ...}``, each run ``(launches,
    round walls, peaks, per-round bytes between the lead shard and the
    others)``, the template the trained tree's leaf shapes on the meta
    device."""
    out, runs = {}, {}
    if one_run is not None:
        runs["one"], out["one"] = one_run
    todo = [("one", list(one or [torch.device("cuda", 0)])),
            ("many", list(devices))]
    for key, devs in todo[1 if one_run is not None else 0:]:
        result, launches, payloads, st, peaks, traffic, shards = drive_tapped(
            cfg, smi, f"{label} on {len(devs)} device(s)", devs)
        runs[key], out[key] = kept_run(result, launches, payloads, st,
                                       peaks, traffic)
        out["shards"] = shards
        out["template"] = {p: torch.empty(x.shape, device="meta")
                           for p, x in result.trainable.items()}
        del result
        torch.cuda.empty_cache()
    (t1, head1, rec1, n1, p1, s1) = runs["one"]
    (tn, headn, recn, nn, pn, sn) = runs["many"]
    bad = [p for p, x in t1.items() if not same_bits(tn[p], x)]
    if len(p1) != cfg.num_rounds or len(pn) != len(p1):
        bad.append(f"payload rounds {len(p1)} / {len(pn)}")
    for rnd, (a, b) in enumerate(zip(p1, pn)):
        bad += [f"round {rnd} payload {p}/{k}" for p in a for k in a[p]
                if not same_bits(b[p][k], a[p][k])]
    bad += [f"round {rnd} client stats" for rnd, (a, b)
            in enumerate(zip(s1, sn)) if not same_bits(b, a)]
    if head1 != headn:
        bad.append("ledger head")
    for a, b in zip(rec1, recn):
        if (a.train_loss, a.local_acc, a.global_loss, a.bytes_on_wire) != (
                b.train_loss, b.local_acc, b.global_loss, b.bytes_on_wire):
            bad.append(f"round {a.round} record")
    want = {k: v * (out["shards"] if k in SHARD_CODEC_OPS else 1)
            for k, v in n1.items()}
    if nn != want:
        bad.append(f"launches {nn} against {want} (one shard's {n1}, K4 "
                   f"and K5 x {out['shards']} shards)")
    if bad:
        raise RuntimeError(f"{label}: {len(devices)} devices differ from "
                           f"one: {bad[:8]}")
    return out


def print_clients_axis(label, pair, smi):
    (_, w1, pk1, _), (nn, wn, pkn, moved) = pair["one"], pair["many"]
    shards = pair["shards"]
    print(f"{label}: {shards} client shard(s) equal one shard bit for bit "
          f"(global tree, payloads, ledger head, per-client stats, "
          f"launches {nn}); round walls one shard "
          f"{[round(w, 4) for w in w1]} s, {shards} shards "
          f"{[round(w, 4) for w in wn]} s; peak GB one shard "
          f"{ {k: round(v, 2) for k, v in pk1.items()} }, {shards} shards "
          f"{ {k: round(v, 2) for k, v in pkn.items()} }", flush=True)
    for rnd, t in enumerate(moved):
        print(f"{label} round {rnd}: MB between the lead shard and the "
              f"others: the round to them {t['to_shards'] / 1e6:.3f}, to "
              f"the lead {t['to_lead'] / 1e6:.3f}; its evaluation to them "
              f"{t['eval_to_shards'] / 1e6:.3f}, to the lead "
              f"{t['eval_to_lead'] / 1e6:.3f} ({smi})", flush=True)


def codec_on_each_card(ck, template, comp, per, label):
    """K5 and K4 on every visible card but card 0, at one client shard's
    calls of ``per`` clients (``main_path_calls``), random inputs, each
    held bit for bit to its plain version on the same card: the kernels a
    shard launches on its own card. These launches compare, they do not
    count for a path."""
    n = torch.cuda.device_count()
    topk, int8 = main_path_calls(template, comp, per)
    for d in range(1, n):
        with torch.cuda.device(d):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(100 + d)
            pairs = []
            for R, N, k in topk:
                x = torch.randn((R, N), generator=gen, device="cuda")
                pairs += zip(ck.TOPK_SELECT(x, k=k),
                             ck.topk_select_ref(x, k=k))
                del x
            gs = [torch.randn(sh, generator=gen, device="cuda")
                  for sh in int8]
            us = ([torch.rand(sh, generator=gen, device="cuda")
                   for sh in int8] if comp.stochastic else None)
            for got, want in zip(
                    ck.INT8_QUANTIZE(gs, us, stochastic=comp.stochastic),
                    ck.int8_quantize_grids_ref(gs, us,
                                               stochastic=comp.stochastic)):
                pairs += zip(got, want)
            torch.cuda.synchronize(d)
            same, _ = held("bit-identical", pairs)
        print(f"{label}: on cuda:{d}, topk_select ({len(topk)} calls of "
              f"{per} client(s)' rows) and int8_quantize (one call, "
              f"{len(int8)} grids) "
              f"{'equal' if same else 'DIFFER from'} their plain versions "
              f"bit for bit", flush=True)
        if not same:
            raise RuntimeError(f"{label}: a codec kernel on cuda:{d} "
                               "differs from its plain version")


def phase_clients_axis(ck, stats, smi, dataset, medical):
    """(z): the clients axis. Path (b)'s configuration with the ledger on
    ``[cuda:0] * 4`` (4 client shards of 1 sharing one card), then path
    (c) (10 clients) on ``[cuda:0] * 4`` (2 shards of 5), each against the
    same configuration on ``[cuda:0]``: global tree, payload bytes, ledger
    head and per-client stats bit for bit, K1-K3 launched as on one shard
    and K4, K5 once per shard (each shard encodes its own rows); the round
    walls, the peaks and each round's bytes between the lead shard and the
    others print. Each of the four runs is a main path run whose launches
    count. Where more cards are visible, K4 and K5 on each of them are
    held to their plain versions at (b)'s calls of one shard's rows."""
    from bcfl_tpu_torch.config import LedgerConfig

    quad = [torch.device("cuda", 0)] * 4
    cfg = flash_config(dataset, ledger=LedgerConfig(enabled=True))
    label = "clients axis (z) seq-512 flash"
    pair = clients_axis_pair(cfg, smi, label, quad)
    for key in ("one", "many"):
        count_launches(stats, pair[key][0])
        if min(pair[key][0].values()) <= 0:
            raise RuntimeError(f"{label}: a kernel never launched "
                               f"({pair[key][0]})")
    print_clients_axis(label, pair, smi)
    codec_on_each_card(ck, pair["template"], cfg.compression, 1, label)
    torch.cuda.empty_cache()
    cfg = gossip_config(medical)
    label = "clients axis (z) serverless gossip"
    pair = clients_axis_pair(cfg, smi, label, quad)
    for key in ("one", "many"):
        count_launches(stats, pair[key][0])
        for name in SHARD_CODEC_OPS:
            if pair[key][0][name] <= 0:
                raise RuntimeError(f"{label}: {name} never launched")
    print_clients_axis(label, pair, smi)
    torch.cuda.empty_cache()



# -------------------------------------------------------------- profile


def phase_profile(cfg, label):
    """Where one warm round of a main path spends its time: the round's
    three stages timed on the host clock with a synchronize after each,
    then the same round under ``torch.profiler`` for the device's busy time
    and the kernels by device time."""
    import numpy as np

    from bcfl_tpu_torch.compression import codecs as cc
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.fed.engine import FedEngine
    from bcfl_tpu_torch.parallel import masked_weighted_mean

    cfg = cfg.replace(num_rounds=1, eval_every=0)
    eng = FedEngine(cfg, device="cuda")
    C, g = cfg.num_clients, eng.trainable0
    batches, n_ex = eng._round_batches(0)
    w = eng._weights(np.ones((C,), np.float32), n_ex)
    resid = cc.zero_residual(g, C)

    def one_round():
        t = {}
        t0 = time.perf_counter()
        gens = prng.client_round_generators(cfg.seed, C, 0, eng.device)
        new_t, _ = cs.train_clients(eng.local_train, g, batches, gens)
        torch.cuda.synchronize()
        t["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, dec, _ = cs.compress_stage(eng._comp, new_t, g, resid,
                                      prng.codec_uniforms(cfg.seed, 0))
        torch.cuda.synchronize()
        t["codec"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        masked_weighted_mean(cs.recon(g, dec, new_t), w, g)
        torch.cuda.synchronize()
        t["mean"] = time.perf_counter() - t0
        return t

    profile_round(one_round, label)


def phase_profile_gossip(cfg, label):
    """``phase_profile`` for a serverless round with the ledger on: local
    training from each client's row, the codec against the round-start
    stack, the ledger's fingerprint, commit and auth, and the ring-gossip
    mix of what arrived."""
    import numpy as np

    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.fed.engine import FedEngine

    cfg = cfg.replace(num_rounds=1, eval_every=0)
    eng = FedEngine(cfg, device="cuda")
    C = cfg.num_clients
    start = cs.broadcast(eng.trainable0, C)
    ef = [{p: torch.zeros_like(x) for p, x in start.items()}]
    batches, _ = eng._round_batches(0)
    m = eng._mask_tensor(np.ones((C,), np.float32))
    rnd = [0]

    def one_round():
        t = {}
        t0 = time.perf_counter()
        gens = prng.client_round_generators(cfg.seed, C, 0, eng.device)
        new_t, _ = cs.local_updates(eng.local_train, start, batches, gens)
        torch.cuda.synchronize()
        t["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        payload, rec, ef[0] = cs.encode_deltas(
            eng._comp, new_t, start, ef[0], prng.codec_uniforms(cfg.seed, 0))
        torch.cuda.synchronize()
        t["codec"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng._ledger_verify(rnd[0], payload, kind="payload")
        rnd[0] += 1
        t["ledger"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.mix_recv(new_t, rec, m, start, cfg.topology.gossip_alpha,
                    cfg.topology.gossip_steps)
        torch.cuda.synchronize()
        t["mix"] = time.perf_counter() - t0
        return t

    profile_round(one_round, label)


def profile_round(one_round, label):
    """Time ``one_round`` (stage name -> host seconds) warm, then once
    under ``torch.profiler``: the device's busy share, the kernels by
    device time and the host ops by the device time they launched."""
    from torch.profiler import ProfilerActivity, profile

    one_round()  # warm
    t = one_round()
    total = sum(t.values())
    print(f"{label} round stages (host clock, synchronized, warm): "
          + ", ".join(
        f"{k} {v * 1e3:.1f} ms ({v / total:.1%})" for k, v in t.items())
        + f", total {total * 1e3:.1f} ms", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    avg = prof.key_averages()
    # device-side events are kernels and memcpys, plus the mirrors of host
    # annotations (e.g. "Optimizer.step#AdamW.step") that span the kernels
    # launched inside them: those are left out, or the time counts twice
    host_keys = {e.key for e in avg if e.device_type == DeviceType.CPU}
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA
               and e.key not in host_keys]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3  # ms
    print(f"{label} profiled round: device busy {busy:.1f} ms = "
          f"{busy / (total * 1e3):.1%} of the unprofiled warm round "
          f"({total * 1e3:.1f} ms; the profiled one took "
          f"{wall * 1e3:.1f} ms)", flush=True)
    print("device kernels by device time:", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}", flush=True)
    print("host ops by the device time they launched:", flush=True)
    ops = [e for e in avg if e.device_type == DeviceType.CPU
           and e.device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}", flush=True)


# ------------------------------------------------------------ reference


def reference_round(use_flash: bool, S: int):
    """A tiny-bert server round (float32, dropout off, int8+topk at
    topk_frac 1, ragged masks) on the card and on the CPU, held to the
    tolerance of ``tests/test_torch_round.py``; returns the CPU round."""
    import numpy as np

    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed.client_step import (
        make_local_train, make_loss_fn, server_round)
    from bcfl_tpu_torch.models import build
    from bcfl_tpu_torch.models.bert import init_params
    from bcfl_tpu_torch.models.convert import trainable_tree

    rng = np.random.default_rng(S)
    C, steps, B = 2, 2, 4
    batches_np = {
        "ids": rng.integers(4, 512, (C, steps, B, S)).astype(np.int32),
        "mask": (np.arange(S)[None, None, None, :]
                 < rng.integers(4, S + 1, (C, steps, B, 1))).astype(np.int32),
        "labels": rng.integers(0, 2, (C, steps, B)).astype(np.int32),
        "example_mask": np.ones((C, steps, B), np.float32)}
    comp = CompressionConfig(kind="int8+topk", topk_frac=1.0,
                             stochastic=False)
    base = build("tiny-bert", num_labels=2, vocab_size=512,
                 dtype=torch.float32, dropout_rate=0.0, use_flash=use_flash,
                 flash_min_seq=0)
    init_params(base, prng.generator("cpu", 7))
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        g0 = trainable_tree(model)
        batches = {k: torch.from_numpy(v).to(dev)
                   for k, v in batches_np.items()}
        w = torch.tensor([3.0, 1.0], device=dev)
        resid = {p: torch.zeros((C,) + tuple(x.shape), device=dev)
                 for p, x in g0.items()}
        local = make_local_train(model, make_loss_fn(model))
        out[dev] = server_round(local, comp, g0, batches, w, [None] * C,
                                resid)
    # the tolerance of tests/test_torch_round.py: AdamW moves a coordinate
    # with a near-zero gradient by up to lr per step in the direction of
    # its float32 noise, so every coordinate is held to 2 * lr * steps plus
    # one quantization step, and all but 1e-4 of them (the key biases,
    # whose exact gradient is zero, left out) to 2e-6 plus one step
    attn = "flash" if use_flash else "dense"
    lr, far, total, worst = 5e-5, 0, 0, 0.0
    for p, x in out["cpu"].global_t.items():
        step = float(out["cpu"].payload[p]["s"].max())
        err = (out["cuda"].global_t[p].cpu() - x).abs()
        worst = max(worst, float(err.max()))
        if float(err.max()) > 2 * lr * steps * 1.01 + step:
            raise RuntimeError(f"reference round ({attn}): {p} differs by "
                               f"{float(err.max())}")
        if not p.endswith("/key/bias"):
            far += int((err > 2e-6 + step).sum())
            total += err.numel()
    if far > total * 1e-4:
        raise RuntimeError(f"reference round ({attn}): {far} of {total} "
                           "coordinates past 2e-6 plus one quantization step")
    print(f"reference round (tiny-bert, f32, {attn} attention, S={S}, card "
          f"vs CPU): max |diff| {worst:.3e}, {far} of {total} coordinates "
          "past 2e-6 + one quantization step", flush=True)
    return out["cpu"]


def reference_gossip_round():
    """A tiny-bert serverless round (ring gossip, int8+topk at topk_frac 1,
    float32, dropout off, S=16, each client from its own row, client 2
    masked) on the card and on the CPU, held to the tolerance of
    ``tests/test_torch_round.py``; then the fingerprint of its payload on
    the card against the CPU, at the tolerance of
    ``tests/test_torch_ledger.py`` (rtol 1e-5 plus 1e-6 of the largest
    magnitude)."""
    import numpy as np

    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.ledger import client_fingerprint
    from bcfl_tpu_torch.models import build
    from bcfl_tpu_torch.models.bert import init_params
    from bcfl_tpu_torch.models.convert import trainable_tree

    rng = np.random.default_rng(3)
    C, steps, B, S = 4, 2, 4, 16
    batches_np = {
        "ids": rng.integers(4, 512, (C, steps, B, S)).astype(np.int32),
        "mask": (np.arange(S)[None, None, None, :]
                 < rng.integers(4, S + 1, (C, steps, B, 1))).astype(np.int32),
        "labels": rng.integers(0, 2, (C, steps, B)).astype(np.int32),
        "example_mask": np.ones((C, steps, B), np.float32)}
    comp = CompressionConfig(kind="int8+topk", topk_frac=1.0,
                             stochastic=False)
    base = build("tiny-bert", num_labels=2, vocab_size=512,
                 dtype=torch.float32, dropout_rate=0.0)
    init_params(base, prng.generator("cpu", 11))
    g0 = trainable_tree(base)
    start_np = {p: (x.numpy()[None] + 1e-3 * rng.standard_normal(
        (C,) + tuple(x.shape))).astype(np.float32) for p, x in g0.items()}
    mask = np.asarray([1, 1, 0, 1], np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        start = {p: torch.from_numpy(x).to(dev) for p, x in start_np.items()}
        resid = {p: torch.zeros_like(x) for p, x in start.items()}
        local = cs.make_local_train(model, cs.make_loss_fn(model))
        out[dev] = cs.gossip_round(
            local, comp, start,
            {k: torch.from_numpy(v).to(dev) for k, v in batches_np.items()},
            torch.from_numpy(mask).to(dev), [None] * C, resid, None,
            alpha=0.5, steps=1)
    lr, far, total, worst = 5e-5, 0, 0, 0.0
    for p, x in out["cpu"].global_t.items():
        step = float(out["cpu"].payload[p]["s"].max())
        err = (out["cuda"].global_t[p].cpu() - x).abs()
        worst = max(worst, float(err.max()))
        if float(err.max()) > 2 * lr * steps * 1.01 + step:
            raise RuntimeError(f"reference gossip round: {p} differs by "
                               f"{float(err.max())}")
        if not p.endswith("/key/bias"):
            far += int((err > 2e-6 + step).sum())
            total += err.numel()
    if far > total * 1e-4:
        raise RuntimeError(f"reference gossip round: {far} of {total} "
                           "coordinates past 2e-6 plus one quantization step")
    print(f"reference gossip round (tiny-bert, f32, int8+topk, ring gossip, "
          f"S={S}, card vs CPU): max |diff| {worst:.3e}, {far} of {total} "
          "coordinates past 2e-6 + one quantization step", flush=True)
    # one payload, fingerprinted on the card and on the CPU
    pay = out["cpu"].payload
    fp_cpu = client_fingerprint(pay)
    fp_gpu = client_fingerprint({p: {k: v.cuda() for k, v in parts.items()}
                                 for p, parts in pay.items()}).cpu()
    scale = float(fp_cpu.abs().max())
    err = float((fp_gpu - fp_cpu).abs().max())
    ok = bool(((fp_gpu - fp_cpu).abs()
               <= 1e-5 * fp_cpu.abs() + 1e-6 * scale).all())
    print(f"payload fingerprint card vs CPU: max |diff| {err:.3e} of "
          f"magnitude {scale:.3e}", flush=True)
    if not ok:
        raise RuntimeError("the payload fingerprint differs between the "
                           "card and the CPU past rtol 1e-5 + 1e-6 max")


def tiny_engine_config(**kw):
    """A tiny-bert engine configuration for the card-vs-CPU checks."""
    from bcfl_tpu_torch.config import FedConfig, PartitionConfig

    base = dict(name="reference", model="tiny-bert", dataset="synthetic",
                num_labels=2, num_clients=3, num_rounds=2, seq_len=16,
                batch_size=4, max_local_batches=2, vocab_size=512,
                eval_every=0, compute_dtype="float32",
                partition=PartitionConfig(kind="iid", iid_samples=8))
    base.update(kw)
    return FedConfig(**base)


def reference_faithful_round():
    """A tiny-bert faithful run (3 clients, 2 rounds, the ledger on,
    dropout off, float32) on the card and on the CPU from the same start
    and batches: ``chain_ok`` 1 and every client authenticated on both,
    the final trees within 2 * lr * steps per sequential training (each
    round's last client trained C times in turn), all but 1e-4 of the
    coordinates within 2e-6 per training."""
    from bcfl_tpu_torch.config import LedgerConfig
    from bcfl_tpu_torch.fed.engine import FedEngine

    cfg = tiny_engine_config(mode="serverless", faithful=True,
                             weighted_agg=False,
                             ledger=LedgerConfig(enabled=True))
    out = {}
    start = None
    for dev in ("cpu", "cuda"):
        eng = FedEngine(cfg, device=dev)
        if start is None:
            start = eng.trainable0
        eng.trainable0 = {p: x.to(dev) for p, x in start.items()}
        eng._generators = lambda rnd: [None] * cfg.num_clients
        out[dev] = eng.run()
        m = out[dev].metrics
        if m.ledger.get("chain_ok") != 1.0 or any(
                r.auth != [1.0] * cfg.num_clients for r in m.rounds):
            raise RuntimeError(f"reference faithful run ({dev}): ledger "
                               f"{m.ledger}, auth {[r.auth for r in m.rounds]}")
    trainings = cfg.num_clients * cfg.num_rounds
    lr, steps, far, total, worst = 5e-5, 2, 0, 0, 0.0
    for p, x in out["cpu"].trainable.items():
        err = (out["cuda"].trainable[p].cpu() - x).abs()
        worst = max(worst, float(err.max()))
        if float(err.max()) > trainings * 2 * lr * steps * 1.01:
            raise RuntimeError(f"reference faithful run: {p} differs by "
                               f"{float(err.max())}")
        if not p.endswith("/key/bias"):
            far += int((err > trainings * 2e-6).sum())
            total += err.numel()
    if far > total * 1e-4:
        raise RuntimeError(f"reference faithful run: {far} of {total} "
                           f"coordinates past {trainings} x 2e-6")
    print(f"reference faithful run (tiny-bert, f32, ledger, {cfg.num_clients}"
          f" clients, card vs CPU): chain_ok 1 on both, max |diff| "
          f"{worst:.3e}, {far} of {total} coordinates past {trainings} x 2e-6",
          flush=True)


def reference_remat_dropout():
    """On the card, a tiny-bert server round (2 clients, float32, dropout
    ON from per-client CUDA generators of the same seeds) with and without
    remat: the same gradients (one step, compared directly) and the same
    round, to float32 noise of the recompute (1e-6 of the largest
    value)."""
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed.client_step import (
        make_local_train, make_loss_fn, server_round)
    from bcfl_tpu_torch.models import build
    from bcfl_tpu_torch.models.bert import init_params
    from bcfl_tpu_torch.models.convert import trainable_tree

    import numpy as np

    rng = np.random.default_rng(12)
    C, steps, B, S = 2, 2, 4, 32
    batches = {
        "ids": torch.from_numpy(rng.integers(4, 512, (C, steps, B, S))
                                .astype(np.int64)).cuda(),
        "mask": torch.from_numpy((np.arange(S)[None, None, None, :]
                                  < rng.integers(4, S + 1, (C, steps, B, 1)))
                                 .astype(np.int32)).cuda(),
        "labels": torch.from_numpy(rng.integers(0, 2, (C, steps, B))
                                   .astype(np.int64)).cuda(),
        "example_mask": torch.ones((C, steps, B), device="cuda")}
    grads, rounds = [], []
    for remat in (False, True):
        with torch.device("cuda"):
            model = build("tiny-bert", num_labels=2, vocab_size=512,
                          dtype=torch.float32, remat=remat)
        init_params(model, prng.generator("cuda", 21))
        g0 = trainable_tree(model)
        model.train()
        loss_fn = make_loss_fn(model)
        loss, _, _ = loss_fn({k: v[0, 0] for k, v in batches.items()},
                             prng.generator("cuda", 5))
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
        gens = [prng.generator("cuda", 6, c) for c in range(C)]
        rounds.append(server_round(make_local_train(model, loss_fn), None,
                                   g0, batches, torch.ones(C, device="cuda"),
                                   gens).global_t)
    worst_g = max(float((grads[0][n] - x).abs().max())
                  for n, x in grads[1].items())
    scale_g = max(float(x.abs().max()) for x in grads[0].values())
    worst_r = max(float((rounds[0][p] - x).abs().max())
                  for p, x in rounds[1].items())
    scale_r = max(float(x.abs().max()) for x in rounds[0].values())
    print(f"reference remat round (tiny-bert, f32, dropout on, card): "
          f"gradients max |diff| {worst_g:.3e} of {scale_g:.3e}, round max "
          f"|diff| {worst_r:.3e} of {scale_r:.3e}", flush=True)
    if worst_g > 1e-6 * scale_g or worst_r > 1e-6 * scale_r:
        raise RuntimeError("remat with dropout changed the gradients on the "
                           "card")


def reference_fp16_round():
    """A tiny-bert server round with float16 compute and dense attention
    (2 clients, float32 params, SGD at lr 1e-2, dropout off) on the card
    and on the CPU from the same start: within 2e-5, the tolerance of
    ``tests/test_torch_switches.py``'s float16 round against JAX."""
    import numpy as np

    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed.client_step import (
        make_local_train, make_loss_fn, server_round)
    from bcfl_tpu_torch.models import build
    from bcfl_tpu_torch.models.bert import init_params
    from bcfl_tpu_torch.models.convert import trainable_tree

    rng = np.random.default_rng(13)
    C, steps, B, S = 2, 2, 4, 16
    batches_np = {
        "ids": rng.integers(4, 512, (C, steps, B, S)).astype(np.int32),
        "mask": (np.arange(S)[None, None, None, :]
                 < rng.integers(4, S + 1, (C, steps, B, 1))).astype(np.int32),
        "labels": rng.integers(0, 2, (C, steps, B)).astype(np.int32),
        "example_mask": np.ones((C, steps, B), np.float32)}
    base = build("tiny-bert", num_labels=2, vocab_size=512,
                 dtype=torch.float16, dropout_rate=0.0)
    init_params(base, prng.generator("cpu", 17))
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        out[dev] = server_round(
            make_local_train(model, make_loss_fn(model), "sgd", 1e-2),
            None, trainable_tree(model),
            {k: torch.from_numpy(v).to(dev) for k, v in batches_np.items()},
            torch.tensor([2.0, 1.0], device=dev), [None] * C).global_t
    worst = max(float((out["cuda"][p].cpu() - x).abs().max())
                for p, x in out["cpu"].items())
    print(f"reference fp16-compute round (tiny-bert, dense, SGD, card vs "
          f"CPU): max |diff| {worst:.3e} (bound 2e-5)", flush=True)
    if worst > 2e-5:
        raise RuntimeError(f"fp16-compute round: card and CPU differ by "
                           f"{worst}")


def phase_reference():
    """The main paths' functions on small inputs: the card against the
    CPU (plain versions), as the CPU tests hold the CPU against JAX."""
    import numpy as np

    from bcfl_tpu_torch.compression import CompressionConfig, encode_tree
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.models import full_float32_matmuls
    from bcfl_tpu_torch.ops import registry

    full_float32_matmuls()
    cpu_round = reference_round(False, 16)
    registry.reset_launches()
    reference_round(True, 64)
    if min(registry.launch_counts()[n] for n in FLASH_OPS) <= 0:
        raise RuntimeError("the flash reference round launched no flash "
                           "kernel on the card")
    rng = np.random.default_rng(0)
    # the codec alone: card vs CPU on one delta, payload bit for bit
    tree = {p: torch.from_numpy(rng.standard_normal((3,) + tuple(x.shape))
                                .astype(np.float32))
            for p, x in cpu_round.global_t.items()}
    comp = CompressionConfig(kind="int8+topk", topk_frac=0.05)
    draw = prng.codec_uniforms(5, 0)

    def uniforms(i, shape, device):
        return draw(i, shape, torch.device("cpu")).to(device)

    pay_cpu = encode_tree(comp, tree, uniforms)
    pay_gpu = encode_tree(comp, {p: x.cuda() for p, x in tree.items()},
                          uniforms)
    for p, parts in pay_cpu.items():
        for name, t in parts.items():
            if not held("bit-identical", [(pay_gpu[p][name].cpu(), t)])[0]:
                raise RuntimeError(f"codec payload {p}/{name}: card and CPU "
                                   "differ")
    print(f"codec payload (int8+topk, {len(tree)} leaves, 3 clients): card "
          "and CPU bit-identical", flush=True)
    reference_gossip_round()
    reference_faithful_round()
    reference_remat_dropout()
    reference_fp16_round()


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the four phases, a stage and kernel "
                         "breakdown of one warm round of each main path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    # the hub datasets take their offline stand-ins: never reach for a host
    for var in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE"):
        os.environ.setdefault(var, "1")
    from bcfl_tpu_torch.ops import codec_kernels as ck
    from bcfl_tpu_torch.ops import cuda_build, registry
    from bcfl_tpu_torch.ops import flash_kernels as fk

    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    stats = {op.name: KernelStats(op) for op in registry.kernel_ops()}
    t0 = time.perf_counter()
    secs = cuda_build.build_all()  # every registered kernel op's source
    print(f"build: {time.perf_counter() - t0:.2f} s wall, nvcc seconds "
          f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}",
          flush=True)
    for line in ptxas_notes(cuda_build.BUILD_LOGS):
        print(line, flush=True)
    native_status()

    def done(what):
        # the script's own clock, so each phase's share of the call shows
        print(f"{what}: done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    done("build")
    dataset = write_long_docs()
    main_lens = main_padding(dataset, flash_config(dataset))
    llama_lens = main_padding(dataset, llama_config(dataset))
    flash_per, llama_per = phase_kernels(ck, fk, stats, main_lens,
                                         llama_lens)
    done("kernels")
    b_path = phase_main(ck, stats, smi, dataset, flash_per)
    medical = write_medical_docs()
    c_walls = phase_p2p(ck, stats, smi, medical)
    done("paths (a)-(d), (u)")
    phase_run_surface(ck, fk, stats, smi, dataset, b_path)
    done("paths (e)-(g)")
    phase_resilience(ck, stats, smi, dataset)
    done("paths (h)-(j)")
    k_peak = phase_llama(ck, fk, stats, smi, dataset, llama_per)
    done("paths (k)-(l)")
    tp_one, long4k = phase_parallel(fk, stats, smi, dataset, llama_per,
                                    k_peak)
    done("paths (v)-(w)")
    phase_inner_rows(stats, smi, dataset, long4k, tp_one)
    done("path (aa)")
    phase_lint()
    path_synthetic(ck, stats, smi)
    done("paths (x)-(y)")
    phase_clients_axis(ck, stats, smi, dataset, medical)
    done("path (z)")
    m_loss = phase_dist(ck, stats, smi, medical, c_walls)
    done("path (m)")
    phase_partition_kill(stats, smi, medical)
    done("path (o)")
    phase_storage_repair(stats, smi, medical)
    done("path (p)")
    phase_byzantine(stats, smi, medical, m_loss)
    done("path (q)")
    phase_chaos(stats, smi, medical)
    done("path (r)")
    phase_gossip(stats, smi, medical)
    done("path (s)")
    phase_lora_dist(ck, stats, smi, dataset)
    done("path (t)")
    count_launches(stats, phase_hf(smi))
    done("path (n)")
    phase_reference()
    done("reference")
    if args.profile:
        phase_profile(main_config(), "seq-128 path")
        phase_profile(flash_config(dataset), "seq-512 flash path")
        phase_profile_gossip(gossip_config(medical), "serverless gossip path")
        phase_profile(llama_config(dataset, lora_rank=8, registry_size=64,
                                   sample_clients=4),
                      "llama2-7b LoRA cohort path (k)")
    for name, by in PATH_LAUNCHES_BY_DTYPE.items():
        stats[name].launched(by)
    print(json.dumps({"kernels": [s.record() for s in stats.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
