"""Command line: port of ``bcfl_tpu/entrypoints/__main__.py`` for the
flags the ported slice supports.

    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu
    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu \\
        --use-flash on --seq-len 64
    python -m bcfl_tpu_torch.entrypoints --preset bcfl_async_pagerank \\
        --device cpu --model tiny-albert --dataset synthetic --rounds 2
    python -m bcfl_tpu_torch.entrypoints --preset server_iid_medical \\
        --model bert-base --compress int8+topk --device cuda
    python -m bcfl_tpu_torch.entrypoints --preset serverless_cancer_biobert \\
        --sweep --rounds 2    # 5/10/20 clients; figures and JSON in results/
    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu \\
        --rounds 3 --chaos-crash-round 1 --checkpoint-dir ck \\
        --checkpoint-every 1    # raises SimulatedCrash at round 1
    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu \\
        --rounds 3 --chaos-crash-round 1 --checkpoint-dir ck \\
        --checkpoint-every 1 --resume    # rounds 1 and 2 from round 0's
    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu \\
        --mode server --model tiny-llama --lora-rank 4 --task causal_lm \\
        --rounds 1 --seq-len 32 --registry-size 16 --sample-clients 4
    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu \\
        --runtime dist --peers 2 --clients 4 --rounds 3 --seq-len 16 \\
        --batch-size 4 --ledger --compress int8+topk    # 2 peer processes
    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu \\
        --runtime dist --peers 3 --clients 6 --rounds 5 --seq-len 16 \\
        --batch-size 4 --ledger --aggregator trimmed_mean --dist-buffer 3 \\
        --reputation --reputation-quarantine-rounds 1000 --chaos-byz 2 \\
        --chaos-byz-behaviors scale,digest_forge --chaos-seed 7
    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu \\
        --runtime dist --peers 3 --clients 6 --rounds 3 --seq-len 16 \\
        --batch-size 4 --ledger --chaos-wire drop=0.2,dup=0.2,corrupt=0.05
    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu \\
        --runtime dist --peers 2 --clients 4 --rounds 2 --seq-len 16 \\
        --batch-size 4 --model tiny-llama --task causal_lm --lora-rank 2 \\
        --ledger --compress int8+topk --dist-buffer 2 --dist-run-dir RUN
    python -m bcfl_tpu_torch.entrypoints trace RUN     # collate + invariants
    python -m bcfl_tpu_torch.entrypoints monitor RUN   # the live monitor
    python -m bcfl_tpu_torch.entrypoints lint --json   # static analysis

Subcommands: ``trace RUN_DIR`` collates a run's per-process event streams
into one causally ordered timeline and runs the invariant checks (exit 1
on any violation); ``monitor RUN_DIR`` is its live counterpart
(:mod:`bcfl_tpu_torch.telemetry.live`): incremental collation, streaming
invariants and the per-merge ``health.jsonl`` series over a run that may
still be going (exit 1 on a violation or an unhealed critical alert, 2
with no streams); ``lint [PATHS]`` runs the static checkers of
:mod:`bcfl_tpu_torch.analysis` over ``bcfl_tpu_torch/`` (or PATHS) and
exits 1 on any unsuppressed, unbaselined finding.

``--device`` defaults to ``cuda``, which raises when no GPU is present.
``--runtime dist`` spawns ``--peers`` peer processes on the same device
(:mod:`bcfl_tpu_torch.dist`), prints a JSON summary with the collated
timeline and its invariant verdicts, and exits 1 on a failed peer or a
violation; the run directory (``--dist-run-dir``, default a fresh
temporary directory) keeps the peers' logs, reports, event streams and
checkpoints (``ckpt_peer*``, one every version). ``--chaos-partition``
and ``--chaos-partition-rounds`` there name PEERS and span each peer's
local rounds. ``--aggregator`` (trimmed_mean, median, krum: the robust
merge over the leader's arrival set, with JAX's buffer preconditions) and
``--reputation*`` (the per-peer tracker) reach ``--runtime dist``, and
``--chaos-byz*`` arms the byzantine lane there (adversarial PEER ids),
``--chaos-wire*`` the wire lane (socket-level faults on every frame).
Gossip dispatch, the limp and the resource lanes are config fields
(``DistConfig(dispatch="gossip")``, ``FaultPlan(limp_*, resource_*)``)
driven through :func:`bcfl_tpu_torch.dist.run_dist`, as in JAX.
Peer crash and rejoin are the harness's
(``bcfl_tpu_torch.dist.run_dist(kill_peer=...)``), so ``--resume`` is
refused with ``--runtime dist``. ``--lora-rank`` (uniform adapters, and
Llama models) reaches ``--runtime dist`` too: the adapter tree is what
every frame, vote, fingerprint and checkpoint of the peers carries.
``--tp`` and ``--sp`` (tensor and sequence parallelism, JAX's flags) take
the engine's devices: the visible CUDA devices, refusing an inner axis
larger than their count in JAX's words, or with ``--device cpu`` as many
CPU devices as the inner axis needs (``FedEngine``'s rule). Every row of
that mesh trains: on four cards ``--tp 2`` runs two client shards of
``tp=2``, as JAX's mesh over ``jax.devices()`` does.
``--pod`` spans the mesh over every process of a pod, as JAX's does; unlike
JAX's CLI, which leaves ``jax.distributed`` to its caller, it joins the
pod itself first (:func:`bcfl_tpu_torch.core.mesh.distributed_init`, the
``BCFL_*`` environment): start one process per host (or per card, each
with its own ``CUDA_VISIBLE_DEVICES``), process 0 prints the run.
``--telemetry-dir``, ``--no-telemetry`` and ``--telemetry-sample`` set
the event streams as JAX's do. ``--rounds-per-dispatch`` fuses rounds
into chunks read back once (:meth:`FedEngine._chunk_rounds`), and
``--fused-tamper`` (JAX's checks and messages) corrupts a round of such a
chunk; a request for a round that runs the per-round path fails at its
round instead of passing vacuously. Any flag of the JAX
command line that is not listed here is rejected as "not ported yet".
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from bcfl_tpu_torch.compression import KINDS as COMPRESS_KINDS
from bcfl_tpu_torch.entrypoints.presets import _HF, get_preset, list_presets
from bcfl_tpu_torch.entrypoints.run import run, run_sweep

# (flag, FedConfig field)
_FIELD_FLAGS = (
    ("clients", "num_clients"), ("rounds", "num_rounds"), ("model", "model"),
    ("dataset", "dataset"), ("seq_len", "seq_len"),
    ("batch_size", "batch_size"), ("lr", "learning_rate"),
    ("max_local_batches", "max_local_batches"),
    ("eval_every", "eval_every"), ("seed", "seed"),
    ("compute_dtype", "compute_dtype"), ("param_dtype", "param_dtype"),
    ("mode", "mode"), ("sync", "sync"), ("aggregator", "aggregator"),
    ("aggregator_trim", "aggregator_trim"),
    ("checkpoint_dir", "checkpoint_dir"),
    ("checkpoint_every", "checkpoint_every"), ("task", "task"),
    ("lora_rank", "lora_rank"), ("lora_ranks", "lora_ranks"),
    ("registry_size", "registry_size"),
    ("sample_clients", "sample_clients"), ("cohort_size", "cohort_size"),
    ("rounds_per_dispatch", "rounds_per_dispatch"), ("tp", "tp"),
    ("sp", "sp"),
)


def build_parser() -> argparse.ArgumentParser:
    # no prefix matching: "--mode" must not be taken for "--model"
    ap = argparse.ArgumentParser(prog="bcfl_tpu_torch", allow_abbrev=False)
    ap.add_argument("--preset", default="smoke",
                    help=f"one of: {', '.join(list_presets())}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--sweep", action="store_true",
                    help="run the 5/10/20-worker sweep like "
                         "serverless_cancer_biobert_allclients.py")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest valid checkpoint of "
                         "--checkpoint-dir")
    ap.add_argument("--hf", action="store_true",
                    help="seed the preset from its model's HF checkpoint "
                         "and tokenizer (needs transformers and the "
                         "checkpoint on disk)")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--model", default=None)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--mode", choices=["server", "serverless"], default=None)
    ap.add_argument("--sync", choices=["sync", "async"], default=None)
    # the multi-process async P2P runtime (bcfl_tpu_torch.dist)
    ap.add_argument("--runtime", choices=["local", "dist"], default=None,
                    help="'dist' runs the multi-process async P2P runtime: "
                         "--peers OS processes, each owning a client "
                         "slice, exchanging updates over TCP with "
                         "FedBuff-buffered aggregation and MEASURED "
                         "staleness (implies sync=async, eval_every=0)")
    ap.add_argument("--peers", type=int, default=None,
                    help="peer process count for --runtime dist "
                         "(num_clients must split evenly across them)")
    ap.add_argument("--dist-deadline", type=float, default=600.0,
                    help="hard per-peer wall deadline in seconds for "
                         "--runtime dist (a hung peer fails the run)")
    ap.add_argument("--dist-buffer", type=int, default=None, metavar="N",
                    help="FedBuff merge target for --runtime dist, in "
                         "DISTINCT sending peers (0 = merge on every "
                         "arrival, the default; must be <= peers)")
    ap.add_argument("--dist-quorum", type=float, default=None,
                    metavar="FRAC",
                    help="quorum fraction for --runtime dist leaders: "
                         "below this reachable fraction the leader stops "
                         "advancing the global (default 0.5)")
    ap.add_argument("--no-dist-pipeline", action="store_true",
                    help="disable the comms/compute overlap for --runtime "
                         "dist (per-destination sender workers + "
                         "double-buffered merge intake, on by default)")
    ap.add_argument("--dist-pipeline-depth", type=int, default=None,
                    metavar="N",
                    help="bounded per-destination handoff queue for the "
                         "pipelined sender (default 2)")
    ap.add_argument("--dist-run-dir", default=None, metavar="DIR",
                    help="run directory of --runtime dist (default: a "
                         "fresh temporary directory)")
    ap.add_argument("--task", choices=["classification", "causal_lm"],
                    default=None,
                    help="causal_lm = federated next-token fine-tuning "
                         "(llama-family models; label columns ignored)")
    ap.add_argument("--lora-rank", type=int, default=None,
                    help="train LoRA adapters of this rank on a frozen base "
                         "(0 = full fine-tune)")
    ap.add_argument("--lora-ranks", type=str, default=None,
                    help="heterogeneous per-client adapter ranks, e.g. "
                         "'2,4,8' cycled over clients (RBLA aggregation). "
                         "Exclusive with --lora-rank")
    ap.add_argument("--registry-size", type=int, default=None,
                    help="simulate a registry of N clients (host state "
                         "only); each round a seeded sampler draws "
                         "--sample-clients of them onto the stacked axis. "
                         "Requires mode=server")
    ap.add_argument("--sample-clients", type=int, default=None,
                    help="per-round sampled cohort size under "
                         "--registry-size; defaults to --clients")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="clients stacked per client shard: pins the "
                         "mesh to sample_clients/cohort_size client "
                         "shards; must divide the sampled cohort size")
    ap.add_argument("--rounds-per-dispatch", type=int, default=None,
                    help="fuse up to N federated rounds into one dispatch, "
                         "read back once at its end (sync server FedAvg or "
                         "parallel gossip; the ledger fuses too via "
                         "device-side fingerprints — only anomaly filters, "
                         "tamper hooks, and faithful mode fall back to "
                         "per-round)")
    ap.add_argument("--sp", type=int, default=None,
                    help="sequence-parallel shards per client: 2-D "
                         "(clients, seq) mesh, ring attention over the seq "
                         "axis (llama causal / encoder non-causal)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel shards per client (2-D clients x tp "
                         "mesh; requires --lora-rank > 0)")
    ap.add_argument("--pod", action="store_true",
                    help="span the mesh over every process of the pod: "
                         "joins it first (core.mesh.distributed_init, the "
                         "BCFL_COORDINATOR / BCFL_NUM_PROCESSES / "
                         "BCFL_PROCESS_ID environment); each process trains "
                         "the client shards on its own devices")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--max-local-batches", type=int, default=None)
    ap.add_argument("--eval-every", type=int, default=None,
                    help="evaluate every Nth round (the last round always "
                         "evaluates); 0 = never")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16", "float16"],
                    help="the model's compute dtype, dense or flash "
                         "attention alike (flash runs the kernels' "
                         "instance of that dtype)")
    ap.add_argument("--remat", action="store_true",
                    help="per-layer activation rematerialization: less HBM "
                         "per client (more clients stack per chip) for "
                         "~1/3 more FLOPs")
    ap.add_argument("--param-dtype", default=None,
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--faithful", action="store_true",
                    help="reference-exact sequential serverless semantics")
    ap.add_argument("--use-flash", choices=["on", "off"], default=None,
                    help="force flash attention on or off (default: the "
                         "model family's choice; encoders stay dense)")
    ap.add_argument("--compress", default=None, choices=list(COMPRESS_KINDS),
                    help="compress the update exchange (int8, topk, "
                         "int8+topk), with error feedback")
    ap.add_argument("--compress-topk", type=float, default=None,
                    metavar="FRAC",
                    help="fraction of coordinates the topk codecs keep "
                         "(default 0.05)")
    ap.add_argument("--compress-chunk", type=int, default=None, metavar="N",
                    help="elements per int8 quantization chunk (default 256)")
    ap.add_argument("--no-compress-ef", action="store_true",
                    help="disable the error-feedback residual")
    ap.add_argument("--anomaly-filter",
                    choices=["pagerank", "dbscan", "zscore", "community",
                             "none"], default=None)
    ap.add_argument("--gossip-steps", type=int, default=None,
                    help="ring-gossip diffusion steps per serverless round "
                         "(0 = exact mask-weighted mean)")
    ap.add_argument("--ledger", action="store_true",
                    help="enable the hash-chained weight ledger (BC-FL)")
    ap.add_argument("--aggregator", default=None,
                    choices=["mean", "trimmed_mean", "median", "krum"],
                    help="aggregation rule: mean = reference FedAvg; the "
                         "robust rules survive up to an aggregator-trim "
                         "fraction of Byzantine clients without the ledger")
    ap.add_argument("--aggregator-trim", type=float, default=None,
                    help="assumed Byzantine fraction for trimmed_mean/krum "
                         "(default 0.2, must be < 0.5)")
    # the fault plan's local lanes (bcfl_tpu_torch.faults.FaultPlan)
    ap.add_argument("--chaos-dropout", type=float, default=None,
                    metavar="P", help="per-round per-client dropout "
                    "probability (fault injection)")
    ap.add_argument("--chaos-straggler", type=float, default=None,
                    metavar="P", help="per-round per-client straggler "
                    "probability (simulated-clock delay)")
    ap.add_argument("--chaos-straggler-delay", type=float, default=30.0,
                    metavar="SECONDS", help="injected straggler delay")
    ap.add_argument("--chaos-corrupt", type=float, default=None,
                    metavar="P", help="per-round per-client transport-"
                    "corruption probability; with --ledger corrupted "
                    "updates fail auth, without it use a robust "
                    "--aggregator")
    ap.add_argument("--chaos-crash-round", type=int, default=None,
                    metavar="N", help="inject a host crash at round N "
                    "(resume afterwards with --resume)")
    ap.add_argument("--chaos-partition", default=None, metavar="GROUPS",
                    help="split the clients into isolated components for "
                         "the --chaos-partition-rounds span: groups like "
                         "'0,1/2,3' (unlisted clients form one extra "
                         "component) or an integer N for a seeded N-way "
                         "split")
    ap.add_argument("--chaos-partition-rounds", default=None,
                    metavar="START:END",
                    help="half-open round span the partition lasts, e.g. "
                         "'2:5' = rounds 2,3,4 (required with "
                         "--chaos-partition)")
    ap.add_argument("--chaos-churn-leave", action="append", default=None,
                    metavar="CLIENT:ROUND",
                    help="client CLIENT permanently leaves at round ROUND "
                         "(repeatable)")
    ap.add_argument("--chaos-churn-join", action="append", default=None,
                    metavar="CLIENT:ROUND",
                    help="client CLIENT joins late at round ROUND "
                         "(repeatable)")
    ap.add_argument("--chaos-flaky", default=None, metavar="CLIENTS",
                    help="comma-separated client ids that corrupt transport "
                         "in intermittent multi-round bursts (see "
                         "--reputation)")
    ap.add_argument("--chaos-flaky-burst", type=int, default=None,
                    metavar="N", help="rounds per flaky burst window "
                    "(default 3)")
    ap.add_argument("--chaos-flaky-on-prob", type=float, default=None,
                    metavar="P", help="probability each flaky window "
                    "actually bursts (default 0.5)")
    ap.add_argument("--chaos-wire", default=None, metavar="SPEC",
                    help="wire-fault lane for --runtime dist: comma list of "
                         "K=V with K in {drop,dup,reorder,delay,corrupt} "
                         "(per-message probabilities) plus optional "
                         "delay-s / hold-s (seconds), e.g. "
                         "'drop=0.2,dup=0.2,reorder=0.2,corrupt=0.05' — "
                         "seeded socket-level frame drop / duplication / "
                         "reorder-hold / delay-jitter / byte-corruption, "
                         "absorbed by the self-healing transport")
    ap.add_argument("--chaos-wire-rounds", default=None, metavar="START:END",
                    help="bound the wire lane to this half-open span of the "
                         "sender's local-round clock (default: every round)")
    ap.add_argument("--chaos-byz", default=None, metavar="PEERS",
                    help="byzantine lane for --runtime dist: comma-separated "
                         "ADVERSARIAL peer ids — each rewrites its outbound "
                         "updates above the wire (scaled/sign-flipped/"
                         "garbage payloads, stale replays, digest "
                         "forgeries, equivocation); caught by the robust "
                         "--aggregator rules, the ledger refingerprint, and "
                         "--reputation quarantine")
    ap.add_argument("--chaos-byz-behaviors", default=None, metavar="LIST",
                    help="comma subset of scale,sign_flip,garbage,replay,"
                         "digest_forge,equivocate (default: all)")
    ap.add_argument("--chaos-byz-prob", type=float, default=None,
                    metavar="P", help="per-(peer, round) probability an "
                    "adversarial peer acts (default 1.0)")
    ap.add_argument("--chaos-byz-scale", type=float, default=None,
                    metavar="S", help="payload perturbation magnitude for "
                    "the scale/garbage behaviors (default 25.0)")
    ap.add_argument("--chaos-byz-rounds", default=None, metavar="START:END",
                    help="bound the byzantine lane to this half-open span "
                         "of the adversary's local-round clock (default: "
                         "every round)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the chaos schedule (independent of --seed)")
    ap.add_argument("--reputation", action="store_true",
                    help="enable the peer-lifecycle state machine: EWMA "
                         "trust over per-round evidence drives HEALTHY -> "
                         "SUSPECT -> QUARANTINED -> PROBATION")
    ap.add_argument("--reputation-alpha", type=float, default=None,
                    metavar="A", help="EWMA trust update rate (default 0.4)")
    ap.add_argument("--reputation-suspect-below", type=float, default=None,
                    metavar="T", help="trust below T -> SUSPECT "
                    "(default 0.7)")
    ap.add_argument("--reputation-quarantine-below", type=float,
                    default=None, metavar="T",
                    help="trust below T -> QUARANTINED (default 0.4)")
    ap.add_argument("--reputation-quarantine-rounds", type=int, default=None,
                    metavar="N", help="rounds a quarantined peer sits out "
                    "(default 3)")
    ap.add_argument("--reputation-probation-rounds", type=int, default=None,
                    metavar="N", help="clean probation rounds before full "
                    "readmission (default 2)")
    ap.add_argument("--reputation-probation-weight", type=float,
                    default=None, metavar="W",
                    help="vote weight while on probation (default 0.5)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="event-stream directory (bcfl_tpu_torch.telemetry, "
                         "OBSERVABILITY.md). Default: dist runs stream "
                         "into their run dir, local runs emit nothing; "
                         "naming a dir enables streaming on both")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable event streaming everywhere (the "
                         "overhead-measurement setting)")
    ap.add_argument("--telemetry-sample", type=float, default=None,
                    metavar="P",
                    help="sampling rate in [0,1] for high-rate transport "
                         "events (per-attempt outcomes, chaos draws); "
                         "invariant-grade events are never sampled")
    ap.add_argument("--fused-tamper", action="append", default=None,
                    metavar="ROUND:CLIENT:SCALE",
                    help="inject a simulated transport corruption (additive "
                         "SCALE) into CLIENT's update in fused round ROUND "
                         "(repeatable). The corrupted update fails ledger "
                         "auth and is excluded from the aggregate — the "
                         "BC-FL tamper-resistance demo. Needs --ledger and "
                         "a fused dispatch (--rounds-per-dispatch > 1); a "
                         "request landing on a per-round-path round fails "
                         "loudly instead of being ignored")
    return ap


def _pair_schedule(entries, flag):
    """``CLIENT:ROUND`` entries -> ((client, round), ...), or None."""
    if not entries:
        return None
    out = []
    for s in entries:
        try:
            c, r = s.split(":")
            out.append((int(c), int(r)))
        except ValueError:
            raise SystemExit(f"{flag} {s!r}: expected CLIENT:ROUND")
    return tuple(out)


def _fault_plan(args):
    """The FaultPlan the ``--chaos-*`` flags ask for (None: no flag), parsed
    as the JAX command line parses them."""
    from bcfl_tpu_torch.faults import FaultPlan

    if not (args.chaos_dropout is not None or args.chaos_straggler is not None
            or args.chaos_corrupt is not None
            or args.chaos_crash_round is not None
            or args.chaos_partition is not None
            or args.chaos_churn_leave or args.chaos_churn_join
            or args.chaos_flaky is not None or args.chaos_wire is not None
            or args.chaos_byz is not None
            # the byz sub-flags enter the gate, so one without --chaos-byz
            # reaches the fail-loudly check below
            or args.chaos_byz_behaviors is not None
            or args.chaos_byz_prob is not None
            or args.chaos_byz_scale is not None
            or args.chaos_byz_rounds is not None):
        return None
    plan_kw = dict(
        seed=args.chaos_seed,
        dropout_prob=args.chaos_dropout or 0.0,
        straggler_prob=args.chaos_straggler or 0.0,
        straggler_delay_s=args.chaos_straggler_delay,
        corrupt_prob=args.chaos_corrupt or 0.0,
        crash_at_round=args.chaos_crash_round,
        churn_leave=_pair_schedule(args.chaos_churn_leave,
                                   "--chaos-churn-leave"),
        churn_join=_pair_schedule(args.chaos_churn_join,
                                  "--chaos-churn-join"),
    )
    if args.chaos_partition is not None:
        if args.chaos_partition_rounds is None:
            raise SystemExit("--chaos-partition needs "
                             "--chaos-partition-rounds START:END")
        try:
            lo, hi = (int(x) for x in args.chaos_partition_rounds.split(":"))
        except ValueError:
            raise SystemExit(
                f"--chaos-partition-rounds "
                f"{args.chaos_partition_rounds!r}: expected START:END")
        if hi <= lo:
            raise SystemExit(
                f"--chaos-partition-rounds "
                f"{args.chaos_partition_rounds!r}: empty span "
                "(END must be > START; the span is half-open)")
        plan_kw["partition_rounds"] = tuple(range(lo, hi))
        spec = args.chaos_partition
        try:
            if "/" in spec or "," in spec:
                plan_kw["partition_groups"] = tuple(
                    tuple(int(c) for c in g.split(","))
                    for g in spec.split("/") if g)
            else:
                plan_kw["partition_count"] = int(spec)
        except ValueError:
            raise SystemExit(f"--chaos-partition {spec!r}: expected "
                             "groups like 0,1/2,3 or an integer N")
    if args.chaos_flaky is not None:
        try:
            plan_kw["flaky_clients"] = tuple(
                int(c) for c in args.chaos_flaky.split(","))
        except ValueError:
            raise SystemExit(f"--chaos-flaky {args.chaos_flaky!r}: "
                             "expected comma-separated client ids")
        if args.chaos_flaky_burst is not None:
            plan_kw["flaky_burst_len"] = args.chaos_flaky_burst
        if args.chaos_flaky_on_prob is not None:
            plan_kw["flaky_on_prob"] = args.chaos_flaky_on_prob
    if args.chaos_wire is not None:
        wire_keys = {"drop": "wire_drop_prob", "dup": "wire_dup_prob",
                     "reorder": "wire_reorder_prob",
                     "delay": "wire_delay_prob",
                     "corrupt": "wire_corrupt_prob",
                     "delay-s": "wire_delay_s",
                     "hold-s": "wire_reorder_hold_s"}
        for part in args.chaos_wire.split(","):
            try:
                k, v = part.split("=")
                plan_kw[wire_keys[k.strip()]] = float(v)
            except (ValueError, KeyError):
                raise SystemExit(
                    f"--chaos-wire {part!r}: expected K=V with K in "
                    f"{sorted(wire_keys)}")
        if not any(plan_kw.get(wire_keys[k])
                   for k in ("drop", "dup", "reorder", "delay", "corrupt")):
            # delay-s/hold-s alone arm nothing: fail loudly instead of
            # injecting zero faults under a chaos-looking flag
            raise SystemExit(
                f"--chaos-wire {args.chaos_wire!r} sets no "
                "probability: add at least one of "
                "drop/dup/reorder/delay/corrupt > 0")
    if args.chaos_byz is not None:
        try:
            plan_kw["byz_peers"] = tuple(
                int(p) for p in args.chaos_byz.split(","))
        except ValueError:
            raise SystemExit(f"--chaos-byz {args.chaos_byz!r}: "
                             "expected comma-separated peer ids")
        if args.chaos_byz_behaviors is not None:
            plan_kw["byz_behaviors"] = tuple(
                b.strip() for b in args.chaos_byz_behaviors.split(",")
                if b.strip())
        if args.chaos_byz_prob is not None:
            plan_kw["byz_prob"] = args.chaos_byz_prob
        if args.chaos_byz_scale is not None:
            plan_kw["byz_scale"] = args.chaos_byz_scale
        if args.chaos_byz_rounds is not None:
            try:
                lo, hi = (int(x) for x in args.chaos_byz_rounds.split(":"))
            except ValueError:
                raise SystemExit(f"--chaos-byz-rounds "
                                 f"{args.chaos_byz_rounds!r}: "
                                 "expected START:END")
            if hi <= lo:
                raise SystemExit(f"--chaos-byz-rounds "
                                 f"{args.chaos_byz_rounds!r}: empty "
                                 "span (END must be > START; the span "
                                 "is half-open)")
            plan_kw["byz_rounds"] = tuple(range(lo, hi))
    elif (args.chaos_byz_behaviors is not None
          or args.chaos_byz_prob is not None
          or args.chaos_byz_scale is not None
          or args.chaos_byz_rounds is not None):
        raise SystemExit("--chaos-byz-* tuning flags have no effect "
                         "without --chaos-byz PEERS")
    if args.chaos_wire_rounds is not None:
        if args.chaos_wire is None:
            raise SystemExit("--chaos-wire-rounds has no effect "
                             "without --chaos-wire")
        try:
            lo, hi = (int(x) for x in args.chaos_wire_rounds.split(":"))
        except ValueError:
            raise SystemExit(f"--chaos-wire-rounds "
                             f"{args.chaos_wire_rounds!r}: expected "
                             "START:END")
        if hi <= lo:
            raise SystemExit(f"--chaos-wire-rounds "
                             f"{args.chaos_wire_rounds!r}: empty span "
                             "(END must be > START; the span is "
                             "half-open)")
        plan_kw["wire_rounds"] = tuple(range(lo, hi))
    return FaultPlan(**plan_kw)


def build_config(args):
    cfg = get_preset(args.preset, hf=args.hf)
    overrides = {field: getattr(args, flag) for flag, field in _FIELD_FLAGS
                 if getattr(args, flag) is not None}
    if args.model is not None and cfg.hf_checkpoint is not None:
        # keep the checkpoint and tokenizer those of the named model
        if args.model not in _HF:
            raise SystemExit(
                f"--model {args.model!r} has no HF checkpoint mapping; "
                f"under --hf use one of {sorted(_HF)}")
        overrides["hf_checkpoint"] = _HF[args.model]
        overrides["tokenizer"] = _HF[args.model]
    if args.lora_ranks is not None and args.lora_rank is None:
        # a per-client spec supersedes a preset's uniform rank; an explicit
        # --lora-rank beside it reaches FedConfig, which refuses both
        overrides["lora_rank"] = 0
    if args.use_flash is not None:
        overrides["use_flash"] = args.use_flash == "on"
    if args.remat:
        overrides["remat"] = True
    if args.faithful:
        overrides["faithful"] = True
    if args.pod:
        overrides["pod"] = True
    if (args.compress is not None or args.compress_topk is not None
            or args.compress_chunk is not None or args.no_compress_ef):
        kind = (args.compress if args.compress is not None
                else cfg.compression.kind)
        if kind == "none" and args.compress != "none":
            raise SystemExit(
                "--compress-topk/--compress-chunk/--no-compress-ef have no "
                "effect without a codec: add --compress {int8,topk,int8+topk}")
        comp_kw = {"kind": kind}
        if args.compress_topk is not None:
            comp_kw["topk_frac"] = args.compress_topk
        if args.compress_chunk is not None:
            comp_kw["chunk"] = args.compress_chunk
        if args.no_compress_ef:
            comp_kw["error_feedback"] = False
        overrides["compression"] = dataclasses.replace(cfg.compression,
                                                       **comp_kw)
    if args.anomaly_filter is not None or args.gossip_steps is not None:
        topo_kw = {}
        if args.anomaly_filter is not None:
            topo_kw["anomaly_filter"] = (None if args.anomaly_filter == "none"
                                         else args.anomaly_filter)
        if args.gossip_steps is not None:
            topo_kw["gossip_steps"] = args.gossip_steps
        overrides["topology"] = dataclasses.replace(cfg.topology, **topo_kw)
    if args.ledger:
        overrides["ledger"] = dataclasses.replace(cfg.ledger, enabled=True)
    plan = _fault_plan(args)
    if plan is not None:
        overrides["faults"] = plan
    rep_tweaks = {
        "ewma_alpha": args.reputation_alpha,
        "suspect_below": args.reputation_suspect_below,
        "quarantine_below": args.reputation_quarantine_below,
        "quarantine_rounds": args.reputation_quarantine_rounds,
        "probation_rounds": args.reputation_probation_rounds,
        "probation_weight": args.reputation_probation_weight,
    }
    rep_tweaks = {k: v for k, v in rep_tweaks.items() if v is not None}
    if rep_tweaks and not args.reputation:
        raise SystemExit("--reputation-* tuning flags have no effect "
                         "without --reputation")
    if args.reputation:
        overrides["reputation"] = dataclasses.replace(
            cfg.reputation, enabled=True, **rep_tweaks)
    if args.no_telemetry and args.telemetry_dir is not None:
        raise SystemExit("--no-telemetry contradicts --telemetry-dir")
    if args.no_telemetry:
        overrides["telemetry_dir"] = "off"
    elif args.telemetry_dir is not None:
        overrides["telemetry_dir"] = args.telemetry_dir
    if args.telemetry_sample is not None:
        overrides["telemetry_sample"] = args.telemetry_sample
    for flag, given in (("--peers", args.peers is not None),
                        ("--dist-quorum", args.dist_quorum is not None),
                        ("--dist-buffer", args.dist_buffer is not None),
                        ("--no-dist-pipeline", args.no_dist_pipeline),
                        ("--dist-pipeline-depth",
                         args.dist_pipeline_depth is not None),
                        ("--dist-run-dir", args.dist_run_dir is not None)):
        if given and args.runtime != "dist":
            raise SystemExit(f"{flag} only applies to --runtime dist")
    if args.runtime is not None:
        # one combined replace: fields the user did not set take the
        # dist defaults, explicit conflicting ones fail in the capability
        # table
        overrides["runtime"] = args.runtime
        if args.runtime == "dist":
            overrides.setdefault("sync", "async")
            overrides.setdefault("mode", "server")
            overrides.setdefault("eval_every", 0)
            dist_kw = dict(peers=args.peers or cfg.dist.peers,
                           peer_deadline_s=args.dist_deadline)
            if args.dist_quorum is not None:
                dist_kw["quorum_frac"] = args.dist_quorum
            if args.dist_buffer is not None:
                dist_kw["buffer"] = args.dist_buffer
            if args.no_dist_pipeline:
                dist_kw["pipeline"] = False
            if args.dist_pipeline_depth is not None:
                dist_kw["pipeline_depth"] = args.dist_pipeline_depth
            overrides["dist"] = dataclasses.replace(cfg.dist, **dist_kw)
    return cfg.replace(**overrides)


def run_dist_cli(cfg, device: str, run_dir=None) -> int:
    """Run the dist federation, print its JSON summary (the collated
    timeline and invariant verdicts included); 1 on a failed peer or an
    invariant violation."""
    import json
    import tempfile

    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate

    run_dir = run_dir or tempfile.mkdtemp(prefix="bcfl_dist_cli_")
    result = run_dist(cfg, run_dir, device=device)
    summary = {
        "ok": result["ok"],
        "process_count": result["process_count"],
        "returncodes": result["returncodes"],
        "final_versions": {p: r.get("final_version")
                           for p, r in result["reports"].items()},
        "final_eval": result["reports"].get(0, {}).get("final_eval"),
        "run_dir": result["run_dir"],
    }
    if result["event_streams"]:
        col = collate(result["event_streams"])
        summary["event_streams"] = result["event_streams"]
        summary["timeline"] = col["timeline"]
        summary["invariants"] = col["invariants"]
        summary["invariants_ok"] = col["ok"]
    print(json.dumps(summary, indent=2), flush=True)
    return 0 if result["ok"] and summary.get("invariants_ok", True) else 1


def fused_tamper_schedule(cfg, specs):
    """``ROUND:CLIENT:SCALE`` entries -> the engine's ``(round) -> [C]
    scales or None`` callable, with JAX's checks and messages; None when
    no entry is given."""
    import numpy as np

    if not specs:
        return None
    if not cfg.ledger.enabled:
        # without the ledger there is no transport-verification stage:
        # the corruption would be dropped and the demo pass vacuously
        raise SystemExit("--fused-tamper needs --ledger (the transport-"
                         "verification stage lives in the ledger's "
                         "fused fingerprint programs)")
    spec = {}
    for s in specs:
        try:
            r, c, scale = s.split(":")
            r, c, scale = int(r), int(c), float(scale)
        except ValueError:
            raise SystemExit(
                f"--fused-tamper {s!r}: expected ROUND:CLIENT:SCALE")
        if not 0 <= c < cfg.num_clients:
            raise SystemExit(
                f"--fused-tamper {s!r}: client out of range "
                f"[0, {cfg.num_clients})")
        if not 0 <= r < cfg.num_rounds:
            # a never-reached round would make the demo pass vacuously
            raise SystemExit(
                f"--fused-tamper {s!r}: round out of range "
                f"[0, {cfg.num_rounds}) (rounds are 0-indexed)")
        spec.setdefault(r, []).append((c, scale))

    def fused_tamper(rnd, _spec=spec, _n=cfg.num_clients):
        rows = _spec.get(rnd)
        if not rows:
            return None
        row = np.zeros((_n,), np.float32)
        for c, scale in rows:
            row[c] = scale
        return row

    return fused_tamper


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "trace":
        # collate a run's event streams and run the invariant checks
        from bcfl_tpu_torch.telemetry import trace_main

        return trace_main(argv[1:])
    if argv and argv[0] == "monitor":
        # the live counterpart: tails a possibly-running fleet's streams
        from bcfl_tpu_torch.telemetry.live import monitor_main

        return monitor_main(argv[1:])
    if argv and argv[0] == "lint":
        # the static analysis of the port's own contracts (stdlib ast);
        # exits nonzero on any unsuppressed, unbaselined finding
        from bcfl_tpu_torch.analysis import lint_main

        return lint_main(argv[1:])
    ap = build_parser()
    args, rest = ap.parse_known_args(argv)
    if rest:
        ap.error(f"not ported yet (or unknown): {' '.join(rest)}")
    cfg = build_config(args)
    if cfg.pod:
        # the pod's group comes up before the engine gathers its devices
        # (a single process: a no-op)
        from bcfl_tpu_torch.core.mesh import distributed_init

        distributed_init()
    fused_tamper = fused_tamper_schedule(cfg, args.fused_tamper)
    if cfg.runtime == "dist":
        if args.sweep or fused_tamper is not None or args.resume:
            raise SystemExit("--runtime dist composes with neither --sweep "
                             "nor --fused-tamper nor --resume (peer "
                             "crash/rejoin is driven by "
                             "bcfl_tpu_torch.dist.run_dist(kill_peer=...) "
                             "or a peer started with python -m "
                             "bcfl_tpu_torch.dist --resume)")
        return run_dist_cli(cfg, args.device, args.dist_run_dir)
    if args.sweep:
        if fused_tamper is not None:
            raise SystemExit("--fused-tamper does not compose with --sweep "
                             "(client indices change per sweep point)")
        run_sweep(cfg, device=args.device, resume=args.resume)
    else:
        run(cfg, device=args.device, resume=args.resume,
            fused_tamper=fused_tamper)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
