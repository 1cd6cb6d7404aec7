"""``run(cfg, device=None)`` and ``run_sweep``: port of
``bcfl_tpu/entrypoints/run.py``.

``run`` builds the engine on ``device`` (``None`` means the GPU, and raises
when there is none; ``devices=[...]`` spreads the clients axis over the
cards it lists), runs it, streams one line per round and ends with the
reference's metric set: CPU overhead %, memory GB, latency in minutes,
model size, the per-round global accuracies; ``resume=True`` restores the
newest valid checkpoint of ``cfg.checkpoint_dir`` first. ``run_sweep`` is
the reference's worker sweep over client counts, each count checkpointing
into its own ``c<n>`` subdirectory."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from bcfl_tpu_torch.config import FedConfig
from bcfl_tpu_torch.core.mesh import process_index
from bcfl_tpu_torch.fed.engine import FedEngine, RunResult


def run(cfg: FedConfig, device=None, verbose: bool = True,
        resume: bool = False, fused_tamper=None, devices=None) -> RunResult:
    """``fused_tamper``: optional ``(round) -> [num_clients] scales or
    None``, the engine's fused-round corruption shim (a round it names
    must run in a fused chunk, or the run raises). ``devices``: the mesh's
    device list (``FedEngine``'s)."""
    engine = FedEngine(cfg, device=device, fused_tamper=fused_tamper,
                       devices=devices)
    # a pod's process 0 speaks for it
    verbose = verbose and process_index() == 0
    if verbose:
        shards = engine.local_train.devices
        print("\n".join(_header(cfg, ",".join(str(d) for d in shards))),
              flush=True)
    result = engine.run(resume=resume,
                        on_round=_print_round if verbose else None)
    if verbose:
        print(format_report(result), flush=True)
    return result


def _header(cfg: FedConfig, device) -> list:
    lines = [f"== {cfg.name} ==",
             f"mode={cfg.mode} sync={cfg.sync} clients={cfg.num_clients} "
             f"rounds={cfg.num_rounds} model={cfg.model} task={cfg.task} "
             f"dataset={cfg.dataset} compress={cfg.compression.kind} "
             f"device={device}"]
    if cfg.lora_rank > 0:
        lines.append(f"lora: rank={cfg.lora_rank}"
                     + (f" ranks={cfg.lora_ranks}" if cfg.lora_ranks else ""))
    if cfg.registry_size > 0:
        lines.append(f"cohort mode: registry={cfg.registry_size} "
                     f"cohort={cfg.sample_clients or cfg.num_clients}/round")
    return lines


def round_line(r) -> str:
    acc = f" global_acc={r.global_acc:.4f}" if r.global_acc is not None else ""
    anom = f" anomalies={r.anomalies}" if r.anomalies else ""
    # a ledger rejection is the BC-FL flow's observable outcome
    rejected = ([i for i, a in enumerate(r.auth) if a == 0.0]
                if r.auth else [])
    rej = f" auth_failed={rejected}" if rejected else ""
    drop = f" dropped={r.dropped}" if r.dropped else ""
    deg = " DEGRADED" if r.degraded else ""
    # the fault plan and the peer lifecycle in the stream: partition spans,
    # heals, churn absences, quarantined and probation peers
    part = ""
    if r.partition is not None:
        comps = sorted(set(p for p in r.partition if p >= 0))
        part = f" PARTITIONED x{len(comps)}"
    if r.healed:
        part += " HEALED"
    gone = ([i for i, a in enumerate(r.churn_alive) if a == 0.0]
            if r.churn_alive else [])
    churn = f" churned_out={gone}" if gone else ""
    rep = ""
    if r.reputation_state is not None:
        q = [i for i, s in enumerate(r.reputation_state)
             if s == "quarantined"]
        p = [i for i, s in enumerate(r.reputation_state) if s == "probation"]
        if q:
            rep += f" quarantined={q}"
        if p:
            rep += f" probation={p}"
    cohort = f" cohort={r.cohort}" if r.cohort is not None else ""
    erank = (f" eff_rank={r.effective_rank:.3f}"
             if r.effective_rank is not None else "")
    # a fused round's wall is its chunk's split evenly
    chunk = f" (fused, chunk {r.wall_chunk_s:.2f}s)" if r.fused else ""
    return (f"round {r.round:3d}: train_loss={r.train_loss:.4f} "
            f"train_acc={r.train_acc:.4f}{acc}{anom}{rej}{drop}{part}"
            f"{churn}{rep}{deg}{cohort}{erank} "
            f"ratio={r.compression_ratio:.2f} wall={r.wall_s:.2f}s{chunk}")


def _print_round(r) -> None:
    print(round_line(r), flush=True)


def format_report(result: RunResult) -> str:
    m = result.metrics
    lines = [m.summary()]
    if m.rounds and m.rounds[-1].info_passing_sync_s is not None:
        r = m.rounds[-1]
        lines.append(f"info passing time: sync={r.info_passing_sync_s:.3f}s "
                     f"async={r.info_passing_async_s:.3f}s")
    if m.ledger:
        lines.append("ledger: " + json.dumps(m.ledger))
    if m.reputation:
        lines.append("reputation: " + json.dumps(m.reputation))
    accs = m.global_accuracies
    lines.append(f"global_accuracies: {[round(a, 4) for a in accs]}")
    return "\n".join(lines)


def sweep_record(cfg: FedConfig, results: Dict[int, RunResult]) -> dict:
    """What ``<name>_sweep.json`` holds: per client count the final global
    accuracy, the summed round walls in minutes and the run's memory
    growth in GB."""
    runs = {
        str(n): {
            "final_acc": (r.metrics.global_accuracies[-1]
                          if r.metrics.global_accuracies else None),
            "latency_min": sum(x.wall_s for x in r.metrics.rounds) / 60.0,
            "memory_gb": r.metrics.resources.get("memory_gb"),
        } for n, r in results.items()}
    return {"model": cfg.model, "dataset": cfg.dataset,
            "rounds": cfg.num_rounds, "mode": cfg.mode,
            "counts": sorted(results), "runs": runs}


def run_sweep(cfg: FedConfig, client_counts: Optional[List[int]] = None,
              device=None, verbose: bool = True,
              out_dir: Optional[str] = "results",
              resume: bool = False) -> Dict[int, RunResult]:
    """The reference's worker sweep (``for NUM_CLIENTS in [5, 10, 20]``,
    ``serverless_cancer_biobert_allclients.py:41``) over one config, each
    count a run named ``<name>_c<n>`` that checkpoints into
    ``<checkpoint_dir>/c<n>`` and, with ``resume``, resumes from there.
    ``out_dir`` gets the latency, accuracy and memory figures by client
    count (matplotlib) and
    ``<name>_sweep.json`` (:func:`sweep_record`); None records nothing. A
    pod's process 0 alone writes them."""
    from bcfl_tpu_torch.entrypoints.presets import SWEEP_CLIENTS

    out: Dict[int, RunResult] = {}
    for n in client_counts or SWEEP_CLIENTS:
        ckpt = (os.path.join(cfg.checkpoint_dir, f"c{n}")
                if cfg.checkpoint_dir else None)
        out[n] = run(cfg.replace(name=f"{cfg.name}_c{n}", num_clients=n,
                                 checkpoint_dir=ckpt),
                     device=device, verbose=verbose, resume=resume)
    if out_dir and process_index() == 0:
        from bcfl_tpu_torch.viz import sweep_report

        paths = sweep_report(out, out_dir, name=f"{cfg.name}_sweep")
        jpath = os.path.join(out_dir, f"{cfg.name}_sweep.json")
        with open(jpath, "w") as f:
            json.dump(sweep_record(cfg, out), f, indent=2)
        if verbose:
            print(f"sweep artifacts: {jpath} + {len(paths)} figures",
                  flush=True)
    return out
