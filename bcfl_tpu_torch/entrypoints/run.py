"""``run(cfg, device=None)`` and ``run_sweep``: port of
``bcfl_tpu/entrypoints/run.py``.

``run`` builds the engine on ``device`` (``None`` means the GPU, and raises
when there is none), runs it, streams one line per round and ends with the
reference's metric set: CPU overhead %, memory GB, latency in minutes,
model size, the per-round global accuracies. ``run_sweep`` is the
reference's worker sweep over client counts (no ``resume`` until
checkpointing is ported)."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from bcfl_tpu_torch.config import FedConfig
from bcfl_tpu_torch.fed.engine import FedEngine, RunResult


def run(cfg: FedConfig, device=None, verbose: bool = True) -> RunResult:
    engine = FedEngine(cfg, device=device)
    if verbose:
        print("\n".join(_header(cfg, engine.device)), flush=True)
    result = engine.run(on_round=_print_round if verbose else None)
    if verbose:
        print(format_report(result), flush=True)
    return result


def _header(cfg: FedConfig, device) -> list:
    return [f"== {cfg.name} ==",
            f"mode={cfg.mode} sync={cfg.sync} clients={cfg.num_clients} "
            f"rounds={cfg.num_rounds} model={cfg.model} "
            f"dataset={cfg.dataset} compress={cfg.compression.kind} "
            f"device={device}"]


def round_line(r) -> str:
    acc = f" global_acc={r.global_acc:.4f}" if r.global_acc is not None else ""
    anom = f" anomalies={r.anomalies}" if r.anomalies else ""
    # a ledger rejection is the BC-FL flow's observable outcome
    rejected = ([i for i, a in enumerate(r.auth) if a == 0.0]
                if r.auth else [])
    rej = f" auth_failed={rejected}" if rejected else ""
    deg = " DEGRADED" if r.degraded else ""
    return (f"round {r.round:3d}: train_loss={r.train_loss:.4f} "
            f"train_acc={r.train_acc:.4f}{acc}{anom}{rej}{deg} "
            f"ratio={r.compression_ratio:.2f} wall={r.wall_s:.2f}s")


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
              out_dir: Optional[str] = "results") -> Dict[int, RunResult]:
    """The reference's worker sweep (``for NUM_CLIENTS in [5, 10, 20]``,
    ``serverless_cancer_biobert_allclients.py:41``) over one config, each
    count a run named ``<name>_c<n>``. ``out_dir`` gets the latency,
    accuracy and memory figures by client count (matplotlib) and
    ``<name>_sweep.json`` (:func:`sweep_record`); None records nothing."""
    from bcfl_tpu_torch.entrypoints.presets import SWEEP_CLIENTS

    out: Dict[int, RunResult] = {}
    for n in client_counts or SWEEP_CLIENTS:
        out[n] = run(cfg.replace(name=f"{cfg.name}_c{n}", num_clients=n),
                     device=device, verbose=verbose)
    if out_dir:
        from bcfl_tpu_torch.viz import sweep_report

        paths = sweep_report(out, out_dir, name=f"{cfg.name}_sweep")
        jpath = os.path.join(out_dir, f"{cfg.name}_sweep.json")
        with open(jpath, "w") as f:
            json.dump(sweep_record(cfg, out), f, indent=2)
        if verbose:
            print(f"sweep artifacts: {jpath} + {len(paths)} figures",
                  flush=True)
    return out
