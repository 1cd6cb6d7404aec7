"""``run(cfg, device=None)``: port of ``bcfl_tpu/entrypoints/run.py``.

Builds the engine on ``device`` (``None`` means the GPU, and raises when
there is none), runs it, streams one line per round and ends with the
reference's summary lines."""

from __future__ import annotations

import json

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
