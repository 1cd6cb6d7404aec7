"""Run metrics: port of the parts of ``bcfl_tpu/metrics/metrics.py`` that
the ported rounds fill (``RoundRecord``, ``RunMetrics``,
``model_size_gb``): train loss and accuracy, per-client local accuracy,
global loss and accuracy, the participation mask and anomalies, ledger
authentication, async staleness and merge weights, the information
passing times, round wall time, the bytes-on-wire accounting, and the
ledger rollup."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def model_size_gb(tree) -> float:
    """Bytes of a ``{path: tensor}`` tree, in GB (metadata only)."""
    return sum(x.numel() * x.element_size() for x in tree.values()) / 1e9


class StepClock:
    """Named phase timers on the host clock (port of
    ``bcfl_tpu/metrics/tracing.py::StepClock``, without the event
    stream): ``with clock.phase("ledger"): ...`` per round."""

    def __init__(self):
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._times.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "total_s": float(a.sum()),
                "mean_s": float(a.mean()),
                "p50_s": float(np.percentile(a, 50)),
                "p95_s": float(np.percentile(a, 95)),
            }
        return out


@dataclasses.dataclass
class RoundRecord:
    round: int
    train_loss: float
    train_acc: float
    local_acc: List[float]  # per client
    global_acc: Optional[float] = None
    global_loss: Optional[float] = None
    mask: Optional[List[float]] = None
    anomalies: Optional[List[int]] = None
    # ledger-authentication outcome per client (1 = update verified against
    # the hash chain, 0 = rejected); None when the ledger is off
    auth: Optional[List[float]] = None
    # staleness-decayed merge weight per client for this aggregation event
    # (async mode only)
    async_alpha: Optional[List[float]] = None
    # True when every client was masked out and the global was kept
    degraded: bool = False
    # async staleness (global version - client version) at this aggregation
    # event, for each client (async mode only)
    staleness: Optional[List[int]] = None
    info_passing_sync_s: Optional[float] = None
    info_passing_async_s: Optional[float] = None
    # what this round's update exchange shipped across all clients: the
    # raw full-precision size vs the configured codec's payload
    bytes_raw: Optional[float] = None
    bytes_on_wire: Optional[float] = None
    compression_ratio: Optional[float] = None
    # host wall seconds of the round, ending after the device finished
    wall_s: float = 0.0


@dataclasses.dataclass
class RunMetrics:
    rounds: List[RoundRecord] = dataclasses.field(default_factory=list)
    model_size_gb: float = 0.0
    # ledger rollup: payload accounting and chain_ok (ledger on)
    ledger: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per-phase host-clock timings (StepClock.summary)
    phases: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # codec kind, per-round raw vs on-wire bytes, compression ratio
    comms: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def global_accuracies(self) -> List[float]:
        return [r.global_acc for r in self.rounds if r.global_acc is not None]

    def summary(self) -> str:
        accs = self.global_accuracies
        return "\n".join([
            f"rounds: {len(self.rounds)}",
            f"model size: {self.model_size_gb:.4f} GB",
            f"final global accuracy: {accs[-1]:.4f}" if accs
            else "no global eval",
        ])
