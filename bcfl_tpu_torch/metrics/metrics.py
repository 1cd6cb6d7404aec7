"""Run metrics: port of the parts of ``bcfl_tpu/metrics/metrics.py`` that
the ported rounds fill (``ResourceMonitor``, ``RoundRecord``,
``RunMetrics``, ``model_size_gb``): the reference's resource set (CPU
overhead %, memory GB, latency in minutes), train loss and accuracy,
per-client local accuracy, global loss and accuracy, the participation
mask and anomalies, ledger authentication, async staleness and merge
weights, the information passing times, round wall time, the
bytes-on-wire accounting, and the ledger rollup.

``ResourceMonitor`` reads the process's own counters without psutil (which
the card's machine does not have): CPU time from ``os.times()`` and the
resident set from ``/proc/self/statm``, the quantities psutil's
``Process.cpu_percent`` and ``memory_info().rss`` read on Linux. JAX's
``start_sampling``/``stop_sampling`` (the live monitor's resource series)
are not ported yet. ``StepClock`` lives in :mod:`.tracing`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Dict, List, Optional


def model_size_gb(tree) -> float:
    """Bytes of a ``{path: tensor}`` tree, in GB (metadata only)."""
    return sum(x.numel() * x.element_size() for x in tree.values()) / 1e9


def _rss_bytes() -> int:
    """Resident set size of this process: ``/proc/self/statm``'s second
    field (pages) times the page size, as psutil reads it on Linux."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _cpu_seconds() -> float:
    """User + system CPU seconds of this process (children excluded)."""
    t = os.times()
    return t.user + t.system


class ResourceMonitor:
    """Before/after capture of the process's CPU, memory and wall clock
    (the JAX ``ResourceMonitor``'s semantics).

    CPU percent is windowed, as psutil's ``Process.cpu_percent(None)``:
    each reading is the CPU time used since the PREVIOUS reading over the
    wall time since then, x 100 (so > 100 with several busy threads),
    rounded to one decimal. ``__init__`` primes the window, so the first
    :meth:`snapshot` covers init -> snapshot and a later one only the time
    since the previous snapshot. ``memory_gb`` is the change in resident
    set since ``__init__``; ``latency_min`` the wall minutes since it."""

    def __init__(self, run_dir: Optional[str] = None):
        # prime the CPU window: the first reading covers init -> snapshot
        self._last_wall, self._last_cpu = time.monotonic(), _cpu_seconds()
        self.rss_before = _rss_bytes()
        self.t_before = time.time()
        # when set, disk_free_bytes reports the run directory's filesystem
        self._run_dir = run_dir

    def _cpu_percent(self) -> float:
        """Average CPU % since the previous reading (or ``__init__``)."""
        wall, cpu = time.monotonic(), _cpu_seconds()
        dt = wall - self._last_wall
        used = cpu - self._last_cpu
        self._last_wall, self._last_cpu = wall, cpu
        if dt <= 0:
            return 0.0
        return round(used / dt * 100, 1)

    def disk_free_bytes(self) -> Optional[int]:
        """Free bytes on the filesystem holding ``run_dir``, or None when
        no run_dir was given or the statvfs fails (observer never raises)."""
        if self._run_dir is None:
            return None
        try:
            return int(shutil.disk_usage(self._run_dir).free)
        except OSError:
            return None

    def snapshot(self) -> Dict[str, float]:
        return {
            "cpu_percent": self._cpu_percent(),
            "memory_gb": (_rss_bytes() - self.rss_before) / 1e9,
            "latency_min": (time.time() - self.t_before) / 60.0,
        }


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
    # True when every client was eliminated from the aggregate (anomaly
    # filter x dropout x churn x reputation x ledger auth): the global was
    # kept
    degraded: bool = False
    # the fault plan's clients dropped this round / per-client injected
    # straggler delay (seconds)
    dropped: Optional[List[int]] = None
    straggler_s: Optional[List[float]] = None
    # per-client connected-component id under a partition (None = whole);
    # healed marks the first whole round after a span
    partition: Optional[List[int]] = None
    healed: bool = False
    # per-client alive mask under churn (None = no churn scheduled)
    churn_alive: Optional[List[float]] = None
    # per-client lifecycle state name and EWMA trust after this round's
    # evidence (None = reputation off)
    reputation_state: Optional[List[str]] = None
    reputation_trust: Optional[List[float]] = None
    # async staleness (global version - client version) at this aggregation
    # event, for each client (async mode only)
    staleness: Optional[List[int]] = None
    # cohort mode: the round's sampled registry ids in slot order; every
    # other per-client field stays slot-aligned (None = sampling off)
    cohort: Optional[List[int]] = None
    info_passing_sync_s: Optional[float] = None
    info_passing_async_s: Optional[float] = None
    # what this round's update exchange shipped across all clients: the
    # raw full-precision size vs the configured codec's payload
    bytes_raw: Optional[float] = None
    bytes_on_wire: Optional[float] = None
    compression_ratio: Optional[float] = None
    # LoRA: mean Shannon effective rank of the global adapter tree after
    # the round's aggregation (None without LoRA)
    effective_rank: Optional[float] = None
    # host wall seconds of the round, ending after the device finished
    wall_s: float = 0.0


@dataclasses.dataclass
class RunMetrics:
    rounds: List[RoundRecord] = dataclasses.field(default_factory=list)
    model_size_gb: float = 0.0
    # ResourceMonitor.snapshot() around the run: cpu_percent, memory_gb,
    # latency_min (the reference's metric set)
    resources: Dict[str, float] = dataclasses.field(default_factory=dict)
    # ledger rollup: payload accounting and chain_ok (ledger on)
    ledger: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per-phase host-clock timings (StepClock.summary)
    phases: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # codec kind, per-round raw vs on-wire bytes, compression ratio
    comms: Dict[str, float] = dataclasses.field(default_factory=dict)
    # reputation rollup (ReputationTracker.summary): final state and trust
    # per client, quarantine event and round counts
    reputation: Dict = dataclasses.field(default_factory=dict)

    @property
    def global_accuracies(self) -> List[float]:
        return [r.global_acc for r in self.rounds if r.global_acc is not None]

    def to_json(self) -> str:
        return json.dumps({
            "rounds": [dataclasses.asdict(r) for r in self.rounds],
            "model_size_gb": self.model_size_gb,
            "resources": self.resources,
            "ledger": self.ledger,
            "phases": self.phases,
            "comms": self.comms,
            "reputation": self.reputation,
            "global_accuracies": self.global_accuracies,
        }, indent=2)

    def summary(self) -> str:
        accs = self.global_accuracies
        lines = [
            f"rounds: {len(self.rounds)}",
            f"model size: {self.model_size_gb:.4f} GB",
            f"final global accuracy: {accs[-1]:.4f}" if accs
            else "no global eval",
        ]
        for k, v in self.resources.items():
            lines.append(f"{k}: {v:.3f}")
        return "\n".join(lines)
