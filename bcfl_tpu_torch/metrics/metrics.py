"""Run metrics: port of the parts of ``bcfl_tpu/metrics/metrics.py`` that
the server round fills (``RoundRecord``, ``RunMetrics``,
``model_size_gb``): train loss and accuracy, per-client local accuracy,
global loss and accuracy, round wall time, and the bytes-on-wire
accounting."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


def model_size_gb(tree) -> float:
    """Bytes of a ``{path: tensor}`` tree, in GB (metadata only)."""
    return sum(x.numel() * x.element_size() for x in tree.values()) / 1e9


@dataclasses.dataclass
class RoundRecord:
    round: int
    train_loss: float
    train_acc: float
    local_acc: List[float]  # per client
    global_acc: Optional[float] = None
    global_loss: Optional[float] = None
    mask: Optional[List[float]] = None
    # True when every client was masked out and the global was kept
    degraded: bool = False
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
