"""Tracing and profiling: port of ``bcfl_tpu/metrics/tracing.py``.

- :class:`StepClock` — host-clock phase timers (``with clock.phase(...)``)
  with mean/p50/p95 summaries; every completed phase also lands in the
  run's event stream as a ``phase`` span (a no-op unless a writer is
  installed, :mod:`bcfl_tpu_torch.telemetry`).
- :func:`trace` — ``torch.profiler`` over the wrapped region, written as a
  Chrome/Perfetto trace (JAX writes ``jax.profiler``'s TensorBoard trace).
- :func:`annotate` — a named range inside a profiler trace
  (``torch.profiler.record_function``; JAX uses ``TraceAnnotation``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from bcfl_tpu_torch.telemetry import events as _telemetry


class StepClock:
    """Named phase timers: ``with clock.phase("train"): ...`` per round."""

    def __init__(self):
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._times[name].append(dt)
            _telemetry.emit("phase", name=name, wall_s=dt)

    def record(self, name: str, seconds: float):
        self._times[name].append(seconds)
        _telemetry.emit("phase", name=name, wall_s=seconds)

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


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the wrapped region (CPU and, when a
    card is present, CUDA activity) written to ``log_dir/trace.json``; a
    no-op if ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range inside a profiler trace (a no-op when not profiling)."""
    import torch

    return torch.profiler.record_function(name)
