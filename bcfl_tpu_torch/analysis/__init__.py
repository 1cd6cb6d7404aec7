"""The ``lint`` subcommand (port of ``bcfl_tpu/analysis``): AST-based
static analysis of the port's concurrency, determinism, telemetry and wire
contracts, run as ``python -m bcfl_tpu_torch.entrypoints lint``.

- :mod:`bcfl_tpu_torch.analysis.core` — the framework: :class:`Finding`,
  :class:`Checker` + registry, the ``# lint: disable=<id> — <why>``
  suppression convention, the committed baseline, and :func:`lint_main`.
- :mod:`bcfl_tpu_torch.analysis.concurrency` — **guarded-by** (registered
  shared fields only touched under their declared lock) and
  **lock-order** (the static acquisition graph is cycle-free).
- :mod:`bcfl_tpu_torch.analysis.determinism` — **determinism** (seeded-draw
  modules: no wall clock, no module-level RNG, no unsorted dict/set
  iteration).
- :mod:`bcfl_tpu_torch.analysis.telemetry_schema` — **telemetry-schema**
  (every literal emit names an EVENT_TYPES entry with its required
  fields).
- :mod:`bcfl_tpu_torch.analysis.wire_static` — **socket-deadline** and
  **no-frame-concat**.

stdlib-only: no torch, no jax, nothing of ``bcfl_tpu``.
"""

from bcfl_tpu_torch.analysis import (  # noqa: F401 — populate the registry
    concurrency,
    determinism,
    telemetry_schema,
    wire_static,
)
from bcfl_tpu_torch.analysis.core import (  # noqa: F401
    CHECKERS,
    DEFAULT_BASELINE,
    JSON_VERSION,
    PACKAGE_DIR,
    Checker,
    Finding,
    Source,
    baseline_json,
    checker_ids,
    lint_main,
    load_baseline,
    run_lint,
)
from bcfl_tpu_torch.analysis.determinism import SEEDED_SCOPE  # noqa: F401
from bcfl_tpu_torch.analysis.wire_static import iter_socket_sites  # noqa: F401
