"""Determinism checker for the seeded-draw modules (port of
``bcfl_tpu/analysis/determinism.py``; the scope names the port's files).

The chaos/robustness stack's central contract is "a fault's fate is a
pure function of its coordinates" (RUNTIME.md §4: a message's fault fate
= f(round-that-produced-it), never worker timing): every chaos draw, every
byzantine behavior, every codec stochastic-rounding uniform comes from an
explicitly seeded stream keyed by (seed, lane, round, ids). Three bug
classes silently break that — and survive every single-process test:

- **wall-clock reads** (``time.time`` / ``time.monotonic``) feeding a
  decision: two runs of the same schedule diverge by host speed,
- **module-level RNG** (stdlib ``random``, ``np.random.<draw>``, or an
  UNSEEDED ``np.random.default_rng()``): a global stream any import can
  perturb, unlike the ``default_rng((seed, lane, ...))`` keyed streams,
- **unsorted dict/set iteration** whose order reaches a seeded draw or a
  digest: CPython insertion order is deterministic per process, but two
  *hosts* constructing the container differently draw RNG in different
  leaf order — a cross-host nondeterminism bug in the lineage records.

Scope (:data:`SEEDED_SCOPE`): the modules whose outputs the determinism
proofs pin. Files outside the bcfl_tpu_torch package are fully in scope (the
fixture workflow). Telemetry/deadline wall-clock uses inside scope are
annotated with the standard suppression
(``# lint: disable=determinism — <why>``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from bcfl_tpu_torch.analysis.core import Checker, Finding, Source, register

#: package-relative file -> None (whole module in scope) or a tuple of
#: class/function names (only code enclosed by one of those names is in
#: scope). These are the modules whose seeded draws the repo's
#: determinism contracts pin (ROBUSTNESS.md, RUNTIME.md §4):
SEEDED_SCOPE: Dict[str, Optional[Tuple[str, ...]]] = {
    # the chaos schedule itself: every lane's draws
    "faults/plan.py": None,
    # adversarial payload mutations (bit-identical per coordinates)
    "dist/byzantine.py": None,
    # codec stochastic rounding / chunk grids (bit-identical encode pins)
    "compression/codecs.py": None,
    # the codec's CUDA kernels and their plain versions (JAX's
    # ops/pallas_codec.py): they consume the precomputed stochastic-
    # rounding uniforms as an input operand (never draw RNG themselves) and
    # their outputs sit under the same bit-identical encode pins — so the
    # whole module is held to the no-wall-clock / no-global-RNG /
    # no-unsorted-iteration contract
    "ops/codec_kernels.py": None,
    # the kernel harness: impl resolution decides WHICH kernel encodes a
    # payload — the decision must be a pure function of (registry, impl,
    # backend), never of host timing or iteration order
    "ops/registry.py": None,
    # robust merge: vote order feeds krum selection + lineage records
    "dist/robust.py": None,
    # evidence aggregation order feeds the committed reputation rows
    "reputation/dist.py": None,
    # the wire + limp chaos lanes' draw seams (the rest of transport.py
    # is wall-clock country: deadlines, backoff, detector probes — the
    # phi estimator MEASURES the live run and is excluded by design)
    "dist/transport.py": ("WireChaos", "LimpChaos"),
    # votes_by_peer construction: peer iteration order reaches the
    # lineage record and the krum-selected-peer translation
    "dist/runtime.py": ("_apply_robust_merge",),
    # gossip's pure seams: the seeded neighbor draw (topology replay),
    # the canonical-order commutative merge, and the state digest — the
    # GossipPeerRuntime class around them is wall-clock country
    # (hello cadence, drain windows, arrival latencies)
    "dist/gossip.py": ("sample_neighbors", "hedge_neighbors",
                       "probe_targets", "merge_states", "state_digest",
                       "_walk_sorted"),
}

_WALLCLOCK = {"time", "monotonic", "time_ns", "monotonic_ns",
              "perf_counter", "perf_counter_ns"}
_NP_NAMES = {"np", "numpy"}
#: iterable-producing wrappers we look through when flagging iteration
_TRANSPARENT = {"enumerate", "list", "tuple", "reversed"}


def _dotted(node: ast.AST) -> Optional[List[str]]:
    """['np', 'random', 'default_rng'] for nested attributes, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _scope_names(src: Source) -> Optional[Tuple[str, ...]]:
    """None = whole file in scope; () = out of scope; else the name
    filter."""
    if src.rel is None:
        return None  # outside the package: fixtures are fully in scope
    if src.rel in SEEDED_SCOPE:
        return SEEDED_SCOPE[src.rel]
    return ()


@register
class DeterminismChecker(Checker):
    id = "determinism"
    contract = ("seeded-draw modules use no wall clock, no module-level "
                "RNG, and no unsorted dict/set iteration (fault fate = "
                "f(coordinates), RUNTIME.md §4)")

    def check(self, src: Source) -> Iterable[Finding]:
        if src.tree is None:
            return ()
        names = _scope_names(src)
        if names == ():
            return ()
        out: List[Finding] = []

        def in_scope_walk(node, enclosed: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                enclosed = enclosed or (names is None
                                        or node.name in names)
                for child in ast.iter_child_nodes(node):
                    in_scope_walk(child, enclosed)
                return
            if enclosed or names is None:
                self._check_node(src, node, out)
            for child in ast.iter_child_nodes(node):
                in_scope_walk(child, enclosed)

        in_scope_walk(src.tree, names is None)
        return out

    # ------------------------------------------------------------- rules

    def _check_node(self, src: Source, node: ast.AST,
                    out: List[Finding]) -> None:
        if isinstance(node, ast.Call):
            self._check_call(src, node, out)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._check_iter(src, node.iter, out)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                self._check_iter(src, gen.iter, out)

    def _check_call(self, src: Source, call: ast.Call,
                    out: List[Finding]) -> None:
        dotted = _dotted(call.func)
        if dotted is None:
            return
        if len(dotted) == 2 and dotted[0] == "time" \
                and dotted[1] in _WALLCLOCK:
            out.append(self.finding(
                src, call,
                f"wall-clock read time.{dotted[1]}() in a seeded-draw "
                f"module: a fault's fate must be a pure function of its "
                f"coordinates, never of host timing (suppress with a "
                f"justification for telemetry/deadline uses)"))
            return
        if dotted[0] == "random" and len(dotted) >= 2:
            out.append(self.finding(
                src, call,
                f"stdlib random.{dotted[1]}() uses the process-global RNG "
                f"stream: draw from np.random.default_rng((seed, lane, "
                f"...)) keyed by the fault coordinates instead"))
            return
        if (len(dotted) >= 3 and dotted[0] in _NP_NAMES
                and dotted[1] == "random"):
            if dotted[2] == "default_rng":
                if not call.args and not call.keywords:
                    out.append(self.finding(
                        src, call,
                        "np.random.default_rng() without a seed draws "
                        "from OS entropy: key it by the fault "
                        "coordinates, e.g. default_rng((seed, lane, "
                        "round))"))
                return
            out.append(self.finding(
                src, call,
                f"np.random.{dotted[2]}() uses the module-level global "
                f"RNG: draw from np.random.default_rng((seed, lane, ...)) "
                f"keyed by the fault coordinates instead"))

    def _check_iter(self, src: Source, it: ast.AST,
                    out: List[Finding]) -> None:
        # look through enumerate/list/tuple/reversed wrappers
        inner = it
        while (isinstance(inner, ast.Call)
               and isinstance(inner.func, ast.Name)
               and inner.func.id in _TRANSPARENT and inner.args):
            inner = inner.args[0]
        if (isinstance(inner, ast.Call)
                and isinstance(inner.func, ast.Attribute)
                and inner.func.attr in ("items", "keys", "values")
                and not inner.args):
            what = f".{inner.func.attr}()"
        elif (isinstance(inner, ast.Call)
              and isinstance(inner.func, ast.Name)
              and inner.func.id in ("set", "frozenset")):
            what = "a set"
        elif isinstance(inner, (ast.Set, ast.SetComp)):
            what = "a set"
        else:
            return
        out.append(self.finding(
            src, it,
            f"iteration over {what} without sorted() in a seeded-draw "
            f"module: dict/set order differs across hosts and feeds the "
            f"draw/digest order — wrap in sorted(...)"))
