"""Telemetry-schema checker: every literal ``telemetry.emit(<type>, ...)``
names a catalogued event and carries its required fields (port of
``bcfl_tpu/analysis/telemetry_schema.py``).

The event writer validates at runtime — but deliberately NEVER raises: an
unknown type or a missing required field is a counted-and-dropped bad
event (telemetry must not take down the run it observes). The flip side
is that an emit-site typo is invisible until an invariant query finds
nothing to read — the exact failure mode a run-crashing validator would
have caught in the first unit test. This checker closes that gap
statically: the catalogue (:data:`EVENT_TYPES` in
``bcfl_tpu_torch/telemetry/events.py``) is the single source of truth, checked
here at lint time and in the writer at run time, so the two cannot drift.

What is checked, and when:

- the first argument of ``emit``/``emit_sampled`` when it is a string
  literal (dynamic event names are skipped — the runtime counter is the
  only guard there),
- required-field presence when the keyword set is statically complete:
  explicit keywords plus ``**{...}`` dict literals with constant string
  keys count; any other ``**`` expansion makes the field set unknowable
  and skips the field check (the type check still applies).

Receivers matter: only calls through a ``telemetry``/``_telemetry``
binding (module convention across the repo) or a bare imported
``emit``/``emit_sampled`` are checked — ``self.emit(...)`` inside the
writer and ``w.emit(...)`` on explicit writer objects are not emit-seam
call sites.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from bcfl_tpu_torch.analysis.core import Checker, Finding, Source, register
from bcfl_tpu_torch.telemetry.events import EVENT_TYPES

_FUNCS = {"emit": 1, "emit_sampled": 2}  # name -> index of first field arg
_BASES = {"telemetry", "_telemetry"}


def _emit_call(call: ast.Call) -> Optional[str]:
    """'emit'/'emit_sampled' when ``call`` is an emit-seam call site."""
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id in _FUNCS:
        return fn.id
    if isinstance(fn, ast.Attribute) and fn.attr in _FUNCS:
        base = fn.value
        if isinstance(base, ast.Name) and base.id in _BASES:
            return fn.attr
        if isinstance(base, ast.Attribute) and base.attr in _BASES:
            return fn.attr
    return None


def _static_fields(call: ast.Call) -> Optional[Set[str]]:
    """The statically-known keyword field set, or None when a ``**``
    expansion makes it unknowable."""
    fields: Set[str] = set()
    for kw in call.keywords:
        if kw.arg is not None:
            fields.add(kw.arg)
            continue
        # **expr: a dict literal with constant string keys is still
        # statically complete (the `**{"from": ...}` idiom for reserved
        # words); anything else is not
        if isinstance(kw.value, ast.Dict) and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str)
                for k in kw.value.keys):
            fields.update(k.value for k in kw.value.keys)
            continue
        return None
    return fields


@register
class TelemetrySchemaChecker(Checker):
    id = "telemetry-schema"
    contract = ("every literal telemetry.emit(<type>) names an "
                "EVENT_TYPES entry and passes its required fields when "
                "statically visible")

    def check(self, src: Source) -> Iterable[Finding]:
        if src.tree is None:
            return ()
        # the catalogue module itself is the definition site, not a call
        # site population worth checking against itself
        if src.rel == "telemetry/events.py":
            return ()
        out: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = _emit_call(node)
            if fname is None:
                continue
            first = _FUNCS[fname]
            if len(node.args) <= first - 1:
                continue
            ev = node.args[0]
            if not (isinstance(ev, ast.Constant)
                    and isinstance(ev.value, str)):
                continue  # dynamic event name: runtime counter's job
            name = ev.value
            if name not in EVENT_TYPES:
                out.append(self.finding(
                    src, node,
                    f"unknown telemetry event type {name!r}: not in "
                    f"EVENT_TYPES (bcfl_tpu_torch/telemetry/events.py) — at "
                    f"runtime this emit is silently counted and DROPPED"))
                continue
            fields = _static_fields(node)
            if fields is None:
                continue  # ** expansion: field set not statically visible
            missing = [k for k in EVENT_TYPES[name] if k not in fields]
            if missing:
                out.append(self.finding(
                    src, node,
                    f"telemetry.emit({name!r}) is missing required "
                    f"field(s) {missing} (EVENT_TYPES) — at runtime this "
                    f"emit is silently counted and DROPPED"))
        return out
