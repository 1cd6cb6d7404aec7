"""Wire-layer static checkers: socket deadlines and frame concatenation
(port of ``bcfl_tpu/analysis/wire_static.py``).

Two AST checkers that resolve the actual call sites:

- **socket-deadline** (RUNTIME.md §7 "nothing can wedge"): every socket
  ``recv`` / ``recv_into`` / ``accept`` / ``connect`` /
  ``create_connection`` call site under ``bcfl_tpu_torch/dist`` must
  carry a visible deadline: a ``timeout``/``timeout_s``/``deadline``
  keyword (or a positional argument whose expression mentions one), a
  ``settimeout``/``_budget`` call in the enclosing function (the
  streaming reader's budget idiom), or an explicit ``# deadline: ...``
  pointer on the statement (or the line directly above it).
- **no-frame-concat** (RUNTIME.md §3, the zero-copy send path): no
  production code may build a full frame payload as one ``bytes`` —
  ``pack_frame`` (the in-memory reference) is only callable from
  ``dist/wire.py`` itself, and nothing under ``bcfl_tpu_torch/dist`` may
  ``b"".join`` a payload. A regression here silently doubles peak
  serialization memory per send (a model-sized copy), exactly what the
  streaming writer (``wire.write_frame``) exists to avoid.

Package scoping: socket-deadline applies under ``dist/``; no-frame-concat
applies package-wide for ``pack_frame`` and under ``dist/`` for
``b"".join``, with ``dist/wire.py`` (the reference implementation) exempt
from both. Files outside the package are fully in scope.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from bcfl_tpu_torch.analysis.core import Checker, Finding, Source, register

#: method names that are deadline-bearing socket operations
SOCKET_METHODS = ("accept", "recv", "recv_into", "connect")
#: function names that open a connection (socket.create_connection)
SOCKET_FUNCS = ("create_connection",)

_TIMEOUT_KWARGS = {"timeout", "timeout_s", "deadline", "deadline_s"}
_BUDGET_CALLS = {"settimeout", "_budget"}


def _socket_site(call: ast.Call) -> Optional[str]:
    """The matched operation name when ``call`` is a socket-op call site
    (e.g. 'recv' for ``sock.recv(...)``, 'create_connection' for
    ``socket.create_connection(...)``), else None."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        if fn.attr in SOCKET_METHODS:
            return fn.attr
        if fn.attr in SOCKET_FUNCS:
            return fn.attr
    if isinstance(fn, ast.Name) and fn.id in SOCKET_FUNCS:
        return fn.id
    return None


def iter_socket_sites(tree: ast.AST) -> List[Tuple[ast.Call, str, Optional[ast.AST]]]:
    """Every socket-op call site in ``tree`` as ``(call, op, enclosing
    function)`` — shared by the checker and the grep-parity test, so the
    two cannot drift."""
    parents: Dict[ast.AST, ast.AST] = {}
    for p in ast.walk(tree):
        for ch in ast.iter_child_nodes(p):
            parents[ch] = p
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            op = _socket_site(node)
            if op is None:
                continue
            fn = node
            while fn is not None and not isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = parents.get(fn)
            out.append((node, op, fn))
    return out


def _has_deadline_evidence(src: Source, call: ast.Call,
                           enclosing: Optional[ast.AST]) -> bool:
    # (1) an explicit timeout/deadline keyword on the call itself
    for kw in call.keywords:
        if kw.arg in _TIMEOUT_KWARGS:
            return True
    # (2) a positional argument whose expression names a timeout/deadline
    # (e.g. read_frame(conn, self.io_timeout_s))
    for arg in call.args:
        text = ast.unparse(arg)
        if "timeout" in text or "deadline" in text:
            return True
    # (3) the enclosing function budgets the socket: a settimeout(...) or
    # _budget() call anywhere in it (the streaming reader's idiom — the
    # per-chunk recv runs under the budget set just above it)
    if enclosing is not None:
        for node in ast.walk(enclosing):
            if isinstance(node, ast.Call):
                fn = node.func
                name = (fn.attr if isinstance(fn, ast.Attribute)
                        else fn.id if isinstance(fn, ast.Name) else None)
                if name in _BUDGET_CALLS:
                    return True
    # (4) an explicit '# deadline: ...' pointer on the statement's span or
    # the line directly above it (comment-accurate, not substring-in-code)
    start = call.lineno
    end = getattr(call, "end_lineno", call.lineno) or call.lineno
    for line in range(start - 1, end + 1):
        if src.comment_on(line, "deadline:"):
            return True
    return False


@register
class SocketDeadlineChecker(Checker):
    id = "socket-deadline"
    contract = ("every socket recv/recv_into/accept/connect/"
                "create_connection under dist/ carries a visible deadline "
                "(kwarg, enclosing settimeout/_budget, or '# deadline:' "
                "pointer)")

    def check(self, src: Source) -> Iterable[Finding]:
        if src.tree is None:
            return ()
        if src.rel is not None and not src.rel.startswith("dist/"):
            return ()  # package scope: the dist wire layer only
        out: List[Finding] = []
        for call, op, enclosing in iter_socket_sites(src.tree):
            if _has_deadline_evidence(src, call, enclosing):
                continue
            out.append(self.finding(
                src, call,
                f"socket call site .{op}(...) without a visible deadline "
                f"(add a timeout kwarg, a settimeout in the enclosing "
                f"function, or a '# deadline: ...' pointer to where it "
                f"is enforced) — a new call site without one wedges a "
                f"peer in CI, not here"))
        return out


@register
class NoFrameConcatChecker(Checker):
    id = "no-frame-concat"
    contract = ("no pack_frame call outside dist/wire.py; no b\"\".join "
                "under dist/ — full-frame payloads must stream "
                "(wire.write_frame), never concatenate")

    def check(self, src: Source) -> Iterable[Finding]:
        if src.tree is None:
            return ()
        if src.rel == "dist/wire.py":
            return ()  # the in-memory reference implementation lives here
        in_dist = src.rel is None or src.rel.startswith("dist/")
        out: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name == "pack_frame":
                out.append(self.finding(
                    src, node,
                    "pack_frame() call outside dist/wire.py: the "
                    "in-memory reference materializes the whole payload "
                    "— production sends must stream via wire.write_frame"))
            elif (in_dist and name == "join"
                  and isinstance(fn, ast.Attribute)
                  and isinstance(fn.value, ast.Constant)
                  and fn.value.value == b""):
                out.append(self.finding(
                    src, node,
                    'b"".join(...) under dist/: a full-frame payload '
                    "concatenation allocates a model-sized copy per send "
                    "— stream via wire.write_frame instead"))
        return out
