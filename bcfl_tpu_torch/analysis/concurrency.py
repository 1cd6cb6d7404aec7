"""Concurrency checkers: guarded-by field access and lock acquisition
order (port of ``bcfl_tpu/analysis/concurrency.py``, same logic).

The dist runtime is genuinely threaded — per-destination sender workers,
per-connection serve threads, a leader intake thread, watchdog Timers, a
SIGTERM handler — and the repo's own comments document which lock guards
which shared field (``transport._bump``: "a plain += is a racy
read-add-store"). These two checkers turn those comments into enforced
declarations:

- **guarded-by** — a field registered with a trailing ``# guarded-by:
  <lock>`` comment on its ``__init__`` assignment must only be accessed
  inside a ``with self.<lock>`` block (or from a method annotated
  ``# guarded-by: <lock>`` on its ``def`` line, meaning callers hold the
  lock). The ``(writes)`` qualifier restricts enforcement to mutations —
  the honest contract for counters whose reads are GIL-atomic snapshot
  reads (reports) while their ``+=`` is the read-add-store race.
- **lock-order** — the static graph "lock B acquired while lock A held"
  (direct ``with`` nesting, same-class method calls resolved
  transitively, plus the known telemetry seam: every ``telemetry.emit``
  takes the EventWriter's internal lock). Any cycle is the deadlock the
  pipelined sender + intake thread made possible; a plain ``Lock``
  re-acquired while already held is reported too (only RLock/Condition
  are reentrant).

Static limits (documented, deliberate): accesses through another object
(``self.rep.quarantine_drops`` guarded by a lock the *runtime* owns) and
locks passed across classes are not resolved — the registry covers fields
whose lock lives on the same object, which is every lock site the dist
runtime has today.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from bcfl_tpu_torch.analysis.core import Checker, Finding, Source, register

_GUARD_RE = re.compile(
    r"#\s*guarded-by:\s*([A-Za-z_]\w*)\s*(?P<writes>\(writes\))?")

#: constructors whose result is treated as a lock attribute
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
#: reentrant lock constructors (self-nesting is legal)
_REENTRANT = {"RLock", "Condition"}

#: calls that are known to acquire a lock the AST cannot see locally:
#: every telemetry emit/flush goes through EventWriter's internal RLock
#: (bcfl_tpu_torch/telemetry/events.py) — the one cross-module seam that
#: matters, because emit sites sit inside detector/report critical
#: sections
_TELEMETRY_LOCK = "EventWriter._lock"
_TELEMETRY_FUNCS = {"emit", "emit_sampled", "flush"}
_TELEMETRY_BASES = {"telemetry", "_telemetry"}


def _lock_ctor_name(node: ast.AST) -> Optional[str]:
    """'RLock' for ``threading.RLock()`` / ``RLock()`` calls, else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = None
    if isinstance(fn, ast.Attribute):
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    return name if name in _LOCK_CTORS else None


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _telemetry_acquire(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _TELEMETRY_FUNCS:
        base = fn.value
        if isinstance(base, ast.Name) and base.id in _TELEMETRY_BASES:
            return True
        if isinstance(base, ast.Attribute) and base.attr in _TELEMETRY_BASES:
            return True
    return False


@dataclasses.dataclass
class _ClassInfo:
    name: str
    locks: Dict[str, str]              # lock attr -> ctor name
    guarded: Dict[str, Tuple[str, bool]]  # field -> (lock attr, writes_only)
    methods: Dict[str, ast.FunctionDef]
    annotations: Dict[str, Set[str]]   # method -> locks held by contract


def _scan_class(src: Source, cls: ast.ClassDef) -> _ClassInfo:
    locks: Dict[str, str] = {}
    guarded: Dict[str, Tuple[str, bool]] = {}
    methods: Dict[str, ast.FunctionDef] = {}
    annotations: Dict[str, Set[str]] = {}
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        methods[item.name] = item
        held = set()
        m = _GUARD_RE.search(src.line_text(item.lineno))
        if m and src.comment_on(item.lineno, "guarded-by:"):
            held.add(m.group(1))
        annotations[item.name] = held
        for node in ast.walk(item):
            # lock attrs + guarded-field registrations, wherever assigned
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                value = node.value
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    ctor = _lock_ctor_name(value) if value is not None \
                        else None
                    if ctor is not None:
                        locks[attr] = ctor
                        continue
                    gm = _GUARD_RE.search(src.line_text(node.lineno))
                    if gm and src.comment_on(node.lineno, "guarded-by:"):
                        guarded[attr] = (gm.group(1),
                                         gm.group("writes") is not None)
    return _ClassInfo(cls.name, locks, guarded, methods, annotations)


def _is_write(node: ast.Attribute, parents: Dict[ast.AST, ast.AST]) -> bool:
    """Store/Del context, or the base of a subscript that is itself being
    stored/deleted (``self.d[k] = v`` / ``self.d[k] += 1``)."""
    if isinstance(node.ctx, (ast.Store, ast.Del)):
        return True
    parent = parents.get(node)
    if (isinstance(parent, ast.Subscript) and parent.value is node
            and isinstance(parent.ctx, (ast.Store, ast.Del))):
        return True
    return False


def _walk_with_locks(fn: ast.AST, lock_attrs: Set[str], held: Tuple[str, ...],
                     visit) -> None:
    """DFS that tracks which of the class's locks are held via ``with
    self.<lock>`` nesting; ``visit(node, held)`` fires on every node."""
    visit(fn, held)
    if isinstance(fn, (ast.With, ast.AsyncWith)):
        acquired = list(held)
        for item in fn.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in lock_attrs:
                acquired.append(attr)
            visit(item.context_expr, held)
        inner = tuple(acquired)
        for stmt in fn.body:
            _walk_with_locks(stmt, lock_attrs, inner, visit)
        return
    for child in ast.iter_child_nodes(fn):
        _walk_with_locks(child, lock_attrs, held, visit)


@register
class GuardedByChecker(Checker):
    id = "guarded-by"
    contract = ("registered shared fields are only accessed under their "
                "declared lock (# guarded-by: <lock> annotations)")

    def check(self, src: Source) -> Iterable[Finding]:
        out: List[Finding] = []
        if src.tree is None:
            return out
        classes = [n for n in ast.walk(src.tree)
                   if isinstance(n, ast.ClassDef)]
        scanned = {cls.name: (_scan_class(src, cls), cls)
                   for cls in classes}

        def merged_locks(name: str, seen: Tuple[str, ...]) -> Dict[str, str]:
            # a subclass guards state with the base's lock (e.g. the phi
            # detector reuses FailureDetector._lock) — resolve lock attrs
            # through same-file bases so those registrations still verify
            info, cls = scanned[name]
            locks = dict(info.locks)
            for b in cls.bases:
                base = b.id if isinstance(b, ast.Name) else None
                if base in scanned and base not in seen:
                    for k, v in merged_locks(base, seen + (name,)).items():
                        locks.setdefault(k, v)
            return locks

        for cls in classes:
            info, _ = scanned[cls.name]
            if not info.guarded:
                continue
            info = dataclasses.replace(
                info, locks=merged_locks(cls.name, ()))
            # fail-loudly on a registration naming a lock that is not a
            # lock attribute of this class (typo'd annotations must not
            # silently un-guard a field)
            for field, (lock, _w) in sorted(info.guarded.items()):
                if lock not in info.locks:
                    out.append(self.finding(
                        src, cls,
                        f"{info.name}.{field} is declared guarded-by "
                        f"{lock!r}, but {info.name} has no lock attribute "
                        f"of that name"))
            for mname, fn in info.methods.items():
                if mname == "__init__":
                    continue  # construction happens-before publication
                parents: Dict[ast.AST, ast.AST] = {}
                for p in ast.walk(fn):
                    for ch in ast.iter_child_nodes(p):
                        parents[ch] = p
                base_held = tuple(info.annotations.get(mname, ()))

                def visit(node, held, _fn_name=mname):
                    attr = _self_attr(node) if isinstance(
                        node, ast.Attribute) else None
                    if attr is None or attr not in info.guarded:
                        return
                    lock, writes_only = info.guarded[attr]
                    if lock not in info.locks:
                        return  # already reported above
                    write = _is_write(node, parents)
                    if writes_only and not write:
                        return
                    if lock in held:
                        return
                    out.append(self.finding(
                        src, node,
                        f"{info.name}.{attr} is guarded by self.{lock} "
                        f"but is {'written' if write else 'read'} in "
                        f"{_fn_name}() outside `with self.{lock}` "
                        f"(annotate the method `# guarded-by: {lock}` if "
                        f"every caller holds it)"))

                _walk_with_locks(fn, set(info.locks), base_held, visit)
        return out


@register
class LockOrderChecker(Checker):
    id = "lock-order"
    contract = ("the static lock acquisition graph (lock B taken while "
                "lock A held) is cycle-free; non-reentrant locks are "
                "never self-nested")

    def __init__(self):
        # edge (held, acquired) -> one example "file:line (context)"
        self.edges: Dict[Tuple[str, str], str] = {}
        self.lock_ctors: Dict[str, str] = {_TELEMETRY_LOCK: "RLock"}
        self._example_src: Dict[Tuple[str, str], Tuple[str, int]] = {}

    # ----------------------------------------------------------- per file

    def check(self, src: Source) -> Iterable[Finding]:
        if src.tree is None:
            return ()
        # module-level locks (e.g. native/build.py `_lock`)
        mod_locks: Dict[str, str] = {}
        mod_name = (src.rel or src.path).rsplit("/", 1)[-1].rsplit(".", 1)[0]
        for node in src.tree.body:
            if isinstance(node, ast.Assign):
                ctor = _lock_ctor_name(node.value)
                if ctor:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            lid = f"{mod_name}.{t.id}"
                            mod_locks[t.id] = lid
                            self.lock_ctors[lid] = ctor
        for cls in [n for n in ast.walk(src.tree)
                    if isinstance(n, ast.ClassDef)]:
            self._check_class(src, cls, mod_locks)
        # module-level functions using module locks
        for fn in src.tree.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._collect_edges(src, fn, mod_locks, {}, {}, ())
        return ()

    def _check_class(self, src: Source, cls: ast.ClassDef,
                     mod_locks: Dict[str, str]) -> None:
        info = _scan_class(src, cls)
        for attr, ctor in info.locks.items():
            self.lock_ctors[f"{info.name}.{attr}"] = ctor
        # pass 1: per-method direct acquisitions (for call propagation)
        direct: Dict[str, Set[str]] = {}
        for mname, fn in info.methods.items():
            acq: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        a = _self_attr(item.context_expr)
                        if a in info.locks:
                            acq.add(f"{info.name}.{a}")
                if isinstance(node, ast.Call) and _telemetry_acquire(node):
                    acq.add(_TELEMETRY_LOCK)
            direct[mname] = acq
        # pass 2: transitive closure over same-class self.method() calls
        calls: Dict[str, Set[str]] = {m: set() for m in info.methods}
        for mname, fn in info.methods.items():
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    a = _self_attr(node.func)
                    if a in info.methods:
                        calls[mname].add(a)
        effective = {m: set(s) for m, s in direct.items()}
        changed = True
        while changed:
            changed = False
            for m in info.methods:
                for callee in calls[m]:
                    new = effective[callee] - effective[m]
                    if new:
                        effective[m] |= new
                        changed = True
        # pass 3: edges — annotation locks and with-nesting both count as
        # "held"; anything acquired below adds an edge
        for mname, fn in info.methods.items():
            base = tuple(f"{info.name}.{a}"
                         for a in info.annotations.get(mname, ())
                         if a in info.locks)
            self._collect_edges(src, fn, mod_locks, info.locks,
                                {m: effective[m] for m in info.methods},
                                base, class_name=info.name)

    def _collect_edges(self, src: Source, fn, mod_locks: Dict[str, str],
                       class_locks: Dict[str, str],
                       method_acquires: Dict[str, Set[str]],
                       base_held: Tuple[str, ...],
                       class_name: str = "") -> None:
        def lock_id_of(expr) -> Optional[str]:
            a = _self_attr(expr)
            if a is not None and a in class_locks:
                return f"{class_name}.{a}"
            if isinstance(expr, ast.Name) and expr.id in mod_locks:
                return mod_locks[expr.id]
            return None

        def add_edge(held: Tuple[str, ...], acquired: str, node) -> None:
            for h in held:
                key = (h, acquired)
                if key not in self.edges:
                    self.edges[key] = f"{src.path}:{node.lineno}"
                    self._example_src[key] = (src.path, node.lineno)

        def walk(node, held: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for item in node.items:
                    lid = lock_id_of(item.context_expr)
                    if lid is not None:
                        add_edge(tuple(inner), lid, item.context_expr)
                        inner.append(lid)
                for stmt in node.body:
                    walk(stmt, tuple(inner))
                return
            if isinstance(node, ast.Call):
                if _telemetry_acquire(node) and held:
                    add_edge(held, _TELEMETRY_LOCK, node)
                a = _self_attr(node.func)
                if a is not None and a in method_acquires and held:
                    for lid in method_acquires[a]:
                        add_edge(held, lid, node)
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        walk(fn, base_held)

    # ----------------------------------------------------------- finalize

    def finalize(self) -> Iterable[Finding]:
        out: List[Finding] = []
        # self-nesting of a non-reentrant lock is an immediate deadlock
        for (a, b), where in sorted(self.edges.items()):
            if a == b and self.lock_ctors.get(a) not in _REENTRANT:
                path, line = self._example_src[(a, b)]
                out.append(Finding(
                    checker=self.id, file=path, line=line,
                    message=f"non-reentrant lock {a} acquired while "
                            f"already held (plain Lock deadlocks on "
                            f"re-entry; use RLock or restructure)"))
        # cycle detection over the directed edge set (self-loops excluded
        # — handled above; RLock self-loops are legal re-entry)
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            if a != b:
                adj.setdefault(a, set()).add(b)
        for cycle in _find_cycles(adj):
            # anchor the report at the edge closing the cycle
            key = (cycle[-1], cycle[0])
            path, line = self._example_src.get(
                key, self._example_src[(cycle[0], cycle[1])]
                if (cycle[0], cycle[1]) in self._example_src
                else next(iter(self._example_src.values())))
            order = " -> ".join(cycle + [cycle[0]])
            out.append(Finding(
                checker=self.id, file=path, line=line,
                message=f"lock-order cycle: {order} (two threads taking "
                        f"these locks in opposite orders deadlock; pick "
                        f"one global order)"))
        return out


def _find_cycles(adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Elementary cycles via Tarjan SCCs: one representative cycle per
    strongly connected component with more than one node."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []
    nodes = sorted(set(adj) | {b for bs in adj.values() for b in bs})

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in sorted(adj.get(v, ())):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                sccs.append(sorted(comp))

    for v in nodes:
        if v not in index:
            strongconnect(v)
    return sccs
