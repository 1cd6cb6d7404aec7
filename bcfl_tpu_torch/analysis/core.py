"""The ``lint`` subcommand's framework (port of
``bcfl_tpu/analysis/core.py``; stdlib only): AST-based static analysis of
the port's own contracts.

The port's claims (bit-identical seeded chaos draws, bit-for-bit
crash/resume, ledger digests stable across the wire, zero invariant
violations under byzantine and wire chaos) are contracts; its dist runtime
is threaded (per-destination sender workers, a leader intake thread,
watchdog timers). These checkers reject a contract violation at lint time,
before it becomes a flaky loopback test.

Design constraints:

- **stdlib only** (``ast``, ``tokenize``, ``argparse``, ``json``): the
  checkers import no torch and nothing of ``bcfl_tpu``; the telemetry
  catalogue they read (:mod:`bcfl_tpu_torch.telemetry.events`) is
  host-only too.
- **Checkers are registered declaratively** (:func:`register`): each owns
  one checker id and one contract and yields :class:`Finding` rows with a
  stable ``file:line`` anchor.
- **Suppressions are explicit and justified**: ``# lint:
  disable=<checker-id> — <justification>`` on the offending line (or a
  standalone comment line directly above it). A suppression without a
  justification suppresses nothing and is itself a finding.
- **A committed baseline** (``baseline.json`` next to this module) can
  grandfather findings; ``--no-baseline`` ignores it. It is keyed on
  (checker, package-relative file, message): line numbers churn,
  messages are the stable identity.
- **The exit code is the contract**: ``lint`` exits nonzero on any
  finding that is neither suppressed nor baselined.

Scope rule: files inside ``bcfl_tpu_torch/`` are checked under each
checker's package scoping (socket-deadline only under ``dist/``,
determinism only in the seeded-draw modules); files outside the package
are fully in scope for every checker (fixtures, one-off scripts).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: schema version of the ``--json`` output (tests pin the key sets)
JSON_VERSION = 1

#: the bcfl_tpu_torch package root (scope anchor for package-relative paths)
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the committed grandfather file (empty == every contract enforced live)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")

#: checker id reserved for the framework's own suppression hygiene
SUPPRESSION_ID = "suppression"

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Za-z0-9_,\-]+)"
    r"(?:\s*(?:—|–|--|-|:)?\s*(?P<why>\S.*))?$")


@dataclasses.dataclass
class Finding:
    """One checker hit, anchored to ``file:line``.

    ``suppressed`` / ``baselined`` are verdicts the runner stamps after
    matching suppression comments and the baseline file; a finding fails
    the run only when both are False."""

    checker: str
    file: str       # path as scanned (absolute)
    line: int
    message: str
    suppressed: bool = False
    justification: Optional[str] = None
    baselined: bool = False

    @property
    def failing(self) -> bool:
        return not (self.suppressed or self.baselined)

    def rel_file(self) -> str:
        """Package-relative posix path when under bcfl_tpu_torch/ (the stable
        baseline key), else the basename."""
        ap = os.path.abspath(self.file)
        if ap.startswith(PACKAGE_DIR + os.sep):
            rel = os.path.relpath(ap, os.path.dirname(PACKAGE_DIR))
            return rel.replace(os.sep, "/")
        return os.path.basename(ap)

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.checker}] {self.message}"

    def to_json(self) -> Dict:
        return {
            "checker": self.checker,
            "file": self.rel_file(),
            "line": self.line,
            "message": self.message,
            "suppressed": self.suppressed,
            "baselined": self.baselined,
        }


@dataclasses.dataclass
class _Suppression:
    line: int           # the line of code the suppression covers
    ids: Set[str]
    justification: Optional[str]
    comment_line: int   # where the comment itself sits
    used: bool = False


class Source:
    """One parsed file: text, lines, AST, parsed suppressions."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        with open(self.path, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(self.text, filename=self.path)
        except SyntaxError as e:
            self.parse_error = e
        # package scoping: None when the file is outside bcfl_tpu_torch/ —
        # checkers then treat it as fully in scope (fixtures, scripts)
        self.rel: Optional[str] = None
        if self.path.startswith(PACKAGE_DIR + os.sep):
            self.rel = os.path.relpath(
                self.path, PACKAGE_DIR).replace(os.sep, "/")
        self._comment_cache: Optional[List[Tuple[int, int, str]]] = None
        self.suppressions: List[_Suppression] = self._parse_suppressions()

    # ------------------------------------------------------- suppressions

    def _comments(self) -> List[Tuple[int, int, str]]:
        """[(line, col, text)] of every comment token (tokenize-accurate:
        a '#' inside a string literal is never a comment). Tokenized once
        and cached — comment_on is called per def line / call site."""
        if self._comment_cache is not None:
            return self._comment_cache
        out: List[Tuple[int, int, str]] = []
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    out.append((tok.start[0], tok.start[1], tok.string))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # fall back to nothing: an unparseable file already surfaces
            # as a parse-error finding
            pass
        self._comment_cache = out
        return out

    def _parse_suppressions(self) -> List[_Suppression]:
        out = []
        for line, col, text in self._comments():
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            ids = {i.strip() for i in m.group(1).split(",") if i.strip()}
            why = m.group("why")
            # a standalone comment line covers the next line carrying
            # code; a trailing comment covers its own line
            standalone = self.lines[line - 1][:col].strip() == ""
            target = line
            if standalone:
                target = line + 1
                while (target <= len(self.lines)
                       and (not self.lines[target - 1].strip()
                            or self.lines[target - 1].lstrip()
                            .startswith("#"))):
                    target += 1
            out.append(_Suppression(line=target, ids=ids,
                                    justification=why, comment_line=line))
        return out

    def suppression_for(self, checker_id: str,
                        line: int) -> Optional[_Suppression]:
        for s in self.suppressions:
            if s.line == line and (checker_id in s.ids or "all" in s.ids):
                return s
        return None

    # ------------------------------------------------------------ helpers

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""

    def comment_on(self, line: int, needle: str) -> bool:
        """Does line ``line`` carry a comment containing ``needle``?
        (Comment-accurate — a match inside a string does not count.)"""
        for ln, _col, text in self._comments():
            if ln == line and needle in text:
                return True
        return False


class Checker:
    """Base class. Subclasses set ``id`` + ``contract`` and implement
    :meth:`check` (per file); cross-file checkers accumulate state in
    ``check`` and yield the rest from :meth:`finalize`. Checker instances
    are constructed fresh per lint run — state never leaks between runs."""

    id: str = ""
    contract: str = ""

    def check(self, src: Source) -> Iterable[Finding]:
        return ()

    def finalize(self) -> Iterable[Finding]:
        return ()

    def finding(self, src: Source, node, message: str) -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Finding(checker=self.id, file=src.path, line=line,
                       message=message)


#: checker id -> class (populated by the @register decorators at import)
CHECKERS: Dict[str, type] = {}


def register(cls: type) -> type:
    if not cls.id:
        raise ValueError(f"checker {cls.__name__} has no id")
    if cls.id in CHECKERS:
        raise ValueError(f"duplicate checker id {cls.id!r}")
    CHECKERS[cls.id] = cls
    return cls


def checker_ids() -> List[str]:
    return sorted(CHECKERS)


# ---------------------------------------------------------------- baseline


def load_baseline(path: str) -> Set[Tuple[str, str, str]]:
    """(checker, package-relative file, message) triples the repo has
    grandfathered. A missing file is an empty baseline; a PRESENT but
    unreadable one (merge-conflict garbage, schema drift) fails loudly —
    silently treating it as empty would un-grandfather everything with a
    wall of confusing findings instead of one clear error."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return set()
    except json.JSONDecodeError as e:
        raise ValueError(
            f"baseline {path} is not valid JSON: {e}") from None
    try:
        return {(row["checker"], row["file"], row["message"])
                for row in data.get("findings", ())}
    except (TypeError, KeyError, AttributeError) as e:
        raise ValueError(
            f"baseline {path} is unreadable (each findings row needs "
            f"checker/file/message): {e!r}") from None


def baseline_json(findings: Sequence[Finding]) -> str:
    """Serialize ``findings`` in the committed baseline format (what
    ``--write-baseline`` emits) — sorted, line-number free."""
    rows = sorted({(f.checker, f.rel_file(), f.message) for f in findings})
    return json.dumps(
        {"version": JSON_VERSION,
         "findings": [{"checker": c, "file": fl, "message": m}
                      for c, fl, m in rows]},
        indent=2) + "\n"


# ------------------------------------------------------------------ runner


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out = []
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isdir(ap):
            for dirpath, dirnames, files in os.walk(ap):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(files) if f.endswith(".py"))
        elif ap.endswith(".py"):
            out.append(ap)
    # dedup, stable order
    seen: Set[str] = set()
    uniq = []
    for f in out:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return uniq


def run_lint(paths: Sequence[str],
             checker_ids_filter: Optional[Sequence[str]] = None,
             use_baseline: bool = True,
             baseline_path: str = DEFAULT_BASELINE) -> List[Finding]:
    """Run the (selected) checkers over every ``.py`` under ``paths`` and
    return ALL findings — suppressed and baselined ones included, with
    their verdicts stamped. Callers decide the exit code via
    :attr:`Finding.failing`."""
    # the checker modules self-register on import; import here so `import
    # bcfl_tpu_torch.analysis.core` alone stays side-effect-light
    from bcfl_tpu_torch.analysis import (  # noqa: F401
        concurrency,
        determinism,
        telemetry_schema,
        wire_static,
    )

    ids = list(checker_ids_filter) if checker_ids_filter else checker_ids()
    unknown = [i for i in ids if i not in CHECKERS]
    if unknown:
        raise ValueError(
            f"unknown checker id(s) {unknown}; known: {checker_ids()}")
    checkers = [CHECKERS[i]() for i in ids]

    files = iter_py_files(paths)
    if not files:
        # a typo'd path (or the wrong cwd) must not make the standing
        # guard pass vacuously while checking zero files
        raise ValueError(
            f"no .py files found under {list(paths)!r} — nothing to lint")

    findings: List[Finding] = []
    sources: Dict[str, Source] = {}
    for path in files:
        src = Source(path)
        sources[path] = src
        if src.parse_error is not None:
            findings.append(Finding(
                checker="parse-error", file=src.path,
                line=src.parse_error.lineno or 1,
                message=f"file does not parse: {src.parse_error.msg}"))
            continue
        for c in checkers:
            findings.extend(c.check(src))
    for c in checkers:
        findings.extend(c.finalize())

    # --- suppression pass: justified suppressions mark findings; a
    # suppression without a justification is itself a finding and
    # suppresses nothing (the convention REQUIRES the why)
    for f in findings:
        src = sources.get(f.file)
        if src is None:
            continue
        sup = src.suppression_for(f.checker, f.line)
        if sup is not None and sup.justification:
            f.suppressed = True
            f.justification = sup.justification
            sup.used = True
        elif sup is not None:
            sup.used = True  # matched, but invalid — reported below
    for src in sources.values():
        for sup in src.suppressions:
            if not sup.justification:
                findings.append(Finding(
                    checker=SUPPRESSION_ID, file=src.path,
                    line=sup.comment_line,
                    message="suppression without a justification: write "
                            "'# lint: disable=<id> — <why>' (the why is "
                            "mandatory; this suppression was ignored)"))

    # --- baseline pass
    if use_baseline:
        grandfathered = load_baseline(baseline_path)
        for f in findings:
            if (f.checker, f.rel_file(), f.message) in grandfathered:
                f.baselined = True

    findings.sort(key=lambda f: (f.file, f.line, f.checker, f.message))
    return findings


# --------------------------------------------------------------------- CLI


def lint_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m bcfl_tpu_torch.entrypoints lint [PATHS] [--checker ID] [--json] [--no-baseline]
    [--list-checkers] [--write-baseline]`` — exit 0 iff no unsuppressed,
    unbaselined finding exists."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="bcfl_tpu_torch lint",
        description="AST-based static analysis of the port's concurrency, "
                    "determinism, telemetry and wire contracts")
    ap.add_argument("paths", nargs="*", default=None, metavar="PATH",
                    help="files or directories to lint (default: the "
                         "installed bcfl_tpu_torch package)")
    ap.add_argument("--checker", action="append", default=None,
                    metavar="ID",
                    help="run only this checker (repeatable; default all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout (schema "
                         "version %d)" % JSON_VERSION)
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the committed baseline: every finding "
                         "counts")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default: the committed "
                         "bcfl_tpu_torch/analysis/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="print the current unsuppressed findings in "
                         "baseline format (adoption helper) and exit 0")
    ap.add_argument("--list-checkers", action="store_true",
                    help="list checker ids and the contract each enforces")
    args = ap.parse_args(argv)

    from bcfl_tpu_torch.analysis import (  # noqa: F401 — populate the registry
        concurrency,
        determinism,
        telemetry_schema,
        wire_static,
    )

    if args.list_checkers:
        for cid in checker_ids():
            print(f"{cid:18s} {CHECKERS[cid].contract}")
        return 0

    paths = args.paths or [PACKAGE_DIR]
    try:
        findings = run_lint(paths, checker_ids_filter=args.checker,
                            use_baseline=not args.no_baseline,
                            baseline_path=args.baseline)
    except ValueError as e:
        # unknown --checker id, empty path set, unreadable baseline:
        # usage errors, exit 2 — never a silent pass or a raw traceback
        ap.error(str(e))
    failing = [f for f in findings if f.failing]

    if args.write_baseline:
        # every unsuppressed finding, INCLUDING currently-baselined ones:
        # regenerating the baseline must be a superset operation, or
        # redirecting the output over baseline.json would silently drop
        # every already-grandfathered entry
        print(baseline_json([f for f in findings if not f.suppressed]),
              end="")
        return 0

    if args.as_json:
        print(json.dumps({
            "version": JSON_VERSION,
            "checkers": (sorted(args.checker) if args.checker
                         else checker_ids()),
            "findings": [f.to_json() for f in findings],
            "counts": {
                "total": len(findings),
                "suppressed": sum(f.suppressed for f in findings),
                "baselined": sum(f.baselined for f in findings),
                "failing": len(failing),
            },
        }, indent=2))
    else:
        for f in failing:
            print(f.render())
        n_sup = sum(f.suppressed for f in findings)
        n_base = sum(f.baselined for f in findings)
        print(f"bcfl_tpu_torch lint: {len(failing)} finding(s) "
              f"({n_sup} suppressed, {n_base} baselined)")
    return 1 if failing else 0
