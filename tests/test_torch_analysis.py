"""PyTorch port (``bcfl_tpu_torch``): the ``lint`` static analysis
(``bcfl_tpu_torch/analysis``) against the JAX package's
(``bcfl_tpu/analysis``).

- Every fixture of ``tests/test_analysis.py`` goes through both packages'
  ``run_lint``: the ``(checker, line, message)`` rows are equal, the port
  naming its own ``telemetry/events.py`` where JAX names its own (the one
  path a message carries, mapped before the comparison).
- The suppression convention, the baseline round trip and the ``--json``
  output against JAX's, byte for byte after parsing.
- The standing guard over the port: zero failing findings with the
  committed (empty) baseline and without it, the ``guarded-by`` registry
  over the port's transport, runtime and event writer, the lock-order
  graph reaching ``EventWriter._lock``, every ``SEEDED_SCOPE`` name
  resolving to a class or function of its file, and the socket grep
  parity over the port's ``dist/``.
- The analysis package imports nothing of JAX or ``bcfl_tpu`` (a fresh
  interpreter's ``sys.modules``), and the CLI's ``lint`` subcommand.
"""

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from bcfl_tpu import analysis as janalysis
from bcfl_tpu_torch import analysis as tanalysis
from bcfl_tpu_torch.analysis import (
    DEFAULT_BASELINE,
    SEEDED_SCOPE,
    checker_ids,
    iter_socket_sites,
    lint_main,
    load_baseline,
    run_lint,
)
from bcfl_tpu_torch.analysis.core import Source

pytestmark = pytest.mark.analysis

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "bcfl_tpu_torch"
ALL_CHECKERS = ("determinism", "guarded-by", "lock-order",
                "no-frame-concat", "socket-deadline", "telemetry-schema")


def _jax_tests():
    spec = importlib.util.spec_from_file_location(
        "jax_test_analysis", ROOT / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JT = _jax_tests()

#: checker -> (firing fixture, clean twin), JAX's strings
PAIRS = {
    "guarded-by": (JT._GUARDED_FIRING, JT._GUARDED_CLEAN),
    "lock-order": (JT._ORDER_FIRING, JT._ORDER_CLEAN),
    "determinism": (JT._DET_FIRING, JT._DET_CLEAN),
    "telemetry-schema": (JT._TELEM_FIRING, JT._TELEM_CLEAN),
    "socket-deadline": (JT._SOCK_FIRING, JT._SOCK_CLEAN),
    "no-frame-concat": (JT._CONCAT_FIRING, JT._CONCAT_CLEAN),
}

#: the other fixtures of JAX's tests, each under its checker
_EXTRA = {
    "method-annotation": ("guarded-by", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: _lock

            def _bump_locked(self):  # guarded-by: _lock
                self.n += 1
    """),
    "writes-qualifier": ("guarded-by", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: _lock (writes)

            def snapshot(self):
                return self.n

            def bump_racy(self):
                self.n += 1
    """),
    "subscript-write": ("guarded-by", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.d = {}  # guarded-by: _lock (writes)

            def put(self, k):
                self.d[k] = 1
    """),
    "unknown-lock": ("guarded-by", """
        import threading

        class C:
            def __init__(self):
                self.n = 0  # guarded-by: _lok
    """),
    "same-class-calls": ("lock-order", """
        import threading

        class C:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def takes_b(self):
                with self._b:
                    pass

            def ab(self):
                with self._a:
                    self.takes_b()

            def ba(self):
                with self._b:
                    with self._a:
                        pass
    """),
    "self-nesting": ("lock-order", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def inner(self):
                with self._lock:
                    pass

            def outer(self):
                with self._lock:
                    self.inner()
    """),
    "set-iteration": ("determinism", """
        def f(xs):
            out = []
            for x in set(xs):
                out.append(x)
            return [y for y in {1, 2, 3}]
    """),
    "writer-methods": ("telemetry-schema", """
        def f(self, w, ev):
            self.emit("not_a_type_but_not_our_seam")
            w.emit("also_not_checked")
            from bcfl_tpu import telemetry
            telemetry.emit(ev, x=1)  # dynamic: runtime counter's job
    """),
}


def _write(tmp_path, code, name="fixture.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(code))
    return str(p)


def _rows(findings):
    """(checker, line, message, suppressed, baselined) of each finding,
    the port's own catalogue path mapped onto JAX's."""
    return [(f.checker, f.line,
             f.message.replace("bcfl_tpu_torch/", "bcfl_tpu/"),
             f.suppressed, f.baselined) for f in findings]


def _both(path, **kw):
    return (_rows(janalysis.run_lint([path], **kw)),
            _rows(run_lint([path], **kw)))


# ------------------------------------------------------- fixture parity


@pytest.mark.parametrize("variant", ["firing", "clean"])
@pytest.mark.parametrize("checker", sorted(PAIRS))
def test_fixture_findings_equal_jax(tmp_path, checker, variant):
    code = PAIRS[checker][variant == "clean"]
    want, got = _both(_write(tmp_path, code), checker_ids_filter=[checker],
                      use_baseline=False)
    assert got == want
    if variant == "firing":
        assert got and all(r[0] == checker for r in got)
    else:
        assert not got
    # and every checker at once sees the same
    want, got = _both(_write(tmp_path, code, "all.py"), use_baseline=False)
    assert got == want


@pytest.mark.parametrize("name", sorted(_EXTRA))
def test_more_fixtures_equal_jax(tmp_path, name):
    checker, code = _EXTRA[name]
    want, got = _both(_write(tmp_path, code), checker_ids_filter=[checker],
                      use_baseline=False)
    assert got == want


def test_registry_lists_the_six_checkers(capsys):
    assert tuple(checker_ids()) == ALL_CHECKERS == tuple(
        janalysis.checker_ids())
    assert lint_main(["--list-checkers"]) == 0
    out = capsys.readouterr().out
    assert janalysis.lint_main(["--list-checkers"]) == 0
    assert out == capsys.readouterr().out


def test_chip_smoke_lint_fixtures_are_jax_firing_fixtures():
    """The card run's phase (x) proves each checker fires with these."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert sorted(smoke.LINT_FIXTURES) == sorted(PAIRS)
    for checker, code in smoke.LINT_FIXTURES.items():
        assert textwrap.dedent(code) == textwrap.dedent(PAIRS[checker][0])


# ------------------------------------------- suppression and baseline


@pytest.mark.parametrize("form", ["trailing", "standalone", "unjustified"])
def test_suppression_equal_jax(tmp_path, form):
    base = JT._GUARDED_FIRING
    if form == "trailing":
        code = base.replace(
            "self.n += 1", "self.n += 1  # lint: disable=guarded-by — "
            "fixture: single-threaded by construction")
    elif form == "standalone":
        code = base.replace(
            "            self.n += 1",
            "            # lint: disable=guarded-by — fixture: single-"
            "threaded\n            self.n += 1")
    else:
        code = base.replace("self.n += 1",
                            "self.n += 1  # lint: disable=guarded-by")
    assert code != base
    path = _write(tmp_path, code)
    want, got = _both(path, use_baseline=False)
    assert got == want
    fs = run_lint([path], use_baseline=False)
    failing = {f.checker for f in fs if f.failing}
    if form == "unjustified":
        assert failing == {"guarded-by", "suppression"}
    else:
        assert not failing and fs[0].suppressed
        jfs = janalysis.run_lint([path], use_baseline=False)
        assert fs[0].justification == jfs[0].justification


def test_baseline_roundtrip_equal_jax(tmp_path):
    path = _write(tmp_path, JT._GUARDED_FIRING)
    fs = [f for f in run_lint([path], use_baseline=False) if f.failing]
    jfs = [f for f in janalysis.run_lint([path], use_baseline=False)
           if f.failing]
    text = tanalysis.baseline_json(fs)
    assert text == janalysis.baseline_json(jfs)
    bl = tmp_path / "baseline.json"
    bl.write_text(text)
    assert load_baseline(str(bl)) == janalysis.load_baseline(str(bl))
    kw = dict(use_baseline=True, baseline_path=str(bl))
    want, got = _both(path, **kw)
    assert got == want and got[0][4] is True  # baselined
    assert not [f for f in run_lint([path], **kw) if f.failing]


@pytest.mark.parametrize("extra", [[], ["--no-baseline"],
                                   ["--checker", "guarded-by"]])
def test_cli_json_equal_jax(tmp_path, capsys, extra):
    bad = _write(tmp_path, JT._GUARDED_FIRING, "bad.py")
    good = _write(tmp_path, JT._GUARDED_CLEAN, "good.py")
    assert lint_main([good] + extra) == 0
    capsys.readouterr()
    rcs, outs = [], []
    for main in (janalysis.lint_main, lint_main):
        rcs.append(main([bad, good, "--json"] + extra))
        outs.append(json.loads(capsys.readouterr().out))
    assert rcs == [1, 1]
    assert outs[1] == outs[0]
    data = outs[1]
    assert set(data) == {"version", "checkers", "findings", "counts"}
    assert data["version"] == 1
    assert set(data["counts"]) == {"total", "suppressed", "baselined",
                                   "failing"}
    (row,) = data["findings"]
    assert set(row) == {"checker", "file", "line", "message",
                        "suppressed", "baselined"}
    assert row["file"] == "bad.py"


def test_cli_usage_errors(tmp_path):
    (tmp_path / "a.py").write_text("x = 1\n")
    with pytest.raises(SystemExit) as exc:
        lint_main(["--checker", "nope", str(tmp_path)])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        lint_main([str(tmp_path / "no_such_dir")])
    assert exc.value.code == 2
    bad = tmp_path / "baseline.json"
    bad.write_text("<<<<<<< not json")
    with pytest.raises(ValueError, match="not valid JSON"):
        run_lint([str(tmp_path)], baseline_path=str(bad))


# --------------------------------------------------- the standing guard


def test_port_lint_is_clean_and_its_baseline_empty():
    for use_baseline in (True, False):
        failing = [f for f in run_lint([str(PORT)], use_baseline=use_baseline)
                   if f.failing]
        assert not failing, "\n".join(f.render() for f in failing)
    assert load_baseline(DEFAULT_BASELINE) == set()
    assert pathlib.Path(DEFAULT_BASELINE).parent == PORT / "analysis"
    # every suppression in the port carries its reason and is used
    sups = [f for f in run_lint([str(PORT)]) if f.suppressed]
    assert sups and all(f.justification for f in sups)


def test_port_findings_anchor_in_the_port():
    """A finding in the port is keyed ``bcfl_tpu_torch/...`` (the baseline
    key), and files outside it are keyed by their basename."""
    path = PORT / "dist" / "runtime.py"
    fs = run_lint([str(path)], checker_ids_filter=["determinism"])
    assert fs and {f.rel_file() for f in fs} == {
        "bcfl_tpu_torch/dist/runtime.py"}
    assert Source(str(path)).rel == "dist/runtime.py"


def test_cli_lint_subcommand_exits_zero():
    from bcfl_tpu_torch.entrypoints.__main__ import main

    assert main(["lint"]) == 0
    assert main(["lint", "--no-baseline"]) == 0


def test_guarded_by_registry_covers_the_port():
    from bcfl_tpu_torch.analysis.concurrency import _scan_class

    def classes(rel):
        src = Source(str(PORT / rel))
        return src, {n.name: n for n in ast.walk(src.tree)
                     if isinstance(n, ast.ClassDef)}

    src, cls = classes("dist/transport.py")
    info = _scan_class(src, cls["PeerTransport"])
    assert "_stats_lock" in info.locks
    for field in ("retries", "crc_drops", "_send_queues", "_next_msg_id",
                  "_dedup_seen", "_inflight", "chaos_injected"):
        assert field in info.guarded, field
    det = _scan_class(src, cls["FailureDetector"])
    assert "_state" in det.guarded and "_lock" in det.annotations["_set"]
    src, cls = classes("telemetry/events.py")
    wr = _scan_class(src, cls["EventWriter"])
    for field in ("_buf", "_seq", "_closed", "dropped"):
        assert field in wr.guarded, field
    src, cls = classes("dist/runtime.py")
    pr = _scan_class(src, cls["PeerRuntime"])
    for field in ("_buffer", "_buffer_since", "_report_terminal"):
        assert field in pr.guarded, field


def test_lock_order_graph_reaches_the_event_writer():
    from bcfl_tpu_torch.analysis.concurrency import LockOrderChecker

    c = LockOrderChecker()
    for rel in ("dist/transport.py", "dist/runtime.py",
                "telemetry/events.py"):
        list(c.check(Source(str(PORT / rel))))
    assert "EventWriter._lock" in {b for (_a, b) in c.edges}
    assert not list(c.finalize())


def test_seeded_scope_is_jax_scope_under_port_names():
    rename = {"ops/pallas_codec.py": "ops/codec_kernels.py"}
    want = {rename.get(k, k): v for k, v in janalysis.SEEDED_SCOPE.items()}
    assert SEEDED_SCOPE == want


@pytest.mark.parametrize("rel", sorted(SEEDED_SCOPE))
def test_seeded_scope_names_resolve(rel):
    """Each scoped file exists and each name is a class or function of it,
    so a rename cannot empty the scope silently; the file is clean."""
    path = PORT / rel
    assert path.is_file(), rel
    tree = ast.parse(path.read_text())
    defined = {n.name for n in ast.walk(tree)
               if isinstance(n, (ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))}
    missing = sorted(set(SEEDED_SCOPE[rel] or ()) - defined)
    assert not missing, f"{rel}: {missing}"
    assert not [f for f in run_lint([str(path)],
                                    checker_ids_filter=["determinism"],
                                    use_baseline=False) if f.failing]


def test_telemetry_schema_reads_the_port_catalogue():
    from bcfl_tpu.telemetry.events import EVENT_TYPES as J
    from bcfl_tpu_torch.analysis import telemetry_schema
    from bcfl_tpu_torch.telemetry.events import EVENT_TYPES as T

    assert telemetry_schema.EVENT_TYPES is T
    assert T == J


def test_socket_deadline_examines_every_grep_site():
    dist = PORT / "dist"
    patterns = (".accept(", ".recv(", "create_connection(", ".connect(")
    grep_sites, ast_sites = [], set()
    for f in sorted(dist.glob("*.py")):
        for i, line in enumerate(f.read_text().splitlines()):
            if any(p in line.split("#", 1)[0] for p in patterns):
                grep_sites.append((f.name, i + 1))
        for call, _op, _fn in iter_socket_sites(Source(str(f)).tree):
            for ln in range(call.lineno, (call.end_lineno or call.lineno) + 1):
                ast_sites.add((f.name, ln))
    assert grep_sites
    assert [s for s in grep_sites if s not in ast_sites] == []


def test_no_frame_concat_exempts_the_port_wire():
    assert not [f for f in run_lint([str(PORT / "dist" / "wire.py")],
                                    checker_ids_filter=["no-frame-concat"],
                                    use_baseline=False) if f.failing]


def test_analysis_imports_nothing_of_jax():
    code = ("import sys\n"
            "import bcfl_tpu_torch.analysis as a\n"
            "a.run_lint([a.PACKAGE_DIR])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'bcfl_tpu'))\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
