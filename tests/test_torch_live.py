"""The port's live monitor (``bcfl_tpu_torch/telemetry/live.py``) against
the JAX package's (``bcfl_tpu/telemetry/live.py``), on the seeded fixtures
of ``tests/test_live.py`` (``_fixtures``, ``_soak_like_events``, the
damaged-bytes and torn-tail cases), imported from that file.

Held equal, exactly (host Python on JSON events: no tolerance):

- the tailers' events and finalize metas at chunk sizes 1, 3, 17 and
  1 << 20, against each other and against both packages' ``read_stream``;
- the streaming invariant verdicts of every fixture at those chunk sizes,
  against JAX's streaming suite and the port's batch
  ``run_invariants(causal_order(events))`` (the parity contract);
- the health records, the alert lifecycles and the ``health.jsonl``
  streams of the two ``LiveCollator``\\ s, with the streams' bytes
  appearing on disk at those chunk sizes and swept after every chunk;
- the ``monitor`` CLI through the port's ``__main__``: exit 0 on a clean
  run, 1 on a seeded violation while the stream is open, 2 with no
  streams, each equal to JAX's ``monitor_main``.
"""

import json
import os

import pytest

import test_live as jl
import test_telemetry as tt
from bcfl_tpu import telemetry as JT
from bcfl_tpu.telemetry import live as jlive
from bcfl_tpu_torch import telemetry as TT
from bcfl_tpu_torch.entrypoints.__main__ import main as cli_main
from bcfl_tpu_torch.telemetry import live as tlive
from bcfl_tpu_torch.telemetry.invariants import run_invariants

pytestmark = pytest.mark.telemetry

CHUNKS = [1, 3, 17, 1 << 20]

#: the fields the monitor's own writer stamps (its clock, pid and order)
_STAMPS = ("t_wall", "t_mono", "pid", "seq")


def _replay(mod, data, chunk):
    t = mod.StreamTailer("x")
    evs = []
    for i in range(0, len(data), chunk):
        evs.extend(t.feed_bytes(data[i:i + chunk]))
    tail_e, meta = t.finalize()
    if tail_e is not None:
        evs.append(tail_e)
    return evs, meta


DAMAGED = {
    "clean": b'{"ev":"round","peer":0,"seq":0,"round":0,"wall_s":1}\n',
    "torn": b'{"ev":"round","peer":0,"seq":0,"round":0,"wall_s":1}\n'
            b'{"ev":"round","pee',
    "corrupt_mid": b'{"ev":"round","peer":0,"seq":0}\nGARBAGE{{{\n'
                   b'{"ev":"round","peer":0,"seq":1}\n',
    "torn_terminated": b'{"ev":"round","peer":0,"seq":0}\nGARB{{\n',
    "parseable_tail": b'{"ev":"round","peer":0,"seq":0}\n'
                      b'{"ev":"round","peer":0,"seq":1}',
    "ws_tail": b'{"ev":"round","peer":0,"seq":0}\n   ',
    "empty": b"",
}


@pytest.mark.parametrize("chunk", CHUNKS)
def test_tailer_equals_jax_on_damaged_bytes(tmp_path, chunk):
    for name, data in DAMAGED.items():
        path = str(tmp_path / f"events_{name}.jsonl")
        with open(path, "wb") as f:
            f.write(data)
        got, got_meta = _replay(tlive, data, chunk)
        want, want_meta = _replay(jlive, data, chunk)
        assert got == want and got_meta == want_meta, (name, chunk)
        batch, batch_meta = TT.read_stream(path)
        assert (batch, batch_meta) == JT.read_stream(path), name
        assert got == batch, (name, chunk)
        for k in ("events", "torn_tail", "corrupt_lines"):
            assert got_meta[k] == batch_meta[k], (name, chunk, k)


def test_tailer_torn_tail_completes_later(tmp_path):
    path = str(tmp_path / "events_peer0.jsonl")
    line = json.dumps({"ev": "round", "peer": 0, "seq": 0, "round": 0,
                       "wall_s": 0.1}).encode() + b"\n"
    with open(path, "wb") as f:
        f.write(line[:10])
    t, j = tlive.StreamTailer(path), jlive.StreamTailer(path)
    assert t.poll() == j.poll() == []
    assert t.corrupt_so_far == j.corrupt_so_far == 0
    with open(path, "ab") as f:
        f.write(line[10:])
    evs = t.poll()
    assert evs == j.poll() and len(evs) == 1 and evs[0]["round"] == 0
    assert t.finalize() == j.finalize() == (
        None, {"path": path, "events": 1, "torn_tail": False,
               "corrupt_lines": 0})


def test_tailer_bounded_reads_drain_the_backlog(tmp_path):
    path = str(tmp_path / "events_peer0.jsonl")
    w = TT.EventWriter(path, peer=0, flush_every=1)
    for r in range(50):
        w.emit("round", round=r, wall_s=0.1)
    w.close()
    evs = tlive.StreamTailer(path).poll(chunk_bytes=7)
    assert [e["round"] for e in evs] == list(range(50))
    assert evs == jlive.StreamTailer(path).poll(chunk_bytes=7)


# ---------------------------------------------- streaming invariant parity


def _stream_verdict(mod, events, chunk):
    """``tests/test_live.py::_stream_verdict`` over ``mod``'s tailers and
    suite: a round-robin cross-stream interleave at ``chunk`` bytes."""
    streams = jl._streams_of(events)
    tailers = {p: mod.StreamTailer(p) for p in streams}
    suite = mod.StreamingInvariantSuite()
    offs = dict.fromkeys(streams, 0)
    progressed = True
    while progressed:
        progressed = False
        for p, data in streams.items():
            o = offs[p]
            if o >= len(data):
                continue
            progressed = True
            piece = data[o:o + chunk]
            offs[p] = o + len(piece)
            for e in tailers[p].feed_bytes(piece):
                suite.feed(e)
    for p in streams:
        tail_e, _meta = tailers[p].finalize()
        if tail_e is not None:
            suite.feed(tail_e)
    return suite.finalize()


def test_streaming_registry_equals_jax():
    assert list(tlive.STREAMING_CHECKS) == list(jlive.STREAMING_CHECKS)
    assert set(tlive.STREAMING_CHECKS) == set(TT.INVARIANTS)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_streaming_verdicts_equal_jax_and_batch(chunk):
    for name, events, firing in jl._fixtures():
        got = _stream_verdict(tlive, events, chunk)
        assert jl._norm(got) == jl._norm(
            _stream_verdict(jlive, events, chunk)), (name, chunk)
        assert jl._norm(got) == jl._norm(
            run_invariants(TT.causal_order(events))), (name, chunk)
        assert {k for k, v in got.items() if v} == firing, (name, chunk)


def test_streaming_violations_fire_before_finalize():
    for name, events, firing in jl._fixtures():
        if not firing:
            continue
        live = {}
        for mod in (tlive, jlive):
            suite = mod.StreamingInvariantSuite()
            for p, data in jl._streams_of(events).items():
                for e in mod.StreamTailer(p).feed_bytes(data):
                    suite.feed(e)
            live[mod] = {k for k, c in suite.checks.items() if c.out}
        assert firing <= live[tlive] == live[jlive], name


def test_streaming_acked_retracts_on_receiver_restart():
    events = tt._clean_run()
    del events[5]
    late = tt._ev("run.start", "B", 0, 30.0, role="peer")
    late["pid"] = 99999
    for mod in (tlive, jlive):
        suite = mod.StreamingInvariantSuite()
        for e in events:
            suite.feed(e)
        assert suite.checks["acked_not_lost"].out, mod
        suite.feed(late)
        assert suite.checks["acked_not_lost"].out == []
        assert suite.finalize()["acked_not_lost"] == []


# ----------------------------------------------------- health and alerts


def _health_and_alerts(mod, events, thresholds):
    """Every health record and alert record of ``events`` fed in order
    through ``mod``'s rollup and alert manager, and the unhealed set."""
    h, alerts = mod.HealthRollup(), mod.AlertManager(thresholds)
    recs, fired = [], []
    for e in events:
        rec = h.feed(e)
        if rec is not None:
            recs.append(rec)
            fired.extend(mod.evaluate_health_alerts(alerts, rec))
    return recs, fired, alerts.unhealed()


def _lifecycle_events():
    """``_soak_like_events`` then ``test_alert_lifecycle_fire_heal_and_
    severity_gate``'s recovery, rss sample and critical merge."""
    m, a = tt._merge, tt._arrival
    return jl._soak_like_events() + [
        dict(m("B", 7, 15.0, version=3, arrivals=[a("A", 3)],
               component=["A", "B"]), trust={"A": 0.9, "B": 1.0}),
        tt._ev("resource", "B", 8, 15.5, rss_gb=3.0, cpu_percent=10.0),
        m("B", 9, 16.0, version=4, arrivals=[a("A", 4)],
          component=["A", "B"]),
    ]


def test_health_records_and_alert_lifecycle_equal_jax():
    events = _lifecycle_events()
    got = _health_and_alerts(tlive, events, tlive.AlertThresholds(
        trust_warn=0.35, rss_critical_gb=2.0))
    want = _health_and_alerts(jlive, events, jlive.AlertThresholds(
        trust_warn=0.35, rss_critical_gb=2.0))
    assert got == want
    recs, fired, unhealed = got
    assert [r["round"] for r in recs] == [1, 2, 3, 4]
    assert recs[0]["effective_rank"] == 1.8
    assert [(a["what"], a["severity"], bool(a.get("healed")))
            for a in fired] == [("trust_low", "warn", False),
                                ("trust_low", "warn", True),
                                ("rss_high", "critical", False)]
    assert [u["what"] for u in unhealed] == ["rss_high"]


def _write_chunked(run, events, chunk, collators):
    """Append each peer's stream bytes to ``run`` ``chunk`` bytes at a time
    (round-robin over the peers), sweeping every collator after each
    write; returns what each collator's sweeps reported, in order."""
    streams = jl._streams_of(events)
    paths = {p: os.path.join(str(run), f"events_peer{p}.jsonl")
             for p in streams}
    offs = dict.fromkeys(streams, 0)
    seen = [[] for _ in collators]
    progressed = True
    while progressed:
        progressed = False
        for p, data in streams.items():
            o = offs[p]
            if o >= len(data):
                continue
            progressed = True
            with open(paths[p], "ab") as f:
                f.write(data[o:o + chunk])
            offs[p] = o + chunk
            for i, lc in enumerate(collators):
                res = lc.sweep()
                seen[i].append((res["violations"], res["health"],
                                res["alerts"]))
    return seen


def _strip(records):
    return [{k: v for k, v in r.items() if k not in _STAMPS}
            for r in records]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_live_collators_equal_jax_while_streams_grow(tmp_path, chunk):
    """Both packages' collators watch the same run directory as its
    streams grow ``chunk`` bytes at a time: every sweep reports the same
    violations, health records and alerts, the two ``health.jsonl``
    streams hold the same records, and the finalize summaries are
    equal."""
    cases = [("soak", _lifecycle_events())]
    cases += [(n, ev) for n, ev, _ in jl._fixtures()
              if n in ("clean", "double_merge", "lost_acked",
                       "quarantined_merge")]
    for name, events in cases:
        run = tmp_path / f"{name}_run"
        run.mkdir()
        th = dict(trust_warn=0.35, rss_critical_gb=2.0)
        health = {}
        lcs = []
        for mod, tel in ((tlive, TT), (jlive, JT)):
            health[mod] = str(tmp_path / f"{name}_{mod.__name__}.jsonl")
            lcs.append(mod.LiveCollator(
                str(run), thresholds=mod.AlertThresholds(**th)))
        # each collator's records go to its own package's writer
        TT.install(TT.EventWriter(health[tlive], run="monitor",
                                  flush_every=1))
        JT.install(JT.EventWriter(health[jlive], run="monitor",
                                  flush_every=1))
        try:
            got, want = _write_chunked(run, events, chunk, lcs)
            assert got == want, (name, chunk)
            summaries = [lc.finalize() for lc in lcs]
        finally:
            TT.uninstall()
            JT.uninstall()
        assert summaries[0] == summaries[1], (name, chunk)
        streams = [TT.read_stream(health[m]) for m in (tlive, jlive)]
        assert _strip(streams[0][0]) == _strip(streams[1][0]), name
        assert streams[0][1]["corrupt_lines"] == 0
        batch = TT.collate(TT.find_streams(str(run)))
        assert summaries[0]["invariants"] == batch["invariants"], name
        assert summaries[0]["events"] == batch["timeline"]["events"], name


def test_live_collator_equals_batch_collate_on_every_fixture(tmp_path):
    for name, events, _firing in jl._fixtures():
        d = tmp_path / name
        d.mkdir()
        by_peer = {}
        for e in events:
            by_peer.setdefault(str(e["peer"]), []).append(e)
        paths = [jl._write_stream(d, p, evs) for p, evs in by_peer.items()]
        batch = TT.collate(paths)
        got = tlive.LiveCollator(str(d)).finalize()
        assert got == jlive.LiveCollator(str(d)).finalize(), name
        assert got["invariants"] == batch["invariants"], name
        assert got["events"] == batch["timeline"]["events"], name
        assert got["torn_tails"] == batch["torn_tails"], name


# -------------------------------------------------------------- monitor CLI


def _write_run(run, events):
    run.mkdir()
    by_peer = {}
    for e in events:
        by_peer.setdefault(str(e["peer"]), []).append(e)
    for p, evs in by_peer.items():
        jl._write_stream(run, p, evs)


def test_monitor_cli_clean_run_exits_zero(tmp_path):
    _write_run(tmp_path / "run", tt._clean_run())
    _write_run(tmp_path / "jrun", tt._clean_run())
    out = {}
    for main, run in ((cli_main, "run"), (jlive.monitor_main, "jrun")):
        path = str(tmp_path / f"{run}_summary.json")
        rc = main((["monitor"] if main is cli_main else [])
                  + [str(tmp_path / run), "--once", "--quiet",
                     "--summary-out", path])
        assert rc == 0
        with open(path) as f:
            out[run] = json.load(f)
        out[run].pop("wall_s")
        out[run].pop("run_dir")
        for m in out[run]["streams"]:
            m["path"] = os.path.basename(m["path"])
    assert out["run"] == out["jrun"]
    assert out["run"]["ok"] and out["run"]["health_records"] == 2
    health = str(tmp_path / "run" / "health.jsonl")
    assert os.path.exists(health)
    assert health not in TT.find_streams(str(tmp_path / "run"))
    assert (_strip(TT.read_stream(health)[0]) == _strip(TT.read_stream(
        str(tmp_path / "jrun" / "health.jsonl"))[0]))


def test_monitor_cli_flags_seeded_violation_while_stream_open(tmp_path):
    events = tt._clean_run()
    events[3]["arrivals"] = [tt._arrival("A", 0)]
    events = [e for e in events if e["ev"] != "run.end"]
    _write_run(tmp_path / "run", events)
    args = [str(tmp_path / "run"), "--once", "--quiet", "--health-out",
            "off"]
    assert cli_main(["monitor"] + args) == 1
    assert jlive.monitor_main(args) == 1


def test_monitor_cli_no_streams_exits_two(tmp_path):
    args = [str(tmp_path), "--once", "--quiet", "--health-out", "off"]
    assert cli_main(["monitor"] + args) == 2
    assert jlive.monitor_main(args) == 2


def test_monitor_stops_on_its_stop_file(tmp_path):
    """``--stop-file`` ends a watch over streams that never close (at the
    first sweep when the file is already there: exit 0), and
    ``--max-wall`` bounds it when the file never appears (exit 1: the
    fixture's last merge is decades old by the monitor's clock, so the
    wall-stall watchdog leaves an unhealed critical ``round_stall``); the
    exit codes equal JAX's."""
    events = [e for e in tt._clean_run() if e["ev"] != "run.end"]
    _write_run(tmp_path / "run", events)
    stop = tmp_path / "stop"
    stop.write_text("")
    args = [str(tmp_path / "run"), "--quiet", "--health-out", "off",
            "--poll", "0.01", "--idle", "0"]
    for extra, rc in ((["--stop-file", str(stop)], 0),
                      (["--stop-file", str(tmp_path / "never"),
                        "--max-wall", "0.05"], 1)):
        assert cli_main(["monitor"] + args + extra) == rc
        assert jlive.monitor_main(args + extra) == rc


def test_trace_subcommand_equals_the_collate_cli(tmp_path, capsys):
    events = tt._clean_run()
    events[3]["arrivals"] = [tt._arrival("A", 0)]
    _write_run(tmp_path / "run", events)
    assert cli_main(["trace", str(tmp_path / "run")]) == 1
    got = capsys.readouterr().out
    assert TT.trace_main([str(tmp_path / "run")]) == 1
    assert capsys.readouterr().out == got
    _write_run(tmp_path / "clean", tt._clean_run())
    assert cli_main(["trace", str(tmp_path / "clean")]) == 0
