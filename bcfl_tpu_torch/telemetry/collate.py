"""Collator (port of ``bcfl_tpu/telemetry/collate.py``, host-only, the
same ordering, rollups and verdicts): merge per-process event streams into
one causally-ordered timeline and answer queries over it
(OBSERVABILITY.md §3).

Reading is torn-tail tolerant by construction: a process killed mid-write
leaves at most one partial final line, which :func:`read_stream` counts and
skips — a crashed peer's stream is still evidence, not a parse error.

Causal ordering: wall clocks are only approximately shared (exactly shared
on loopback, skewed across real hosts), so the collator does NOT trust
``t_wall`` alone. It builds the happens-before graph —

- within one stream, the writer's ``seq`` is a total order (it is assigned
  under the writer lock, so it already linearizes that process's threads),
- across streams, a ``send`` with identity ``(src, msg_epoch, msg_id)``
  happens before every ``recv`` of that identity on the destination
  (senders stamp their ``send`` event with the send's START instant, so
  even the wall-time heuristic agrees on unskewed clocks),

— and emits a topological order using wall time only as the tie-break
priority (a heap-based Kahn traversal). Skewed clocks reorder concurrent
events at worst; they can never invert a causal edge.

On top of the merged timeline: message-latency and staleness
distributions, merge-lineage counts, per-phase/per-peer rollups, and the
declared invariant checks (:mod:`bcfl_tpu_torch.telemetry.invariants`).
``python -m bcfl_tpu_torch.telemetry.collate RUN_DIR`` is the CLI over
exactly this module.
"""

from __future__ import annotations

import glob
import heapq
import json
import os
from typing import Dict, List, Optional, Tuple

from bcfl_tpu_torch.telemetry.invariants import (
    INVARIANTS,
    MERGE_EVS,
    run_invariants,
)


# --------------------------------------------------------------------- read


def read_stream(path: str) -> Tuple[List[Dict], Dict]:
    """Parse one JSONL event stream. Returns ``(events, meta)`` where meta
    counts what was tolerated: ``torn_tail`` (the final line was partial —
    the expected signature of a killed process) and ``corrupt_lines``
    (non-final unparseable lines — disk damage, or a predecessor
    incarnation's torn tail that a restart's append-mode reopen
    newline-terminated mid-file). Never raises on stream content."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    last_idx = max((i for i, ln in enumerate(lines) if ln.strip()),
                   default=-1)
    events: List[Dict] = []
    torn = False
    corrupt = 0
    for i, ln in enumerate(lines):
        if not ln.strip():
            continue
        try:
            e = json.loads(ln)
            if not isinstance(e, dict):
                raise ValueError("event is not an object")
        except (ValueError, UnicodeDecodeError):
            if i == last_idx:
                torn = True
            else:
                corrupt += 1
            continue
        events.append(e)
    return events, {"path": path, "events": len(events),
                    "torn_tail": torn, "corrupt_lines": corrupt}


def find_streams(run_dir: str) -> List[str]:
    """Every event stream a run directory holds (peer streams + the local
    engine's), sorted for deterministic collation."""
    return sorted(glob.glob(os.path.join(run_dir, "events_*.jsonl")))


def resolve_stream_dir(telemetry_dir: Optional[str],
                       run_dir: str) -> Optional[str]:
    """THE one mapping from ``FedConfig.telemetry_dir`` to where a run's
    streams live: ``"off"`` -> None (disabled), a path -> that path,
    None -> ``run_dir``. Writers (PeerRuntime) and scanners (the dist
    harness) both go through this, so they can never drift apart."""
    if telemetry_dir == "off":
        return None
    return telemetry_dir or run_dir


# ------------------------------------------------------------- causal order


def causal_order(events: List[Dict]) -> List[Dict]:
    """Topologically order events under happens-before (per-stream ``seq``
    chains + dead-incarnation -> restart edges + send->recv identity
    edges), using ``t_wall`` as the heap priority — the causally-valid
    linearization closest to wall time.

    Cycles CAN arise from real writers: a ``send`` event is emitted only
    after the ack (so its seq is late), while the frame itself may have
    been delivered much earlier by a chaos dup — the receiver's merge
    broadcast can then land back on the sender's stream BEFORE the
    sender's retry loop finally records the send, closing
    send->recv->broadcast-send->recv->send. Per-stream seq chains are
    ground truth (assigned under the writer lock); cross-stream edges are
    correlation hints. When Kahn stalls, the unmet cross edges into the
    stuck nodes are dropped and traversal continues — seq-only chains are
    trivially acyclic, so this always completes with every per-stream
    order intact and every non-contradictory cross edge honored."""
    n = len(events)
    succ_seq: List[List[int]] = [[] for _ in range(n)]
    succ_cross: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n

    def _key(i: int):
        e = events[i]
        return (e.get("t_wall") or 0.0, str(e.get("peer")),
                e.get("seq") or 0)

    # per-stream chains (peer identifies the stream; engine streams use
    # peer=None and pid disambiguates restarts of the same peer id)
    by_stream: Dict = {}
    for i, e in enumerate(events):
        by_stream.setdefault((e.get("peer"), e.get("pid")), []).append(i)
    for idxs in by_stream.values():
        idxs.sort(key=lambda i: (events[i].get("seq") or 0))
        for a, b in zip(idxs, idxs[1:]):
            succ_seq[a].append(b)
            indeg[b] += 1
    # incarnation chains: a restarted peer id cannot emit until the prior
    # incarnation is dead, and both append to the same stream file, so
    # every event of the earlier pid happens-before every event of the
    # later one. Without this edge a restart can overtake its predecessor
    # in the linearization whenever the old incarnation's seq chain stalls
    # behind a late-recorded cross edge (sends are stamped at ack time),
    # inverting incarnation order for rollback/readmission judgements.
    # First file appearance orders incarnations; seq-class edge (ground
    # truth, never dropped) — per-peer chains stay trivially acyclic.
    by_peer: Dict = {}
    for (peer, pid), idxs in by_stream.items():
        by_peer.setdefault(peer, []).append((min(idxs), idxs))
    for incarnations in by_peer.values():
        incarnations.sort(key=lambda t: t[0])
        for (_, prev), (_, nxt) in zip(incarnations, incarnations[1:]):
            succ_seq[prev[-1]].append(nxt[0])
            indeg[nxt[0]] += 1
    # cross-stream send -> recv edges on the transport identity
    sends: Dict = {}
    for i, e in enumerate(events):
        if (e.get("ev") == "send" and e.get("ok")
                and e.get("msg_id") is not None):
            sends[(e.get("peer"), e.get("to"), e.get("msg_epoch"),
                   e.get("msg_id"))] = i
    cross_in: Dict[int, List[int]] = {}
    for i, e in enumerate(events):
        if e.get("ev") == "recv" and e.get("msg_id") is not None:
            j = sends.get((e.get("src"), e.get("peer"),
                           e.get("msg_epoch"), e.get("msg_id")))
            if j is not None:
                succ_cross[j].append(i)
                cross_in.setdefault(i, []).append(j)
                indeg[i] += 1

    heap = [(_key(i), i) for i in range(n) if indeg[i] == 0]
    heapq.heapify(heap)
    out: List[Dict] = []
    emitted = [False] * n

    def _emit(i: int) -> None:
        out.append(events[i])
        emitted[i] = True
        for j in succ_seq[i] + succ_cross[i]:
            if not emitted[j]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    heapq.heappush(heap, (_key(j), j))

    while True:
        while heap:
            _, i = heapq.heappop(heap)
            if not emitted[i]:
                _emit(i)
        if len(out) == n:
            break
        # stalled on a cycle: drop the unmet CROSS edges into the stuck
        # nodes (their senders are part of the cycle too), keep seq
        # edges. Removed from BOTH endpoints, so a later _emit of the
        # sender cannot double-decrement. One pass suffices: what
        # remains is seq-only, which is acyclic.
        for i in range(n):
            if emitted[i] or indeg[i] == 0:
                continue
            for j in cross_in.get(i, ()):
                if not emitted[j]:
                    indeg[i] -= 1
                    succ_cross[j].remove(i)
            cross_in[i] = []
            if indeg[i] == 0:
                heapq.heappush(heap, (_key(i), i))
    return out


# ---------------------------------------------------------------- summarize


def _dist_stats(xs: List[float]) -> Optional[Dict]:
    if not xs:
        return None
    import numpy as np

    a = np.asarray(xs, np.float64)
    return {
        "n": int(a.size),
        "mean": float(a.mean()),
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "max": float(a.max()),
    }


def summarize(ordered: List[Dict]) -> Dict:
    """Timeline rollup over a causally-ordered event list: end-to-end
    message latency (send START -> receive, via the matched identity),
    merge staleness histogram + lineage counts, per-peer/per-phase
    rollups, and the detector's SUSPECT->REACHABLE roundtrips."""
    send_start: Dict = {}
    latencies: List[float] = []
    staleness_hist: Dict[str, int] = {}
    merge = {"count": 0, "arrivals": 0, "unique_update_ids": 0,
             "rejected": 0, "solo": 0, "degraded": 0}
    merge_ids = set()
    weights: List[float] = []
    phases: Dict = {}
    per_peer: Dict = {}
    suspected: Dict = {}
    detector_roundtrips = 0

    def peer_slot(p):
        return per_peer.setdefault(str(p), {
            "events": 0, "rounds": 0, "send_ok": 0, "send_failed": 0,
            "recv": {}, "chaos_injected": 0})

    for e in ordered:
        p = e.get("peer")
        slot = peer_slot(p)
        slot["events"] += 1
        ev = e.get("ev")
        if ev == "send":
            if e.get("ok"):
                slot["send_ok"] += 1
                if e.get("msg_id") is not None:
                    send_start[(p, e.get("to"), e.get("msg_epoch"),
                                e.get("msg_id"))] = e.get("t_wall")
            else:
                slot["send_failed"] += 1
        elif ev == "recv":
            d = e.get("disposition")
            slot["recv"][d] = slot["recv"].get(d, 0) + 1
            # latency = send START -> the ACCEPTED delivery only: a chaos
            # dup / retransmit of an already-delivered frame also lands a
            # dedup recv for the same identity, which measures the
            # duplicate's arrival, not delivery
            if d == "accepted" and e.get("msg_id") is not None:
                t0 = send_start.get((e.get("src"), p, e.get("msg_epoch"),
                                     e.get("msg_id")))
                if t0 is not None and e.get("t_wall") is not None:
                    latencies.append(max(e["t_wall"] - t0, 0.0))
        elif ev == "chaos":
            slot["chaos_injected"] += 1
        elif ev == "round":
            slot["rounds"] += 1
        elif ev == "phase":
            phases.setdefault(str(p), {}).setdefault(
                e.get("name"), []).append(float(e.get("wall_s") or 0.0))
        elif ev in MERGE_EVS:
            # leadered merges and gossip (per-peer) merges roll up into
            # the same lineage counters; under gossip the unique-id
            # tally is scoped by the MERGING peer (first key), so two
            # peers each merging the same broadcast epoch's ids is not
            # double-counted as a dedup anomaly
            merge["count"] += 1
            merge["rejected"] += len(e.get("rejected") or [])
            if e.get("solo"):
                merge["solo"] += 1
            if e.get("degraded"):
                merge["degraded"] += 1
            for a in e.get("arrivals") or []:
                merge["arrivals"] += 1
                if a.get("msg_id") is not None:
                    merge_ids.add((p, a.get("peer"), a.get("msg_epoch"),
                                   a.get("msg_id")))
                s = a.get("staleness")
                if s is not None:
                    staleness_hist[str(s)] = staleness_hist.get(str(s),
                                                                0) + 1
                if a.get("weight") is not None:
                    weights.append(float(a["weight"]))
        elif ev == "detector":
            t = e.get("target")
            if e.get("to") == "suspect":
                suspected.setdefault(p, set()).add(t)
            elif (e.get("to") == "reachable"
                  and t in suspected.get(p, ())):
                suspected[p].discard(t)
                detector_roundtrips += 1
    merge["unique_update_ids"] = len(merge_ids)
    phase_stats = {
        p: {name: _dist_stats(xs) for name, xs in d.items()}
        for p, d in phases.items()}
    return {
        "events": len(ordered),
        "message_latency_s": _dist_stats(latencies),
        "staleness": staleness_hist,
        "merges": merge,
        "merge_weight": _dist_stats(weights),
        "detector_suspect_roundtrips": detector_roundtrips,
        "per_peer": per_peer,
        "phases": phase_stats,
    }


# ------------------------------------------------------------------ collate


def collate(paths: List[str], invariant_names=None) -> Dict:
    """Merge the given streams into one causally-ordered timeline, compute
    the rollup, and run the invariant checks. The returned record carries
    the ordered timeline under ``"ordered"`` (callers serializing to JSON
    usually drop it — it is the full event list)."""
    all_events: List[Dict] = []
    streams = []
    for path in paths:
        events, meta = read_stream(path)
        streams.append(meta)
        all_events.extend(events)
    ordered = causal_order(all_events)
    timeline = summarize(ordered)
    violations = run_invariants(ordered, invariant_names)
    total = sum(len(v) for v in violations.values())
    # append-mode streams in a reused directory hold MULTIPLE runs: the
    # rollups then span all of them, and multi-incarnation receivers are
    # not judged by acked_not_lost — surfaced here so cross-run
    # pollution is visible (use a fresh telemetry_dir per run to avoid)
    runs = sorted({str(e.get("run")) for e in all_events
                   if e.get("run") is not None})
    return {
        "streams": streams,
        "runs": runs,
        "torn_tails": sum(1 for s in streams if s["torn_tail"]),
        "timeline": timeline,
        "invariants": {name: len(v) for name, v in violations.items()},
        "violations": {name: v[:20] for name, v in violations.items() if v},
        "invariant_violations_total": total,
        "ok": total == 0,
        "ordered": ordered,
    }


def collate_run(run_dir: str, invariant_names=None) -> Dict:
    """Collate every ``events_*.jsonl`` stream under ``run_dir``."""
    return collate(find_streams(run_dir), invariant_names)


# ---------------------------------------------------------------------- CLI


def trace_main(argv=None) -> int:
    """``python -m bcfl_tpu_torch.telemetry.collate`` — collate a run's event streams, print the
    timeline summary + invariant verdicts, exit 1 on any violation."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="bcfl_tpu_torch.telemetry.collate",
        description="Merge a run's per-process event streams into one "
                    "causally-ordered timeline and run the invariant "
                    "checks (OBSERVABILITY.md).")
    ap.add_argument("run_dir", nargs="?", default=None,
                    help="directory holding events_*.jsonl streams (a dist "
                         "run dir, or a FedConfig.telemetry_dir)")
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON here")
    ap.add_argument("--dump", default=None, metavar="PATH",
                    help="write the full causally-ordered timeline (JSONL) "
                         "here")
    ap.add_argument("--invariants", default=None,
                    help=f"comma subset of {sorted(INVARIANTS)} "
                         "(default: all)")
    ap.add_argument("--list-invariants", action="store_true",
                    help="print the invariant catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_invariants:
        for name, (_fn, doc) in INVARIANTS.items():
            print(f"{name}: {doc}")
        return 0
    if args.run_dir is None:
        ap.error("run_dir is required (unless --list-invariants)")
    names = None
    if args.invariants:
        names = [s.strip() for s in args.invariants.split(",") if s.strip()]
        bad = [s for s in names if s not in INVARIANTS]
        if bad:
            print(f"unknown invariants {bad}; known: {sorted(INVARIANTS)}")
            return 2
    paths = find_streams(args.run_dir)
    if not paths:
        print(f"no events_*.jsonl streams under {args.run_dir}")
        return 2
    record = collate(paths, names)
    ordered = record.pop("ordered")
    if args.dump:
        with open(args.dump, "w") as f:
            for e in ordered:
                f.write(json.dumps(e) + "\n")
        record["dump"] = args.dump
    out = json.dumps(record, indent=2)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    if not record["ok"]:
        print(f"trace: {record['invariant_violations_total']} invariant "
              "violation(s)")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(trace_main())
