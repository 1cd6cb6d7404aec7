"""Invariant checks as queries over the merged event stream (port of
``bcfl_tpu/telemetry/invariants.py``, host-only, the same catalogue and
verdicts; OBSERVABILITY.md §4).

Each check is a pure function ``(ordered_events) -> [violation, ...]`` over
the causally-ordered timeline the collator produces; a violation is a small
dict naming the rule, the offending identity, and the evidence. The checks
replace the bespoke per-script gate logic that used to live in
``scripts/dist_chaos.py`` / ``scripts/dist_async.py`` — one shared,
*testable* implementation (tests/test_telemetry.py corrupts fixture streams
and asserts each rule fires) that every proof script and CI leg queries.

The catalogue (RUNTIME.md §4 "Delivery contract" names the evidence each
rule consumes):

- **no_double_merge** — at-least-once delivery is made safe by the
  receiver's dedup window; therefore no ``(leader, from, msg_epoch,
  msg_id)`` update identity may ever be merged twice (and every merged
  arrival must carry an identity at all).
- **acked_not_lost** — an acked frame was enqueued (or deliberately
  discarded by gate/dedup policy) on the receiver; either way the receiver
  emitted a ``recv`` event for it. A send recorded ``ok`` whose identity
  never appears in the receiver's stream is a lost acked frame. Only
  enforced against receivers whose stream closed cleanly (``run.end``):
  a SIGKILLed receiver's unflushed buffer tail proves nothing.
- **no_cross_partition_merge** — the partition gate drops frames whose
  origin is outside the receiver's component; a merge that composed an
  update from a peer outside the merger's recorded component crossed a
  partition that was supposed to exist. Scopes over BOTH dispatches: the
  leader's component under leadered dispatch, and — since every gossip
  peer is its own merge authority — each gossiping peer's own gate
  component (``gossip.merge`` records the gate's view, and the merge
  seam re-checks buffered arrivals against it during an active span).
- **quarantine_evidence** — the reputation lifecycle quarantines only on
  observed evidence; a ``rep.transition`` to ``quarantined`` with no prior
  ``rep.evidence`` for that client in the same stream is a state machine
  acting on nothing. ``from: "restored"`` re-declarations are exempt:
  they replay state whose evidence lives at the original decision site
  (a resumed leader's earlier incarnation, or — for a follower that
  absorbed the leader's committed verdicts from broadcast chain rows —
  a different process entirely).
- **monotone_heads** — a peer's ledger chain only ever grows, except at a
  declared rewrite (fork-merge adoption / full resync), which the emitting
  site flags ``rewrite: true``. A length decrease on a non-rewrite event
  is silent history loss.
- **no_quarantined_merge** — a QUARANTINED peer's arrivals are refused
  post-ack (RUNTIME.md §5); a merge whose lineage includes an arrival from
  a peer that was quarantined AT THAT LEADER at merge time is the
  byzantine-tolerance contract broken. Scoped by the leader's process
  incarnation (peer, pid) and judged only against PEER-scoped
  ``rep.transition`` events (the local engine's client-scoped lifecycle
  shares the event types but talks about a different population).
- **repair_authenticated** — a bootstrapping peer adopts foreign state
  ONLY through the verified STATE_SYNC gates (RUNTIME.md "State-sync
  protocol"): every ``state.sync.adopt`` must be preceded, in the same
  peer incarnation, by a ``state.sync.verify`` with ``ok: true`` that no
  earlier adopt already consumed. An unverified adoption is a peer
  accepting arbitrary state on faith.
- **partition_heals_leaderless** — the leaderless partition contract
  (RUNTIME.md §9): a gossip peer that recorded a ``fork.begin`` with
  ``leaderless: true`` and closed its stream cleanly (``run.end``) must
  (a) have recorded a matching ``fork.heal``, and (b) after the heal,
  show cross-component contact — a send at, an accepted recv from, a
  merged arrival from, or a membership join of a peer OUTSIDE the
  recorded fork component (the heal-time anti-entropy probes guarantee
  at least the send on a correct implementation, even when the other
  side is dead). A SIGKILLed stream (no ``run.end``) proves nothing and
  is exempt; so is the leadered protocol's ``fork.begin`` (no flag),
  whose heal runs through the peer-0 reconcile instead. Skipped when the
  span's component already covers every static peer (``run.start``'s
  ``peers``) — there is no outside to contact.
- **no_rollback_readmission** — a restarted peer whose durable state was
  rolled back (checkpoint chain shorter than an earlier incarnation's)
  must resync FORWARD before persisting: a ``ckpt.save`` whose
  ``chain_len`` sits below the maximum any EARLIER incarnation of the
  same peer committed is a violation unless this incarnation already
  repaired (``state.sync.adopt``) or declared a resync (``ledger``
  ``op: "resync"``) first. Same-pid shrinkage is monotone_heads'
  jurisdiction; this rule closes the across-restart hole.
"""

from __future__ import annotations

from typing import Dict, List

# grace window for acked_not_lost: a frame acked in the instants between a
# receiver's terminal flush and its process exit may have its recv event
# only in the (lost) buffer tail — sends that close to the receiver's
# run.end are not judged
ACK_GRACE_S = 1.0

# the event names that record a model-composition step. The merge-scoped
# rules key their per-merger state on the event's OWN (peer, pid) — under
# leadered dispatch that is the component leader; under gossip dispatch
# (RUNTIME.md "Gossip dispatch") EVERY peer merges and fills the "leader"
# slot with itself, and the same rules hold per merging peer with no code
# fork: dedup identities, component membership, and quarantine verdicts
# are all per-merger facts, not global ones.
MERGE_EVS = ("merge", "gossip.merge")


def _peer_of(e: Dict):
    return e.get("peer")


def no_double_merge(events: List[Dict]) -> List[Dict]:
    # scoped by the LEADER's process incarnation (pid): append-mode
    # streams can hold several runs, each restarting its epoch files and
    # msg_id counters from scratch — identical identities across
    # incarnations are different messages, not dedup failures. Within one
    # leader process the dedup window is exactly what this rule checks.
    seen = {}
    out = []
    for e in events:
        if e.get("ev") not in MERGE_EVS:
            continue
        leader = (_peer_of(e), e.get("pid"))
        for a in e.get("arrivals") or []:
            if a.get("msg_id") is None:
                out.append({
                    "rule": "no_double_merge",
                    "problem": "merged arrival without (msg_epoch, msg_id) "
                               "identity",
                    "leader": leader[0], "leader_pid": leader[1],
                    "version": e.get("version"),
                    "arrival": a,
                })
                continue
            key = (leader, a.get("peer"), a.get("msg_epoch"),
                   a.get("msg_id"))
            if key in seen:
                out.append({
                    "rule": "no_double_merge",
                    "problem": "update identity merged twice",
                    "leader": leader[0], "leader_pid": leader[1],
                    "key": list(key[1:]),
                    "first_version": seen[key],
                    "second_version": e.get("version"),
                })
            else:
                seen[key] = e.get("version")
    return out


def acked_not_lost(events: List[Dict]) -> List[Dict]:
    # receivers' seen identities + clean-close instants. A receiver is
    # only judged when its stream shows exactly ONE process incarnation
    # (one pid) that closed cleanly (run.end): a killed-and-restarted
    # peer's stream carries a second incarnation's run.end, while the
    # first incarnation's final buffer tail — and the recv events in it —
    # was legitimately lost to the SIGKILL.
    recv_seen = {}   # peer -> set of (src, msg_epoch, msg_id)
    closed_at = {}   # peer -> run.end t_wall
    pids = {}        # peer -> set of pids seen in the stream
    for e in events:
        ev = e.get("ev")
        p = _peer_of(e)
        if e.get("pid") is not None:
            pids.setdefault(p, set()).add(e.get("pid"))
        if ev == "recv" and e.get("msg_id") is not None:
            recv_seen.setdefault(p, set()).add(
                (e.get("src"), e.get("msg_epoch"), e.get("msg_id")))
        elif ev == "run.end":
            closed_at[p] = e.get("t_wall", 0.0)
    out = []
    for e in events:
        if e.get("ev") != "send" or not e.get("ok"):
            continue
        if e.get("msg_id") is None:
            continue
        dst = e.get("to")
        end = closed_at.get(dst)
        # graced against the send's END instant (t_wall is the START;
        # wall_s the duration): a chaos-retried send can be acked many
        # seconds after it began, and it is the ACK that must clear the
        # receiver's final flush — not the first attempt
        sent_done = e.get("t_wall", 0.0) + (e.get("wall_s") or 0.0)
        if end is None or sent_done > end - ACK_GRACE_S:
            continue  # receiver crashed / send too close to its close
        if len(pids.get(dst, ())) > 1:
            continue  # receiver restarted mid-run: kill-window not provable
        key = (_peer_of(e), e.get("msg_epoch"), e.get("msg_id"))
        if key not in recv_seen.get(dst, ()):
            out.append({
                "rule": "acked_not_lost",
                "problem": "acked send never appeared in the receiver's "
                           "stream",
                "src": _peer_of(e), "dst": dst,
                "msg_epoch": e.get("msg_epoch"), "msg_id": e.get("msg_id"),
                "type": e.get("type"),
            })
    return out


def no_cross_partition_merge(events: List[Dict]) -> List[Dict]:
    out = []
    for e in events:
        if e.get("ev") not in MERGE_EVS:
            continue
        comp = e.get("component")
        if not comp:
            continue
        comp_set = set(comp)
        for a in e.get("arrivals") or []:
            if a.get("peer") is not None and a["peer"] not in comp_set:
                out.append({
                    "rule": "no_cross_partition_merge",
                    "problem": "merged an update from outside the leader's "
                               "component",
                    "leader": _peer_of(e), "version": e.get("version"),
                    "component": comp, "from_peer": a["peer"],
                })
    return out


def quarantine_evidence(events: List[Dict]) -> List[Dict]:
    evidenced = set()  # (stream peer, client) with prior evidence
    out = []
    for e in events:
        ev = e.get("ev")
        if ev == "rep.evidence":
            evidenced.add((_peer_of(e), e.get("client")))
        elif ev == "rep.transition" and e.get("to") == "quarantined":
            if e.get("from") == "restored":
                # a re-declaration of restored state, not a fresh
                # decision: a resumed process replays quarantines whose
                # evidence lives elsewhere — the leader's own stream, or
                # (for a follower that absorbed the leader's committed
                # verdicts from broadcast chain rows) another process
                # entirely. The decision site was evidenced; this event
                # only re-anchors it for pid-scoped checks.
                continue
            key = (_peer_of(e), e.get("client"))
            if key not in evidenced:
                out.append({
                    "rule": "quarantine_evidence",
                    "problem": "quarantined with no prior evidence event",
                    "peer": _peer_of(e), "client": e.get("client"),
                    "trust": e.get("trust"),
                })
    return out


def monotone_heads(events: List[Dict]) -> List[Dict]:
    # keyed by (peer, pid): streams are opened in append mode, so one
    # file can hold several process incarnations (a re-run into the same
    # telemetry_dir, a within-run restart) — each incarnation starts its
    # own chain-length baseline rather than inheriting its predecessor's
    # final length as a floor
    last: Dict = {}  # (stream peer, pid) -> last seen chain_len
    out = []
    for e in events:
        if "chain_len" not in e:
            continue
        n = e.get("chain_len")
        if n is None:
            continue
        p = (_peer_of(e), e.get("pid"))
        prev = last.get(p)
        if (prev is not None and n < prev and not e.get("rewrite")):
            out.append({
                "rule": "monotone_heads",
                "problem": "ledger chain shrank outside a declared rewrite",
                "peer": p[0], "pid": p[1], "event": e.get("ev"),
                "op": e.get("op"), "prev_len": prev, "new_len": n,
            })
        last[p] = n
    return out


def no_quarantined_merge(events: List[Dict]) -> List[Dict]:
    # per leader incarnation (stream peer, pid): the set of peers the
    # leader's own tracker currently holds QUARANTINED. Only peer-scoped
    # transitions count — the engine's client-scoped lifecycle emits the
    # same event types about clients, not peers. Stream order is the
    # leader's own seq order (causal_order preserves per-stream chains),
    # so "quarantined at merge time" is exactly "transition seen before
    # the merge in this stream".
    quarantined: Dict = {}  # (peer, pid) -> set of quarantined peer ids
    out = []
    for e in events:
        key = (_peer_of(e), e.get("pid"))
        ev = e.get("ev")
        if ev == "rep.transition" and e.get("scope") == "peer":
            q = quarantined.setdefault(key, set())
            if e.get("to") == "quarantined":
                q.add(e.get("client"))
            else:
                q.discard(e.get("client"))
        elif ev in MERGE_EVS:
            q = quarantined.get(key)
            if not q:
                continue
            for a in e.get("arrivals") or []:
                if a.get("peer") in q:
                    out.append({
                        "rule": "no_quarantined_merge",
                        "problem": "merged an arrival from a peer "
                                   "quarantined at this leader",
                        "leader": key[0], "leader_pid": key[1],
                        "version": e.get("version"),
                        "from_peer": a.get("peer"),
                        "arrival": a,
                    })
    return out


def repair_authenticated(events: List[Dict]) -> List[Dict]:
    # per peer incarnation (stream peer, pid): a state.sync.adopt must
    # consume a pending ok=True state.sync.verify from the SAME
    # incarnation. Stream order is the peer's own seq order, so "verified
    # before adopting" is exactly "verify seen earlier in this stream".
    pending: Dict = {}  # (peer, pid) -> unconsumed verified-ok count
    out = []
    for e in events:
        ev = e.get("ev")
        if ev not in ("state.sync.verify", "state.sync.adopt"):
            continue
        key = (_peer_of(e), e.get("pid"))
        if ev == "state.sync.verify":
            if e.get("ok"):
                pending[key] = pending.get(key, 0) + 1
        else:
            if pending.get(key, 0) > 0:
                pending[key] -= 1
            else:
                out.append({
                    "rule": "repair_authenticated",
                    "problem": "state adopted without a preceding "
                               "verified-ok STATE_SYNC in this "
                               "incarnation",
                    "peer": key[0], "pid": key[1],
                    "version": e.get("version"), "src": e.get("src"),
                })
    return out


def no_rollback_readmission(events: List[Dict]) -> List[Dict]:
    # per PEER across incarnations: the high-water committed chain length
    # is the max chain_len over EARLIER pids' ckpt.save events. A later
    # pid persisting below that mark readmits rolled-back history —
    # unless it already repaired forward (state.sync.adopt) or declared a
    # resync (ledger op="resync") in its own stream first, which is the
    # legitimate shorter-but-verified rejoin (a HELLO resync from a
    # component whose chain forked shorter, or a repair from a peer that
    # is itself slightly behind).
    hw: Dict = {}       # peer -> (max chain_len, pid that set it)
    exempt: set = set()  # (peer, pid) incarnations that repaired/resynced
    out = []
    for e in events:
        ev = e.get("ev")
        p = _peer_of(e)
        key = (p, e.get("pid"))
        if ev == "state.sync.adopt" or (ev == "ledger"
                                        and e.get("op") == "resync"):
            exempt.add(key)
            continue
        if ev != "ckpt.save":
            continue
        n = e.get("chain_len")
        if n is None:
            continue
        prev = hw.get(p)
        if (prev is not None and n < prev[0] and e.get("pid") != prev[1]
                and key not in exempt):
            out.append({
                "rule": "no_rollback_readmission",
                "problem": "restarted peer persisted a chain below an "
                           "earlier incarnation's committed high-water "
                           "without repairing forward",
                "peer": p, "pid": e.get("pid"),
                "prev_len": prev[0], "prev_pid": prev[1], "new_len": n,
            })
        if prev is None or n >= prev[0]:
            hw[p] = (n, e.get("pid"))
    return out


def slowness_is_not_malice(events: List[Dict]) -> List[Dict]:
    # the gray-failure contract (ROBUSTNESS.md §11): slowness evidence
    # (rep.dist_evidence source="slowness", the phi estimator's suspicion
    # lane) down-weights but NEVER quarantines. So every peer-scoped
    # quarantine decision must be preceded — in the deciding peer's own
    # stream — by at least one dist-evidence row from a NON-slowness
    # source about that target. from=="restored" re-declarations are
    # exempt for the same reason as quarantine_evidence: the decision
    # site lives in another incarnation's (or another peer's) stream.
    malice: set = set()  # (stream peer, target) with non-slowness evidence
    out = []
    for e in events:
        ev = e.get("ev")
        if ev == "rep.dist_evidence":
            if e.get("source") != "slowness":
                malice.add((_peer_of(e), e.get("target")))
        elif (ev == "rep.transition" and e.get("to") == "quarantined"
                and e.get("scope") == "peer"
                and e.get("from") != "restored"):
            key = (_peer_of(e), e.get("client"))
            if key not in malice:
                out.append({
                    "rule": "slowness_is_not_malice",
                    "problem": "peer quarantined with no prior "
                               "non-slowness dist evidence — an "
                               "honest-slow peer was treated as "
                               "malicious",
                    "peer": _peer_of(e), "target": e.get("client"),
                    "trust": e.get("trust"),
                })
    return out


def partition_heals_leaderless(events: List[Dict]) -> List[Dict]:
    # per peer incarnation (stream peer, pid), leaderless spans only.
    # Stream order is the peer's own seq order, so "after the heal" is
    # exactly "later in this stream". Output is sorted (peer, pid,
    # at_version, problem): the verdict must not depend on which stream
    # the collator (or the live monitor) happened to open first.
    streams: Dict = {}  # (peer, pid) -> state
    for e in events:
        key = (_peer_of(e), e.get("pid"))
        st = streams.setdefault(key, {"open": None, "awaiting": [],
                                      "closed": False, "spans": [],
                                      "peers": None})
        ev = e.get("ev")
        if ev == "run.start":
            if e.get("peers") is not None:
                st["peers"] = e.get("peers")
        elif ev == "fork.begin" and e.get("leaderless"):
            span = {"component": set(e.get("component") or ()),
                    "at_version": e.get("at_version"),
                    "healed": False, "contact": False}
            st["spans"].append(span)
            st["open"] = span
        elif ev == "fork.heal" and st["open"] is not None:
            st["open"]["healed"] = True
            st["awaiting"].append(st["open"])
            st["open"] = None
        elif ev == "run.end":
            st["closed"] = True
        elif st["awaiting"]:
            # any post-heal contact with a peer outside the span's
            # component discharges the anti-entropy obligation
            touched = []
            if ev == "send":
                touched = [e.get("to")]
            elif ev == "recv" and e.get("disposition") == "accepted":
                touched = [e.get("src")]
            elif ev == "membership.join":
                touched = [e.get("member")]
            elif ev in MERGE_EVS:
                touched = [a.get("peer") for a in e.get("arrivals") or []]
            if touched:
                still = []
                for span in st["awaiting"]:
                    if any(p is not None and p not in span["component"]
                           for p in touched):
                        span["contact"] = True
                    else:
                        still.append(span)
                st["awaiting"] = still
    out = []
    for (peer, pid), st in streams.items():
        if not st["closed"]:
            continue  # SIGKILLed / unterminated stream: proves nothing
        for span in st["spans"]:
            n = st["peers"]
            no_outside = n is not None and len(span["component"]) >= n
            if not span["healed"]:
                out.append({
                    "rule": "partition_heals_leaderless",
                    "problem": "leaderless partition span never healed "
                               "before the peer's clean close",
                    "peer": peer, "pid": pid,
                    "at_version": span["at_version"],
                    "component": sorted(span["component"]),
                })
            elif not span["contact"] and not no_outside:
                out.append({
                    "rule": "partition_heals_leaderless",
                    "problem": "no cross-component contact after the "
                               "leaderless heal — anti-entropy never "
                               "attempted",
                    "peer": peer, "pid": pid,
                    "at_version": span["at_version"],
                    "component": sorted(span["component"]),
                })
    out.sort(key=lambda v: (str(v["peer"]), str(v["pid"]),
                            v["at_version"] if v["at_version"] is not None
                            else -1, v["problem"]))
    return out


# name -> (check fn, one-line description); the collator and the trace CLI
# walk this registry — adding a rule here adds it to every consumer
INVARIANTS = {
    "no_double_merge": (
        no_double_merge,
        "no (leader, from, msg_epoch, msg_id) update merged twice"),
    "acked_not_lost": (
        acked_not_lost,
        "every acked send appears in the (cleanly-closed) receiver's "
        "stream"),
    "no_cross_partition_merge": (
        no_cross_partition_merge,
        "no merge composes an update from outside the leader's component"),
    "quarantine_evidence": (
        quarantine_evidence,
        "quarantine transitions only follow observed evidence"),
    "monotone_heads": (
        monotone_heads,
        "per-peer ledger length is monotone outside declared rewrites"),
    "no_quarantined_merge": (
        no_quarantined_merge,
        "no merge lineage includes an arrival from a peer quarantined at "
        "that leader (per incarnation)"),
    "repair_authenticated": (
        repair_authenticated,
        "every STATE_SYNC adoption is preceded by a verified-ok transfer "
        "in the same incarnation"),
    "no_rollback_readmission": (
        no_rollback_readmission,
        "no restarted peer persists below an earlier incarnation's "
        "committed chain high-water without repairing forward"),
    "slowness_is_not_malice": (
        slowness_is_not_malice,
        "no peer-scoped quarantine rests on slowness evidence alone — "
        "gray failure down-weights, it never excludes"),
    "partition_heals_leaderless": (
        partition_heals_leaderless,
        "every leaderless partition span on a cleanly-closed stream "
        "heals and is followed by cross-component anti-entropy contact"),
}


def run_invariants(events: List[Dict],
                   names=None) -> Dict[str, List[Dict]]:
    """Run the named invariant checks (default: all) over a causally
    ordered event list; returns {name: [violations]} for every check run
    (empty lists included, so 'checked and clean' is distinguishable from
    'not checked')."""
    picked = INVARIANTS if names is None else {
        n: INVARIANTS[n] for n in names}
    return {name: fn(events) for name, (fn, _doc) in picked.items()}
