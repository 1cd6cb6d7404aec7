"""Leaderless gossip dispatch (``DistConfig.dispatch="gossip"``): port of
``bcfl_tpu/dist/gossip.py``.

The leadered path (:mod:`bcfl_tpu_torch.dist.runtime`) funnels every
update through one process per component; a slow or killed leader stalls
its component until failover. Here no peer is special:

- **Exchange**: after each local round a peer pushes its whole state to
  ``gossip_fanout`` neighbors drawn by :func:`sample_neighbors` from a
  numpy generator keyed ``(seed, lane, round, peer)`` over the LIVE
  membership view (epidemic draw or ring successors), so the topology is
  replayable from the seed and the membership history; a neighbor whose
  phi suspicion crossed ``gossip_hedge_phi`` is redrawn
  (:func:`hedge_neighbors`).
- **Merge**: arrivals fold in through :func:`merge_states`, a
  commutative versioned rule: every state carries a per-source version
  vector, the merged vector is the elementwise max, each input weighs its
  example mass x ``staleness_decay ** lag`` x the local trust, and inputs
  reduce in canonical ``(peer, order)`` order, so the result is bitwise
  independent of arrival order. The merge runs on the peer's device, one
  multiply and one add per input (no fused multiply-add), so the card's
  bits are the host's.
- **Robustness**: under a robust aggregator the rule
  (:mod:`bcfl_tpu_torch.dist.robust`) runs peer-locally over the round's
  arrival set plus the peer's own state, on its device; outlier flags feed
  the local reputation tracker only. An arrival authenticates against its
  announced :func:`state_digest`; a mismatch is ledger-auth evidence.
- **Membership is elastic** (:mod:`bcfl_tpu_torch.dist.membership`): the
  live view shrinks on detector DOWN transitions and "leaving" messages
  and regrows on any received frame; a HELLO beacon answered by anyone
  with a state and chain sync makes a rejoin a steady-state event.
- **Ledger**: each peer extends its own chain (its clients' digests and
  its accepted arrivals' announced state digests); replicas reconcile
  pairwise through ``fork_point`` / ``verify_segment`` / ``merge_rows`` /
  ``adopt_merge`` whenever a sync lands.
- **Partitions heal with no arbiter**: during a span of the fault plan's
  partition lane the neighbor draws stay inside the gate component, the
  merge refuses frames buffered across the cut, and a component below the
  robust vote floor degrades to the commutative mean with a
  ``gossip.vote_floor`` event. On span exit the peer HELLO-probes everyone
  the cut hid, the answering syncs fold in through the ordinary merge, and
  the hidden peers enter :class:`RejoinGrace` (a partition is not malice);
  a seeded probe of one DORMANT peer per beacon (:func:`probe_targets`)
  keeps two detector-shrunk views from never meeting again.

Termination is leaderless too: each peer trains its ``num_rounds`` local
rounds (version = its own merge count), drains briefly so late exchanges
are still served, announces "leaving" and exits 0 on its own clock.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bcfl_tpu_torch import telemetry
from bcfl_tpu_torch.core.fence import fence
from bcfl_tpu_torch.dist.membership import MembershipView
from bcfl_tpu_torch.dist.runtime import (
    DurabilityError,
    MergeRecord,
    PeerRuntime,
    _to_device,
    _to_host,
    logger,
)

# rng lane tags: the neighbor, hello, hedge and probe draws are different
# streams of the same (seed, round, peer) coordinates (JAX's numbers)
GOSSIP_LANE = 71
HELLO_LANE = 72
HEDGE_LANE = 73
PROBE_LANE = 74

# the float dtypes the merge reduces (numpy's np.floating); any other
# leaf, bfloat16 included (ml_dtypes' bfloat16 is no np.floating), rides
# the first canonical item, as in JAX
_MERGED_FLOATS = (torch.float16, torch.float32, torch.float64)


def _walk_sorted(tree, prefix: str = ""):
    """``(path, leaf)`` of a (nested) tree in sorted-key order, paths
    joined with "/": a flat dict keyed ``a/b`` and a nested ``{a: {b:}}``
    visit the same path, so the port's flat trees hash as JAX's nested
    ones."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_sorted(tree[k], prefix + "/" + str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_sorted(v, prefix + "/" + str(i))
    else:
        yield prefix, tree


def _leaf_identity(leaf) -> Tuple[str, str, memoryview]:
    """numpy's spellings of a leaf's dtype and shape (``float32``,
    ``(768,)``, ``()``) and its C-order bytes: a torch leaf hashes as the
    numpy array JAX would hash. bfloat16 spells ``bfloat16``, as
    ml_dtypes' dtype prints."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        shape = str(tuple(int(d) for d in t.shape))
        if t.dtype == torch.bfloat16:
            return "bfloat16", shape, memoryview(
                t.view(torch.int16).numpy().reshape(-1)).cast("B")
        a = t.numpy()
    else:
        a = np.asarray(leaf)
        shape = str(a.shape)
    # (ascontiguousarray lifts a 0-d array to 1-d: the shape is read first)
    a = np.ascontiguousarray(a)
    return str(a.dtype), shape, memoryview(a.reshape(-1)).cast("B")


def state_digest(tree) -> bytes:
    """SHA-256 over a host state tree (paths, dtypes, shapes and bytes in
    sorted-key order): the one digest a gossip update announces. The
    receiver recomputes it over what arrived, so announcing one state and
    shipping another is ledger-auth evidence."""
    h = hashlib.sha256()
    for path, leaf in _walk_sorted(tree):
        dtype, shape, raw = _leaf_identity(leaf)
        h.update(path.encode())
        h.update(dtype.encode())
        h.update(shape.encode())
        h.update(raw)
    return h.digest()


def sample_neighbors(seed: int, round_idx: int, peer: int,
                     live: Tuple[int, ...], fanout: int,
                     topology: str = "epidemic",
                     lane: int = GOSSIP_LANE) -> Tuple[int, ...]:
    """The seeded neighbor draw of one ``(round, peer)`` over the LIVE
    view: the same seed and view give the same neighbors on every host.
    ``ring`` takes the next ``fanout`` successors around the sorted view;
    ``epidemic`` draws ``fanout`` distinct live peers (self excluded)
    without replacement."""
    view = tuple(sorted(int(p) for p in live))
    others = [p for p in view if p != int(peer)]
    if not others:
        return ()
    k = min(int(fanout), len(others))
    if topology == "ring":
        if int(peer) in view:
            i = view.index(int(peer))
            ring = [p for p in view[i + 1:] + view[:i] if p != int(peer)]
        else:
            ring = others
        return tuple(ring[:k])
    rng = np.random.default_rng(
        (int(seed), int(lane), int(round_idx), int(peer)))
    pick = rng.choice(len(others), size=k, replace=False)
    return tuple(others[i] for i in sorted(pick))


def probe_targets(seed: int, seq: int, peer: int,
                  dormant: Tuple[int, ...], k: int = 1) -> Tuple[int, ...]:
    """The seeded anti-entropy draw: up to ``k`` DORMANT peers (ids the
    live view does not hold) to HELLO at this beacon tick, keyed
    ``(seed, PROBE_LANE, seq, peer)``."""
    pool = sorted(int(p) for p in dormant if int(p) != int(peer))
    if not pool:
        return ()
    kk = min(int(k), len(pool))
    rng = np.random.default_rng((int(seed), PROBE_LANE, int(seq),
                                 int(peer)))
    pick = rng.choice(len(pool), size=kk, replace=False)
    return tuple(pool[i] for i in sorted(pick))


def hedge_neighbors(seed: int, round_idx: int, peer: int,
                    live: Tuple[int, ...], nbrs: Tuple[int, ...],
                    suspicion: Dict[int, float],
                    threshold: float) -> Tuple[Tuple[int, ...],
                                               Tuple[int, ...]]:
    """Suspicion-hedged redraw of one round's neighbors: a neighbor whose
    phi crossed ``threshold`` is dropped and a replacement drawn from its
    own seeded lane out of the non-suspicious rest of the live view; with
    no replacement left the fanout shrinks. Returns ``(new_nbrs,
    dropped)``; with nothing suspicious the sample passes untouched."""
    dropped = tuple(n for n in nbrs
                    if suspicion.get(int(n), 0.0) >= threshold)
    if not dropped:
        return tuple(nbrs), ()
    kept = [int(n) for n in nbrs if n not in dropped]
    pool = [p for p in sorted(int(x) for x in live)
            if p != int(peer) and p not in kept
            and suspicion.get(p, 0.0) < threshold]
    k = min(len(dropped), len(pool))
    if k > 0:
        rng = np.random.default_rng(
            (int(seed), HEDGE_LANE, int(round_idx), int(peer)))
        pick = rng.choice(len(pool), size=k, replace=False)
        kept.extend(pool[i] for i in sorted(pick))
    return tuple(kept), dropped


def _map_tree(fn, trees):
    """``fn(*leaves)`` over trees of one structure (nested dicts)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_tree(fn, [t[k] for t in trees]) for k in first}
    return fn(*trees)


def merge_states(items: List[Dict], decay: float):
    """The commutative, versioned gossip merge.

    Each item is ``{"peer", "order", "state" (tree of tensors), "vv"
    (int64 over the static id space), "mass", "trust"}``. The merged
    version vector is the elementwise max; each item weighs ``mass *
    decay ** lag * trust``, ``lag`` being how far its vv total trails the
    union's. States reduce as a normalized weighted sum in float32 in
    canonical ``(peer, order)`` order, ``acc = acc + leaf * w`` as two
    operations (so on the card as on the host, with no fused multiply-add),
    on the device the leaves are on. A leaf that is not float16/32/64
    rides the first canonical item, bfloat16 included (JAX's
    ``np.floating`` test).

    Returns ``(merged_state, union_vv, weights)`` with ``weights`` in the
    canonical order."""
    items = sorted(items, key=lambda it: (int(it["peer"]),
                                          tuple(it.get("order") or ())))
    vvs = [np.asarray(it["vv"], np.int64) for it in items]
    union = vvs[0].copy()
    for v in vvs[1:]:
        union = np.maximum(union, v)
    total = int(union.sum())
    weights = []
    for it, v in zip(items, vvs):
        lag = max(total - int(v.sum()), 0)
        weights.append(float(it["mass"]) * float(decay) ** lag
                       * float(it.get("trust", 1.0)))
    wsum = sum(weights)
    if wsum <= 0.0:
        # every input eliminated (trust/decay underflow): keep the first
        # canonical state; the caller records the merge as degraded
        return items[0]["state"], union, weights
    norm = [np.float32(w / wsum) for w in weights]

    def _reduce(*leaves):
        first = leaves[0]
        if first.dtype not in _MERGED_FLOATS:
            return first
        scalars = [torch.tensor(w, dtype=torch.float32) for w in norm]
        acc = torch.mul(first.to(torch.float32), scalars[0])
        for leaf, w in zip(leaves[1:], scalars[1:]):
            acc = torch.add(acc, torch.mul(
                leaf.to(device=acc.device, dtype=torch.float32), w))
        return acc.to(first.dtype)

    merged = _map_tree(_reduce, [it["state"] for it in items])
    return merged, union, weights


class RejoinGrace:
    """Trust-evidence amnesty for peers a partition (or the failure
    detector) hid: a rejoiner arrives stale and, after a long cut,
    divergent, which would draw exactly a byzantine peer's staleness and
    outlier evidence. Grace withholds those two lanes until its first
    arrival lands within the staleness limit; the detector-DOWN lane and
    the merge weighting are untouched. Thread-safe: rejoins land on the
    intake thread, clears on the merge."""

    def __init__(self):
        self._lock = threading.Lock()
        self._graced: set = set()  # guarded-by: _lock

    def note_rejoin(self, peer: int) -> None:
        with self._lock:
            self._graced.add(int(peer))

    def note_caught_up(self, peer: int) -> None:
        with self._lock:
            self._graced.discard(int(peer))

    def active(self, peer: int) -> bool:
        with self._lock:
            return int(peer) in self._graced

    def report(self) -> List[int]:
        with self._lock:
            return sorted(self._graced)


class GossipPeerRuntime(PeerRuntime):
    """One peer process of the leaderless dispatch. Inherits everything
    that is not leader-shaped (the transport with its chaos lanes and
    detector, the embedded engine, the watchdogs, checkpoint and restore,
    state sync, the reports) and replaces the FedBuff funnel with the
    epidemic exchange and the commutative merge."""

    #: keep serving hellos and exchanges this long after the last round
    DRAIN_S = 2.0

    def __init__(self, cfg, peer_id: int, ports: List[int], run_dir: str,
                 device=None, resume: bool = False, bootstrap: bool = False):
        # _restore (inside super().__init__ on resume) calls _restore_extra
        # before any subclass attribute exists: pre-seed the slot it writes
        self._gossip_restored_vv = None
        super().__init__(cfg, peer_id, ports, run_dir, device=device,
                         resume=resume, bootstrap=bootstrap)
        self.membership = MembershipView(self.peers, self.peer_id)
        # vv[p] = local rounds of peer p this state has incorporated
        self.vv = np.zeros(self.peers, np.int64)
        if self._gossip_restored_vv is not None:
            self.vv = np.asarray(self._gossip_restored_vv, np.int64).copy()
        self._mem_seen = 0      # detector transitions folded into membership
        self._hello_seq = 0     # the hello beacon's lane counter
        self._last_hello_beacon = 0.0
        self._self_mass = float(self.local_clients)  # last round's mass
        self._state_np = None   # host copy of the current state (pushes)
        self._exchanges = 0
        self._auth_rejects = 0
        self._chain_merges = 0
        self._peers_done: set = set()
        self._draining = False
        self._drain_started = 0.0
        self._grace = RejoinGrace()
        self._vote_floor_active = False  # rising-edge latch (vote_floor)

    # ------------------------------------------------------------- hooks

    def _checkpoint_extra(self) -> Dict:
        return dict(super()._checkpoint_extra(),
                    gossip_vv=np.asarray(self.vv, np.int64).copy())

    def _restore_extra(self, state: Dict) -> None:
        super()._restore_extra(state)
        vv = state.get("gossip_vv")
        if vv is not None:
            if torch.is_tensor(vv):
                vv = vv.numpy()
            self._gossip_restored_vv = np.asarray(vv, np.int64)

    def _sync_targets(self) -> List[int]:
        """A STATE_SYNC attempt asks one peer drawn from the LIVE view on
        the hello lane, keyed by the attempt counter: no leader to
        prefer."""
        mem = getattr(self, "membership", None)
        live = (self._reachable_live() if mem is not None
                else tuple(range(self.peers)))
        return list(sample_neighbors(self.cfg.seed, self._sync_target_i,
                                     self.peer_id, live, 1, "epidemic",
                                     lane=HELLO_LANE))

    def _sync_serve_extra(self, header_out: Dict) -> None:
        # the served state carries this peer's training frontier: ship the
        # vv so the adopter's staleness lag starts truthful
        header_out["vv"] = [int(x) for x in self.vv]

    def _adopt_extra(self, header: Dict, trees: Dict) -> None:
        self._state_np = trees["model"]
        vv = header.get("vv")
        if vv is not None and len(vv) == self.peers:
            self.vv = np.maximum(self.vv, np.asarray(vv, np.int64))

    def _report_extra(self) -> Dict:
        # the deadline timer can fire before the subclass attributes exist
        mem = getattr(self, "membership", None)
        vv = getattr(self, "vv", None)
        return {
            "dispatch": "gossip",
            "membership": mem.report() if mem is not None else None,
            "vv": [int(x) for x in vv] if vv is not None else None,
            "gossip": {
                "exchanges": getattr(self, "_exchanges", 0),
                "auth_rejects": getattr(self, "_auth_rejects", 0),
                "chain_merges": getattr(self, "_chain_merges", 0),
                "peers_done": sorted(getattr(self, "_peers_done", ())),
                "rejoin_graced": (self._grace.report()
                                  if getattr(self, "_grace", None)
                                  is not None else []),
                "fork": getattr(self, "fork", None),
            },
        }

    def _note_version(self):
        # gossip reads no version history (no update is a delta against a
        # base version), so no model copy is kept per version: only the
        # idle watchdog's clock moves
        self._last_version_change = time.time()

    # --------------------------------------------------- train + exchange

    def _host_state(self) -> Dict[str, torch.Tensor]:
        if self._state_np is None:
            with self.clock.phase("to_host"):
                self._state_np = _to_host(self.trainable)
        return self._state_np

    def _train_once(self):
        """One gossip local round: every local client fine-tunes from the
        peer's current state, the client deltas fold in locally (a
        staleness-0 FedBuff step where they were produced), the vv
        advances, and the state ships to the round's sampled neighbors."""
        from bcfl_tpu_torch.fed import client_step as cs

        cfg, eng = self.cfg, self.eng
        rnd = self.local_round
        t0 = time.time()
        batches, n_ex = eng._round_batches(rnd)
        base = cs.broadcast(self.trainable, self.local_clients)
        with self.clock.phase("train"):
            post, stats = cs.local_updates(eng.local_train, base, batches,
                                           eng._generators(rnd), eng._rmask)
            fence(post)
        # the engine's exchange seam gives the per-client fingerprints that
        # bind this round into the peer's own chain
        with self.clock.phase("encode"):
            ex = eng._exchange_updates(rnd, post, base, None, mode="async",
                                       commit=False)
        n = np.asarray(n_ex, np.float32)
        w = n if cfg.weighted_agg else np.ones_like(n)
        deltas = {p: post[p] - base[p] for p in post}
        del post, base
        zero = {p: torch.zeros_like(x) for p, x in self.trainable.items()}
        step = cs.collapse(deltas, torch.as_tensor(w, device=self.device),
                           zero, eng.agg)
        del deltas
        lr = float(cfg.async_server_lr)
        self.trainable = {p: x + lr * step[p].to(x.dtype)
                          for p, x in self.trainable.items()}
        del step
        self._self_mass = float(w.sum()) or 1.0
        self.vv[self.peer_id] += 1
        if self.chain is not None and ex.fp is not None:
            # own training attested on the peer's own chain: per-peer
            # chains diverge by construction and reconcile on sync
            for c in range(self.local_clients):
                self.chain.append_digest(
                    int(rnd), int(self.global_ids[c]),
                    eng._entry_digest(ex.wire_kind, ex.fp[c]),
                    eng._client_payload_bytes)
            telemetry.emit("ledger", op="commit", round=int(rnd),
                           n=self.local_clients, chain_len=len(self.chain),
                           rewrite=False, head8=self.chain.head.hex()[:16])
        del ex
        s = stats.double().sum(0).cpu().numpy()
        self.local_round += 1
        telemetry.emit("round", round=rnd, wall_s=time.time() - t0,
                       base_version=int(self.version),
                       train_loss=float(s[0] / max(s[2], 1.0)))

        # the straggler lane: a real pre-send sleep, as on the leadered path
        plan = cfg.faults
        delays = (plan.straggler_delays(rnd, self.peers)
                  if plan is not None else None)
        if delays is not None and delays[self.peer_id] > 0:
            time.sleep(float(delays[self.peer_id]))
        self._limp_stall(rnd)

        self._state_np = None
        state = self._host_state()
        live = self._reachable_live()
        nbrs = sample_neighbors(cfg.seed, rnd, self.peer_id, live,
                                cfg.dist.gossip_fanout,
                                cfg.dist.gossip_topology)
        # the suspicion hedge (phi detector only): a neighbor the
        # estimator already suspects is redrawn before any bytes move
        hedged = ()
        det = self.transport.detector
        hedge_phi = float(cfg.dist.gossip_hedge_phi)
        if nbrs and hedge_phi > 0 and hasattr(det, "phi"):
            suspicion = {int(p): float(det.phi(int(p)))
                         for p in live if int(p) != self.peer_id}
            nbrs, hedged = hedge_neighbors(
                cfg.seed, rnd, self.peer_id, live, nbrs, suspicion,
                hedge_phi)
        telemetry.emit("gossip.exchange", round=int(rnd),
                       neighbors=list(nbrs), live=list(live),
                       fanout=int(cfg.dist.gossip_fanout),
                       topology=cfg.dist.gossip_topology,
                       hedged=list(hedged),
                       vv=[int(x) for x in self.vv])
        with self.clock.phase("digest"):
            digest = state_digest(state).hex()
        header0 = {
            "type": "update", "round": int(rnd),
            "vv": [int(x) for x in self.vv],
            "n_ex": self._self_mass, "digest": digest,
            "sent_at": time.time(),
        }
        for nbr in nbrs:
            header, out_tree = dict(header0), state
            if self.byz is not None:
                # the leadered path's seam, above the wire, per
                # destination: poisoning re-announces over the mutated
                # state (auth passes, the rule catches it); forgery and
                # equivocation keep the honest digest (the re-hash fails)
                header, out_tree, act = self.byz.corrupt_update(
                    header, out_tree, dst=nbr)
                if act is not None and act.get("reannounce"):
                    header = dict(header,
                                  digest=state_digest(out_tree).hex())
            if cfg.dist.pipeline:
                self.transport.send_async(nbr, header,
                                          {"payload": out_tree})
            else:
                self.transport.send(nbr, header, {"payload": out_tree})
            self._exchanges += 1

    # ------------------------------------------------------------ merging

    def _prepare_gossip_arrival(self, header: Dict, trees: Dict,
                                recv_t: float) -> Dict:
        """Authenticate and weigh one buffered arrival: the leadered
        ``_prepare_update`` with the whole-state digest for the per-client
        fingerprints and the version-vector lag for the base version."""
        src = int(header.get("from", -1))
        rec = {"peer": src, "msg_id": header.get("msg_id"),
               "msg_epoch": header.get("msg_epoch"),
               "round": int(header.get("round", -1)),
               "latency_s": max(
                   recv_t - float(header.get("sent_at", recv_t)), 0.0)}
        vv = np.asarray(header.get("vv", ()), np.int64)
        if vv.shape != (self.peers,):
            rec["rejected"] = "malformed version vector"
            rec["staleness"] = 0
            return {"ok": False, "rec": rec}
        # the lag against this peer's frontier (the merge recomputes it
        # against the union; this is the observed staleness)
        lag = max(int(self.vv.sum()) - int(vv.sum()), 0)
        rec["staleness"] = lag
        if self.gate.components() is not None:
            # the merge-seam twin of the socket gate: a frame buffered
            # before the cut opened must not cross it at merge time
            comp = self.gate.component_of(self.peer_id) or ()
            if src not in comp:
                rec["rejected"] = "cross-partition (span active)"
                return {"ok": False, "rec": rec}
        if (self.rep is not None and src != self.peer_id
                and self.rep.is_quarantined(src)):
            # the post-ack quarantine gate at merge time
            with self._qdrop_lock:
                self.rep.quarantine_drops += 1
            rec["rejected"] = "peer quarantined (post-ack gate)"
            return {"ok": False, "rec": rec}
        state = trees["payload"]
        announced = header.get("digest")
        if announced is not None:
            actual = state_digest(state).hex()
            rec["auth"] = [1.0 if actual == announced else 0.0]
            if actual != announced:
                # announce one state, ship another: the gossip form of
                # the ledger-auth evidence lane
                self._auth_rejects += 1
                rec["rejected"] = "state digest mismatch"
                if self.rep is not None and src != self.peer_id:
                    self.rep.note_auth_failure(src, 1.0)
                return {"ok": False, "rec": rec}
            if self.chain is not None:
                # the accepted arrival's announced digest joins this
                # peer's own chain (client slot = the sender's first
                # global client id: one state row per arrival)
                self.chain.append_digest(
                    max(int(header.get("round", 0)), 0),
                    src * self.local_clients, bytes.fromhex(announced),
                    self.eng._client_payload_bytes)
                telemetry.emit("ledger", op="commit",
                               round=max(int(header.get("round", 0)), 0),
                               n=1, chain_len=len(self.chain),
                               rewrite=False,
                               head8=self.chain.head.hex()[:16])
        graced = src != self.peer_id and self._grace.active(src)
        if graced and (self.rep is None
                       or lag <= self.rep.cfg.staleness_limit):
            # caught up: the amnesty lifts and normal evidence resumes
            self._grace.note_caught_up(src)
            graced = False
        if graced:
            # partition is not malice: no staleness charge until the
            # rejoiner arrives caught up (the decay still weighs it down)
            rec["graced"] = True
        elif self.rep is not None and src != self.peer_id:
            self.rep.note_staleness(src, lag)
        trust = 1.0
        if self.rep is not None:
            trust = float(self.rep.gate(src))
            rec["trust"] = round(trust, 6)
        mass = float(header.get("n_ex", 1.0))
        weight = mass * (self.cfg.staleness_decay ** lag) * trust
        if weight <= 0.0:
            rec["rejected"] = "eliminated (trust/decay)"
            return {"ok": False, "rec": rec}
        rec["weight"] = float(weight)
        return {"ok": True, "rec": rec, "peer": src, "state": state,
                "vv": vv, "mass": mass, "trust": trust,
                "order": (int(header.get("msg_epoch") or 0),
                          int(header.get("msg_id") or 0))}

    def _adopt_merged(self, merged) -> None:
        """The merge's result becomes the peer's state on its device; the
        host copy is taken when a push or a hello reply needs it."""
        self.trainable = self._cast(merged)
        self._state_np = None

    def _gossip_merge(self):
        """One peer-local merge after every local round (solo when nothing
        arrived): fold the arrivals into this peer's state on its device
        with the commutative vv rule (or the robust rule over the arrival
        set and self), advance the version, clock the reputation tracker,
        checkpoint. The version is the peer's own merge count, so no other
        process can stall it."""
        cfg = self.cfg
        t0 = time.time()
        with self._buffer_lock:
            buf, self._buffer = self._buffer, []
        self._drain_membership_transitions()
        arrivals, rejected, items = [], [], []
        for header, trees, recv_t in buf:
            with self.clock.phase("merge.prepare"):
                out = self._prepare_gossip_arrival(header, trees, recv_t)
            (arrivals if out.get("ok") else rejected).append(out["rec"])
            if out.get("ok"):
                out["state"] = _to_device(out["state"], self.device)
                items.append(out)
        del buf
        robust_info = None
        robust_degraded = False
        if items:
            self_item = {"peer": self.peer_id, "order": (),
                         "state": self.trainable, "vv": self.vv.copy(),
                         "mass": self._self_mass, "trust": 1.0}
            with self.clock.phase("merge.apply"):
                if cfg.aggregator != "mean":
                    robust_info, robust_degraded = self._apply_robust_gossip(
                        items, self_item)
                else:
                    merged, union, _w = merge_states([self_item] + items,
                                                     cfg.staleness_decay)
                    self.vv = union
                    self._adopt_merged(merged)
                fence(self.trainable)
        del items
        self.version += 1
        if cfg.aggregator != "mean":
            self._note_vote_floor(len(arrivals) + 1)
        # the component this merge claims: the gate component during an
        # active span on this peer's clock (what no_cross_partition_merge
        # checks arrivals against), the whole id space otherwise
        comp = sorted(self.gate.component_of(self.peer_id) or ())
        rec = MergeRecord(
            version=self.version, leader=self.peer_id, arrivals=arrivals,
            rejected=rejected, wall_s=time.time() - t0,
            solo=not arrivals, degraded=False, quorum=None,
            robust=robust_info, robust_degraded=robust_degraded)
        self.merges.append(rec)
        trust_map = ({str(p): round(float(self.rep.tracker.trust[p]), 6)
                      for p in range(self.peers)}
                     if self.rep is not None else None)
        telemetry.emit(
            "gossip.merge", version=rec.version, leader=self.peer_id,
            arrivals=arrivals, rejected=rejected, solo=rec.solo,
            degraded=False, component=comp, wall_s=rec.wall_s,
            vv=[int(x) for x in self.vv], trust=trust_map,
            robust=robust_info, robust_degraded=robust_degraded,
            **({"chain_len": len(self.chain),
                "head8": self.chain.head.hex()[:16], "rewrite": False}
               if self.chain is not None else {}))
        self._observe_gray_health()
        if self.rep is not None:
            # the peer-local merge is the observation clock: drain the
            # detector evidence, fold the round's observations, commit the
            # transitions to the own chain (they spread with the syncs)
            self._drain_detector_evidence()
            arrived = ([a["peer"] for a in arrivals]
                       + [r["peer"] for r in rejected])
            transitions = self.rep.observe_merge(arrived)
            if transitions and self.chain is not None:
                self.rep.commit_transitions(self.chain, self.version,
                                            transitions)
                telemetry.emit("ledger", op="rep_transition",
                               n=len(transitions),
                               chain_len=len(self.chain), rewrite=False,
                               head8=self.chain.head.hex()[:16])
        self._note_version()
        self._maybe_checkpoint()

    def _note_vote_floor(self, votes: int) -> None:
        """Rising-edge record of the runtime vote floor: the config check
        (``gossip_fanout + 1 >= MIN_ORDER_VOTES``) only guarantees the
        topology can feed the rule; a partition or churn can still shrink
        the cohort below it, and the merge then degrades to the
        commutative mean. One event marks each episode's entry."""
        from bcfl_tpu_torch.dist.robust import MIN_ORDER_VOTES

        if votes < MIN_ORDER_VOTES:
            if not self._vote_floor_active:
                self._vote_floor_active = True
                telemetry.emit(
                    "gossip.vote_floor", votes=int(votes),
                    need=int(MIN_ORDER_VOTES), version=int(self.version),
                    component=sorted(self.gate.component_of(self.peer_id)
                                     or ()),
                    rule=self.cfg.aggregator)
        else:
            self._vote_floor_active = False

    def _apply_robust_gossip(self, items: List[Dict], self_item: Dict):
        """Peer-local robust rule: one vote per source (its whole state),
        the configured order statistic over the arrival set and self, on
        this peer's device. Below MIN_ORDER_VOTES the rule excludes
        nothing: fall back to the commutative merge, recorded
        ``robust_degraded``."""
        from bcfl_tpu_torch.dist.robust import MIN_ORDER_VOTES, robust_merge

        cfg = self.cfg
        votes_in = sorted([self_item] + items,
                          key=lambda it: (int(it["peer"]),
                                          tuple(it.get("order") or ())))
        if len(votes_in) < MIN_ORDER_VOTES:
            merged, union, _w = merge_states(votes_in, cfg.staleness_decay)
            self.vv = union
            self._adopt_merged(merged)
            return {"k": len(votes_in), "rule": cfg.aggregator,
                    "fallback": "mean"}, True
        votes = [it["state"] for it in votes_in]
        vote_w = [float(it["mass"]) * float(it.get("trust", 1.0))
                  for it in votes_in]
        t0 = time.perf_counter()
        agg, flags, info = robust_merge(votes, vote_w, cfg.aggregator,
                                        cfg.aggregator_trim)
        fence(agg)
        info["rule_s"] = time.perf_counter() - t0
        info["rule_device"] = self.device.type
        info["votes_by_peer"] = {str(int(it["peer"])): 1
                                 for it in votes_in}
        dists = info.get("distances")
        for j, it in enumerate(votes_in):
            if not flags[j]:
                continue
            p = int(it["peer"])
            if p == self.peer_id:
                continue  # never against self (non-iid honest outliers)
            for a in items:
                if a is it:
                    a["rec"]["outlier"] = True
            if self.rep is not None and not self._grace.active(p):
                # a rejoiner's first post-heal state is the cohort outlier
                # by construction: keep the flag, charge no evidence while
                # graced (one flag would re-quarantine a probationer)
                self.rep.note_outlier(
                    p, distance=(dists[j] if dists else None))
        union = self.vv.copy()
        for it in votes_in:
            union = np.maximum(union, np.asarray(it["vv"], np.int64))
        self.vv = union
        if agg is not None:
            # states are points, not deltas: the coordinate-wise robust
            # aggregate of the points is the new state
            self._adopt_merged(agg)
        return info, False

    # --------------------------------------------------- partition lifecycle

    def _reachable_live(self) -> Tuple[int, ...]:
        """The live view restricted to this peer's component while a span
        is active on its own round clock (untouched outside a span)."""
        live = self.membership.live()
        if self.gate.components() is None:
            return live
        comp = self.gate.component_of(self.peer_id) or ()
        return tuple(p for p in live if p in comp)

    def _probe(self, target: int, wait: bool = False) -> None:
        """One anti-entropy HELLO at a peer the live view does not reach
        (a DOWN target costs one budgeted probe per interval). ``wait``
        sends it before returning, past the frames queued for ``target``
        (the heal's probes)."""
        header = {"type": "hello", "version": int(self.version),
                  "probe": True}
        if self.cfg.dist.pipeline and not wait:
            self.transport.send_async(target, header)
        else:
            self.transport.send(target, header)

    def _update_partition_state(self):
        """The leadered span observation on this peer's own round clock,
        with a leaderless heal: ``fork.begin`` / ``fork.heal`` carry
        ``leaderless=True``; at the heal nothing is offered to peer 0, the
        peer HELLO-probes every peer the cut hid and puts them in rejoin
        grace, and the answering syncs fold in through the ordinary
        merge and the pairwise chain reconcile of ``_handle_sync``.

        Every peer the cut hid is probed, one that has announced leaving
        too: the gate drops a "leaving" sent during the span, so one read
        now arrived after the gate opened, from a peer that left while
        hidden and was never reconciled with. Its probe is refused, and
        the refusal is the heal's attempt on the stream
        (``partition_heals_leaderless``); skipping departed peers, as
        JAX's runtime does, leaves a peer whose other side all finished
        during its span with no attempt at all. The probes are sent
        before the loop goes on: queued behind model-sized pushes, one
        could still be waiting when the peer departs."""
        comps = self.gate.components()
        if comps is not None and not self._partitioned:
            self._partitioned = True
            self._fork_comps = comps
            comp = list(self.gate.component_of(self.peer_id) or ())
            self.fork = {
                "at_version": int(self.version),
                "fork_base": (int(len(self.chain))
                              if self.chain is not None else None),
                "head_at_fork": self._head(),
                "component": comp,
            }
            telemetry.emit("fork.begin", at_version=int(self.version),
                           component=comp, leaderless=True,
                           head8=(self._head() or "")[:16],
                           fork_base=self.fork["fork_base"])
            logger.info("peer %d: partition began at version %d "
                        "(component %s, leaderless)", self.peer_id,
                        self.version, comp)
        elif comps is None and self._partitioned:
            self._partitioned = False
            self.fork["head_before_heal"] = self._head()
            old_comp = set(self.fork.get("component") or ())
            telemetry.emit("fork.heal", at_version=int(self.version),
                           leaderless=True,
                           head8=(self._head() or "")[:16])
            hidden = [p for p in range(self.peers)
                      if p != self.peer_id and p not in old_comp]
            for p in hidden:
                self._grace.note_rejoin(p)
                self._probe(p, wait=True)
            logger.info("peer %d: partition healed at version %d, probing "
                        "%s", self.peer_id, self.version, hidden)

    # -------------------------------------------------- membership + resync

    def _drain_membership_transitions(self):
        """Fold the detector's NEW DOWN transitions into the live view
        (its own cursor, beside the reputation tracker's)."""
        from bcfl_tpu_torch.dist.transport import DOWN

        det = self.transport.detector
        new = det.transitions_total - self._mem_seen
        if new <= 0:
            return
        self._mem_seen = det.transitions_total
        recent = list(det.transitions)[-min(new, len(det.transitions)):]
        for t in recent:
            if t.get("to") == DOWN:
                self.membership.note_leave(t["peer"], "detector_down")

    def _maybe_hello(self):
        """The HELLO beacon: every ``gossip_hello_interval_s`` ping one
        seeded live neighbor, which answers with a full state and chain
        sync; outside a span, also probe one seeded DORMANT peer."""
        now = time.time()
        if now - self._last_hello_beacon < self.cfg.dist.gossip_hello_interval_s:
            return
        self._last_hello_beacon = now
        self._hello_seq += 1
        nbrs = sample_neighbors(self.cfg.seed, self._hello_seq,
                                self.peer_id, self._reachable_live(), 1,
                                "epidemic", lane=HELLO_LANE)
        if nbrs:
            self.transport.send(nbrs[0], {"type": "hello",
                                          "version": int(self.version)})
        if self.gate.components() is None:
            # departed peers are dormant but done: never probed
            dormant = tuple(p for p in self.membership.dormant()
                            if p not in self._peers_done)
            for t in probe_targets(self.cfg.seed, self._hello_seq,
                                   self.peer_id, dormant):
                self._probe(t)

    def _handle_gossip_hello(self, header: Dict):
        """Any peer answers a hello (no leader gate) with its whole state,
        vv and chain: the sync a joiner folds in."""
        if self._needs_bootstrap:
            return  # nothing trustworthy to serve while damaged
        src = int(header["from"])
        state = self._host_state()
        reply = {
            "type": "sync", "round": int(self.local_round),
            "vv": [int(x) for x in self.vv], "n_ex": self._self_mass,
            "digest": state_digest(state).hex(),
            "sent_at": time.time(),
            "chain": (self.chain.segment(0)
                      if self.chain is not None else None),
        }
        self.transport.send(src, reply, {"payload": state})

    def _handle_sync(self, header: Dict, trees: Dict):
        """Fold a hello reply in: reconcile the chain replicas through the
        fork/merge API (pairwise, no consensus head), absorb the committed
        reputation rows, then queue the carried state as an ordinary
        arrival of the next merge."""
        from bcfl_tpu_torch.ledger import Ledger

        if self._needs_bootstrap:
            # a damaged peer adopts state only through the verified
            # STATE_SYNC gates: a hello sync carries no commitment row
            return
        src = int(header.get("from", -1))
        rows = header.get("chain")
        if rows and self.chain is not None:
            their_heads = [bytes.fromhex(r["head"]) for r in rows]
            fork = self.chain.fork_point(their_heads)
            bad = Ledger.verify_segment(self.chain.head_at(fork),
                                        rows[fork:],
                                        self.cfg.ledger.use_native)
            if bad == -1:
                merged = Ledger.merge_rows(self.chain.segment(fork),
                                           rows[fork:])
                self.chain.adopt_merge(fork, merged)
                self.eng.ledger = self.chain
                self._chain_merges += 1
                telemetry.emit("ledger", op="adopt_merge",
                               chain_len=len(self.chain), rewrite=True,
                               head8=self.chain.head.hex()[:16],
                               fork_point=fork)
                if self.rep is not None:
                    self.rep.absorb_rows(rows)
            else:
                telemetry.emit("warn", what="gossip_sync_segment_rejected",
                               peer_from=src, link=int(bad))
                logger.warning("peer %d: rejected tampered sync segment "
                               "from %d (link %d)", self.peer_id, src, bad)
        # the sync's state joins the next merge like any arrival (the
        # transport stamped from/msg_id/msg_epoch)
        self._buffer_push((dict(header, type="update"), trees,
                           time.time()))

    # ---------------------------------------------------------- main loop

    def _intake_update(self, header: Dict, trees: Dict):
        """Every peer buffers (no leader check); any frame re-attests its
        sender into the live view, with rejoin grace for a returner."""
        src = int(header.get("from", -1))
        if self.membership.note_alive(src):
            self._grace.note_rejoin(src)
        if (self.rep is not None and src != self.peer_id
                and self.rep.is_quarantined(src)):
            with self._qdrop_lock:
                self.rep.quarantine_drops += 1
            return
        self._buffer_push((header, trees, time.time()))

    def _handle(self, header: Dict, trees: Dict):
        kind = header.get("type")
        src = int(header.get("from", -1))
        if src >= 0 and kind not in ("shutdown", "leaving"):
            if self.membership.note_alive(src):
                self._grace.note_rejoin(src)
        if kind == "update":
            self._intake_update(header, trees)
        elif kind == "ping":
            pass
        elif kind == "hello":
            self._handle_gossip_hello(header)
        elif kind == "sync":
            self._handle_sync(header, trees)
        elif kind == "state_sync_req":
            self._handle_state_sync_req(header)
        elif kind == "state_sync":
            self._handle_state_sync(header, trees)
        elif kind == "leaving":
            self._peers_done.add(src)
            self.membership.note_leave(src, "leaving")
        elif kind == "shutdown":
            # honored so a script can still stop a fleet; no gossip peer
            # sends one
            self._stop = True
        else:
            logger.warning("peer %d: unknown message type %r",
                           self.peer_id, kind)

    def _maybe_depart(self):
        """Leaderless termination: after the version target evaluate once,
        drain ``DRAIN_S`` so in-flight beacons are still served, announce
        "leaving" to the live view and stop on this peer's own clock."""
        if not self._draining:
            self._draining = True
            self._drain_started = time.time()
            loss = acc = None
            try:
                loss, acc = self._global_eval()
            except Exception as e:  # an eval failure must not eat the report
                logger.warning("peer %d: final eval failed (%s)",
                               self.peer_id, e)
            self._final_eval = {"loss": loss, "acc": acc}
            return
        if time.time() - self._drain_started < self.DRAIN_S:
            time.sleep(0.05)
            return
        self.transport.flush_sends(timeout_s=self.cfg.dist.send_deadline_s)
        for p in self.membership.live():
            if p == self.peer_id:
                continue
            self.transport.send(p, {"type": "leaving",
                                    "version": int(self.version)})
        self._stop = True

    def run(self) -> int:
        logger.info("peer %d/%d up on %s (gossip): clients %s, version %d%s",
                    self.peer_id, self.peers, self.device,
                    list(self.global_ids), self.version,
                    " (resumed)" if self._resumed else "")
        telemetry.emit("run.start", role="peer", peers=self.peers,
                       resumed=self._resumed, version=int(self.version),
                       epoch=self.transport.epoch,
                       pipeline=bool(self.cfg.dist.pipeline),
                       dispatch="gossip")
        self.transport.start()
        if (self.cfg.dist.resource_sample_s > 0
                and self.events_path is not None):
            try:
                from bcfl_tpu_torch.metrics.metrics import ResourceMonitor

                self._resmon = ResourceMonitor(run_dir=self.run_dir)
                self._resmon.start_sampling(self.cfg.dist.resource_sample_s)
            except Exception as e:  # noqa: BLE001 — an observer never kills a peer
                logger.warning("resource sampling unavailable: %s", e)
        if self.cfg.dist.pipeline:
            self._intake_thread = threading.Thread(
                target=self._intake_loop, daemon=True,
                name=f"bcfl-gossip-intake-{self.peer_id}")
            self._intake_thread.start()
        self._write_report(status="running")
        if self._resumed and not self._needs_bootstrap:
            # a rejoiner's first beacon is immediate: it re-enters every
            # live view it touches and gets a sync back
            self._last_hello_beacon = 0.0
            self._maybe_hello()
        try:
            while not self._stop:
                self._check_watchdogs()
                self._maybe_flush_report()
                msg = self._next_ctrl(timeout_s=0.0)
                while msg is not None:
                    self._handle(*msg)
                    msg = self._next_ctrl(timeout_s=0.0)
                if self._stop:
                    break
                if self._needs_bootstrap:
                    # damaged or empty durable state: no training, beacon
                    # or serving until a verified STATE_SYNC is adopted
                    self._maybe_request_sync()
                    time.sleep(0.05)
                    continue
                self._update_partition_state()
                self._maybe_hello()
                if self.version < self.cfg.num_rounds:
                    # train, then merge whatever arrived meanwhile: the
                    # version advances every round, arrivals or not
                    self._train_once()
                    self._gossip_merge()
                else:
                    self._maybe_depart()
        except DurabilityError as e:
            # the ladder's last rung: exit with its own code, never go on
            # with state that could not be made durable
            logger.error("peer %d un-durable: %s", self.peer_id, e)
            self._write_report(status="undurable")
            return DurabilityError.EXIT_CODE
        finally:
            self.transport.flush_sends(timeout_s=2.0)
            self.transport.close()
            self._deadline_timer.cancel()
            if self._resmon is not None:
                self._resmon.stop_sampling()
        self._write_report(status="ok")
        return 0
