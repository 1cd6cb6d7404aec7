"""The federated round engine: port of ``bcfl_tpu/fed/engine.py`` for
``runtime="local"`` (``FedEngine.run`` with ``_participation``,
``_exchange_updates``, the ledger's fingerprint path, ``_server_round``,
``_serverless_round``, ``_async_round`` and ``_maybe_eval``).

Per round the host control plane:

1. runs the anomaly filter over the latency graph -> participation mask
   (``cfg.topology.anomaly_filter``; all ones when off);
2. runs the round: server FedAvg (``mode="server"``), serverless ring
   gossip (``mode="serverless"``), the reference's own serverless
   semantics (``faithful=True``: the clients train one shared model in
   turn and the snapshots are averaged), or one buffered-async
   aggregation event (``sync="async"``, FedBuff-style, under a simulated
   network clock derived from the latency graph);
3. with the ledger on, every update crosses the wire seam
   (:meth:`FedEngine._exchange_updates`): each client's update (the codec
   payload when compression is on) is fingerprinted on the device, the
   digest is chained, and what arrived is authenticated against the chain
   before aggregation; a client that fails authentication is masked out;
4. records the round: mask, anomalies, auth, staleness and merge weights
   (async), the synchronous/asynchronous information passing times, bytes
   on the wire, wall time; evaluates every ``eval_every`` rounds and after
   the last.

A ``ResourceMonitor`` spans the run (``RunMetrics.resources``). The fault
plan, reputation, robust aggregators, cohorts and fused multi-round
dispatch of the JAX engine are not ported yet (the config raises); with
them off the JAX engine runs exactly these steps. Without a fault plan
nothing corrupts the wire, so what arrives is what was sent.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from bcfl_tpu_torch.compression import codecs as cc
from bcfl_tpu_torch.config import FedConfig
from bcfl_tpu_torch.core import prng, resolve_device
from bcfl_tpu_torch.core.fence import fence
from bcfl_tpu_torch.data import (
    Partitioner,
    TokenCache,
    central_eval_batches,
    client_batches,
    get_tokenizer,
    load_dataset,
)
from bcfl_tpu_torch.fed import client_step as cs
from bcfl_tpu_torch.ledger import Ledger
from bcfl_tpu_torch.ledger import fingerprint as fp_lib
from bcfl_tpu_torch.metrics import (
    ResourceMonitor,
    RoundRecord,
    RunMetrics,
    StepClock,
    model_size_gb,
)
from bcfl_tpu_torch.models import build, full_float32_matmuls
from bcfl_tpu_torch.models.bert import init_params
from bcfl_tpu_torch.models.convert import load_trainable, trainable_tree
from bcfl_tpu_torch.topology import anomaly_filter, random_graph, reference_graph

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
#: generator lane of the model's fresh init (the JAX engine folds 2)
INIT_LANE = 2

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RunResult:
    metrics: RunMetrics
    trainable: Dict[str, torch.Tensor]  # final global tree, JAX layout
    model: nn.Module  # the model, holding the final global parameters
    ledger: Optional[Ledger] = None


@dataclasses.dataclass
class ExchangeResult:
    """One update exchange through the engine's wire seam."""

    # what arrived at the aggregation point: the stacked tree (no codec) or
    # the codec payload
    sent: object
    # receiver-side reconstruction to aggregate or mix: ``ref + decoded``
    # with a codec in the global/local modes, ``sent`` itself without one,
    # None in async mode (the async merge decodes the deltas itself)
    recon: object
    # ledger 0/1 auth mask over the clients (None: ledger off)
    auth: Optional[np.ndarray]


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in tree.items()}


class FedEngine:
    def __init__(self, cfg: FedConfig, device=None, info_source: int = 1):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        if dev.type == "cuda":
            full_float32_matmuls()
        self.C = cfg.num_clients
        # --- data: tokenize once ---
        self.dataset = load_dataset(cfg.dataset, num_labels=cfg.num_labels,
                                    text_col=cfg.text_col,
                                    label_col=cfg.label_col)
        self.tokenizer = get_tokenizer(cfg.tokenizer, cfg.vocab_size)
        self.cache = TokenCache.build(self.dataset, self.tokenizer,
                                      cfg.seq_len)
        self.num_labels = max(cfg.num_labels, self.cache.num_labels)
        self.partitioner = Partitioner(cfg.partition, self.dataset.n_train,
                                       self.dataset.n_test, cfg.seed)
        # --- model: built on the device, fresh init from the seed ---
        overrides = {}
        if cfg.use_flash is not None:
            overrides["use_flash"] = cfg.use_flash
            if cfg.use_flash:
                # an explicit "on" forces flash attention at every length
                # (the family otherwise gates on flash_min_seq)
                overrides["flash_min_seq"] = 0
        with torch.device(dev):
            self.model = build(cfg.model, num_labels=self.num_labels,
                               vocab_size=self.tokenizer.vocab_size,
                               dtype=DTYPES[cfg.compute_dtype],
                               param_dtype=DTYPES[cfg.param_dtype],
                               remat=cfg.remat, **overrides)
        init_params(self.model, prng.generator(dev, cfg.seed, INIT_LANE))
        self.trainable0 = trainable_tree(self.model)
        loss_fn = cs.make_loss_fn(self.model, cfg.task)
        self.local_train = cs.make_local_train(self.model, loss_fn,
                                               cfg.optimizer,
                                               cfg.learning_rate,
                                               cfg.max_grad_norm)
        self.eval_one = cs.make_eval_one(self.model, loss_fn)
        # --- update codec; its error-feedback residual is round state ---
        self._comp = cfg.compression if cfg.compression.enabled else None
        self._ef = None
        # --- topology graph (positional over the stacked clients) ---
        if cfg.topology.bandwidth == "reference" and self.C == 10:
            self.graph = reference_graph()
        else:
            self.graph = random_graph(self.C, cfg.topology.bw_low,
                                      cfg.topology.bw_high, seed=cfg.seed)
        self.info_source = info_source % self.C
        self.ledger = (Ledger(cfg.ledger.use_native) if cfg.ledger.enabled
                       else None)
        # bytes-on-wire accounting: what ONE client ships per round, raw vs
        # through the codec; it feeds the records, the comms model and the
        # ledger's per-entry payload accounting
        self._raw_bytes_per_client = cc.payload_nbytes(None, self.trainable0)
        self._wire_bytes_per_client = cc.payload_nbytes(self._comp,
                                                        self.trainable0)
        self._client_payload_bytes = int(self._wire_bytes_per_client)
        self._struct_cache: Dict[str, bytes] = {}
        self.clock = StepClock()
        self.eval_batches = _to_device(
            central_eval_batches(self.cache, cfg.batch_size,
                                 max_batches=cfg.max_eval_batches), dev)
        self._static_batches = None  # the partition is round-static

    # ----------------------------------------------------------------- utils

    def _round_batches(self, rnd: int):
        cfg = self.cfg
        static = not (cfg.partition.kind == "iid"
                      and cfg.partition.resample_each_round)
        if static and self._static_batches is not None:
            return self._static_batches
        tree, n_ex = client_batches(self.cache, self.partitioner, self.C,
                                    rnd, cfg.batch_size,
                                    max_batches=cfg.max_local_batches)
        out = (_to_device(tree, self.device), np.asarray(n_ex))
        if static:
            self._static_batches = out
        return out

    def _generators(self, rnd: int):
        return prng.client_round_generators(self.cfg.seed, self.C, rnd,
                                            self.device)

    def _uniforms(self, rnd: int) -> Optional[cc.Uniforms]:
        if self._comp is None or not self._comp.stochastic:
            return None
        return prng.codec_uniforms(self.cfg.seed, rnd)

    def _participation(self, rnd: int) -> Dict:
        return anomaly_filter(self.cfg.topology.anomaly_filter, self.graph,
                              protect=(self.info_source,))

    def _payload_gb(self) -> float:
        # the comms model scales by what crosses a link: the codec payload
        # when compression is on, the raw tree otherwise
        return self._wire_bytes_per_client / 1e9

    def _comms_payload_bytes(self) -> int:
        """What one update exchange ships, for the info-passing model: the
        codec payload with a codec on; else the reference's modeled
        ledger-entry payload with the ledger on; else the raw tree."""
        if self._comp is not None:
            return int(self._wire_bytes_per_client)
        if self.ledger is not None:
            return int(self.cfg.ledger.entry_payload_bytes)
        return int(self._raw_bytes_per_client)

    def _mask_tensor(self, mask: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mask, np.float32),
                               device=self.device)

    def _weights(self, mask: np.ndarray, n_ex: np.ndarray) -> torch.Tensor:
        w = np.asarray(mask, np.float32) * (
            np.asarray(n_ex, np.float32) if self.cfg.weighted_agg else 1.0)
        if not np.isfinite(w).all():
            raise ValueError(f"non-finite aggregation weights mask={mask!r} "
                             f"n_ex={n_ex!r}")
        return torch.as_tensor(w, dtype=torch.float32, device=self.device)

    def _stats_to_rec(self, rnd: int, stats: torch.Tensor) -> RoundRecord:
        s = stats.double().cpu().numpy()  # [C, 3]; waits for the device
        n = np.maximum(s[:, 2], 1)
        total = s.sum(0)
        raw = float(self._raw_bytes_per_client * self.C)
        wire = float(self._wire_bytes_per_client * self.C)
        return RoundRecord(
            round=rnd,
            train_loss=float(total[0] / max(total[2], 1)),
            train_acc=float(total[1] / max(total[2], 1)),
            local_acc=(s[:, 1] / n).tolist(),
            bytes_raw=raw, bytes_on_wire=wire,
            compression_ratio=raw / max(wire, 1.0))

    def _check_payload(self, payload: dict) -> None:
        """The payload's tensors hold exactly the bytes the accounting
        bills: ``payload_nbytes`` per client."""
        got = cc.payload_tensor_nbytes(payload)
        want = self._wire_bytes_per_client * self.C
        if got != want:
            raise RuntimeError(f"codec payload holds {got} bytes, the "
                               f"accounting bills {want}")

    def _note_degraded(self, rec: RoundRecord, participation) -> None:
        """Mark (and warn about) a round whose every client was eliminated
        by the anomaly gate x ledger auth: the aggregation keeps the
        previous state through its fallback."""
        if float(np.asarray(participation).sum()) > 0.0:
            return
        rec.degraded = True
        logger.warning(
            "round %d: every client eliminated from the aggregate "
            "(mask/auth all zero) — keeping the previous global model",
            rec.round)

    # ---------------------------------------------------------------- ledger

    def _entry_digest(self, kind: str, fp_row: np.ndarray) -> bytes:
        """Digest a fingerprint row, bound to the update tree's structure
        (names, dtypes, shapes) of ``kind``, taken from the first tree of
        that kind the ledger committed."""
        return fp_lib.entry_digest(self._struct_cache[kind], fp_row,
                                   self.cfg.ledger.use_native)

    def _ledger_commit_rows(self, rnd: int, kind: str, fps) -> None:
        """Chain one entry per client for the fingerprint rows [C, K]."""
        for c in range(self.C):
            self.ledger.append_digest(rnd, c, self._entry_digest(kind, fps[c]),
                                      self._client_payload_bytes)

    def _ledger_auth_rows(self, rnd: int, kind: str, fps) -> np.ndarray:
        """0/1 auth mask: do the fingerprint rows match the committed chain
        entries for this round?"""
        return np.asarray([
            1.0 if self.ledger.authenticate_digest(
                rnd, c, self._entry_digest(kind, fps[c])) else 0.0
            for c in range(self.C)], np.float32)

    def _ledger_verify(self, rnd: int, stacked, sent=None,
                       kind: str = "stacked") -> np.ndarray:
        """Commit every client's update, then authenticate what arrived;
        returns the 0/1 auth mask. ``stacked`` is the honest tree each
        client COMMITS (the codec payload with ``kind="payload"``);
        ``sent`` (default: the same) is what reached the aggregation point.
        The content digest is the device-side fingerprint: only ``[C, K]``
        floats reach the host."""
        # the device is still training: without the fence its time would
        # be billed to the ledger phase
        fence(stacked if sent is None else sent)
        with self.clock.phase("ledger"):
            if kind not in self._struct_cache:
                self._struct_cache[kind] = fp_lib.struct_digest(
                    stacked, self.cfg.ledger.use_native)
            fp = fp_lib.client_fingerprint(stacked).cpu().numpy()
            self._ledger_commit_rows(rnd, kind, fp)
            if sent is None or sent is stacked:
                # the committed buffer IS the aggregated one: recomputing
                # the fingerprint would give the same bits
                return self._ledger_auth_rows(rnd, kind, fp)
            fp_recv = fp_lib.client_fingerprint(sent).cpu().numpy()
            return self._ledger_auth_rows(rnd, kind, fp_recv)

    def _exchange_updates(self, rnd: int, new_t, ref_t,
                          mode: str) -> ExchangeResult:
        """The update-exchange seam: the codec encode (``mode``: "global"
        = delta vs the global, "local" = vs the stacked round-start tree,
        "async" = recon-free), then the ledger's commit and verify of what
        crossed the wire."""
        if self._comp is None:
            auth = (self._ledger_verify(rnd, new_t)
                    if self.ledger is not None else None)
            return ExchangeResult(sent=new_t, recon=new_t, auth=auth)
        uniforms = self._uniforms(rnd)
        if mode == "async":
            payload, self._ef = cs.encode_deltas_async(
                self._comp, new_t, ref_t, self._ef, uniforms)
            recon = None
        else:
            payload, recon, self._ef = cs.encode_deltas(
                self._comp, new_t, ref_t, self._ef, uniforms)
        self._check_payload(payload)
        auth = (self._ledger_verify(rnd, payload, kind="payload")
                if self.ledger is not None else None)
        return ExchangeResult(sent=payload, recon=recon, auth=auth)

    # ----------------------------------------------------------- round bodies

    def _server_round(self, rnd: int, trainable, mask: np.ndarray):
        # train -> (ledger commit) -> (ledger verify) -> aggregate what
        # arrived; all rejected keeps the starting params
        batches, n_ex = self._round_batches(rnd)
        new_t, stats = cs.train_clients(self.local_train, trainable, batches,
                                        self._generators(rnd))
        ex = self._exchange_updates(rnd, new_t, trainable, mode="global")
        del new_t
        auth = ex.auth
        if auth is not None:
            mask = mask * auth
        trainable = cs.collapse(ex.recon, self._weights(mask, n_ex),
                                trainable)
        del ex
        # the record reads the stats back: after the mean is queued
        rec = self._stats_to_rec(rnd, stats)
        if auth is not None:
            rec.auth = auth.tolist()
        self._note_degraded(rec, mask)
        return trainable, rec

    def _serverless_round(self, rnd: int, stacked, prev_consensus,
                          mask: np.ndarray):
        # peers ship their update (the encoded delta vs their own
        # round-start params under a codec) through the wire seam; the mix
        # consumes what arrived, each sender's self-term stays its honest
        # post-train tree
        cfg = self.cfg
        batches, _ = self._round_batches(rnd)
        alpha, steps = cfg.topology.gossip_alpha, cfg.topology.gossip_steps
        start = stacked  # what an all-rejected round keeps
        new_t, stats = cs.local_updates(self.local_train, stacked, batches,
                                        self._generators(rnd))
        ex = self._exchange_updates(rnd, new_t, start, mode="local")
        auth = ex.auth
        if auth is not None:
            mask = mask * auth
        m = self._mask_tensor(mask)
        if ex.recon is not new_t:
            stacked = cs.mix_recv(new_t, ex.recon, m, start, alpha, steps)
        else:
            stacked = cs.mix(new_t, m, start, alpha, steps)
        del new_t, ex, start
        # consensus view for eval (mask-weighted mean)
        consensus = cs.collapse(stacked, m, prev_consensus)
        rec = self._stats_to_rec(rnd, stats)
        if auth is not None:
            rec.auth = auth.tolist()
        self._note_degraded(rec, mask)
        return stacked, consensus, rec

    def _faithful_round(self, rnd: int, trainable, mask: np.ndarray):
        """The reference's serverless semantics
        (``serverless_NonIID_IMDB.py:284-297``): the clients train ONE
        shared tree one after another, each from where the previous one
        left it, and every snapshot is kept; the snapshots are averaged
        with weights ``mask`` (x ledger auth), normalised, in float32 and
        cast back to the leaves' dtype.

        With the ledger on, each snapshot's fingerprint is committed as it
        is produced and the round authenticates the commit-time rows (the
        snapshots are never touched again, so recomputing would give the
        same bits). An all-excluded round keeps the starting tree and is
        marked degraded."""
        batches, _ = self._round_batches(rnd)
        gens = self._generators(rnd)
        shared, snapshots, fps, stats = trainable, [], [], []
        for c in range(self.C):
            shared, st = self.local_train(
                shared, {k: v[c] for k, v in batches.items()}, gens[c])
            if self.ledger is not None:
                fence(shared)  # bill the training to the round, not here
                with self.clock.phase("ledger"):
                    if "one" not in self._struct_cache:
                        self._struct_cache["one"] = fp_lib.struct_digest(
                            self.trainable0, self.cfg.ledger.use_native)
                    fp = fp_lib.tree_fingerprint(shared).cpu().numpy()
                    fps.append(fp)
                    self.ledger.append_digest(
                        rnd, c, self._entry_digest("one", fp),
                        self._client_payload_bytes)
            snapshots.append(shared)
            stats.append(st)
        rec = self._stats_to_rec(rnd, torch.stack(stats))
        w = np.asarray(mask, np.float32)
        if self.ledger is not None:
            with self.clock.phase("ledger"):
                auth = self._ledger_auth_rows(rnd, "one", fps)
            rec.auth = auth.tolist()
            w = w * auth
        total = float(w.sum())
        if total <= 0.0:
            self._note_degraded(rec, w)
            return trainable, rec
        w = w / total
        avg = {}
        for p, x in trainable.items():
            acc = 0
            for c, snap in enumerate(snapshots):
                acc = acc + float(w[c]) * snap[p].float()
            avg[p] = acc.to(x.dtype)
        return avg, rec

    def _init_async_state(self) -> Dict:
        """Simulated network clock: per-client round duration = local
        compute (proportional to the client's example count, mean-normalized
        to 1) + transfer time to the aggregation point over the latency
        graph."""
        times = self.graph.shortest_path_times(self._payload_gb())
        src = self.info_source
        transfer = np.array([
            times[c, src] if c != src else 0.0 for c in range(self.C)])
        _, n_ex = self._round_batches(0)
        n_ex = np.asarray(n_ex, np.float64)
        compute = n_ex / max(n_ex.mean(), 1e-9)
        duration = compute + transfer
        return {
            "duration": duration,
            "next_done": duration.copy(),
            "version": np.zeros((self.C,), np.int64),
            "global_version": 0,
            "clock": 0.0,
        }

    def _async_merge_scale(self, alpha, arrived, n_ex) -> float:
        """sum(decayed weights) / sum(un-decayed weights) over the arrived
        buffer: 1.0 when every arrival is fresh, ``staleness_decay ** s``
        when a lone arrival is ``s`` versions stale."""
        if self.cfg.weighted_agg:
            base = float(np.asarray(n_ex)[arrived].sum())
        else:
            base = float(len(arrived))
        return float(alpha[arrived].sum() / max(base, 1e-9))

    def _async_round(self, rnd: int, trainable, stacked, mask: np.ndarray,
                     st: Dict):
        """One buffered-async aggregation event (FedBuff-style): the K
        earliest-finishing clients merge their local DELTAS, each decayed
        by ``staleness_decay ** staleness``; the global takes an
        ``async_server_lr`` step along the weighted-mean delta, and the
        arrived clients adopt it. The others keep training on their stale
        base."""
        cfg = self.cfg
        K = cfg.async_buffer or self.C
        if stacked is None:
            stacked = cs.broadcast(trainable, self.C)
        base = stacked  # each client's round-start params (delta reference)
        batches, n_ex = self._round_batches(rnd)
        stacked, stats = cs.local_updates(self.local_train, stacked, batches,
                                          self._generators(rnd))
        rec = self._stats_to_rec(rnd, stats)
        # the transmitted quantity is the delta (the encoded delta payload
        # with a codec); each client's own carried state stays its honest
        # post-train tree
        ex = self._exchange_updates(rnd, stacked, base, mode="async")
        if ex.auth is not None:
            rec.auth = ex.auth.tolist()
            mask = mask * ex.auth
        self._note_degraded(rec, mask)
        # the K earliest arrivals among the participating clients
        order = np.argsort(st["next_done"])
        arrived = [c for c in order if mask[c] > 0][:K]
        st["clock"] = (float(st["next_done"][arrived].max()) if arrived
                       else st["clock"])
        staleness = st["global_version"] - st["version"]
        rec.staleness = [max(int(s), 0) for s in staleness]
        alpha = np.zeros((self.C,), np.float32)
        for c in arrived:
            alpha[c] = (float(mask[c])
                        * cfg.staleness_decay ** max(int(staleness[c]), 0))
        rec.async_alpha = alpha.tolist()
        if cfg.weighted_agg:
            alpha = alpha * n_ex
        if arrived:
            if self._comp is None:
                deltas = {p: ex.sent[p] - base[p] for p in ex.sent}
            else:
                deltas = cs.decode_delta(self._comp, ex.sent, stacked)
            del ex, base
            zero = {p: torch.zeros_like(x) for p, x in trainable.items()}
            # collapse normalizes by sum(alpha), which would cancel the
            # staleness decay out of the step: rescale by sum(alpha) /
            # sum(un-decayed weights)
            merged = cs.collapse(
                deltas, torch.as_tensor(alpha, dtype=torch.float32,
                                        device=self.device), zero)
            del deltas
            step = cfg.async_server_lr * self._async_merge_scale(
                alpha, arrived, n_ex)
            trainable = {p: trainable[p] + step * merged[p]
                         for p in trainable}
            pull = np.zeros((self.C,), np.float32)
            pull[arrived] = 1.0
            stacked = cs.adopt(stacked, trainable, self._mask_tensor(pull))
            st["global_version"] += 1
            for c in arrived:
                st["version"][c] = st["global_version"]
                st["next_done"][c] = st["clock"] + st["duration"][c]
        return trainable, stacked, rec

    # -------------------------------------------------------------- evaluate

    def _maybe_eval(self, rnd: int, rec: RoundRecord, trainable,
                    stacked) -> None:
        cfg = self.cfg
        due = ((rnd + 1) % cfg.eval_every == 0
               or rnd == cfg.num_rounds - 1) if cfg.eval_every else False
        if not due:
            return
        with self.clock.phase("eval"):
            s = self.eval_one(trainable, self.eval_batches).double().cpu()
            rec.global_loss = float(s[0] / max(float(s[2]), 1.0))
            rec.global_acc = float(s[1] / max(float(s[2]), 1.0))
            # each client's local accuracy on its own test split: of its
            # own carried tree when clients carry one (serverless, async),
            # of the global otherwise
            tb, _ = client_batches(self.cache, self.partitioner, self.C, rnd,
                                   cfg.batch_size,
                                   max_batches=cfg.max_local_batches,
                                   split="test")
            tb = _to_device(tb, self.device)

            def tree_of(c):
                if stacked is None:
                    return trainable
                return {p: x[c] for p, x in stacked.items()}

            local = torch.stack([
                self.eval_one(tree_of(c), {k: v[c] for k, v in tb.items()})
                for c in range(self.C)]).double().cpu().numpy()
            rec.local_acc = (local[:, 1] / np.maximum(local[:, 2], 1)).tolist()

    # ------------------------------------------------------------------- run

    def run(self, on_round: Optional[Callable[[RoundRecord], None]] = None
            ) -> RunResult:
        """Run ``num_rounds`` rounds; ``on_round(record)`` is called after
        each round's record is complete."""
        cfg = self.cfg
        monitor = ResourceMonitor()
        metrics = RunMetrics()
        clock = self.clock = StepClock()
        trainable = self.trainable0
        stacked = None
        if self._comp is not None:
            self._ef = cc.zero_residual(trainable, self.C)
        if cfg.mode == "serverless" and not cfg.faithful:
            stacked = cs.broadcast(trainable, self.C)
        async_state = (self._init_async_state() if cfg.sync == "async"
                       else None)
        for rnd in range(cfg.num_rounds):
            t0 = time.perf_counter()
            with clock.phase("control_plane"):
                gate = self._participation(rnd)
                mask = gate["mask"].astype(np.float32)
            with clock.phase("round_program"):
                if cfg.sync == "async":
                    trainable, stacked, rec = self._async_round(
                        rnd, trainable, stacked, mask, async_state)
                elif cfg.mode == "server":
                    trainable, rec = self._server_round(rnd, trainable, mask)
                elif cfg.faithful:
                    trainable, rec = self._faithful_round(rnd, trainable,
                                                          mask)
                else:
                    stacked, trainable, rec = self._serverless_round(
                        rnd, stacked, trainable, mask)
            rec.mask = mask.tolist()
            rec.anomalies = list(gate["anomalies"])
            sync_t, async_t = self.graph.info_passing_time(
                0.0, source=self.info_source, anomalies=gate["anomalies"],
                payload_bytes=self._comms_payload_bytes())
            rec.info_passing_sync_s = sync_t
            rec.info_passing_async_s = async_t
            fence(trainable)
            rec.wall_s = time.perf_counter() - t0
            self._maybe_eval(rnd, rec, trainable, stacked)
            metrics.rounds.append(rec)
            if on_round is not None:
                on_round(rec)
        load_trainable(self.model, trainable)
        metrics.model_size_gb = model_size_gb(trainable)
        metrics.resources = monitor.snapshot()
        metrics.phases = clock.summary()
        raw, wire = self._raw_bytes_per_client, self._wire_bytes_per_client
        metrics.comms = {
            "compress": cfg.compression.kind,
            "bytes_raw_per_round": float(raw * self.C),
            "bytes_on_wire_per_round": float(wire * self.C),
            "compression_ratio": float(raw / max(wire, 1)),
        }
        if self.ledger is not None and len(self.ledger):
            metrics.ledger = self.ledger.payload_accounting()
            metrics.ledger["chain_ok"] = float(
                self.ledger.verify_chain() == -1)
        return RunResult(metrics=metrics, trainable=trainable,
                         model=self.model, ledger=self.ledger)
