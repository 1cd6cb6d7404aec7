"""The federated round engine: port of ``bcfl_tpu/fed/engine.py`` for
``runtime="local"``, ``mode="server"``, ``sync="sync"`` (``FedEngine.run``
with ``_server_round``, ``_weights``, ``_stats_to_rec`` and
``_maybe_eval``).

Per round: build every client's batch stack, weight the clients by their
example counts (FedAvg), run :func:`~bcfl_tpu_torch.fed.client_step.
server_round` (local training, the update codec with error feedback, the
masked weighted mean), and record the round. The global model is
evaluated every ``eval_every`` rounds and always after the last one. The
anomaly filter, fault plan, ledger and reputation of the JAX engine are
not ported yet; with their JAX defaults (all off) every client takes part
in every round, which is what the participation mask here says.
"""

from __future__ import annotations

import dataclasses
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
from bcfl_tpu_torch.fed.client_step import (
    make_eval_one,
    make_local_train,
    make_loss_fn,
    server_round,
)
from bcfl_tpu_torch.metrics import RoundRecord, RunMetrics, model_size_gb
from bcfl_tpu_torch.models import build, full_float32_matmuls
from bcfl_tpu_torch.models.bert import init_params
from bcfl_tpu_torch.models.convert import load_trainable, trainable_tree

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: generator lane of the model's fresh init (the JAX engine folds 2)
INIT_LANE = 2


@dataclasses.dataclass
class RunResult:
    metrics: RunMetrics
    trainable: Dict[str, torch.Tensor]  # final global tree, JAX layout
    model: nn.Module  # the model, holding the final global parameters


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in tree.items()}


class FedEngine:
    def __init__(self, cfg: FedConfig, device=None):
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
        with torch.device(dev):
            self.model = build(cfg.model, num_labels=self.num_labels,
                               vocab_size=self.tokenizer.vocab_size,
                               dtype=DTYPES[cfg.compute_dtype],
                               param_dtype=DTYPES[cfg.param_dtype])
        init_params(self.model, prng.generator(dev, cfg.seed, INIT_LANE))
        self.trainable0 = trainable_tree(self.model)
        loss_fn = make_loss_fn(self.model, cfg.task)
        self.local_train = make_local_train(self.model, loss_fn,
                                            cfg.optimizer, cfg.learning_rate)
        self.eval_one = make_eval_one(self.model, loss_fn)
        # --- update codec and its bytes-on-wire accounting ---
        self._comp = cfg.compression if cfg.compression.enabled else None
        self._raw_bytes_per_client = cc.payload_nbytes(None, self.trainable0)
        self._wire_bytes_per_client = cc.payload_nbytes(self._comp,
                                                        self.trainable0)
        self.eval_batches = _to_device(
            central_eval_batches(self.cache, cfg.batch_size,
                                 max_batches=cfg.max_eval_batches), dev)
        self._static_batches = None  # the partition is round-static

    # ------------------------------------------------------------- per round

    def _round_batches(self, rnd: int):
        cfg = self.cfg
        static = not (cfg.partition.kind == "iid"
                      and cfg.partition.resample_each_round)
        if static and self._static_batches is not None:
            return self._static_batches
        tree, n_ex = client_batches(self.cache, self.partitioner, self.C,
                                    rnd, cfg.batch_size,
                                    max_batches=cfg.max_local_batches)
        out = (_to_device(tree, self.device), n_ex)
        if static:
            self._static_batches = out
        return out

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

    def _maybe_eval(self, rnd: int, rec: RoundRecord, trainable) -> None:
        cfg = self.cfg
        due = ((rnd + 1) % cfg.eval_every == 0
               or rnd == cfg.num_rounds - 1) if cfg.eval_every else False
        if not due:
            return
        s = self.eval_one(trainable, self.eval_batches).double().cpu()
        rec.global_loss = float(s[0] / max(float(s[2]), 1.0))
        rec.global_acc = float(s[1] / max(float(s[2]), 1.0))
        # each client's local accuracy of the global model on its own test
        # split
        tb, _ = client_batches(self.cache, self.partitioner, self.C, rnd,
                               cfg.batch_size,
                               max_batches=cfg.max_local_batches,
                               split="test")
        tb = _to_device(tb, self.device)
        local = torch.stack([
            self.eval_one(trainable, {k: v[c] for k, v in tb.items()})
            for c in range(self.C)]).double().cpu().numpy()
        rec.local_acc = (local[:, 1] / np.maximum(local[:, 2], 1)).tolist()

    # ------------------------------------------------------------------- run

    def run(self, on_round: Optional[Callable[[RoundRecord], None]] = None
            ) -> RunResult:
        """Run ``num_rounds`` server rounds; ``on_round(record)`` is called
        after each round's record is complete."""
        cfg = self.cfg
        metrics = RunMetrics()
        trainable = self.trainable0
        resid = (cc.zero_residual(trainable, self.C)
                 if self._comp is not None else None)
        for rnd in range(cfg.num_rounds):
            t0 = time.perf_counter()
            mask = np.ones((self.C,), np.float32)
            batches, n_ex = self._round_batches(rnd)
            weights = self._weights(mask, n_ex)
            gens = prng.client_round_generators(cfg.seed, self.C, rnd,
                                                self.device)
            uniforms = (prng.codec_uniforms(cfg.seed, rnd)
                        if self._comp is not None and self._comp.stochastic
                        else None)
            out = server_round(self.local_train, self._comp, trainable,
                               batches, weights, gens, resid, uniforms)
            trainable, resid = out.global_t, out.resid
            if out.payload is not None:
                self._check_payload(out.payload)
            rec = self._stats_to_rec(rnd, out.stats)
            rec.mask = mask.tolist()
            rec.degraded = not mask.any()
            fence(trainable)
            rec.wall_s = time.perf_counter() - t0
            self._maybe_eval(rnd, rec, trainable)
            metrics.rounds.append(rec)
            if on_round is not None:
                on_round(rec)
        load_trainable(self.model, trainable)
        metrics.model_size_gb = model_size_gb(trainable)
        raw, wire = self._raw_bytes_per_client, self._wire_bytes_per_client
        metrics.comms = {
            "compress": cfg.compression.kind,
            "bytes_raw_per_round": float(raw * self.C),
            "bytes_on_wire_per_round": float(wire * self.C),
            "compression_ratio": float(raw / max(wire, 1)),
        }
        return RunResult(metrics=metrics, trainable=trainable,
                         model=self.model)
