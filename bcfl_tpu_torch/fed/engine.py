"""The federated round engine: port of ``bcfl_tpu/fed/engine.py`` for
``runtime="local"`` (``FedEngine.run`` with ``_participation``,
``_exchange_updates`` and ``_transport``, the ledger's fingerprint and
byte-hash paths, ``_server_round``, ``_serverless_round``,
``_faithful_round``, ``_async_round``, ``_partitioned_round``,
``_heal_partition``, ``_reputation_observe``, ``_maybe_eval`` and
``_maybe_checkpoint``, with the resume guards).

Per round the host control plane:

1. runs the anomaly filter over the latency graph (per component under a
   partition) -> participation mask, composed with the fault plan's
   dropout and churn and the reputation gate;
2. runs the round: server FedAvg (``mode="server"``), serverless ring
   gossip or its exact aggregate (``mode="serverless"``), the reference's
   own serverless semantics (``faithful=True``: the clients train one
   shared model in turn and the snapshots are averaged), one
   buffered-async aggregation event (``sync="async"``, FedBuff-style,
   under a simulated network clock derived from the latency graph), or,
   during a partition span, one aggregation per connected component;
   every aggregation point takes the configured rule
   (``cfg.aggregator``: the mean or a Byzantine-robust statistic);
3. every update crosses the wire seam (:meth:`FedEngine._exchange_updates`):
   the codec encodes each client's update, the fault plan may corrupt
   what is in transit, and with the ledger on each client's committed
   update is fingerprinted on the device, chained, and what arrived is
   authenticated before aggregation; a client that fails authentication
   is masked out;
4. records the round (mask, anomalies, auth, dropped clients, straggler
   delays, partition, heal, churn, staleness and merge weights, the
   information passing times, bytes on the wire, wall time), folds the
   round's evidence into the reputation tracker, evaluates every
   ``eval_every`` rounds and after the last, and checkpoints every
   ``checkpoint_every`` rounds.

``run(resume=True)`` restores the newest valid checkpoint and reproduces
the uninterrupted run bit for bit; the fault plan's host crash fires only
when nothing was restored. A ``ResourceMonitor`` spans the run
(``RunMetrics.resources``).

With ``lora_rank > 0`` the trainable tree is a LoRA adapter tree over the
frozen base the model holds (built on the device from the seed, never
checkpointed), at a uniform rank or per-client ranks (RBLA: the stacked
init's rank-aware mean is the round-0 global); every round records the
adapters' effective rank. Cohort mode (``registry_size > 0``): the stacked
axis holds the round's sampled cohort (``self.C``) of a registry of
``self.R`` clients, and batches, PRNG streams, fault-plan rows,
reputation and ledger identities follow the registry id; the
error-feedback residual lives per registry client in an
:class:`~bcfl_tpu_torch.fed.cohort.EFRegistry`, gathered before each
round and scattered after it.

The fused multi-round dispatch (``rounds_per_dispatch > 1``,
:meth:`FedEngine._chunk_rounds`): where the host has nothing to do
between rounds, a chunk of sync server or parallel gossip rounds is
issued one round after another with no read-back of the device
(:func:`~bcfl_tpu_torch.fed.client_step.server_rounds`,
:func:`~bcfl_tpu_torch.fed.client_step.gossip_rounds`), the ledger's
fingerprints taken before and after the transport stage and compared on
the device, which gates the aggregation. The chunk's stats, fingerprints
and auth then come back in one transfer; the records, the chain's commits
and authentication, evaluation, checkpoint and telemetry follow, at the
chunk's last round. A clean chunk's bits are the per-round rounds'.

The clients axis: the engine's devices (:func:`_devices`: ``devices=`` as
given, else the one device ``device`` names) carry the mesh
(:func:`bcfl_tpu_torch.core.mesh.client_mesh`, the largest divisor of the
client count that fits them), and each client shard trains and
evaluates its clients on its own device (on a 2-D mesh, its own row of
devices, below), the cards working at once
while one host thread issues them
(:class:`bcfl_tpu_torch.fed.client_step.Sharded`). With a codec the
sender's side of every exchange runs there too
(:class:`bcfl_tpu_torch.fed.client_step.Sender`, JAX's ``_compress_stage``
under ``P('clients')``): each shard encodes its own deltas and keeps its
error-feedback rows on its device between rounds, and only the payload
rows cross to the lead device, the first shard's. The stacked
per-client state of the serverless, async and partitioned rounds stays on
the shards (:class:`bcfl_tpu_torch.fed.client_step.Stacked`): each
shard's rows on its device from the broadcast to the end of the run,
trained, decoded, transported, mixed (with two halo rows a step from its
ring neighbours' shards) and adopted where they are. What one reduction
over the client axis reads lands on the lead device in client order and
is reduced there as on one shard (the FedAvg mean, the consensus, the
``steps == 0`` aggregate and the robust rules, a partition component's
aggregate, the async merge, the ledger's fingerprint of an uncompressed
stack), so a run's bits are the one-shard run's (cohort mode's
two-level mean aside). The serverless consensus of such a stack is
collapsed only when something reads it
(:class:`~bcfl_tpu_torch.fed.client_step.Deferred`). Without
``devices=`` the engine stays on one card: spread over four H100s, the
host-bound BERT rounds ran slower than on one
(``scripts/clients_axis.py``).

Tensor and sequence parallelism (``tp``/``sp > 1``) run over the same
device list: the mesh is built before the model (JAX's checks), and every
row of the 2-D mesh is a client shard that trains its own clients on its
own row of devices, inner shard ``i`` on the row's ``i``-th
(``mesh.row_devices(s)``): under ``tp`` each shard holds a megatron split
of the frozen base over its row
(:mod:`bcfl_tpu_torch.parallel.tp_linear`; the model's over row 0, each
other shard's copy slice by slice over its own), under ``sp`` each
shard's attention rides a ring over its row
(:func:`bcfl_tpu_torch.parallel.sp.ring_override`, flash off). In cohort
mode the FedAvg mean is JAX's two-level mean over the client shards
(``hierarchical_weighted_mean``, as many groups as the clients axis has
shards).

The pod (``pod=True``, after
:func:`bcfl_tpu_torch.core.mesh.distributed_init`): the mesh spans every
process's devices (:func:`bcfl_tpu_torch.core.mesh.pod_devices`,
hosts-major), every process runs this engine, and each trains only the
client shards on its own devices. Each builds its shards' inputs
(batches, generators, codec uniforms) from the seed itself; only rows
cross between processes, through the host
(:mod:`bcfl_tpu_torch.parallel.pod`): the global to each process's
shards, payload rows and stats to the lead, halo rows between ring
neighbours, what one reduction lands. The lead device is process 0's: it
alone reduces, and in another process the lead is a ``meta`` device that
holds the shapes of what process 0 computes. Every value the host reads
back from the lead (the records' stats, the ledger's fingerprints, the
evaluations) is process 0's, sent to every other process
(:func:`bcfl_tpu_torch.parallel.pod.decide`), so every host decision is
made alike everywhere and the processes issue the same crossings in the
same order; the bits are the one-process run's over the same shards.
Process 0 alone writes the telemetry stream; every process ends holding
process 0's final global (and its own rows of a stack).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bcfl_tpu_torch import telemetry
from bcfl_tpu_torch.checkpoint import restore_latest, save_checkpoint
from bcfl_tpu_torch.compression import codecs as cc
from bcfl_tpu_torch.config import FedConfig
from bcfl_tpu_torch.core import prng, resolve_device, to_device
from bcfl_tpu_torch.core.mesh import (client_mesh, pod_active, pod_devices,
                                      process_index, visible_devices)
from bcfl_tpu_torch.core.fence import fence
from bcfl_tpu_torch.data import (
    Partitioner,
    TokenCache,
    central_eval_batches,
    client_batches,
    get_tokenizer,
    load_dataset,
)
from bcfl_tpu_torch.faults import FaultInjector, SimulatedCrash
from bcfl_tpu_torch.fed import client_step as cs
from bcfl_tpu_torch.fed.cohort import ClientSampler, EFRegistry, cohort_view
from bcfl_tpu_torch.ledger import Ledger
from bcfl_tpu_torch.ledger import fingerprint as fp_lib
from bcfl_tpu_torch.metrics import (
    ResourceMonitor,
    RoundRecord,
    RunMetrics,
    StepClock,
    model_size_gb,
)
from bcfl_tpu_torch.models import (build, full_float32_matmuls, lora,
                                   lora_targets, tp_param_specs)
from bcfl_tpu_torch.models.bert import TextClassifier, init_params
from bcfl_tpu_torch.models.convert import (leaf_specs, load_trainable,
                                           trainable_tree)
from bcfl_tpu_torch.models.hf_import import import_pretrained, load_into
from bcfl_tpu_torch.parallel import (make_aggregator,
                                     rank_aware_weighted_mean, tp_linear)
from bcfl_tpu_torch.parallel.sp import ring_override
from bcfl_tpu_torch.reputation import ReputationTracker
from bcfl_tpu_torch.topology import (
    anomaly_filter,
    partitioned_anomaly_filter,
    random_graph,
    reference_graph,
)

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
    # the codec's error-feedback residual the run ended with (codec on)
    ef_residual: Optional[Dict[str, torch.Tensor]] = None
    # the per-client stacked state the run ended with (serverless, async,
    # partitioned; None otherwise): a [C, ...] tree on one client shard, a
    # client_step.Stacked on several (client_step.gathered lands it)
    stacked: object = None


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
    # ledger 0/1 auth mask over the clients (None: ledger off, or
    # commit=False)
    auth: Optional[np.ndarray]
    # commit=False with the ledger on: the [C, K] fingerprint rows of
    # ``sent``, which a remote leader commits and re-verifies
    fp: Optional[np.ndarray] = None
    # what ``sent`` is: "stacked" (the tree itself) or "payload" (codec)
    wire_kind: str = "stacked"


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: to_device(torch.from_numpy(np.ascontiguousarray(v)), device)
            for k, v in tree.items()}


def _host_vector(a, device: torch.device) -> torch.Tensor:
    """A host vector as float32 on ``device`` (no wait for the card)."""
    return to_device(torch.from_numpy(np.array(a, np.float32)), device)


def _text(s: str) -> np.ndarray:
    """A string as a uint8 array (checkpoints hold arrays only)."""
    return np.frombuffer(s.encode(), np.uint8).copy()


def _untext(t) -> str:
    return bytes(np.asarray(t, np.uint8)).decode()


def _devices(cfg: FedConfig, device, devices) -> list:
    """The engine's device list: ``devices`` as given (its first entry
    the engine's device), else one device (``device``, default the GPU)
    without an inner axis; with ``tp``/``sp > 1`` the visible CUDA
    devices, or on the CPU as many CPU devices as the inner axis needs
    (the JAX package's virtual host devices). With an inner axis every
    row of the mesh over those devices trains, as JAX's mesh over
    ``jax.devices()`` does: four cards at ``tp=2`` are two client shards
    (pass ``devices`` of one row to keep one). Under ``pod`` every
    process's devices (``devices``, the one ``device`` names, or the
    visible cards), gathered from every process: a call every process of
    the pod makes at once."""
    inner = max(cfg.tp, cfg.sp)
    if cfg.pod:
        # this process's own devices (as given, the one ``device`` names,
        # or every visible card), gathered from every process of the pod
        if devices is None:
            dev = resolve_device(device)
            devices = ([dev] if dev.type == "cpu" or dev.index is not None
                       else visible_devices())
        return pod_devices([resolve_device(d) for d in devices])
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("devices is empty")
        dev = resolve_device(device) if device is not None else devices[0]
        # "cuda" names the current card, index 0 here
        if (dev.type, dev.index or 0) != (devices[0].type,
                                           devices[0].index or 0):
            raise ValueError(f"device={device} is not devices[0]="
                             f"{devices[0]}")
        return devices
    dev = resolve_device(device)
    if inner == 1:
        return [dev]
    if dev.type == "cpu":
        return [dev] * inner
    return visible_devices()


class FedEngine:
    def __init__(self, cfg: FedConfig, device=None, info_source: int = 1,
                 tamper_hook: Optional[Callable] = None,
                 fused_tamper: Optional[Callable] = None,
                 client_ids: Optional[Sequence[int]] = None,
                 devices: Optional[Sequence] = None):
        """``client_ids``: the global ids of the stacked clients (a dist
        peer's slice; default ``0..C-1``). Batches, dropout generators,
        codec uniforms and ledger ids follow them. The dist runtime uses
        the engine's round pieces, never :meth:`run`, so fixed ids refuse
        the per-client state that :meth:`run` keeps (registry sampling,
        reputation).

        ``devices``: the mesh's devices (see :func:`_devices`). Client
        shard ``s`` trains its clients on ``mesh.client_devices[s]``; with
        an inner axis that is the first device of the mesh's row ``s``,
        and the shard's inner ``tp``/``sp`` shard ``i`` lives on the row's
        ``i``-th (``mesh.row_devices(s)``). A list may name one card more
        than once
        (``[cuda:0] * 4``): the shards then share it, which proves the
        sharded arithmetic and gives no memory or speed gain."""
        self.cfg = cfg
        # a pod: every process runs this engine over the pod's devices
        self._pod = cfg.pod and pod_active()
        if self._pod and (tamper_hook is not None or fused_tamper is not None
                          or client_ids is not None):
            raise ValueError(
                "pod=True takes neither the tamper_hook/fused_tamper shims "
                "nor client_ids (a dist peer's slice)")
        devices = _devices(cfg, device, devices)
        self._fixed_ids = None
        if client_ids is not None:
            if cfg.registry_size > 0 or cfg.reputation.enabled:
                raise ValueError(
                    "client_ids (a dist peer's slice) does not compose "
                    "with registry sampling or reputation")
            self._fixed_ids = np.asarray(client_ids, np.int64)
            if len(self._fixed_ids) != cfg.num_clients:
                raise ValueError(
                    f"{len(self._fixed_ids)} client_ids for "
                    f"{cfg.num_clients} clients")
        # cohort mode: C = the stacked width (the round's cohort), R = the
        # registry; with sampling off R == C == num_clients and every
        # per-round id is the slot itself
        self.sampling = cfg.registry_size > 0
        self.C = ((cfg.sample_clients or cfg.num_clients) if self.sampling
                  else cfg.num_clients)
        self.R = cfg.registry_size if self.sampling else cfg.num_clients
        self.sampler = (ClientSampler(cfg.seed, self.R, self.C)
                        if self.sampling else None)
        self._cohort_cache = (-1, None)
        if self.sampling and (tamper_hook is not None
                              or fused_tamper is not None):
            raise ValueError(
                "the legacy tamper_hook/fused_tamper shims are positional "
                "over a fixed client set; with registry sampling schedule "
                "corruption via FedConfig.faults (its schedules are keyed "
                "by registry id)")
        # ``tamper_hook`` (byte-level tampering of the host trees the
        # ledger hashes) and ``fused_tamper`` (corruption of fused
        # multi-round dispatches) are the JAX engine's legacy hooks; new
        # code schedules corruption with ``cfg.faults``
        if tamper_hook is not None or fused_tamper is not None:
            warnings.warn(
                "tamper_hook/fused_tamper are deprecated shims — schedule "
                "corruption via FedConfig.faults "
                "(bcfl_tpu_torch.faults.FaultPlan)",
                DeprecationWarning, stacklevel=2)
        self.faults = FaultInjector(cfg.faults, self.R,
                                    host_tamper=tamper_hook,
                                    fused_tamper=fused_tamper)
        if cfg.compression.enabled and tamper_hook is not None:
            raise ValueError(
                "tamper_hook models byte-tampering of full host update "
                "trees; with compression enabled the wire carries encoded "
                "payloads — schedule corruption via FedConfig.faults "
                "(it corrupts the compressed representation)")
        rep = cfg.reputation
        self.reputation = (ReputationTracker(rep, self.R)
                           if rep is not None and rep.enabled else None)
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
        # --- mesh (before the model: sp puts the mesh into attention) ---
        if self.sampling and cfg.cohort_size:
            # exactly C / cohort_size client shards, each reserving the
            # inner (tp/sp) axis's devices: the cards the mesh uses
            inner = max(cfg.tp, cfg.sp)
            need = (self.C // cfg.cohort_size) * inner
            if need > len(devices):
                raise ValueError(
                    f"cohort_size {cfg.cohort_size} needs {need} devices "
                    f"for a {self.C}-client cohort"
                    + (f" x {inner} inner (tp/sp) shards" if inner > 1
                       else "")
                    + f", have {len(devices)}")
            devices = devices[:need]
        self.mesh = client_mesh(self.C, devices=devices, tp=cfg.tp,
                                sp=cfg.sp)
        # the lead device (another process's in a pod: a meta stand-in),
        # and this process's first own device, where its model lives
        self.device = self.mesh.client_devices[0]
        self.home = home = self.mesh.home
        if any(d.type == "cuda" for d in self.mesh.mesh.flat):
            full_float32_matmuls()
        # the random streams' identity, recorded in checkpoints
        self._prng_name = prng.scheme_name(home)
        # --- model: built on the device, fresh init from the seed ---
        overrides = {}
        if cfg.use_flash is not None:
            overrides["use_flash"] = cfg.use_flash
            if cfg.use_flash:
                # an explicit "on" forces flash attention at every length
                # (the family otherwise gates on flash_min_seq)
                overrides["flash_min_seq"] = 0
        if cfg.sp > 1:
            # each client's attention becomes exact ring attention over the
            # mesh's seq axis; llama rides the causal ring, encoders the
            # non-causal one
            overrides["attention_override"] = ring_override(self.mesh.mesh)
            overrides["use_flash"] = False
        dtypes = dict(dtype=DTYPES[cfg.compute_dtype],
                      param_dtype=DTYPES[cfg.param_dtype], remat=cfg.remat,
                      **overrides)
        if cfg.hf_checkpoint is not None:
            # seed from an HF checkpoint on disk (or a hub name the cache
            # holds): its own architecture, a fresh classifier head
            if cfg.task == "causal_lm":
                raise ValueError(
                    "task='causal_lm' needs a decoder; the HF import path "
                    "builds encoder classifiers")
            model_cfg, variables = import_pretrained(
                cfg.hf_checkpoint, num_labels=self.num_labels,
                reinit_classifier=True)
            with torch.device(home):
                self.model = TextClassifier(
                    dataclasses.replace(model_cfg, **dtypes))
            load_into(self.model, variables["params"])
        else:
            with torch.device(home):
                depth = ({"num_layers": cfg.num_layers}
                         if cfg.num_layers else {})
                self.model = build(cfg.model, num_labels=self.num_labels,
                                   vocab_size=self.tokenizer.vocab_size,
                                   head=("lm" if cfg.task == "causal_lm"
                                         else "classifier"),
                                   **depth, **dtypes)
            init_params(self.model,
                        prng.generator(home, cfg.seed, INIT_LANE))
        # heterogeneous LoRA ranks: the [C, R] padding mask of the fleet
        self._rmask = None
        self.adapters = cfg.lora_rank > 0
        if self.adapters:
            # the model's parameters are the frozen base; the trainable
            # tree is the adapter tree
            self.model.requires_grad_(False)
            self.trainable0 = self._init_adapters()
        else:
            self.trainable0 = trainable_tree(self.model)
        if cfg.tp > 1:
            # the megatron split of the frozen base over the inner devices
            # (tp_param_specs dispatches on the BUILT model's family: an
            # hf_checkpoint always builds an encoder)
            specs = tp_param_specs(self.model, {
                s.path: s for s in leaf_specs(self.model)})
            if not any(d is not None for d in specs.values()):
                raise ValueError(
                    "tp > 1 but no parameter matched the tensor-parallel "
                    "layout — model family unsupported for tp")
            tp_linear.shard_base(self.model, specs, self.mesh.devices)
        # the rank mask makes the mean RBLA's; cohort mode's mean is the
        # two-level one, one group per client shard (JAX's hierarchical
        # build, normalized to the plain rule for the robust aggregators):
        # with one client a shard it is the flat mean bit for bit
        groups = (self.mesh.mesh.shape["clients"]
                  if self.sampling and cfg.aggregator == "mean" else 0)
        self.agg = make_aggregator(cfg.aggregator, cfg.aggregator_trim,
                                   hierarchical_groups=groups,
                                   rank_mask=self._rmask)
        progs = cs.build_programs(
            self.model, self.mesh, optimizer=cfg.optimizer,
            learning_rate=cfg.learning_rate,
            max_grad_norm=cfg.max_grad_norm,
            gossip_alpha=cfg.topology.gossip_alpha,
            gossip_steps=cfg.topology.gossip_steps, task=cfg.task,
            compression=cfg.compression, adapters=self.adapters)
        self.progs = progs
        self.local_train = progs.local_train
        self.eval_one = progs.eval_one
        # the device each stacked slot trains on (its dropout generator's):
        # its client shard's first device
        self._slot_devices = (
            [self.device] * self.C if cfg.faithful
            else [self.mesh.train_device(c) for c in range(self.C)])
        # --- update codec; its error-feedback residual is round state,
        # each client shard's rows on its device (ef_residual) ---
        self._comp = cfg.compression if cfg.compression.enabled else None
        self._ef_rows = None
        # cohort mode keeps the residual per registry client on the host
        self._ef_reg = (EFRegistry(self.trainable0)
                        if self.sampling and self._comp is not None
                        else None)
        # --- topology graph (positional over the stacked clients: in
        # cohort mode the network model applies to whoever is sampled) ---
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
                                 max_batches=cfg.max_eval_batches),
            self.device)
        self._static_batches = None  # the partition is round-static

    def _init_adapters(self):
        """The round-0 adapter tree: uniform rank from one generator on the
        LoRA lane; heterogeneous ranks initialize each client at its own
        rank (its own generator), zero-padded to the maximum, and start
        from their RBLA mean (``b`` is zero everywhere, so it blends the
        per-rank-scaled ``a`` factors)."""
        cfg, dev = self.cfg, self.home
        targets = lora_targets(cfg.model)
        ranks = cfg.client_lora_ranks
        if ranks is not None and len(set(ranks)) > 1:
            self._rmask = lora.rank_mask(ranks, device=dev)
            stacked0 = lora.init_lora_ranks(
                lambda c: prng.generator(dev, cfg.seed, prng.LORA_LANE, c),
                self.model, ranks, targets)
            return rank_aware_weighted_mean(
                stacked0, torch.ones((len(ranks),), device=dev), self._rmask)
        return lora.init_lora(prng.generator(dev, cfg.seed, prng.LORA_LANE),
                              self.model, cfg.lora_rank, targets)

    # ----------------------------------------------------------------- utils

    def _cohort_ids(self, rnd: int) -> Optional[np.ndarray]:
        """The round's sampled registry ids (``[C]`` int64), or None when
        sampling is off (the slot is the client id)."""
        if self.sampler is None:
            return self._fixed_ids
        if self._cohort_cache[0] != rnd:
            self._cohort_cache = (rnd, self.sampler.cohort_ids(rnd))
        return self._cohort_cache[1]

    def _client_id(self, rnd: int, pos: int) -> int:
        """Registry id of the client in stacked slot ``pos`` this round."""
        ids = self._cohort_ids(rnd)
        return int(ids[pos]) if ids is not None else pos

    def _round_batches(self, rnd: int):
        cfg = self.cfg
        # cohort mode: the batches depend on who was sampled
        static = (not (cfg.partition.kind == "iid"
                       and cfg.partition.resample_each_round)
                  and not self.sampling)
        if static and self._static_batches is not None:
            return self._static_batches
        ids = self._cohort_ids(rnd)
        tree, n_ex = client_batches(self.cache, self.partitioner,
                                    ids if ids is not None else self.C,
                                    rnd, cfg.batch_size,
                                    max_batches=cfg.max_local_batches)
        # on this process's own device: every process of a pod draws them
        out = (_to_device(tree, self.home), np.asarray(n_ex))
        if static:
            self._static_batches = out
        return out

    def _generators(self, rnd: int):
        # keyed by registry id in cohort mode, never by slot
        # only for the clients this process trains (a pod's others: None)
        ids = self._cohort_ids(rnd)
        ids = range(self.C) if ids is None else ids
        own = self.local_train.owned_clients()
        gens = [None] * self.C
        for c, g in zip(own, prng.client_round_generators(
                self.cfg.seed, [int(ids[c]) for c in own], rnd,
                [self._slot_devices[c] for c in own])):
            gens[c] = g
        return gens

    def _uniforms(self, rnd: int) -> Optional[cc.Uniforms]:
        if self._comp is None or not self._comp.stochastic:
            return None
        first = int(self._fixed_ids[0]) if self._fixed_ids is not None else 0
        return prng.codec_uniforms(self.cfg.seed, rnd, first)

    def ef_residual(self) -> Optional[Dict[str, torch.Tensor]]:
        """The codec's error-feedback residual as one ``[C, ...]`` float32
        tree on the lead device, in client order (None without a codec,
        and before the run sets it): each client shard's rows gathered
        from its device. On a pod every process lands its rows, and only
        the lead's process gets the tree (None elsewhere)."""
        if self._ef_rows is None:
            return None
        return self.local_train.rows_on_lead(self._ef_rows)

    def set_ef_residual(self, tree: Optional[Dict[str, torch.Tensor]]):
        """Adopt a ``[C, ...]`` residual (a restored checkpoint's, a dist
        peer's fresh one): each client shard's rows, as float32, on its
        device."""
        self._ef_rows = (None if tree is None
                         else cs.split_rows(tree, self.local_train.rows()))

    def _sender(self, rnd: int) -> Optional[cs.Sender]:
        """The round's sender stage on the client shards' devices (None
        without a codec or on one shard: the exchange encodes the landed
        stack on the lead device)."""
        if self._comp is None or cs._shards(self.local_train) is None:
            return None
        return cs.Sender(self._comp, list(self._ef_rows), self._uniforms(rnd))

    # ------------------------------------------------- the stacked state

    def _resolved(self, trainable):
        """A consensus view as a tree (:func:`cs.settle`)."""
        return cs.settle(trainable, self.agg)

    def _observed(self, rnd: int) -> bool:
        """Whether anything reads round ``rnd``'s global or consensus view
        after it: the run's last round, an evaluation or a checkpoint."""
        cfg = self.cfg
        return bool(rnd == cfg.num_rounds - 1
                    or (cfg.eval_every and (rnd + 1) % cfg.eval_every == 0)
                    or (cfg.checkpoint_dir and cfg.checkpoint_every
                        and (rnd + 1) % cfg.checkpoint_every == 0))

    def _participation(self, rnd: int, components=None) -> Dict:
        if components is not None:
            # under a partition the filter sees each component's subgraph
            return partitioned_anomaly_filter(
                self.cfg.topology.anomaly_filter, self.graph, components,
                protect=(self.info_source,))
        return anomaly_filter(self.cfg.topology.anomaly_filter, self.graph,
                              protect=(self.info_source,))

    def _transport_scales(self, rnd: int) -> Optional[np.ndarray]:
        """The round's transport-corruption scales for the stacked slots
        (None = clean): the plan draws per registry client and cohort mode
        takes the sampled rows. Every consumer (round bodies, reputation
        evidence) draws through here."""
        row = self.faults.transport_scales(rnd)
        ids = self._cohort_ids(rnd)
        if row is None or ids is None:
            return row
        row = row[ids]
        return row if row.any() else None

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
        return _host_vector(mask, self.device)

    def _weights(self, mask: np.ndarray, n_ex: np.ndarray) -> torch.Tensor:
        w = np.asarray(mask, np.float32) * (
            np.asarray(n_ex, np.float32) if self.cfg.weighted_agg else 1.0)
        if not np.isfinite(w).all():
            raise ValueError(f"non-finite aggregation weights mask={mask!r} "
                             f"n_ex={n_ex!r}")
        return _host_vector(w, self.device)

    def _stats_to_rec(self, rnd: int, stats) -> RoundRecord:
        """The round's record from its ``[C, 3]`` stats: a tensor (read
        back here, waiting for the device) or a fused chunk's host rows."""
        if isinstance(stats, torch.Tensor):
            # waits for the device
            stats = self.local_train.read(lambda: stats.double().cpu())
        s = np.asarray(stats, np.float64)
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
        """Chain one entry per client for the fingerprint rows [C, K],
        keyed by registry id (the slot when sampling is off)."""
        for c in range(self.C):
            self.ledger.append_digest(rnd, self._client_id(rnd, c),
                                      self._entry_digest(kind, fps[c]),
                                      self._client_payload_bytes)
        telemetry.emit("ledger", op="commit", round=int(rnd), n=self.C,
                       chain_len=len(self.ledger), rewrite=False,
                       head8=self.ledger.head.hex()[:16])

    def _ledger_auth_rows(self, rnd: int, kind: str, fps) -> np.ndarray:
        """0/1 auth mask: do the fingerprint rows match the committed chain
        entries for this round?"""
        return np.asarray([
            1.0 if self.ledger.authenticate_digest(
                rnd, self._client_id(rnd, c),
                self._entry_digest(kind, fps[c])) else 0.0
            for c in range(self.C)], np.float32)

    def _ledger_authenticate(self, rnd: int, host) -> np.ndarray:
        """Byte-hash authentication of the host trees that arrived (after
        ``tamper_hook``) against the committed chain: the 0/1 auth mask."""
        tamper = self.faults.host_tamper
        shipped = tamper(rnd, host) if tamper else host
        return np.asarray([
            1.0 if self.ledger.authenticate(
                rnd, c, {p: x[c] for p, x in shipped.items()}) else 0.0
            for c in range(self.C)], np.float32)

    def _ledger_verify(self, rnd: int, stacked, sent=None,
                       kind: str = "stacked") -> np.ndarray:
        """Commit every client's update, then authenticate what arrived;
        returns the 0/1 auth mask. ``stacked`` is the honest tree each
        client COMMITS (the codec payload with ``kind="payload"``);
        ``sent`` (default: the same) is what reached the aggregation point:
        when the fault plan corrupts transport the two differ, and exactly
        the corrupted clients fail. The content digest is the device-side
        fingerprint (only ``[C, K]`` floats reach the host), except under a
        ``tamper_hook``, which tampers host trees and so takes the full
        byte-hash flow."""
        # the device is still training: without the fence its time would
        # be billed to the ledger phase
        self.local_train.fence(stacked if sent is None else sent)
        with self.clock.phase("ledger"):
            if self.faults.host_tamper is not None:
                host = {p: x.cpu() for p, x in stacked.items()}
                for c in range(self.C):
                    self.ledger.append(rnd, c,
                                       {p: x[c] for p, x in host.items()})
                return self._ledger_authenticate(rnd, host)
            fp = self._fingerprint_rows(kind, stacked)
            self._ledger_commit_rows(rnd, kind, fp)
            if sent is None or sent is stacked:
                # the committed buffer IS the aggregated one: recomputing
                # the fingerprint would give the same bits
                return self._ledger_auth_rows(rnd, kind, fp)
            fp_recv = self.local_train.read(
                lambda: fp_lib.client_fingerprint(sent).cpu().numpy())
            return self._ledger_auth_rows(rnd, kind, fp_recv)

    def _exchange_updates(self, rnd: int, new_t, ref_t, scales,
                          mode: str, commit: bool = True,
                          sender: Optional[cs.Sender] = None
                          ) -> ExchangeResult:
        """The update-exchange seam: the codec encode (``mode``: "global"
        = delta vs the global, "local" = vs the stacked round-start tree,
        "async" = recon-free), the simulated transport (``scales``: the
        round's corruption, None = clean), then the ledger's commit of what
        was sent and verify of what arrived. ``commit=False`` (the dist
        wire) skips the inline chain and returns the fingerprint rows of
        ``sent`` instead, for the caller to announce to a remote leader,
        which commits them and re-verifies what arrived. A ``sender`` that
        ran on the client shards brings the encoded payload and the new
        residual rows; ``new_t`` is then None in "global" mode (no tree
        landed), and the reconstruction is decoded here from what
        arrived."""
        if self._comp is None:
            sent = self._transport(new_t, scales)
            auth = fp = None
            if self.ledger is not None:
                seen, seen_sent = cs.landed(
                    new_t, sent, lambda t: self._transport(t, scales))
                if commit:
                    auth = self._ledger_verify(rnd, seen, seen_sent)
                else:
                    fp = self._fingerprint_rows("stacked", seen_sent)
            return ExchangeResult(sent=sent, recon=sent, auth=auth, fp=fp,
                                  wire_kind="stacked")
        recon = None
        if sender is not None:
            payload = sender.payload
            self._ef_rows = sender.resid
        elif mode == "async":
            payload, ef = cs.encode_deltas_async(
                self._comp, new_t, ref_t, self.ef_residual(),
                self._uniforms(rnd), self._rmask)
            self.set_ef_residual(ef)
        else:
            payload, recon, ef = cs.encode_deltas(
                self._comp, new_t, ref_t, self.ef_residual(),
                self._uniforms(rnd), self._rmask)
            self.set_ef_residual(ef)
        self._check_payload(payload)
        sent = payload
        if scales is not None:
            sent = cc.corrupt_payload(payload, self._scales_tensor(scales))
        if mode != "async" and (recon is None or sent is not payload):
            # the shards' payload is decoded where it arrived, each shard's
            # rows of a stack kept on the shards on that shard, and a
            # corrupted wire yields a corrupted reconstruction: decode the
            # TRANSPORTED payload
            recon = cs.decode_arrived(self._comp, sender, sent, ref_t, new_t,
                                      self.C)
        auth = fp = None
        if self.ledger is not None:
            if commit:
                auth = self._ledger_verify(rnd, payload, sent, kind="payload")
            else:
                fp = self._fingerprint_rows("payload", sent)
        return ExchangeResult(sent=sent, recon=recon, auth=auth, fp=fp,
                              wire_kind="payload")

    def _fingerprint_rows(self, kind: str, tree) -> np.ndarray:
        """The ``[C, K]`` fingerprint rows of a stacked tree of ``kind``,
        on the host; the first tree of a kind fixes its structure
        digest."""
        self.local_train.fence(tree)
        if kind not in self._struct_cache:
            self._struct_cache[kind] = fp_lib.struct_digest(
                tree, self.cfg.ledger.use_native)
        return self.local_train.read(
            lambda: fp_lib.client_fingerprint(tree).cpu().numpy())

    def _scales_tensor(self, scales: np.ndarray) -> torch.Tensor:
        return _host_vector(scales, self.device)

    def _transport(self, stacked, scales):
        """Simulated transport of the stacked updates: the tree that
        arrives is ``stacked + scales[c]`` per client (each shard's rows
        where they are), the same buffer when ``scales`` is None."""
        if scales is None:
            return stacked
        return cs.transport(stacked, self._scales_tensor(scales))

    # ----------------------------------------------------------- round bodies

    def _server_round(self, rnd: int, trainable, mask: np.ndarray):
        # train -> (ledger commit) -> transport -> (ledger verify) ->
        # aggregate what arrived; all rejected keeps the starting params.
        # Without the ledger a corrupted update reaches the aggregation
        # rule, and the robust aggregators are the defense there.
        batches, n_ex = self._round_batches(rnd)
        sender = self._sender(rnd)
        new_t, stats = cs.train_clients(self.local_train, trainable, batches,
                                        self._generators(rnd), self._rmask,
                                        sender)
        ex = self._exchange_updates(rnd, new_t, trainable,
                                    self._transport_scales(rnd),
                                    mode="global", sender=sender)
        del new_t
        auth = ex.auth
        if auth is not None:
            mask = mask * auth
        trainable = cs.collapse(ex.recon, self._weights(mask, n_ex),
                                trainable, self.agg, sh=self.local_train)
        del ex
        # the record reads the stats back: after the aggregate is queued
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
        sender = self._sender(rnd)
        new_t, stats = cs.local_updates(self.local_train, stacked, batches,
                                        self._generators(rnd), self._rmask,
                                        sender)
        ex = self._exchange_updates(rnd, new_t, start,
                                    self._transport_scales(rnd), mode="local",
                                    sender=sender)
        auth = ex.auth
        if auth is not None:
            mask = mask * auth
        m = self._mask_tensor(mask)
        if ex.recon is not new_t:
            stacked = cs.mix_recv(new_t, ex.recon, m, start, alpha, steps,
                                  self.agg)
        else:
            stacked = cs.mix(new_t, m, start, alpha, steps, self.agg)
        del new_t, ex, start
        # consensus view for eval and checkpoint (the masked aggregate)
        consensus = cs.consensus(stacked, mask, m, prev_consensus, self.agg)
        rec = self._stats_to_rec(rnd, stats)
        if auth is not None:
            rec.auth = auth.tolist()
        self._note_degraded(rec, mask)
        return stacked, consensus, rec

    def _partitioned_round(self, rnd: int, trainable, stacked,
                           mask: np.ndarray, comps):
        """One round under a network partition: every client trains, but
        aggregation runs PER CONNECTED COMPONENT through the configured
        aggregator, and only a component's members adopt its aggregate
        (serverless: only its participating members). ``trainable``
        becomes the aggregate across the components (over the per-client
        component models, weighted by participation): the span's eval and
        checkpoint view and what the heal round reconciles onto. A fully
        eliminated component keeps its previous model. The wire quantity
        is the encoded delta vs each client's round-start params
        (``mode="local"``) under a codec, the stacked tree otherwise."""
        cfg = self.cfg
        C = self.C
        batches, n_ex = self._round_batches(rnd)
        # the fallback of the components' aggregates (the last span
        # round's consensus)
        trainable = self._resolved(trainable)
        if stacked is None:
            # span entry from server mode: every client starts the span
            # from the last whole global
            stacked = cs.client_stack(self.local_train, trainable, self.C)
        start = stacked
        sender = self._sender(rnd)
        stacked, stats = cs.local_updates(self.local_train, stacked, batches,
                                          self._generators(rnd), self._rmask,
                                          sender)
        rec = self._stats_to_rec(rnd, stats)
        ex = self._exchange_updates(rnd, stacked, start,
                                    self._transport_scales(rnd), mode="local",
                                    sender=sender)
        agg_src, auth = ex.recon, ex.auth
        if auth is not None:
            rec.auth = auth.tolist()
            mask = mask * auth
        w = np.asarray(mask, np.float32) * (
            np.asarray(n_ex, np.float32) if cfg.weighted_agg else 1.0)
        part_id = np.full((C,), -1, np.int64)
        out = stacked
        # the components' aggregates read the received rows, landed once
        landed = None
        for ci, comp in enumerate(comps):
            cm = np.zeros((C,), np.float32)
            cm[list(comp)] = 1.0
            part_id[list(comp)] = ci
            wc = w * cm
            if float(wc.sum()) <= 0.0:
                # fully eliminated component: in server mode its members
                # keep the component's round-start model; serverless
                # members keep their own post-train state
                if cfg.mode == "server":
                    out = cs.keep_rows(out, start, self._mask_tensor(cm))
                logger.warning(
                    "round %d: partition component %d fully eliminated — "
                    "keeping its previous model", rnd, ci)
                continue
            if landed is None:
                landed = cs.gathered(agg_src)
            comp_agg = cs.collapse(landed, self._mask_tensor(wc), trainable,
                                   self.agg)
            pull = cm if cfg.mode == "server" else cm * (np.asarray(mask) > 0)
            out = cs.adopt(out, comp_agg, self._mask_tensor(pull))
        del ex, agg_src, landed
        consensus = cs.consensus(out, w, self._mask_tensor(w), trainable,
                                 self.agg)
        rec.partition = part_id.tolist()
        self._note_degraded(rec, mask)
        return consensus, out, rec

    def _heal_partition(self, trainable, stacked, mask: np.ndarray):
        """First whole round after a partition span: the aggregate across
        the components that the last partitioned round computed becomes the
        starting point. Server mode resumes from it (the per-component view
        is dropped); serverless participants adopt it into their carried
        state."""
        trainable = self._resolved(trainable)
        if self.cfg.mode == "server":
            return trainable, None
        pull = (np.asarray(mask) > 0).astype(np.float32)
        return trainable, cs.adopt(stacked, trainable,
                                   self._mask_tensor(pull))

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
        shared, snapshots, fps, host_snaps, stats = trainable, [], [], [], []
        fp_mode = self.ledger is not None and self.faults.host_tamper is None
        for c in range(self.C):
            shared, st = self.local_train(
                shared, {k: v[c] for k, v in batches.items()}, gens[c])
            if fp_mode:
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
            elif self.ledger is not None:
                # a tamper_hook tampers host trees: the byte-hash flow
                with self.clock.phase("ledger"):
                    snap = {p: x.cpu() for p, x in shared.items()}
                    self.ledger.append(rnd, c, snap)
                    host_snaps.append(snap)
            snapshots.append(shared)
            stats.append(st)
        rec = self._stats_to_rec(rnd, torch.stack(stats))
        w = np.asarray(mask, np.float32)
        if self.ledger is not None:
            with self.clock.phase("ledger"):
                if fp_mode:
                    auth = self._ledger_auth_rows(rnd, "one", fps)
                else:
                    auth = self._ledger_authenticate(rnd, {
                        p: torch.stack([h[p] for h in host_snaps])
                        for p in host_snaps[0]})
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
                     st: Dict, delays: Optional[np.ndarray] = None):
        """One buffered-async aggregation event (FedBuff-style): the K
        earliest-finishing clients merge their local DELTAS, each decayed
        by ``staleness_decay ** staleness``, through the configured
        aggregator; the global takes an ``async_server_lr`` step along the
        merged delta, and the arrived clients adopt it. The others keep
        training on their stale base. Straggler ``delays`` (the run loop's
        draw) push an affected client's completion later on the clock."""
        cfg = self.cfg
        K = cfg.async_buffer or self.C
        if stacked is None:
            stacked = cs.client_stack(self.local_train, trainable, self.C)
        base = stacked  # each client's round-start params (delta reference)
        batches, n_ex = self._round_batches(rnd)
        sender = self._sender(rnd)
        stacked, stats = cs.local_updates(self.local_train, stacked, batches,
                                          self._generators(rnd), self._rmask,
                                          sender)
        rec = self._stats_to_rec(rnd, stats)
        if delays is None:
            delays = self.faults.straggler_delays(rnd)
        if delays is not None:
            st["next_done"] = st["next_done"] + delays
            rec.straggler_s = delays.tolist()
        # the transmitted quantity is the delta (the encoded delta payload
        # with a codec), which transport may corrupt; each client's own
        # carried state stays its honest post-train tree
        ex = self._exchange_updates(rnd, stacked, base,
                                    self._transport_scales(rnd),
                                    mode="async", sender=sender)
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
            deltas = cs.arrived_deltas(self._comp, ex.sent, base, stacked)
            del ex, base
            zero = {p: torch.zeros_like(x) for p, x in trainable.items()}
            # collapse normalizes by sum(alpha), which would cancel the
            # staleness decay out of the step: rescale by sum(alpha) /
            # sum(un-decayed weights)
            merged = cs.collapse(
                deltas, torch.as_tensor(alpha, dtype=torch.float32,
                                        device=self.device), zero, self.agg)
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

    # -------------------------------------------------- multi-round fast path

    def _chunk_rounds(self, rnd: int) -> int:
        """How many rounds starting at ``rnd`` fuse into one chunk.

        Only where the host has nothing to do between rounds: sync server
        FedAvg or sync parallel serverless gossip (not the faithful
        host-sequential mode), no tamper hook, no fault plan, no
        reputation (its state machine gates each next round), no cohort
        sampling (each round a new cohort, its residual rows gathered and
        scattered on the host) and no anomaly filter (the mask is all
        ones). The ledger does not block fusion: the chunk commits every
        client's fingerprint before a transport stage, fingerprints what
        arrived after it, gates the aggregation by comparing the two on the
        device, and the chain authenticates the received rows after the
        chunk. A chunk never crosses an eval or checkpoint boundary, so
        the observable cadence is the per-round path's."""
        cfg = self.cfg
        k = cfg.rounds_per_dispatch
        if (k <= 1 or cfg.sync != "sync"
                or (cfg.mode != "server" and cfg.faithful)
                or self.faults.host_tamper is not None
                or self.faults.blocks_fusion()
                or self.reputation is not None
                or self.sampling
                or cfg.topology.anomaly_filter is not None):
            return 1
        k = min(k, cfg.num_rounds - rnd)
        if cfg.eval_every:
            k = min(k, cfg.eval_every - rnd % cfg.eval_every)
        if cfg.checkpoint_dir and cfg.checkpoint_every:
            k = min(k, cfg.checkpoint_every - rnd % cfg.checkpoint_every)
        return max(k, 1)

    def _chunk_corrupts(self, rnd: int, k: int) -> np.ndarray:
        """``[k, C]`` transport-corruption scales of the chunk's rounds
        from ``fused_tamper`` (zeros: clean)."""
        corr = np.zeros((k, self.C), np.float32)
        if self.faults.fused_tamper is not None:
            for i in range(k):
                row = self.faults.fused_tamper(rnd + i)
                if row is not None:
                    corr[i] = np.asarray(row, np.float32)
        return corr

    def _chunk_inputs(self, rnd: int, k: int):
        """The chunk's :class:`~bcfl_tpu_torch.fed.client_step.RoundIn`,
        one round at a time as the chunk reaches it: the round's batches,
        generators and codec uniforms as the per-round path draws them,
        the all-ones mask (as aggregation weights in server mode), and
        the round's transport scales (None when clean)."""
        ones = np.ones((self.C,), np.float32)
        corrupts = self._chunk_corrupts(rnd, k)
        for i in range(k):
            r = rnd + i
            batches, n_ex = self._round_batches(r)
            weights = (self._weights(ones, n_ex) if self.cfg.mode == "server"
                       else self._mask_tensor(ones))
            yield cs.RoundIn(
                batches, weights, self._generators(r), self._uniforms(r),
                self._scales_tensor(corrupts[i]) if corrupts[i].any()
                else None)

    def _chunk_check(self, payload: dict) -> None:
        """Every chunk round's payload: the byte accounting, and the first
        one of the run fixes the ledger's payload structure digest."""
        self._check_payload(payload)
        if self.ledger is not None and "payload" not in self._struct_cache:
            self._struct_cache["payload"] = fp_lib.struct_digest(
                payload, self.cfg.ledger.use_native)

    def _chunk_program(self, prog, carry, rnd: int, k: int) -> cs.ChunkOut:
        with_fp = self.ledger is not None
        if (with_fp and self._comp is None
                and "stacked" not in self._struct_cache):
            self._struct_cache["stacked"] = fp_lib.struct_digest(
                cs.stacked_like(self.trainable0, self.C),
                self.cfg.ledger.use_native)
        # the chunk updates the residual rows' list in place, round by
        # round, so no earlier round's rows stay alive in it
        return prog(carry, self._chunk_inputs(rnd, k), self._ef_rows,
                    agg=self.agg, rmask=self._rmask, with_fp=with_fp,
                    check=self._chunk_check)

    def _server_chunk(self, rnd: int, trainable, k: int):
        """Rounds ``[rnd, rnd + k)`` of server FedAvg as one chunk
        (``server_rounds``): the aggregation weights are ``n_ex`` with
        ``weighted_agg``, else 1, times the device's auth."""
        out = self._chunk_program(self.progs.server_rounds, trainable, rnd,
                                  k)
        return out.carry, out

    def _serverless_chunk(self, rnd: int, stacked, prev_consensus, k: int):
        """Gossip rounds ``[rnd, rnd + k)`` as one chunk
        (``gossip_rounds``). The consensus view is collapsed only when the
        chunk's end is observed (the run's last round, an eval round or a
        checkpoint round); otherwise nothing would read it."""
        out = self._chunk_program(self.progs.gossip_rounds, stacked, rnd, k)
        ones = self._mask_tensor(np.ones((self.C,), np.float32))
        consensus = cs.chunk_consensus(out.carry, ones, prev_consensus,
                                       self._observed(rnd + k - 1), self.agg)
        return out.carry, consensus, out

    @staticmethod
    def _read_chunk(out: cs.ChunkOut) -> Dict[str, np.ndarray]:
        """The chunk's one read-back: its stats ``[k, C, 3]`` and, with the
        ledger, the commit and received fingerprints ``[k, C, K]`` and the
        device's auth ``[k, C]``, in one transfer (all float32)."""
        parts = [out.stats]
        if out.auth is not None:
            parts += [out.fp_commit, out.fp_recv, out.auth[..., None]]
        host = torch.cat(parts, dim=-1).cpu().numpy()  # waits for the device
        rows = {"stats": host[..., :3]}
        if out.auth is not None:
            K = out.fp_commit.shape[-1]
            rows.update(fp_commit=host[..., 3:3 + K],
                        fp_recv=host[..., 3 + K:3 + 2 * K],
                        auth=host[..., -1])
        return rows

    def _commit_chunk_fps(self, rnd: int, rows: Dict[str, np.ndarray],
                          recs) -> None:
        """The chunk's ledger flow: chain every round's commit
        fingerprints (taken before the transport stage), then authenticate
        the received ones against the chain. Under ``fused_tamper`` the two
        differ for exactly the corrupted clients; the device's auth, which
        already gated the aggregation, must be the chain's row for row."""
        kind = "stacked" if self._comp is None else "payload"
        with self.clock.phase("ledger"):
            for i in range(len(recs)):
                self._ledger_commit_rows(rnd + i, kind, rows["fp_commit"][i])
            for i, rec in enumerate(recs):
                auth = self._ledger_auth_rows(rnd + i, kind,
                                              rows["fp_recv"][i])
                if not np.array_equal(auth, rows["auth"][i]):
                    raise RuntimeError(
                        f"round {rnd + i}: the device's auth "
                        f"{rows['auth'][i].tolist()} is not the chain's "
                        f"{auth.tolist()}")
                rec.auth = auth.tolist()
                self._note_degraded(rec, auth)

    def _annotate_chunk(self, recs, wall: float) -> None:
        """The participation and information passing fields of fused
        rounds (an all-ones mask by construction). The measured unit is
        the chunk: ``wall_chunk_s`` its wall, ``wall_s`` an even split of
        it, ``fused`` marking both as the chunk's."""
        sync_t, async_t = self.graph.info_passing_time(
            0.0, source=self.info_source, anomalies=(),
            payload_bytes=self._comms_payload_bytes())
        for rec in recs:
            rec.mask = [1.0] * self.C
            rec.anomalies = []
            rec.info_passing_sync_s = sync_t
            rec.info_passing_async_s = async_t
            rec.fused = True
            rec.wall_chunk_s = wall
            rec.wall_s = wall / len(recs)

    def _run_chunk(self, rnd: int, k: int, trainable, stacked, metrics,
                   on_round):
        """Rounds ``[rnd, rnd + k)`` as one chunk, then their records, the
        ledger, eval and checkpoint at the chunk's last round, telemetry
        and ``on_round``. The wall ends at the fence on the chunk's final
        tree; the ledger's host work after it is not in it."""
        t0 = time.perf_counter()
        with self.clock.phase("round_program"):
            if self.cfg.mode == "server":
                trainable, out = self._server_chunk(rnd, trainable, k)
            else:
                stacked, trainable, out = self._serverless_chunk(
                    rnd, stacked, trainable, k)
            rows = self._read_chunk(out)
            del out
            self.local_train.fence(trainable, stacked)
        wall = time.perf_counter() - t0
        recs = [self._stats_to_rec(rnd + i, rows["stats"][i])
                for i in range(k)]
        if self.ledger is not None:
            self._commit_chunk_fps(rnd, rows, recs)
        self._annotate_chunk(recs, wall)
        last = rnd + k - 1
        if self.adapters or self._observed(last):
            trainable = self._resolved(trainable)
        if self.adapters:
            # only the chunk's final global is the host's to read
            recs[-1].effective_rank = self._effective_rank(trainable)
        self._maybe_eval(last, recs[-1], trainable, stacked)
        metrics.rounds.extend(recs)
        self._maybe_checkpoint(last, trainable, stacked)
        for r in recs:
            telemetry.emit("round", round=r.round, wall_s=r.wall_s,
                           fused=True, degraded=r.degraded)
        if on_round is not None:
            for r in recs:
                on_round(r)
        return trainable, stacked

    # -------------------------------------------------------------- evaluate

    def _effective_rank(self, trainable) -> float:
        return self.local_train.read(lambda: float(lora.effective_rank(trainable)))

    def _maybe_eval(self, rnd: int, rec: RoundRecord, trainable,
                    stacked) -> None:
        cfg = self.cfg
        due = ((rnd + 1) % cfg.eval_every == 0
               or rnd == cfg.num_rounds - 1) if cfg.eval_every else False
        if not due:
            return
        with self.clock.phase("eval"):
            s = self.local_train.read(lambda: self.eval_one(
                trainable, self.eval_batches).double().cpu())
            rec.global_loss = float(s[0] / max(float(s[2]), 1.0))
            rec.global_acc = float(s[1] / max(float(s[2]), 1.0))
            # each client's local accuracy on its own test split: of its
            # own carried tree when clients carry one (serverless, async),
            # of the global otherwise
            ids = self._cohort_ids(rnd)
            tb, _ = client_batches(self.cache, self.partitioner,
                                   ids if ids is not None else self.C, rnd,
                                   cfg.batch_size,
                                   max_batches=cfg.max_local_batches,
                                   split="test")
            tb = _to_device(tb, self.home)
            local = cs.eval_clients(self.eval_one, stacked, trainable, tb)
            local = self.local_train.read(lambda: local.double().cpu().numpy())
            rec.local_acc = (local[:, 1] / np.maximum(local[:, 2], 1)).tolist()

    # ------------------------------------------------------ reputation bridge

    def _reputation_observe(self, rnd: int, rec: RoundRecord,
                            gate: Dict) -> None:
        """Fold this round's evidence into the tracker and record the
        post-round states: ledger-auth failures, anomaly flags, the plan's
        injected corruption hits and async staleness beyond the limit,
        each weighted by the config and combined per client by max."""
        rcfg = self.cfg.reputation
        fault = np.zeros((self.C,), np.float64)
        if rec.auth is not None:
            failed = (np.asarray(rec.auth, np.float64) == 0.0)
            fault = np.maximum(fault, rcfg.w_auth * failed)
        if gate["anomalies"]:
            flag = np.zeros((self.C,), np.float64)
            flag[list(gate["anomalies"])] = 1.0
            fault = np.maximum(fault, rcfg.w_anomaly * flag)
        if rcfg.observe_injected:
            scales = self._transport_scales(rnd)  # deterministic redraw
            if scales is not None:
                hit = (np.asarray(scales, np.float64) != 0.0)
                fault = np.maximum(fault, rcfg.w_corrupt * hit)
        if rec.staleness is not None and rcfg.staleness_limit > 0:
            stale = (np.asarray(rec.staleness, np.float64)
                     > rcfg.staleness_limit)
            fault = np.maximum(fault, rcfg.w_staleness * stale)
        ids = self._cohort_ids(rnd)
        if ids is None:
            self.reputation.observe(fault)
            rec.reputation_state = self.reputation.state_names()
            rec.reputation_trust = [float(t) for t in self.reputation.trust]
            return
        # cohort mode: the cohort's evidence lands on its registry rows;
        # only sampled clients are active (their trust and probation
        # advance, quarantine sentences tick for all); the record holds
        # the cohort's view, slot-aligned with mask and auth
        fault_r = np.zeros((self.R,), np.float64)
        fault_r[ids] = fault
        active = np.zeros((self.R,), bool)
        active[ids] = True
        self.reputation.observe(fault_r, active=active)
        names = self.reputation.state_names()
        rec.reputation_state = [names[int(i)] for i in ids]
        rec.reputation_trust = [float(self.reputation.trust[int(i)])
                                for i in ids]

    # ------------------------------------------------------------------- run

    def run(self, resume: bool = False,
            on_round: Optional[Callable[[RoundRecord], None]] = None
            ) -> RunResult:
        """Run the rounds; ``on_round(record)`` is called after each
        round's record is complete. ``resume=True`` restores the newest
        valid checkpoint of ``cfg.checkpoint_dir`` (if any) and runs the
        rounds after it. With ``cfg.telemetry_dir`` naming a directory the
        run streams its events into ``events_engine.jsonl`` there (phases,
        rounds, ledger commits, reputation, checkpoints), closed with the
        run's status even when it crashes."""
        cfg = self.cfg
        if self._pod and resume:
            raise ValueError(
                "resume=True under pod=True is not ported yet: the "
                "error-feedback rows of other processes' shards would have "
                "to be gathered")
        installed = None
        if (cfg.telemetry_dir and cfg.telemetry_dir != "off"
                and process_index() == 0):
            installed = telemetry.install(telemetry.EventWriter(
                os.path.join(cfg.telemetry_dir, "events_engine.jsonl"),
                peer=None, run=cfg.name, sample=cfg.telemetry_sample))
            telemetry.emit("run.start", role="engine", resume=resume,
                           clients=self.C, rounds=cfg.num_rounds)
        status = "crashed"
        try:
            out = self._run(resume, on_round)
            status = "ok"
            return out
        finally:
            if installed is not None:
                telemetry.emit("run.end", status=status)
                telemetry.uninstall()

    def _run(self, resume: bool,
             on_round: Optional[Callable[[RoundRecord], None]]) -> RunResult:
        cfg = self.cfg
        monitor = ResourceMonitor()
        metrics = RunMetrics()
        clock = self.clock = StepClock()
        start_round = 0
        trainable = self.trainable0
        stacked = None
        restored = None
        self._ef_rows = None
        if resume and cfg.checkpoint_dir:
            with clock.phase("restore"):
                restored = restore_latest(cfg.checkpoint_dir)
                if restored is not None:
                    start_round, trainable, stacked = self._restore(restored)
        if (self._comp is not None and self._ef_rows is None
                and self._ef_reg is None):
            # cohort mode gathers each round's rows from the registry
            self._ef_rows = [cc.zero_residual(trainable, b - a, d)
                             for a, b, d in self.local_train.rows()]
        if cfg.mode == "serverless" and not cfg.faithful and stacked is None:
            stacked = cs.client_stack(self.local_train, trainable, self.C)
        # built after the restore, as in the JAX engine: a resumed async
        # run restarts its simulated network clock
        async_state = (self._init_async_state() if cfg.sync == "async"
                       else None)
        rnd = start_round
        while rnd < cfg.num_rounds:
            if restored is None and self.faults.should_crash(rnd):
                # the plan's host crash, before anything of round `rnd`
                # runs; it models ONE failure, so a run that restored a
                # checkpoint does not fire it again (a standing resume over
                # an empty directory still crashes)
                raise SimulatedCrash(rnd)
            chunk = self._chunk_rounds(rnd)
            if chunk > 1:
                trainable, stacked = self._run_chunk(
                    rnd, chunk, trainable, stacked, metrics, on_round)
                rnd += chunk
                continue
            if (self.faults.fused_tamper is not None
                    and self.faults.fused_tamper(rnd) is not None):
                # the transport corruption exists only inside a fused
                # chunk: on a per-round round it would be silently ignored
                # and a verification would pass vacuously
                raise ValueError(
                    f"fused_tamper requests corruption for round {rnd}, but "
                    "this round runs the per-round path (chunk=1: check "
                    "rounds_per_dispatch, eval/checkpoint boundaries, and "
                    "_chunk_rounds eligibility) — the corruption would be "
                    "silently ignored; use tamper_hook for per-round "
                    "tampering")
            t0 = time.perf_counter()
            ids = self._cohort_ids(rnd)
            comps = self.faults.partition_components(rnd)
            with clock.phase("control_plane"):
                gate = self._participation(rnd, comps)
                mask = gate["mask"].astype(np.float32)
                # dropout, churn and the reputation gate compose with the
                # anomaly gate: excluded clients carry weight 0 (probation
                # a reduced weight); every lane draws per registry client
                # and cohort_view takes the sampled rows
                keep = cohort_view(self.faults.dropout_keep(rnd), ids)
                dropped = None
                if keep is not None:
                    # slot indices, as every per-client list of the record;
                    # rec.cohort[slot] maps back to the registry
                    dropped = [c for c in range(self.C) if keep[c] == 0.0]
                    mask = mask * keep
                alive = cohort_view(self.faults.churn_alive(rnd), ids)
                if alive is not None:
                    mask = mask * alive
                if self.reputation is not None:
                    mask = mask * cohort_view(self.reputation.gate(), ids)
                healed = False
                if (comps is None and stacked is not None and rnd > 0
                        and self.faults.partition_components(rnd - 1)
                        is not None):
                    # a partition span just ended: reconcile (derived from
                    # the plan, so a resumed run heals at the same round)
                    trainable, stacked = self._heal_partition(
                        trainable, stacked, mask)
                    healed = True
            delays = cohort_view(self.faults.straggler_delays(rnd), ids)
            if delays is not None and not delays.any():
                delays = None  # no sampled client straggles this round
            if self._ef_reg is not None:
                # the cohort's residual rows (zeros for a client never
                # sampled), each shard's straight to its device
                self._ef_rows = [self._ef_reg.gather(ids[a:b], d)
                                 for a, b, d in self.local_train.rows()]
            with clock.phase("round_program"):
                if comps is not None:
                    trainable, stacked, rec = self._partitioned_round(
                        rnd, trainable, stacked, mask, comps)
                elif cfg.sync == "async":
                    trainable, stacked, rec = self._async_round(
                        rnd, trainable, stacked, mask, async_state,
                        delays=delays)
                elif cfg.mode == "server":
                    trainable, rec = self._server_round(rnd, trainable, mask)
                elif cfg.faithful:
                    trainable, rec = self._faithful_round(rnd, trainable,
                                                          mask)
                else:
                    stacked, trainable, rec = self._serverless_round(
                        rnd, stacked, trainable, mask)
            if self._ef_reg is not None:
                # back by registry id before eval and checkpoint, so the
                # checkpointed store is the uninterrupted run's
                for (a, b, _), rows in zip(self.local_train.rows(),
                                           self._ef_rows):
                    self._ef_reg.scatter(ids[a:b], rows)
            rec.mask = mask.tolist()
            if ids is not None:
                rec.cohort = ids.tolist()
            rec.anomalies = list(gate["anomalies"])
            rec.healed = healed
            if dropped is not None:
                rec.dropped = dropped
            if alive is not None:
                rec.churn_alive = alive.tolist()
            if delays is not None:
                rec.straggler_s = delays.tolist()
            # information passing: under a partition the source informs
            # only its own component; churned-out clients are no targets
            # (the source itself always stays in the set)
            restrict = None
            if comps is not None:
                restrict = list(next(
                    c for c in comps if self.info_source in c))
            if alive is not None:
                base = restrict if restrict is not None else range(self.C)
                restrict = [c for c in base
                            if alive[c] > 0 or c == self.info_source]
            sync_t, async_t = self.graph.info_passing_time(
                0.0, source=self.info_source, anomalies=gate["anomalies"],
                extra_delay=delays,
                payload_bytes=self._comms_payload_bytes(), restrict=restrict)
            rec.info_passing_sync_s = sync_t
            rec.info_passing_async_s = async_t
            self.local_train.fence(trainable, stacked)
            rec.wall_s = time.perf_counter() - t0
            if self.adapters or self._observed(rnd):
                trainable = self._resolved(trainable)
            if self.adapters:
                # the rank-collapse guard over the global adapters
                rec.effective_rank = self._effective_rank(trainable)
            if self.reputation is not None:
                # before eval and checkpoint, so the checkpointed tracker
                # matches the uninterrupted run's at every boundary
                self._reputation_observe(rnd, rec, gate)
            self._maybe_eval(rnd, rec, trainable, stacked)
            metrics.rounds.append(rec)
            self._maybe_checkpoint(rnd, trainable, stacked)
            telemetry.emit("round", round=rnd, wall_s=rec.wall_s,
                           degraded=rec.degraded, healed=rec.healed,
                           partitioned=rec.partition is not None)
            if on_round is not None:
                on_round(rec)
            rnd += 1
        trainable = self._resolved(trainable)
        # on a pod every process ends holding the lead's final global
        trainable = self.local_train.share(trainable, self.home)
        if self.adapters:
            # the model computes with the final global adapters
            lora.attach(self.model, trainable)
        else:
            load_trainable(self.model, trainable)
        metrics.model_size_gb = model_size_gb(
            dict(self.model.named_parameters()))
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
        if self.reputation is not None:
            metrics.reputation = self.reputation.summary()
        return RunResult(metrics=metrics, trainable=trainable,
                         model=self.model, ledger=self.ledger,
                         ef_residual=self.ef_residual(), stacked=stacked)

    # ------------------------------------------------------ checkpoint/resume

    def _lora_format(self) -> str:
        """The LoRA layout's identity: ``full`` (no adapters), ``r<k>``
        (uniform) or ``ranks:<per-client spec>``."""
        cfg = self.cfg
        if cfg.lora_rank <= 0:
            return "full"
        ranks = cfg.client_lora_ranks
        if ranks is None or len(set(ranks)) <= 1:
            return f"r{cfg.lora_rank}"
        return "ranks:" + ",".join(str(r) for r in ranks)

    def _identity(self) -> Dict[str, np.ndarray]:
        """What a checkpoint records of the run's identity, checked on
        resume: the seed, the codec's wire format, the PRNG scheme, the
        LoRA layout and the cohort sizes."""
        return {
            "seed": np.int64(self.cfg.seed),
            "compress_format": _text(cc.wire_format(self._comp)),
            "prng_impl_name": _text(self._prng_name),
            "lora_format": _text(self._lora_format()),
            "registry_size": np.int64(self.cfg.registry_size),
            "sample_clients": np.int64(self.C if self.sampling else 0),
        }

    def _restore(self, restored):
        """Adopt a restored checkpoint after its guards: returns ``(first
        round to run, trainable, stacked)`` and restores the error-feedback
        residual, the reputation tracker and the ledger."""
        cfg = self.cfg
        rnd, state, ledger_json = restored
        name = state.get("prng_impl_name")
        if name is not None and _untext(name) != self._prng_name:
            raise ValueError(
                f"checkpoint PRNG scheme {_untext(name)!r} != this run's "
                f"{self._prng_name!r}: resuming would change the RNG stream")
        ck_comp = state.get("compress_format")
        if ck_comp is not None:
            here = cc.wire_format(self._comp)
            if _untext(ck_comp) != here:
                raise ValueError(
                    f"checkpoint was written with compress="
                    f"{_untext(ck_comp)!r} but this run has {here!r}: "
                    "resuming would change the wire format under the "
                    "carried error-feedback state")
        ck_lora = state.get("lora_format")
        here = self._lora_format()
        if ck_lora is not None and _untext(ck_lora) != here:
            raise ValueError(
                f"checkpoint was written with LoRA layout "
                f"{_untext(ck_lora)!r} but this run has {here!r}: resuming "
                "would reinterpret the checkpointed adapter (and "
                "error-feedback) trees under a different rank layout")
        ck_seed = state.get("seed")
        if ck_seed is not None and int(ck_seed) != cfg.seed:
            raise ValueError(
                f"checkpoint was written with seed {int(ck_seed)} but "
                f"config has seed {cfg.seed}: resuming would break the "
                "per-(client, round) RNG stream")
        # the sampler is a pure function of (seed, registry_size,
        # sample_clients, round): with the seed these pin every remaining
        # round's cohort
        ck_reg = state.get("registry_size")
        want_sc = self.C if self.sampling else 0
        if ck_reg is not None:
            ck_sc = int(state.get("sample_clients", 0))
            if int(ck_reg) != cfg.registry_size or ck_sc != want_sc:
                raise ValueError(
                    "checkpoint was written with registry_size="
                    f"{int(ck_reg)}/sample_clients={ck_sc} but this run "
                    f"has {cfg.registry_size}/{want_sc}: resuming would "
                    "change the per-round cohort stream")
        elif self.sampling:
            raise ValueError(
                "checkpoint predates cohort mode (no registry_size "
                "recorded) but this run samples a registry: resuming "
                "would change every remaining round's cohort")
        # floats take the configured param dtype, whatever wrote them
        pd = DTYPES[cfg.param_dtype]

        def cast(tree):
            return {p: (x.to(self.device, pd) if x.is_floating_point()
                        else x.to(self.device)) for p, x in tree.items()}

        trainable = cast(state["trainable"])
        stacked = (cast(state["stacked"]) if state.get("stacked") is not None
                   else None)
        if stacked is not None:
            # the [C, ...] rows back onto however many shards this run has
            stacked = cs.restack(self.local_train, stacked)
        if state.get("ef_residual") is not None and self._comp is not None:
            # the residual travels with the checkpoint: a compressed resume
            # re-injects exactly what the uninterrupted run would carry,
            # on however many client shards this run has
            self.set_ef_residual(state["ef_residual"])
        if self._ef_reg is not None:
            # cohort mode: the residuals per registry client (ef_ids,
            # ef_registry); each round gathers its cohort's rows
            self._ef_reg.restore(state)
        if self.reputation is not None and state.get("rep_trust") is not None:
            self.reputation.restore(
                {k: v.numpy() for k, v in state.items()
                 if k.startswith("rep_")})
        if ledger_json and self.ledger is not None:
            self.ledger = Ledger.from_json(ledger_json,
                                           cfg.ledger.use_native)
        return rnd + 1, trainable, stacked

    def _maybe_checkpoint(self, rnd: int, trainable, stacked) -> None:
        cfg = self.cfg
        if not (cfg.checkpoint_dir and cfg.checkpoint_every
                and (rnd + 1) % cfg.checkpoint_every == 0):
            return
        with self.clock.phase("checkpoint"):
            state = {"trainable": self._resolved(trainable),
                     # the [C, ...] bytes whatever the shards
                     "stacked": cs.gathered(stacked),
                     # the error-feedback residual (None without a codec;
                     # cohort mode stores the registry's rows instead of
                     # the last cohort's gathered view)
                     "ef_residual": (self.ef_residual()
                                     if self._ef_reg is None else None)}
            state.update(self._identity())
            if self._ef_reg is not None:
                state.update(self._ef_reg.checkpoint_state())
            if self.reputation is not None:
                # trust, states, timers and counters: the lifecycle resumes
                # exactly where the crash left it
                state.update(self.reputation.checkpoint_state())
            save_checkpoint(cfg.checkpoint_dir, rnd, state,
                            self.ledger.to_json() if self.ledger else None)
