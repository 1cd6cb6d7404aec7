#!/usr/bin/env python3
"""The pod: the clients axis over several processes, each driving its own
cards, against one process over the same client shards (card only for the
layouts; the child mode runs anywhere).

    python3 scripts/pod_axis.py               # on a host with four cards
    python3 scripts/pod_axis.py --child SPEC  # one process of a pod

The parent runs ``chip_smoke.py``'s path (b) configuration (bert-base at
full width and depth, 4 clients, 2 local steps of 32 x 512 tokens of long
documents, flash attention, bf16, ``int8+topk``, server FedAvg) with the
ledger on, ``ROUNDS`` rounds, in three layouts of the same 4 client
shards:

1. one process on ``[cuda:0, ..., cuda:3]`` (the clients axis on one
   host);
2. a pod of 2 processes, each started with its own two cards
   (``CUDA_VISIBLE_DEVICES=0,1`` and ``2,3``);
3. a pod of 4 processes, one card each.

Every layout must give the first one's bits (the global tree, every
round's payload bytes, the ledger head, the per-client stats and
evaluation) and the same kernel launches, summed over its processes: a
layout that differs is named and the script exits 1 after the last. It
prints, per layout, the round walls (process 0's), each card's busy share
over the warm rounds (``nvidia-smi``'s utilization sampled every 100 ms
between the first and the last round's end), the MB each process sent to
and received from the others a round, and the peak memory of every card,
then one JSON line with all of it, beside ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``.

The child mode is one process of a pod (``BCFL_COORDINATOR``,
``BCFL_NUM_PROCESSES``, ``BCFL_PROCESS_ID`` set, as
:func:`bcfl_tpu_torch.parallel.pod.launch` sets them): it joins the pod,
runs each of the spec's runs through ``FedEngine(cfg with pod=True)`` on
its own devices and writes what it saw (:func:`record`) to
``<out>/<label>.rank<p>.pt``. ``chip_smoke.py`` (ac) and
``tests/test_torch_pod.py`` drive it through :func:`run_pod`, and compare
with :func:`one_process` (:func:`differences`).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ROUNDS = 4
#: a child of the pod gives up after this (the build, the model, the runs)
CHILD_DEADLINE_S = 900.0
RECORD_FIELDS = ("train_loss", "train_acc", "local_acc", "global_loss",
                 "global_acc", "mask", "auth", "bytes_on_wire", "degraded")


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's dtype, shape and bytes in row-major order."""
    x = t.detach().contiguous().cpu()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    h = hashlib.sha256(f"{t.dtype}:{tuple(t.shape)}:".encode())
    h.update(x.numpy().tobytes())
    return h.hexdigest()


class Tap:
    """Per round of an engine: the payload's digests and each leaf's
    largest quantization scale, the per-client stats' digest, and the
    bytes that crossed between client shards and processes (read where
    the round's record is made)."""

    def __init__(self, eng):
        self.payloads, self.scales, self.stats, self.traffic = [], [], [], []
        check, to_rec = eng._check_payload, eng._stats_to_rec

        def tap_payload(payload):
            real = not next(iter(next(iter(payload.values())).values())
                            ).is_meta
            self.payloads.append({f"{p}/{k}": digest(x)
                                  for p, parts in payload.items()
                                  for k, x in parts.items()} if real
                                 else None)
            self.scales.append({p: float(parts["s"].max())
                                for p, parts in payload.items()
                                if "s" in parts} if real else None)
            return check(payload)

        def tap_stats(rnd, stats):
            self.stats.append(None if stats.is_meta else digest(stats))
            self.traffic.append(dict(eng.local_train.traffic))
            return to_rec(rnd, stats)

        eng._check_payload, eng._stats_to_rec = tap_payload, tap_stats


def _rows(eng, stacked) -> dict:
    """The digests of each client's row of the final stacked state that
    this process holds (``{client: {leaf: digest}}``)."""
    from bcfl_tpu_torch.fed import client_step as cs

    if stacked is None:
        return {}
    if isinstance(stacked, cs.Stacked):
        sh, per, out = stacked.sh, stacked.sh.per_device, {}
        for s in sh.owned_shards():
            for i in range(per):
                out[s * per + i] = {p: digest(x[i])
                                    for p, x in stacked.rows[s].items()}
        return out
    C = next(iter(stacked.values())).shape[0]
    return {c: {p: digest(x[c]) for p, x in stacked.items()}
            for c in range(C)}


def record(eng, res, tap, marks, save: bool = False) -> dict:
    """What a run shows of itself (one process's view)."""
    from bcfl_tpu_torch.core.mesh import process_index
    from bcfl_tpu_torch.ops import registry

    out = {
        "process": process_index(),
        "trainable": {p: digest(x) for p, x in res.trainable.items()},
        "rows": _rows(eng, res.stacked),
        "payloads": tap.payloads, "scales": tap.scales, "stats": tap.stats,
        "traffic": tap.traffic,
        "records": [{f: getattr(r, f) for f in RECORD_FIELDS + ("wall_s",)}
                    for r in res.metrics.rounds],
        "ledger_head": (res.ledger.head.hex() if res.ledger is not None
                        else None),
        "chain_ok": (res.metrics.ledger or {}).get("chain_ok"),
        "ef": ({p: digest(x) for p, x in res.ef_residual.items()}
               if res.ef_residual is not None else None),
        "launches": registry.launch_counts(),
        "launches_by": {op.name: dict(op.launches_by)
                        for op in registry.kernel_ops()},
        "round_marks": marks,
        "peaks_gb": ({f"p{process_index()}:cuda:{i}":
                      torch.cuda.max_memory_allocated(i) / 1e9
                      for i in range(torch.cuda.device_count())}
                     if torch.cuda.is_available() else {}),
        "shards": len(eng.local_train.bodies),
        "shard_processes": eng.mesh.shard_processes,
    }
    if save:
        out["trainable_t"] = {p: x.detach().cpu()
                              for p, x in res.trainable.items()}
    return out


def _patch_inputs(eng, inputs: dict) -> None:
    """Start ``eng`` from given initial parameters and per-round batches,
    dropout off (the JAX comparison's)."""
    import numpy as np

    home = eng.home
    eng.trainable0 = {p: x.to(home) for p, x in inputs["trainable0"].items()}
    eng._round_batches = lambda rnd: (
        {k: v.to(home) for k, v in inputs["batches"][rnd].items()},
        np.asarray(inputs["n_ex"][rnd]))
    eng._generators = lambda rnd: [None] * eng.C


def _engine_run(cfg, device, devices, save=False, inputs=None, fail=False):
    from bcfl_tpu_torch.fed.engine import FedEngine
    from bcfl_tpu_torch.ops import registry

    eng = FedEngine(cfg, device=device, devices=devices)
    tap = Tap(eng)
    if inputs is not None:
        _patch_inputs(eng, inputs)
    if fail:
        def broken(*args):
            raise RuntimeError("a client shard's body failed")
        eng.local_train.bodies = [broken] * len(eng.local_train.bodies)
    marks = []
    if torch.cuda.is_available():
        torch.cuda.init()  # the allocator's per-card stats exist from here
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)
    registry.reset_launches()
    res = eng.run(on_round=lambda r: marks.append(time.time()))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return record(eng, res, tap, marks, save)


def one_process(cfg, devices, save=False, inputs=None) -> dict:
    """``cfg`` through one engine on ``devices`` in this process: the
    reference a pod over the same client shards must equal."""
    return _engine_run(cfg, None, list(devices), save, inputs)


def child_main(spec_path: str) -> int:
    """One process of a pod: every run of the spec, each record written
    to ``<out>/<label>.rank<p>.pt``."""
    from bcfl_tpu_torch.core.mesh import distributed_init, process_index
    from bcfl_tpu_torch.dist.launch import cfg_from_json

    spec = json.loads(Path(spec_path).read_text())
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    for var in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE"):
        os.environ.setdefault(var, "1")
    if torch.cuda.is_available():
        from bcfl_tpu_torch.ops import codec_kernels, cuda_build  # noqa: F401
        from bcfl_tpu_torch.ops import flash_kernels  # noqa: F401

        cuda_build.build_all()  # the checkout's build, cached by its hash
    distributed_init()
    rank = process_index()
    for run in spec["runs"]:
        cfg = cfg_from_json(run["cfg"]).replace(pod=True)
        inputs = (torch.load(run["inputs"], weights_only=False)
                  if run.get("inputs") else None)
        rec = _engine_run(cfg, run.get("device"), run.get("devices"),
                          run.get("save", False), inputs,
                          fail=rank == spec.get("fail_rank"))
        torch.save(rec, Path(spec["out"]) / f"{run['label']}.rank{rank}.pt")
        print(f"pod process {rank}: {run['label']} done, launches "
              f"{rec['launches']}", flush=True)
    return 0


def run_pod(runs, processes: int, out_dir, env_of=None, fail_rank=None,
            threads=None, deadline_s: float = CHILD_DEADLINE_S) -> dict:
    """``runs`` (``[{"label", "cfg": FedConfig, "devices" or "device"}]``,
    each optionally with ``"save": True`` (keep the final global's
    tensors) and ``"inputs"`` (initial parameters and per-round batches,
    :func:`_patch_inputs`)) as one pod of ``processes`` children of this
    script, under a hard deadline
    (:func:`bcfl_tpu_torch.parallel.pod.launch`); raises when a child
    fails (unless ``fail_rank`` asked one to). Returns ``{label: [each
    process's record]}`` and the launch's ``returncodes``, ``killed``,
    ``wall_s`` and ``logs`` under ``"_launch"``."""
    from bcfl_tpu_torch.dist.launch import cfg_to_json
    from bcfl_tpu_torch.parallel import pod

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = {"out": str(out_dir), "fail_rank": fail_rank, "threads": threads,
            "runs": []}
    for r in runs:
        run = {"label": r["label"], "cfg": cfg_to_json(r["cfg"]),
               "devices": ([str(d) for d in r["devices"]]
                           if r.get("devices") else None),
               "device": r.get("device"), "save": r.get("save", False)}
        if r.get("inputs") is not None:
            run["inputs"] = str(out_dir / f"{r['label']}.inputs.pt")
            torch.save(r["inputs"], run["inputs"])
        spec["runs"].append(run)
    spec_path = out_dir / "spec.json"
    spec_path.write_text(json.dumps(spec))
    res = pod.launch([str(Path(__file__).resolve()), "--child",
                      str(spec_path)], processes, deadline_s, env_of=env_of,
                     log_dir=str(out_dir / "logs"))
    out = {"_launch": res}
    if any(rc != 0 for rc in res["returncodes"]):
        if fail_rank is not None:
            return out
        raise RuntimeError(
            f"pod of {processes}: return codes {res['returncodes']} (killed "
            f"{res['killed']}); last output of each: "
            + " | ".join(t[-1500:] for t in res["logs"]))
    for r in runs:
        out[r["label"]] = [
            torch.load(out_dir / f"{r['label']}.rank{p}.pt",
                       weights_only=False) for p in range(processes)]
    return out


def merged(recs: list) -> dict:
    """A pod's records as one run's: process 0's view (the global, the
    payloads, the stats, the records, the ledger), every process's rows of
    the stack, and the launches summed over the processes. Raises if the
    processes disagree on what every one of them holds."""
    lead = dict(recs[0])
    for r in recs[1:]:
        for key in ("trainable", "ledger_head", "records", "traffic"):
            a, b = lead[key], r[key]
            if key == "records":
                a = [{k: v for k, v in x.items() if k != "wall_s"} for x in a]
                b = [{k: v for k, v in x.items() if k != "wall_s"} for x in b]
            if key == "traffic":
                a = [{k: v for k, v in x.items() if not k.startswith(
                    "process_")} for x in a]
                b = [{k: v for k, v in x.items() if not k.startswith(
                    "process_")} for x in b]
            if a != b:
                raise RuntimeError(f"process {r['process']}'s {key} is not "
                                   "process 0's")
    lead["rows"] = {c: row for r in recs for c, row in r["rows"].items()}
    lead["launches"] = {k: sum(r["launches"][k] for r in recs)
                        for k in recs[0]["launches"]}
    lead["launches_by"] = {
        op: {kind: sum(r["launches_by"][op].get(kind, 0) for r in recs)
             for kind in set().union(*(r["launches_by"][op] for r in recs))}
        for op in recs[0]["launches_by"]}
    lead["process_traffic"] = [r["traffic"] for r in recs]
    return lead


def differences(one: dict, pod: dict) -> list:
    """What a pod's :func:`merged` record shows differently from the one
    process's over the same shards (empty: bit for bit)."""
    bad = []
    for key in ("trainable", "rows", "payloads", "stats", "ledger_head",
                "ef", "launches"):
        if one[key] != pod[key]:
            bad.append(key)
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in one["records"]]
    if strip != [{k: v for k, v in r.items() if k != "wall_s"}
                 for r in pod["records"]]:
        bad.append("records")
    flash = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    if ({k: one["launches_by"][k] for k in flash if k in one["launches_by"]}
            != {k: pod["launches_by"][k] for k in flash
                if k in pod["launches_by"]}):
        bad.append("flash launches by dtype")
    return bad


def per_round(traffic: list, key: str) -> list:
    """Each round's bytes of a cumulative traffic counter."""
    vals = [t[key] for t in traffic]
    return [b - a for a, b in zip([0] + vals[:-1], vals)]


# ------------------------------------------------------------- the card


class Busy:
    """``nvidia-smi``'s utilization of every card (the share of its last
    sample period in which a kernel ran), sampled every 100 ms in a child
    process while a layout runs; :meth:`share` averages each card's
    samples between two wall-clock times."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,index,utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)

    def stop(self):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = []
        for line in out.strip().splitlines():
            stamp, card, util = (x.strip() for x in line.split(","))
            day, frac = stamp.split(".") if "." in stamp else (stamp, "0")
            t = time.mktime(time.strptime(day, "%Y/%m/%d %H:%M:%S"))
            self.samples.append((t + float("0." + frac), int(card),
                                 float(util)))

    def share(self, a: float, b: float) -> dict:
        per: dict = {}
        for t, card, util in self.samples:
            if a <= t <= b:
                per.setdefault(card, []).append(util / 100.0)
        return {c: sum(v) / len(v) for c, v in sorted(per.items())}


def layout(label, cfg, processes, cards_each, out_dir, one=None):
    """``cfg`` in one layout: ``one`` process on ``cards_each`` cards, or
    a pod of ``processes`` processes with ``cards_each`` cards each."""
    busy = Busy()
    t0 = time.perf_counter()
    if processes == 1:
        rec = one_process(cfg, [torch.device("cuda", i)
                                for i in range(cards_each)])
        recs = [rec]
    else:
        got = run_pod(
            [{"label": label, "cfg": cfg, "device": "cuda"}], processes,
            out_dir / label.replace(" ", "_"),
            env_of=lambda p: {"CUDA_VISIBLE_DEVICES": ",".join(
                str(p * cards_each + i) for i in range(cards_each))})
        recs = got[label]
        rec = merged(recs)
    wall = time.perf_counter() - t0
    busy.stop()
    marks = recs[0]["round_marks"]
    share = busy.share(marks[0], marks[-1]) if len(marks) > 1 else {}
    walls = [r["wall_s"] for r in recs[0]["records"]]
    sent = [per_round(r["traffic"], "process_sent") for r in recs]
    received = [per_round(r["traffic"], "process_received") for r in recs]
    out = {"label": label, "processes": processes,
           "cards_per_process": cards_each, "wall_s": wall,
           "round_wall_s": walls,
           "busy_share_warm": {str(k): v for k, v in share.items()},
           "mb_sent_per_round": [[b / 1e6 for b in s] for s in sent],
           "mb_received_per_round": [[b / 1e6 for b in s] for s in received],
           "cross_process_mb_per_round": [
               sum(b) / 1e6 for b in zip(*sent)],
           "peaks_gb": {k: v for r in recs for k, v in r["peaks_gb"].items()},
           "launches": rec["launches"]}
    out["differs_in"] = differences(one, rec) if one is not None else []
    print(f"{label}: {json.dumps(out)}", flush=True)
    return rec, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", help="run as one process of a pod")
    args = ap.parse_args(argv)
    if args.child:
        return child_main(args.child)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("pod_axis: needs four CUDA devices", file=sys.stderr)
        return 2
    import chip_smoke
    from bcfl_tpu_torch.config import LedgerConfig
    from bcfl_tpu_torch.ops import codec_kernels, cuda_build  # noqa: F401
    from bcfl_tpu_torch.ops import flash_kernels  # noqa: F401

    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    cuda_build.build_all()
    cfg = chip_smoke.flash_config(chip_smoke.write_long_docs(),
                                  num_rounds=ROUNDS,
                                  ledger=LedgerConfig(enabled=True))
    out_dir = ROOT / "build" / "pod_axis"
    one, first = layout("1 process x 4 cards", cfg, 1, 4, out_dir)
    rows = [first]
    for processes, cards in ((2, 2), (4, 1)):
        _, o = layout(f"{processes} processes x {cards} card(s)", cfg,
                      processes, cards, out_dir, one=one)
        rows.append(o)
    print(json.dumps({"pod_axis": rows, "smi": smi}), flush=True)
    print(smi, flush=True)
    bad = {r["label"]: r["differs_in"] for r in rows if r["differs_in"]}
    if bad:
        print(f"pod_axis: layouts differ from one process on four cards: "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
