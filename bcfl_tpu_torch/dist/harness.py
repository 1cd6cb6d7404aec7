"""Spawn, supervise and reap the peer processes: port of
``bcfl_tpu/dist/harness.py`` with its kill/rejoin, churn and limp legs.

Write the config JSON, pick free ports, spawn one
``python -m bcfl_tpu_torch.dist`` process per peer, enforce a hard wall
deadline and reap stragglers: a hung peer fails the run, it never wedges
it. Peers, restarted ones included, are fresh interpreters (never a
``fork`` of a process that has touched CUDA). Every spawned process sits
in a module-level registry with an ``atexit`` hook, so an interrupted
supervisor leaves no orphan peers.

A peer is SIGKILLed only between checkpoint commits: once its newest
round directory and that round's meta sidecar have landed and no staging
entry shows a commit in flight. Before a killed peer restarts, its last
report is kept as ``report_peer{p}.incarnation{n}.json`` (each
incarnation counts its own kernel launches from 0).
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from bcfl_tpu_torch.telemetry import find_streams, resolve_stream_dir

# every live peer Popen, registered at spawn and discarded at reap
_LIVE: set = set()
# the checkout's root: peers import the package from here
REPO_ROOT = str(Path(__file__).resolve().parents[2])


def reap_all() -> int:
    """SIGKILL every still-running registered peer; returns how many."""
    killed = 0
    for proc in list(_LIVE):
        if proc.poll() is None:
            try:
                proc.kill()
                proc.wait(timeout=10)
                killed += 1
            except OSError:
                pass
        _close(proc)
    return killed


atexit.register(reap_all)


def _close(proc: subprocess.Popen) -> None:
    _LIVE.discard(proc)
    log = getattr(proc, "_bcfl_log", None)
    if log is not None:
        log.close()


def free_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    """``n`` distinct currently-free TCP ports (bound, then released)."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind((host, 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def spawn_peer(cfg_path: str, peer_id: int, ports: List[int], run_dir: str,
               device: str = "cuda", threads: Optional[int] = None,
               resume: bool = False, bootstrap: bool = False
               ) -> subprocess.Popen:
    """Start one peer process; its output goes to ``run_dir/peer{p}.log``.
    ``threads`` caps the peer's CPU threads (``torch.set_num_threads``);
    ``resume`` restarts it from its checkpoints, ``bootstrap`` lets it
    repair over STATE_SYNC when none is usable."""
    cmd = [sys.executable, "-m", "bcfl_tpu_torch.dist",
           "--config", cfg_path, "--peer-id", str(peer_id),
           "--ports", ",".join(str(p) for p in ports),
           "--run-dir", run_dir, "--device", device]
    if resume:
        cmd.append("--resume")
    if bootstrap:
        cmd.append("--bootstrap")
    if threads:
        cmd.extend(["--threads", str(threads)])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    log = open(os.path.join(run_dir, f"peer{peer_id}.log"), "ab")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            env=env, cwd=REPO_ROOT)
    proc._bcfl_log = log  # closed at reap/collect
    _LIVE.add(proc)
    return proc


def _committed_round(ckdir: str) -> Optional[int]:
    """The newest round of a checkpoint dir when it is fully committed
    (its directory and its meta sidecar landed, no staging entry of a
    commit in flight), else None: the only moment a kill is fair."""
    from bcfl_tpu_torch.checkpoint.checkpoint import (
        _STAGING,
        _list_rounds,
        _meta_path,
    )

    if not os.path.isdir(ckdir):
        return None
    if any(n.startswith(_STAGING) for n in os.listdir(ckdir)):
        return None
    rounds = _list_rounds(ckdir)
    if not rounds or not os.path.exists(_meta_path(ckdir, rounds[-1])):
        return None
    return rounds[-1]


def _keep_report(run_dir: str, peer: int, incarnation: int) -> None:
    """Keep a dead incarnation's last report beside the next one's."""
    path = os.path.join(run_dir, f"report_peer{peer}.json")
    if os.path.exists(path):
        os.replace(path, os.path.join(
            run_dir, f"report_peer{peer}.incarnation{incarnation}.json"))


def _keep_round(run_dir: str, ckdir: str, peer: int, rnd: int) -> str:
    """Hard-link a killed peer's newest committed round (state and meta)
    under ``run_dir/killed_peer{p}``: the state the next incarnation
    restores, kept for the resume proof after retention drops it. Costs no
    copy."""
    from bcfl_tpu_torch.checkpoint.checkpoint import _meta_path

    dst = os.path.join(run_dir, f"killed_peer{peer}")
    os.makedirs(dst, exist_ok=True)
    name = f"round_{rnd:06d}"
    os.makedirs(os.path.join(dst, name), exist_ok=True)
    for fn in os.listdir(os.path.join(ckdir, name)):
        os.link(os.path.join(ckdir, name, fn), os.path.join(dst, name, fn))
    meta = _meta_path(ckdir, rnd)
    os.link(meta, os.path.join(dst, os.path.basename(meta)))
    return dst


def _sigkill(proc: subprocess.Popen) -> None:
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    _close(proc)


def run_dist(cfg, run_dir: str, deadline_s: Optional[float] = None,
             device: str = "cuda", threads: Optional[int] = None,
             kill_peer: Optional[int] = None, kill_after_version: int = 1,
             restart_delay_s: float = 2.0, restart_killed: bool = True,
             churn: Optional[Dict] = None,
             limp: Optional[Dict] = None) -> Dict:
    """Run one dist federation: spawn ``cfg.dist.peers`` peer processes,
    supervise them under a hard deadline (default: the peers' own
    deadline + 60 s), and collect the per-peer reports.

    ``kill_peer`` SIGKILLs that peer once a committed checkpoint of
    version ``kill_after_version`` or later has landed, and (unless
    ``restart_killed=False``) restarts it with ``--resume`` after
    ``restart_delay_s``: the crash/rejoin leg. Its newest round is
    hard-linked under ``run_dir/killed_peer{p}`` first.

    ``churn`` drives repeated kill/rejoin cycles of one peer, a dict
    ``{"peer", "cycles", "period_s", "downtime_s", "stop_after_s",
    "damage", "bootstrap"}``: every ``period_s`` seconds (from its last
    restart), while it has a committed checkpoint, peer 0 and the peer
    are alive, fewer than ``cycles`` kills have fired and (with
    ``stop_after_s``) inside that window, the peer is SIGKILLed, its
    checkpoint dir damaged with the next class of ``damage`` (storage
    classes, one per cycle) while it is down, left down ``downtime_s``
    and restarted with ``--resume`` (plus ``--bootstrap`` when
    ``bootstrap``). The cycles land under ``result["churn"]``.

    ``limp`` drives supervised SIGSTOP/SIGCONT pause cycles of one peer,
    the limp lane's gray failure: the peer never dies and never resumes
    from a checkpoint, it goes silent for ``pause_s`` seconds and then
    continues where it was. A dict ``{"peer", "pause_s", "period_s",
    "cycles", "stop_after_s"}``: every ``period_s`` seconds, while fewer
    than ``cycles`` pauses have fired, peer 0 and the peer are alive and
    (with ``stop_after_s``) inside that window, the peer is SIGSTOPped,
    left frozen ``pause_s`` and SIGCONTed. The cycles land under
    ``result["limp"]``; ``limp`` composes with ``churn`` and ``kill_peer``
    on other peers.

    Returns ``{"ok", "process_count", "returncodes", "reports",
    "incarnation_reports", "log_tails", "kill", "churn", "limp",
    "run_dir", "event_streams", "wall_s"}``; raises nothing on peer failure (the
    caller reads the result and the logs under ``run_dir``)."""
    from bcfl_tpu_torch.dist.launch import cfg_to_json

    run_dir = os.path.abspath(run_dir)
    os.makedirs(run_dir, exist_ok=True)
    n = cfg.dist.peers
    ports = ([cfg.dist.base_port + i for i in range(n)]
             if cfg.dist.base_port else free_ports(n, cfg.dist.host))
    cfg_path = os.path.join(run_dir, "config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg_to_json(cfg))
    deadline_s = deadline_s or (cfg.dist.peer_deadline_s + 60.0)

    t0 = time.time()
    procs = {p: spawn_peer(cfg_path, p, ports, run_dir, device, threads)
             for p in range(n)}
    rcs: Dict[int, Optional[int]] = {p: None for p in range(n)}
    incarnations = {p: 1 for p in range(n)}
    kill_record = None
    churn_records: List[Dict] = []
    churn_next = (t0 + float(churn.get("period_s", 45.0))
                  if churn else None)
    limp_records: List[Dict] = []
    limp_next = (t0 + float(limp.get("period_s", 20.0))
                 if limp else None)

    def restart(p: int, bootstrap: bool = False) -> None:
        _keep_report(run_dir, p, incarnations[p])
        incarnations[p] += 1
        procs[p] = spawn_peer(cfg_path, p, ports, run_dir, device, threads,
                              resume=True, bootstrap=bootstrap)
        rcs[p] = None

    while time.time() - t0 < deadline_s:
        for p, proc in procs.items():
            rc = proc.poll()
            if rc is not None and rcs[p] is None:
                rcs[p] = rc
                _close(proc)
        if (kill_peer is not None and kill_record is None
                and rcs.get(kill_peer) is None):
            ckdir = os.path.join(run_dir, f"ckpt_peer{kill_peer}")
            rnd = _committed_round(ckdir)
            if rnd is not None and rnd >= kill_after_version:
                _sigkill(procs[kill_peer])
                killed_at = time.time()
                kill_record = {"peer": kill_peer,
                               "killed_at_s": killed_at - t0,
                               "killed_at_wall": killed_at,
                               "checkpoint_seen": os.path.join(
                                   ckdir, f"round_{rnd:06d}"),
                               "round": rnd,
                               "kept": _keep_round(run_dir, ckdir,
                                                   kill_peer, rnd),
                               "restarted": restart_killed}
                if restart_killed:
                    time.sleep(restart_delay_s)
                    restart(kill_peer)
                else:
                    rcs[kill_peer] = procs[kill_peer].returncode
        if (churn_next is not None and time.time() >= churn_next
                and len(churn_records) < int(churn.get("cycles", 3))
                and rcs.get(0) is None
                and rcs.get(int(churn["peer"])) is None):
            cp = int(churn["peer"])
            stop_after = churn.get("stop_after_s")
            ckdir = os.path.join(run_dir, f"ckpt_peer{cp}")
            if (stop_after is not None
                    and time.time() - t0 > float(stop_after)):
                churn_next = None  # the window closed
            elif _committed_round(ckdir) is not None:
                _sigkill(procs[cp])
                killed_at = time.time()
                damage = None
                classes = churn.get("damage")
                if classes:
                    # damage the corpse's durable state while it is down,
                    # one class per cycle in list order
                    from bcfl_tpu_torch.checkpoint import (
                        apply_storage_fault,
                    )

                    cls = classes[len(churn_records) % len(classes)]
                    frac = round(((len(churn_records) + 1) * 0.31) % 1.0, 3)
                    try:
                        damage = apply_storage_fault(
                            ckdir, {"cls": cls, "frac": frac,
                                    "delete_last": 1})
                    except (OSError, ValueError) as e:
                        damage = {"cls": cls, "error": str(e)}
                time.sleep(float(churn.get("downtime_s", 2.0)))
                restart(cp, bootstrap=bool(churn.get("bootstrap")))
                churn_records.append(
                    {"peer": cp, "cycle": len(churn_records) + 1,
                     "killed_at_s": round(killed_at - t0, 3),
                     "killed_at_wall": killed_at,
                     **({"damage": damage} if damage else {})})
                churn_next = time.time() + float(churn.get("period_s", 45.0))
        if (limp_next is not None and time.time() >= limp_next
                and len(limp_records) < int(limp.get("cycles", 3))
                and rcs.get(0) is None
                and rcs.get(int(limp["peer"])) is None):
            lp = int(limp["peer"])
            stop_after = limp.get("stop_after_s")
            if (stop_after is not None
                    and time.time() - t0 > float(stop_after)):
                limp_next = None  # the window closed
            else:
                proc = procs[lp]
                pause_s = float(limp.get("pause_s", 3.0))
                try:
                    # freeze, not kill: the peer's sockets stay open, so
                    # the others see silence and back-pressure, not a reset
                    proc.send_signal(signal.SIGSTOP)
                    time.sleep(pause_s)
                finally:
                    if proc.poll() is None:
                        proc.send_signal(signal.SIGCONT)
                limp_records.append(
                    {"peer": lp, "cycle": len(limp_records) + 1,
                     "paused_at_s": round(time.time() - t0 - pause_s, 3),
                     "pause_s": pause_s})
                limp_next = time.time() + float(limp.get("period_s", 20.0))
        if all(rc is not None for rc in rcs.values()):
            break
        time.sleep(0.25)
    else:
        # deadline: reap whoever is still running (they exit nonzero)
        for p, proc in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
                rcs[p] = proc.returncode
            _close(proc)

    reports, logs, dead = {}, {}, {}
    for p in range(n):
        path = os.path.join(run_dir, f"report_peer{p}.json")
        if os.path.exists(path):
            with open(path) as f:
                reports[p] = json.load(f)
        for k in range(1, incarnations[p]):
            path = os.path.join(run_dir,
                                f"report_peer{p}.incarnation{k}.json")
            if os.path.exists(path):
                with open(path) as f:
                    dead.setdefault(p, []).append(json.load(f))
        lp = os.path.join(run_dir, f"peer{p}.log")
        if os.path.exists(lp):
            with open(lp, errors="replace") as f:
                logs[p] = f.read()[-2000:]
    ok = (all(rc == 0 for rc in rcs.values())
          and all(reports.get(p, {}).get("status") == "ok"
                  for p in range(n)))
    tele_dir = resolve_stream_dir(cfg.telemetry_dir, run_dir)
    return {
        "ok": ok,
        "process_count": n,
        "returncodes": {str(p): rcs[p] for p in range(n)},
        "reports": reports,
        "incarnation_reports": dead,
        "log_tails": logs,
        "kill": kill_record,
        "churn": churn_records,
        "limp": limp_records,
        "run_dir": run_dir,
        "event_streams": (find_streams(tele_dir)
                          if tele_dir is not None else []),
        "wall_s": time.time() - t0,
    }
