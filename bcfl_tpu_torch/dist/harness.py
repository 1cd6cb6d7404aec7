"""Spawn, supervise and reap the peer processes: port of
``bcfl_tpu/dist/harness.py`` (the whole-network run; the kill/rejoin,
churn and limp legs wait for the crash/rejoin slice).

Write the config JSON, pick free ports, spawn one
``python -m bcfl_tpu_torch.dist`` process per peer, enforce a hard wall
deadline and reap stragglers: a hung peer fails the run, it never wedges
it. Peers are fresh interpreters (never a ``fork`` of a process that has
touched CUDA). Every spawned process sits in a module-level registry with
an ``atexit`` hook, so an interrupted supervisor leaves no orphan peers.
"""

from __future__ import annotations

import atexit
import json
import os
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
               device: str = "cuda", threads: Optional[int] = None
               ) -> subprocess.Popen:
    """Start one peer process; its output goes to ``run_dir/peer{p}.log``.
    ``threads`` caps the peer's CPU threads (``torch.set_num_threads``)."""
    cmd = [sys.executable, "-m", "bcfl_tpu_torch.dist",
           "--config", cfg_path, "--peer-id", str(peer_id),
           "--ports", ",".join(str(p) for p in ports),
           "--run-dir", run_dir, "--device", device]
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


def run_dist(cfg, run_dir: str, deadline_s: Optional[float] = None,
             device: str = "cuda", threads: Optional[int] = None) -> Dict:
    """Run one dist federation: spawn ``cfg.dist.peers`` peer processes,
    supervise them under a hard deadline (default: the peers' own
    deadline + 60 s), and collect the per-peer reports.

    Returns ``{"ok", "process_count", "returncodes", "reports",
    "log_tails", "run_dir", "event_streams", "wall_s"}``; raises nothing
    on peer failure (the caller reads the result and the logs under
    ``run_dir``)."""
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
    while time.time() - t0 < deadline_s:
        for p, proc in procs.items():
            rc = proc.poll()
            if rc is not None and rcs[p] is None:
                rcs[p] = rc
                _close(proc)
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

    reports, logs = {}, {}
    for p in range(n):
        path = os.path.join(run_dir, f"report_peer{p}.json")
        if os.path.exists(path):
            with open(path) as f:
                reports[p] = json.load(f)
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
        "log_tails": logs,
        "run_dir": run_dir,
        "event_streams": (find_streams(tele_dir)
                          if tele_dir is not None else []),
        "wall_s": time.time() - t0,
    }
