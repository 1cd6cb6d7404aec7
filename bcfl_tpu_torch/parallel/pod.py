"""The pod's cross-process transport: what crosses between the processes
of a pod (:func:`bcfl_tpu_torch.core.mesh.distributed_init`), the
counterpart of the DCN hop of JAX's multi-host mesh.

A row that crosses a process boundary goes through the host: its
:func:`~bcfl_tpu_torch.fed.client_step._packed` buffers (one per dtype)
are copied to host memory (pinned, when the card is the source), sent
over the gloo group, received into host memory and copied to the
receiving device. Through the host, two processes can share one card,
where NCCL refuses two ranks on one GPU. Every process issues the same
calls in the same order (the clients axis's order), so a send always
meets its receive and nothing waits in a cycle.

:func:`decide` is the other half: every value the host reads back from
the lead device is read on process 0, which holds the lead, and sent to
every other process, so every host decision (a record, the ledger's
fingerprints, an evaluation) is process 0's everywhere.

:func:`launch` starts a pod of local processes under JAX's
``BCFL_COORDINATOR`` / ``BCFL_NUM_PROCESSES`` / ``BCFL_PROCESS_ID``
contract, with a hard deadline, and reaps them.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: seconds the other processes of a local pod get to fail on their own
#: once one has failed, before :func:`launch` kills them
GRACE_S = 60.0


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """``x``'s elements in row-major order as a flat uint8 tensor on the
    host: pinned when ``x`` is on a card (the copy waits for it)."""
    flat = x.reshape(-1)
    if flat.dtype != torch.uint8:
        flat = flat.view(torch.uint8)
    if flat.device.type == "cpu":
        return flat.contiguous()
    host = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(flat)
    return host


def _host_buffer(x: torch.Tensor) -> torch.Tensor:
    """An empty uint8 host buffer for ``x``'s bytes (pinned when a card
    can use it)."""
    return torch.empty(x.numel() * x.element_size(), dtype=torch.uint8,
                       pin_memory=torch.cuda.is_available())


def _as(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Host bytes ``buf`` viewed as a contiguous tensor shaped like
    ``like``."""
    if like.dtype != torch.uint8:
        buf = buf.view(like.dtype)
    return buf.view(like.shape)


def send(xs: Sequence[torch.Tensor], dst: int) -> None:
    """Send every tensor of ``xs`` to process ``dst``, in order."""
    for x in xs:
        if x.numel():
            dist.send(_bytes(x), dst)


def recv(like: Sequence[torch.Tensor], src: int) -> List[torch.Tensor]:
    """What process ``src`` sends with :func:`send`, one host tensor
    shaped like each of ``like`` (a meta stand-in does)."""
    out = []
    for x in like:
        buf = _host_buffer(x)
        if x.numel():
            dist.recv(buf, src)
        out.append(_as(buf, x))
    return out


def broadcast(xs: Sequence[torch.Tensor], src: int) -> List[torch.Tensor]:
    """Process ``src``'s ``xs`` in host memory in every process: ``src``
    sends its tensors, every other process receives into tensors shaped
    like its own ``xs`` (meta stand-ins)."""
    out = []
    for x in xs:
        buf = _bytes(x) if dist.get_rank() == src else _host_buffer(x)
        if x.numel():
            dist.broadcast(buf, src)
        out.append(_as(buf, x))
    return out


def decide(fn: Callable, src: int):
    """Process ``src``'s ``fn()`` in every process of the pod; ``fn`` runs
    on ``src`` only (a read-back of the lead device it holds: stats,
    fingerprints, an evaluation), its value is pickled to the others."""
    box = [fn() if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def launch(argv: Sequence[str], processes: int, deadline_s: float,
           log_dir: str,
           env_of: Optional[Callable[[int], Dict[str, str]]] = None) -> Dict:
    """Start ``processes`` local processes of ``[python, *argv]`` as one
    pod: process ``p`` gets ``BCFL_PROCESS_ID=p``, the pod's size and a
    free coordinator port on localhost, plus ``env_of(p)`` (say its own
    ``CUDA_VISIBLE_DEVICES``). Waits for all of them under ``deadline_s``;
    once one fails, the others get :data:`GRACE_S` to fail on their own (a
    process that exits closes its connections) before they are killed;
    at the deadline every process left is killed. Returns
    ``{"returncodes", "killed", "wall_s", "logs"}``, each process's output
    in ``log_dir/pod{p}.log`` and its tail in ``logs``."""
    from bcfl_tpu_torch.dist.harness import free_ports

    port = free_ports(1)[0]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs, files = [], []
    t0 = time.time()
    for p in range(processes):
        env = dict(os.environ, BCFL_COORDINATOR=f"127.0.0.1:{port}",
                   BCFL_NUM_PROCESSES=str(processes),
                   BCFL_PROCESS_ID=str(p))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                      if x])
        if env_of is not None:
            env.update(env_of(p))
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(log_dir, f"pod{p}.log"), "w+b")
        files.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env, stdout=out,
            stderr=subprocess.STDOUT))
    killed, failed_at = [], None
    try:
        while True:
            rcs = [proc.poll() for proc in procs]
            if all(rc is not None for rc in rcs):
                break
            now = time.time()
            if failed_at is None and any(rc not in (None, 0) for rc in rcs):
                failed_at = now
            if (now - t0 > deadline_s
                    or (failed_at is not None and now - failed_at > GRACE_S)):
                for p, proc in enumerate(procs):
                    if proc.poll() is None:
                        proc.kill()
                        killed.append(p)
                for proc in procs:
                    proc.wait()
                break
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logs = []
    for out in files:
        out.seek(0)
        logs.append(out.read().decode(errors="replace")[-6000:])
        out.close()
    return {"returncodes": [proc.returncode for proc in procs],
            "killed": killed, "wall_s": time.time() - t0, "logs": logs}
