"""Build and load the hand-written CUDA kernels (``bcfl_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``. The build
runs at first use, from the sources in the checkout only, into
``build/bcfl_tpu_torch/`` beside the package (a directory git ignores);
the library name carries a hash of its source, so an edited kernel is
rebuilt and a stale one is never loaded. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``, and deliberately NO
``--use_fast_math``: the int8 codec's bit-identity with its plain version
rests on IEEE division and ``rintf``/``floorf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "bcfl_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: seconds spent in nvcc by this process, per kernel source
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "bcfl_tpu_torch are built from source at first use and need the "
        "CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return out, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd), time.perf_counter()


def _finish(name: str, out: Path, job, t0: float) -> None:
    if job is None:
        return
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{log}")
    os.replace(tmp, out)


def build_all(names: List[str]) -> Dict[str, float]:
    """Compile every named kernel source in parallel (one nvcc each) and
    load them; returns the nvcc seconds per source (0 when cached)."""
    with _LOCK:
        jobs = {n: _start(n) for n in names if n not in _LIBS}
        err = None
        for n, (out, job, t0) in jobs.items():
            try:
                _finish(n, out, job, t0)
            except RuntimeError as e:  # wait for every nvcc before raising
                err = err or e
        if err is not None:
            raise err
        for n, (out, _, _) in jobs.items():
            _LIBS[n] = ctypes.CDLL(str(out))
    return {n: BUILD_SECONDS.get(n, 0.0) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build_all([name])
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"(cudaGetLastError after the launch)")
