"""Build and load the native C++ cores (``sha256.cc``, ``tokenizer.cc``):
port of ``bcfl_tpu/native/build.py``.

Each source is compiled by ``g++`` at first use into
``build/bcfl_tpu_torch/native/`` beside the package (a directory git
ignores), never into the package directory, and loaded with ``ctypes``.
The library name carries a hash of its source and of the flags, so an
edited source is rebuilt and a stale library is never loaded. A build
writes a temporary file and renames it into place (``os.replace``):
pytest workers and peer processes that race to build the same library
each load a complete one.

Everything here has a pure-Python twin with identical results (hashlib,
the tokenizer's Python loop): when no toolchain exists, or the build
fails, the loader returns None and the caller takes that path. The
result is cached per process, a failure included, so a missing
toolchain is probed once. :func:`status` says which path each core took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "bcfl_tpu_torch" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
# source name -> loaded library, or None when the build/load failed
_cache: Dict[str, Optional[ctypes.CDLL]] = {}
# source name -> "native" | the reason the Python path is taken
_status: Dict[str, str] = {}


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def _compile(src: Path, out: Path) -> Optional[str]:
    """Build ``out`` from ``src`` atomically; None on success, else the
    reason."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "no g++ on PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return f"g++ failed ({proc.returncode}): {proc.stderr[-500:]}"
        os.replace(tmp, out)
        return None
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ failed: {e}"
    finally:
        if tmp.exists():
            tmp.unlink()


def _load_lib(src_name: str,
              configure: Callable[[ctypes.CDLL], None]
              ) -> Optional[ctypes.CDLL]:
    with _lock:
        if src_name in _cache:
            return _cache[src_name]
        lib = None
        src = SRC_DIR / src_name
        try:
            out = _lib_path(src)
            why = None if out.exists() else _compile(src, out)
            if why is None:
                lib = ctypes.CDLL(str(out))
                configure(lib)
                _status[src_name] = "native"
            else:
                _status[src_name] = why
        except OSError as e:
            lib = None
            _status[src_name] = f"load failed: {e}"
        _cache[src_name] = lib
        return lib


def _configure_ledger(lib: ctypes.CDLL) -> None:
    lib.bcfl_sha256.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.bcfl_sha256_multi.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.c_char_p]
    lib.bcfl_chain_extend.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.bcfl_chain_verify.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p, ctypes.c_uint64]
    lib.bcfl_chain_verify.restype = ctypes.c_int64


def _configure_tokenizer(lib: ctypes.CDLL) -> None:
    lib.bcfl_hash_tokenize.argtypes = [
        ctypes.c_char_p,                  # concatenated lowered UTF-8
        ctypes.POINTER(ctypes.c_int64),   # offsets [n+1]
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),   # ids [n, seq_len]
        ctypes.POINTER(ctypes.c_int32),   # mask [n, seq_len]
    ]


def load_ledger_lib() -> Optional[ctypes.CDLL]:
    """The ledger's SHA-256 core, built on first use; None without a
    toolchain (callers hash with hashlib)."""
    return _load_lib("sha256.cc", _configure_ledger)


def load_tokenizer_lib() -> Optional[ctypes.CDLL]:
    """The hash tokenizer's batch core, built on first use; None without
    a toolchain (callers run the Python loop)."""
    return _load_lib("tokenizer.cc", _configure_tokenizer)


def status() -> Dict[str, str]:
    """Per core (``ledger``, ``tokenizer``): ``"native"`` when the C++
    library loaded, else why the Python path is taken. Builds both."""
    load_ledger_lib()
    load_tokenizer_lib()
    return {"ledger": _status["sha256.cc"],
            "tokenizer": _status["tokenizer.cc"]}
