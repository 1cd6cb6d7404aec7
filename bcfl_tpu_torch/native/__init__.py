"""Native C++ cores (port of ``bcfl_tpu/native``): the ledger's SHA-256
chain primitives and the hash tokenizer's batch encoder, built with g++ at
first use and bound with ctypes. Each has a pure-Python twin with
identical results."""

from bcfl_tpu_torch.native.build import (  # noqa: F401
    load_ledger_lib,
    load_tokenizer_lib,
    status,
)
