"""Hash-chained ledger and device-side fingerprints (port of
``bcfl_tpu/ledger``)."""

from bcfl_tpu_torch.ledger.ledger import (  # noqa: F401
    GENESIS,
    Ledger,
    LedgerEntry,
    chain_extend,
    params_digest,
)
from bcfl_tpu_torch.ledger.fingerprint import (  # noqa: F401
    client_fingerprint,
    entry_digest,
    struct_digest,
    tree_fingerprint,
)
