"""The multi-process async P2P runtime (``FedConfig.runtime="dist"``):
port of ``bcfl_tpu/dist``, the leadered dispatch with its fault-tolerance
half.

Each peer is an OS process owning a fixed slice of the clients; updates
ride length-prefixed TCP over loopback (:mod:`.wire`, byte-identical to
the JAX package's frames) carrying the codec payload and the ledger
digests; aggregation is FedBuff-style buffered async at the component
leader with MEASURED staleness (:mod:`.runtime`). Partitions fork the
ledger and heal through a verified reconcile; peers checkpoint, resume
after a crash and repair damaged state over a chain-verified STATE_SYNC.
:mod:`.harness` spawns, supervises, kills, restarts and reaps the peers.
The robust merge, reputation, the wire, byzantine, limp and resource
lanes and the gossip dispatch wait for later slices.
"""

from bcfl_tpu_torch.dist.harness import free_ports, reap_all, run_dist
from bcfl_tpu_torch.dist.launch import cfg_from_json, cfg_to_json
from bcfl_tpu_torch.dist.transport import (
    FailureDetector,
    PartitionGate,
    PeerTransport,
    PhiFailureDetector,
    TransportError,
)
from bcfl_tpu_torch.dist.wire import (
    CrcError,
    WireError,
    frame_prefix,
    pack_frame,
    read_frame,
    unpack_frame,
    write_frame,
)

__all__ = [
    "CrcError", "FailureDetector", "PartitionGate", "PeerTransport",
    "PhiFailureDetector", "TransportError", "WireError", "cfg_from_json",
    "cfg_to_json", "frame_prefix", "free_ports", "pack_frame", "read_frame",
    "reap_all", "run_dist", "unpack_frame", "write_frame",
]
