"""The multi-process async P2P runtime (``FedConfig.runtime="dist"``):
port of ``bcfl_tpu/dist``: the leadered dispatch with its fault-tolerance,
adversarial and chaos halves, and the leaderless gossip dispatch.

Each peer is an OS process owning a fixed slice of the clients; updates
ride length-prefixed TCP over loopback (:mod:`.wire`, byte-identical to
the JAX package's frames) carrying the codec payload and the ledger
digests; aggregation is FedBuff-style buffered async at the component
leader with MEASURED staleness (:mod:`.runtime`). Partitions fork the
ledger and heal through a verified reconcile; peers checkpoint, resume
after a crash and repair damaged state over a chain-verified STATE_SYNC.
:mod:`.harness` spawns, supervises, kills, restarts and reaps the peers.
The leader merges with a robust rule over one vote per peer
(:mod:`.robust`) and quarantines peers through a per-peer reputation
tracker committed to the ledger; :mod:`.byzantine` injects adversarial
updates above the wire. The transport injects the wire lane's socket
faults (:class:`~.transport.WireChaos`) and the limp lane's link throttle
(:class:`~.transport.LimpChaos`); the runtime stalls limping peers and
fails durable writes on the resource lane's draws. Under
``dispatch="gossip"`` every peer merges its sampled neighbors' states
itself (:mod:`.gossip`), with no leader, and heals a partition with no
arbiter.
"""

from bcfl_tpu_torch.dist.harness import free_ports, reap_all, run_dist
from bcfl_tpu_torch.dist.launch import cfg_from_json, cfg_to_json
from bcfl_tpu_torch.dist.transport import (
    FailureDetector,
    LimpChaos,
    PartitionGate,
    PeerTransport,
    PhiFailureDetector,
    TransportError,
    WireChaos,
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
    "CrcError", "FailureDetector", "LimpChaos", "PartitionGate",
    "PeerTransport", "PhiFailureDetector", "TransportError", "WireChaos",
    "WireError", "cfg_from_json",
    "cfg_to_json", "frame_prefix", "free_ports", "pack_frame", "read_frame",
    "reap_all", "run_dist", "unpack_frame", "write_frame",
]
