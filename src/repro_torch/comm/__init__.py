"""Layered replica-aware communication subsystem (the paper's §5-§6), the
PyTorch port of ``repro.comm`` with the same public names.

Three layers, each usable on its own:

  transport   - point-to-point routing with the paper's parallel
                communication scheme: cmp->cmp and rep->rep sends in
                parallel, intercomm fill-in when one side is unreplicated,
                replica-side skip, MPI_ANY_SOURCE forwarding, sender-based
                logging with piggybacked send-IDs.
  collectives - a registry-based CollectiveEngine: allreduce/barrier as
                switchboard collectives (paper §5 role-aware matching) and
                bcast/gather/reduce_scatter/alltoall as explicit algorithms
                over the transport (so they inherit logging + replay);
                plus ReferenceCollectives, the failure-free straight-line
                matcher.
  recovery    - failure-time drain of in-flight messages and sender-log
                replay with send-ID dedup (exactly-once, paper §6.3).

Payloads are numpy arrays, Python objects or torch tensors on the CPU or
the card; a tensor takes every path an ndarray takes, with the same
send-IDs, priced bytes and reduction bits.  Callers (the serving fan-out,
a step scheduler) post ops and resolve pendings in a loop.
"""
from repro_torch.comm.collectives import (COLLECTIVE_OPS, CollectiveEngine,
                                          ReferenceCollectives, combine,
                                          reference_result)
from repro_torch.comm.recovery import RecoveryManager
from repro_torch.comm.transport import (NOTHING, P2P_OPS, Endpoint,
                                        ReplicaTransport)

__all__ = [
    "Endpoint", "ReplicaTransport", "P2P_OPS", "NOTHING",
    "CollectiveEngine", "ReferenceCollectives", "COLLECTIVE_OPS",
    "combine", "reference_result",
    "RecoveryManager",
]
