"""repro_torch.store — the replicated in-memory checkpoint store (diskless
C/R), the port of ``repro.store``.

The paper's combined mode pays for pair-death resilience with checkpoints
whose cost C drives the Young-Daly interval; ReStore-style diskless
checkpointing keeps redundant copies of the recovery data in *partner
process memory*, making C network-bound.  Built on the port's ``comm``
transport:

  placement  - shift-by-k partner-group placement: a rank's shards never
               share a failure domain (node, replica pair) with their
               owner, so any f <= k failures leave every band recoverable;
  memstore   - banded shards (frozen host numpy arrays) pushed to k
               partners as point-to-point messages over ReplicaTransport,
               with a two-generation commit: a generation is durable only
               once all partners ack, and the previous one is retained
               until then;
  recovery   - rebuild a dead worker's state by pulling surviving partner
               shards back over the transport;
  backend    - the CheckpointBackend protocol, ``MemBackend``, which
               turns a torch state into host bytes (one device-to-host copy
               per tensor) and back onto the device of the state it
               replaces, and ``DiskBackend`` over ``checkpoint.Checkpointer``.
"""
from repro_torch.store.backend import (CheckpointBackend, DiskBackend,
                                       MemBackend, make_backend)
from repro_torch.store.memstore import MemStore
from repro_torch.store.placement import PartnerPlacement, PlacementError
from repro_torch.store.recovery import StoreRecovery, StoreUnrecoverable

__all__ = [
    "PartnerPlacement", "PlacementError",
    "MemStore",
    "StoreRecovery", "StoreUnrecoverable",
    "CheckpointBackend", "DiskBackend", "MemBackend", "make_backend",
]
