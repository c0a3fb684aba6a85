"""CheckpointBackend: one protocol over disk and in-memory checkpoints (port
of ``repro/store/backend.py``).

``CheckpointStrategy``/``CombinedStrategy`` (``ft.strategy``) are
backend-agnostic: they snapshot/restore through whichever backend
``make_backend`` selects from the FTConfig —

  MemBackend   wraps ``store.MemStore``: the session state is turned into
               host bytes, split into one byte shard per logical rank, and
               each rank's shard is pushed to its k placement partners over
               a ReplicaTransport mirroring the session's fabric.  C becomes
               network-bound (ckpt_policy.memstore_ckpt_cost feeds the
               Young-Daly interval) and restores pull surviving partner
               shards instead of reading a filesystem.
  DiskBackend  the on-disk ``checkpoint.Checkpointer`` (the reference's
               format) behind the same protocol; C and R are wall-measured.

Host encoding of a torch state (``to_host`` / ``from_host``).  A state's
tensors reach the store as host numpy arrays, one device-to-host copy per
tensor, never through torch's own storage pickling (which writes a
``torch.save`` archive per storage, pickles a view's whole base storage,
and on load puts a tensor back on whatever device it came from):

  * a tensor of a dtype numpy has becomes that numpy array (of the
    tensor's elements only, C-contiguous), so a state of such tensors
    pickles to the same blob — and is priced at the same bytes — as the
    reference's state of numpy arrays with the same values.  A 0-d tensor
    becomes a numpy scalar, which is what numpy's reductions (the
    reference's ``np.dot``, ``sum``) hand its states and messages; a
    tensor in a sender log's message payload becomes a read-only array,
    as the reference's transport freezes every payload it captures;
  * a bf16 tensor travels as its uint16 bits inside a ``BF16Bits`` tag;
    the tag costs ``BF16_FIRST_FRAME_BYTES`` bytes of pickle framing for
    the first bf16 tensor of a state and ``BF16_FRAME_BYTES`` for each
    further one (the class reference is memoised);
  * any other dtype (float8, quantised) raises ``TypeError``;
  * the dtype, shape and device of every tensor are recorded in a manifest
    the backend keeps per generation (bookkeeping like the store's own
    generation table), and ``restore`` rebuilds each tensor with its
    recorded dtype and shape on the device of the tensor at the same place
    in ``like`` (the recorded device where ``like`` has none), or on the
    ``device`` the caller names.  Every restored tensor owns its storage;
  * dataclass instances are walked field by field (the simulated
    runtime's checkpoints hold the sender logs' messages).
"""
from __future__ import annotations

import dataclasses
import pickle
import time
from typing import (Any, Dict, List, NamedTuple, Optional, Protocol,
                    Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch.comm import ReplicaTransport
from repro_torch.core import ckpt_policy
from repro_torch.core.message_log import LoggedMessage
from repro_torch.store.memstore import MemStore
from repro_torch.store.recovery import StoreUnrecoverable

# pickle framing a BF16Bits tag adds to its bits' array (protocol 5): the
# first one in a pickle names the class; later ones reuse the memo entry
BF16_FIRST_FRAME_BYTES = 45
BF16_FRAME_BYTES = 6

Path = Tuple[Any, ...]


class BF16Bits:
    """A bf16 tensor on its way through the store: its uint16 bits."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    def __reduce__(self):
        return BF16Bits, (self.bits,)


class TensorRecord(NamedTuple):
    """One tensor of a saved state: where it sits, what it was."""

    path: Path
    dtype: torch.dtype
    shape: Tuple[int, ...]
    device: torch.device


def _to_numpy(t: torch.Tensor, path: Path, frozen: bool = False):
    """One device-to-host copy of ``t``'s elements as a numpy array (a
    ``BF16Bits`` tag for bf16; a numpy scalar for a 0-d tensor; read-only
    when ``frozen``).  On the CPU a contiguous tensor is not copied: the
    array shares its memory until it is pickled."""
    host = t.detach().to("cpu", memory_format=torch.contiguous_format)
    if t.dtype == torch.bfloat16:
        return BF16Bits(host.view(torch.int16).numpy().view(np.uint16))
    try:
        arr = host.numpy()
    except TypeError as e:
        raise TypeError(f"state tensor at {path} has dtype {t.dtype}, "
                        f"which numpy cannot hold and the store has no "
                        f"encoding for") from e
    if arr.ndim == 0:
        return arr[()]
    if frozen:
        arr = arr.view()                  # the tensor's memory stays writable
        arr.flags.writeable = False
    return arr


def to_host(tree) -> Tuple[Any, List[TensorRecord]]:
    """``tree`` with every tensor (inside dict/list/tuple/NamedTuple
    containers and dataclass instances) as a host numpy array or
    ``BF16Bits``, and the manifest of those tensors. Containers holding no
    tensor are returned as they are."""
    manifest: List[TensorRecord] = []

    def walk(x, path, frozen=False):
        if isinstance(x, torch.Tensor):
            manifest.append(TensorRecord(path, x.dtype, tuple(x.shape),
                                         x.device))
            return _to_numpy(x, path, frozen)
        t = type(x)
        if t is dict:
            out = {k: walk(v, path + (k,), frozen) for k, v in x.items()}
            return x if all(out[k] is v for k, v in x.items()) else out
        if t in (list, tuple) or _is_namedtuple(x):
            items = [walk(v, path + (i,), frozen) for i, v in enumerate(x)]
            if all(a is b for a, b in zip(items, x)):
                return x
            return _rebuild_seq(t, items)
        if _is_dataclass(x):
            # a logged message's payload is the transport's capture, frozen
            # in the reference
            return _replace_fields(
                x, lambda v, p: walk(v, p, frozen or (
                    t is LoggedMessage and p[-1] == "payload")), path)
        return x

    return walk(tree, ()), manifest


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _replace_fields(x, walk, path):
    """The dataclass instance ``x`` with ``walk`` applied to each field;
    ``x`` itself when no field changed."""
    old = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    new = {k: walk(v, path + (k,)) for k, v in old.items()}
    if all(new[k] is v for k, v in old.items()):
        return x
    return dataclasses.replace(x, **new)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _rebuild_seq(t, items):
    """A list, tuple or NamedTuple of type ``t`` holding ``items``."""
    if t is list:
        return items
    return t(*items) if hasattr(t, "_fields") else tuple(items)


def _at(tree, path: Path):
    """The node of ``tree`` at ``path``; None where ``tree`` has none."""
    for key in path:
        try:
            tree = tree[key]
        except (KeyError, IndexError, TypeError):
            return None
    return tree


def _rebuild(leaf, rec: TensorRecord, like, device) -> torch.Tensor:
    bits = isinstance(leaf, BF16Bits)
    arr = leaf.bits if bits else leaf
    if isinstance(arr, np.generic):
        arr = np.array(arr)              # a 0-d tensor's numpy scalar
    elif isinstance(arr, np.ndarray) and not arr.flags.writeable:
        arr = arr.copy()                 # a frozen payload's array
    if not isinstance(arr, np.ndarray) or bits != (rec.dtype ==
                                                  torch.bfloat16) \
            or tuple(arr.shape) != rec.shape:
        raise ValueError(f"restored leaf at {rec.path} does not match its "
                         f"record ({rec.dtype}, {rec.shape})")
    if device is None:
        target = _at(like, rec.path)
        device = target.device if isinstance(target, torch.Tensor) \
            else rec.device
    if bits:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if t.dtype != rec.dtype:
        raise ValueError(f"restored leaf at {rec.path} is {t.dtype}, "
                         f"recorded {rec.dtype}")
    # the unpickled array is this tensor's alone; another device copies
    return t.to(device)


def from_host(tree, manifest: List[TensorRecord], like=None, device=None):
    """Inverse of ``to_host`` on an unpickled host tree: every recorded
    tensor rebuilt with its dtype and shape on ``device``, else on the
    device of ``like``'s tensor at the same place, else on its recorded
    device."""
    records = {rec.path: rec for rec in manifest}

    def walk(x, path):
        rec = records.get(path)
        if rec is not None:
            return _rebuild(x, rec, like, device)
        t = type(x)
        if t is dict:
            return {k: walk(v, path + (k,)) for k, v in x.items()}
        if t in (list, tuple) or _is_namedtuple(x):
            return _rebuild_seq(t, [walk(v, path + (i,))
                                    for i, v in enumerate(x)])
        if _is_dataclass(x):
            return _replace_fields(x, walk, path)
        return x

    return walk(tree, ())


@runtime_checkable
class CheckpointBackend(Protocol):
    """What a checkpoint strategy needs from a durability layer."""

    kind: str
    last_write_s: float

    def save(self, step: int, state: Any, *, workload=None,
             baseline: bool = False, extra: Optional[dict] = None) -> float:
        ...

    def restore(self, like: Any, *, workload=None) -> Tuple[Any, int]:
        ...

    def has_checkpoint(self) -> bool:
        ...

    def on_failure(self, workers) -> None:
        ...


class DiskBackend:
    """The on-disk Checkpointer behind the backend protocol."""

    kind = "disk"
    modeled_cost = False             # C/R are wall-measured, not priced

    def __init__(self, ckpt_dir: str, n_bands: int = 4):
        from repro_torch.checkpoint import Checkpointer
        self.ckpt = Checkpointer(ckpt_dir, n_bands)
        self.last_restore_s = 0.0

    @property
    def last_write_s(self) -> float:
        return self.ckpt.last_write_s

    def save(self, step, state, *, workload=None, baseline=False,
             extra=None) -> float:
        return self.ckpt.save(step, state, baseline=baseline, extra=extra)

    def restore(self, like, *, workload=None):
        # repro: allow[wallclock] -- genuine wall measurement
        t0 = time.perf_counter()
        state, step, _extra = self.ckpt.restore(like)
        # repro: allow[wallclock] -- genuine wall measurement
        self.last_restore_s = time.perf_counter() - t0
        return state, step

    def has_checkpoint(self) -> bool:
        return self.ckpt.latest_tag() is not None

    def on_failure(self, workers) -> None:
        pass                                 # disks do not die with workers


class MemBackend:
    """Replicated in-memory checkpoints for an FTSession.

    The session's single SPMD-collapsed state tree is snapshotted (the
    workload's ``snapshot`` hook, if any), encoded to host arrays
    (``to_host``), pickled, and split into one byte shard per logical rank;
    rank r owns shard r and pushes it to its placement partners.  Worker
    deaths reported by the session kill the matching store memory, and an
    elastic restart rebinds the store to the session's rebuilt fabric
    before pulling the shards back.

    Cost accounting: with the session's clock carrying a cost model
    (``FTConfig.topology`` set), the store transport prices every push and
    fetch message, and ``last_write_s`` / ``last_restore_s`` are MEASURED
    from that traffic (max per-sender α‑β time).  Without a cost model
    they are the flat closed-form ``ckpt_policy.memstore_*`` constants.
    """

    kind = "memory"
    modeled_cost = True              # C/R are modeled/priced, not wall time

    def __init__(self, session, *, k_partners: int = 2, n_bands: int = 4,
                 net_bw_Bps: float = ckpt_policy.DEFAULT_NET_BW_BPS):
        self.session = session
        self.net_bw_Bps = net_bw_Bps
        self.last_write_s = 0.0
        self.last_restore_s = 0.0
        self.k_partners = k_partners
        self.n_bands = n_bands
        # generation -> the tensors of the state it holds
        self.manifests: Dict[int, List[TensorRecord]] = {}
        self.store = self._build(session.rmap, session.topology)

    def _cost_model(self):
        clock = getattr(self.session, "clock", None)
        return clock.cost_model if clock is not None else None

    def _observe(self, transport):
        """Wire the session's ObsRecorder (if any) into a store transport:
        push/fetch traffic counts into the same per-band counters and
        per-link heat as every other message."""
        obs = getattr(self.session, "obs", None)
        if obs is not None:
            transport.add_observer(obs)
            if transport.cost_model is not None:
                if obs.links is None:
                    obs.attach_links(transport.cost_model)
                transport.link_usage = obs.links
        return transport

    def _transport(self, rmap) -> ReplicaTransport:
        transport = self._observe(
            ReplicaTransport(rmap, rmap.n, cost_model=self._cost_model()))
        for w in rmap.alive():
            transport.register(w)
        return transport

    def _build(self, rmap, topology) -> MemStore:
        graph = getattr(getattr(self.session, "pricing", None), "graph",
                        None)
        return MemStore(self._transport(rmap), topology,
                        k_partners=self.k_partners, n_bands=self.n_bands,
                        graph=graph)

    # -- protocol ------------------------------------------------------------

    def save(self, step, state, *, workload=None, baseline=False,
             extra=None) -> float:
        hook = getattr(workload, "snapshot", None)
        snap, manifest = to_host(hook(state) if hook is not None else state)
        blob = pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL)
        del snap
        n = self.store.transport.rmap.n
        chunks = MemStore._chunk(blob, n)
        priced = self.store.transport.cost_model is not None
        if priced:
            self.store.transport.take_comm_time()     # measurement reset
        gen = self.store.save(step, {r: chunks[r] for r in range(n)})
        self.manifests[gen] = manifest
        # keep the manifests of the generations the store still holds
        for g in [g for g in self.manifests if g not in self.store.gens]:
            del self.manifests[g]
        if priced:
            # C measured from the α‑β-priced push traffic the save just
            # generated (max over senders: NICs serialize, ranks overlap)
            self.last_write_s = self.store.transport.take_comm_time()
        else:
            # flat model: the closed-form network-bound C per process
            self.last_write_s = ckpt_policy.memstore_ckpt_cost(
                len(blob) / n, n_partners=self.k_partners,
                net_bw_Bps=self.net_bw_Bps, n_messages=self.n_bands)
        return self.last_write_s

    def restore(self, like, *, workload=None):
        sess = self.session
        # the session swapped in the restarted fabric before calling us:
        # rebuild the store world on it (shard memory carries over)
        transport = self._transport(sess.rmap)
        self.store.rebind(topology=sess.topology, transport=transport)
        priced = transport.cost_model is not None
        if priced:
            transport.take_comm_time()                 # measurement reset
        gen = self.store.committed
        states, step = self.store.restore()      # raises StoreUnrecoverable
        blob = b"".join(states[r].tobytes() for r in sorted(states))
        del states
        if priced:
            # R measured from the fetch/reply traffic of the pull
            self.last_restore_s = transport.take_comm_time()
        else:
            self.last_restore_s = ckpt_policy.memstore_restore_cost(
                len(blob) / max(sess.rmap.n, 1), net_bw_Bps=self.net_bw_Bps,
                relaunch_s=0.0)
        snap = pickle.loads(blob)
        del blob
        state = from_host(snap, self.manifests[gen], like)
        hook = getattr(workload, "restore", None)
        return (hook(state) if hook is not None else state), step

    def has_checkpoint(self) -> bool:
        return self.store.durable() is not None

    def on_failure(self, workers) -> None:
        for w in workers:
            self.store.lose_worker(w)


def make_backend(ft, session, workload) -> CheckpointBackend:
    """Map FTConfig.ckpt_backend onto a backend for this session/workload:
    ``"memory"`` forces the store; ``"disk"`` uses the on-disk
    Checkpointer when the session has a ckpt_dir and the workload is
    disk-checkpointable, and the store otherwise."""
    choice = getattr(ft, "ckpt_backend", "disk")
    if choice not in ("disk", "memory"):
        raise ValueError(f"unknown ckpt_backend {choice!r}; "
                         f"expected 'disk' or 'memory'")
    disk_ok = session.ckpt_dir and getattr(workload, "disk_checkpointable",
                                           True)
    if choice == "disk" and disk_ok:
        return DiskBackend(session.ckpt_dir)
    return MemBackend(session, k_partners=getattr(ft, "store_partners", 2),
                      n_bands=getattr(ft, "store_bands", 4))


__all__ = ["CheckpointBackend", "DiskBackend", "MemBackend", "make_backend",
           "StoreUnrecoverable", "BF16Bits", "TensorRecord", "to_host",
           "from_host"]
