"""VirtualMesh: the interception layer that hides failures from the
compiled step (port of ``repro/core/virtual_mesh.py``).

The paper preloads a proxy that intercepts poll/waitpid so the native MPI
server never observes process death (§4.2). The analogue here: a step
built for a mesh is specialised to a *logical* mesh; ``VirtualMesh`` owns the
logical-slot -> physical-device map, so a device/host failure changes ONLY
the map (spares fill in) or selects a pre-compiled degraded executable —
the program itself never sees the failure.

Works over abstract device ids (ints) for logic and tests and over
``torch.device`` objects (``cuda:0``, ...) in a launcher; ``device_mesh``
gives the current slots as a ``torch.distributed`` ``DeviceMesh`` (ints
are ranks of the default process group). Recovery preference order:
  1. spare fill   — same logical shape, swap failed slots for spares
                    (no recompile; the paper's "hide it entirely" path);
  2. replica promotion — in replication mode the replica slice along the
     ``rep``/``pod`` axis already holds current state: relabel slices
     (handled by ReplicaMap + shrink planning, not here);
  3. shrink      — drop one data-parallel slice and switch to the cached
     degraded executable (background-compiled, the paper's non-blocking
     communicator repair).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class RemapEvent:
    kind: str                       # "spare_fill" | "shrink_dp" | "fatal"
    failed: Tuple[int, ...]
    replaced_with: Tuple[int, ...] = ()
    new_dp: int = 0


class VirtualMesh:
    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 devices: Optional[Sequence] = None, n_spares: int = 0,
                 dp_axis: str = "data"):
        self.shape = tuple(shape)
        self.axes = tuple(axes)
        n = int(np.prod(self.shape))
        if devices is None:
            devices = list(range(n + n_spares))
        if len(devices) < n + n_spares:
            raise ValueError(
                f"need {n + n_spares} devices, got {len(devices)}")
        self.slots: List = list(devices[:n])         # logical slot -> device
        self.spares: List = list(devices[n:n + n_spares])
        self.dead: set = set()
        self.dp_axis = dp_axis
        self.history: List[RemapEvent] = []

    # -- queries --------------------------------------------------------------

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def device_array(self) -> np.ndarray:
        return np.asarray(self.slots, dtype=object).reshape(self.shape)

    def ranks(self) -> np.ndarray:
        """The slots as ranks of the default process group: an int slot
        is its rank, a ``torch.device`` its index."""
        return np.asarray([d if isinstance(d, (int, np.integer))
                           else d.index for d in self.slots],
                          dtype=np.int64).reshape(self.shape)

    def device_mesh(self, device_type: str = "cuda"):
        """A ``DeviceMesh`` over the current slots, axes named as the
        logical mesh's (the reference's ``jax_mesh``). Needs the default
        process group."""
        import torch
        from torch.distributed.device_mesh import DeviceMesh
        return DeviceMesh(device_type, torch.as_tensor(self.ranks()),
                          mesh_dim_names=self.axes)

    def slot_of(self, device) -> int:
        return self.slots.index(device)

    def dp_index_of_slot(self, slot: int) -> int:
        idx = np.unravel_index(slot, self.shape)
        return int(idx[self.axes.index(self.dp_axis)])

    # -- failure handling -------------------------------------------------------

    def fail_devices(self, devices: Sequence) -> RemapEvent:
        """Apply a failure; prefer spare fill, else plan a DP shrink."""
        failed = tuple(d for d in devices if d in self.slots)
        self.dead.update(devices)
        self.spares = [s for s in self.spares if s not in self.dead]
        if not failed:
            ev = RemapEvent("spare_fill", tuple(devices))
            self.history.append(ev)
            return ev
        if len(self.spares) >= len(failed):
            repl = []
            for d in failed:
                s = self.spares.pop(0)
                self.slots[self.slots.index(d)] = s
                repl.append(s)
            ev = RemapEvent("spare_fill", failed, tuple(repl))
            self.history.append(ev)
            return ev
        # shrink: drop every DP slice containing a failed slot
        dp_dim = self.axes.index(self.dp_axis)
        arr = self.device_array()
        bad_dp = sorted({self.dp_index_of_slot(self.slots.index(d))
                         for d in failed})
        keep = [i for i in range(self.shape[dp_dim]) if i not in bad_dp]
        if not keep:
            ev = RemapEvent("fatal", failed)
            self.history.append(ev)
            return ev
        arr = np.take(arr, keep, axis=dp_dim)
        # released healthy devices from dropped slices become spares
        released = [d for d in self.slots
                    if d not in arr.reshape(-1).tolist()
                    and d not in self.dead]
        self.shape = arr.shape
        self.slots = arr.reshape(-1).tolist()
        self.spares.extend(released)
        ev = RemapEvent("shrink_dp", failed, new_dp=len(keep))
        self.history.append(ev)
        return ev


class ExecutableCache:
    """Steps built ahead per degraded configuration: the paper's
    background communicator repair becomes ahead-of-time building, so
    failover never waits on it."""

    def __init__(self):
        self._cache: Dict[Tuple, object] = {}
        self.hits = 0
        self.misses = 0

    def key(self, vm: VirtualMesh, step_kind: str) -> Tuple:
        return (vm.shape, vm.axes, step_kind)

    def get_or_compile(self, vm: VirtualMesh, step_kind: str, compile_fn):
        k = self.key(vm, step_kind)
        if k in self._cache:
            self.hits += 1
            return self._cache[k]
        self.misses += 1
        exe = compile_fn()
        self._cache[k] = exe
        return exe

    def precompile(self, vm_shapes: Sequence[Tuple], step_kind: str,
                   compile_fn):
        for shape in vm_shapes:
            k = (tuple(shape), None, step_kind)
            if k not in self._cache:
                self._cache[k] = compile_fn(shape)
