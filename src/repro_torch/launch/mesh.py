"""Production mesh construction (port of ``repro/launch/mesh.py``).

The meshes are ``torch.distributed`` ``DeviceMesh``es built with
``init_device_mesh`` over the default process group: 16 x 16 ``(data,
model)`` for one pod, 2 x 16 x 16 ``(pod, data, model)`` for two, and the
paper's replication view of one pod, 2 x 8 x 16 ``(rep, data, model)``.

Nothing here touches a process group at import. ``fake_world(n)`` starts
the dry run's stand-in for a cluster of ``n`` devices: one process, torch's
``fake`` backend (every collective a no-op), the counterpart of the
reference forcing 512 host devices; ``end_world`` ends it. The ``fake``
backend's store is an internal module of torch's test suite, and this file
is the only one that imports it.

``activate_mesh(mesh)`` (from ``distributed.context``, which the models
import) installs a mesh as the ambient one that the models read
(``current_mesh()``): the MoE takes its sharded path under one.
"""
from __future__ import annotations

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig
# the ambient mesh the models read, re-exported for the launchers
from repro_torch.distributed.context import (  # noqa: F401
    activate_mesh, current_mesh)


def fake_world(n_devices: int) -> None:
    """Start a one-process world of ``n_devices`` ranks on torch's ``fake``
    backend (rank 0; collectives do nothing), unless one of that size is
    running. Raises if another process group is running."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n_devices and \
                dist.get_backend() == "fake":
            return
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks ({dist.get_backend()}) is running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_devices)


def end_world() -> None:
    """End the default process group, if any."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(cfg: MeshConfig, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``cfg``'s shape and axis names over the default
    process group (``device_type`` names the ranks' devices; the dry run's
    tensors live on ``meta`` whatever it is)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = cfg.n_devices
    if not dist.is_initialized() or dist.get_world_size() < n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"need {n} ranks for mesh {cfg.shape}, have {have}: start a "
            f"world first (fake_world({n}) for the dry run)")
    return init_device_mesh(device_type, tuple(cfg.shape),
                            mesh_dim_names=tuple(cfg.axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    return make_mesh(MULTI_POD if multi_pod else SINGLE_POD, device_type)


def make_replica_split_mesh(n_devices: int = 256, device_type: str = "cpu"):
    """One pod re-viewed for the paper's replication mode: (rep=2,
    data=n/32, model=16); the first ``rep`` slice is the computational
    group, the second the replica group."""
    return make_mesh(MeshConfig((2, n_devices // 32, 16),
                                ("rep", "data", "model")), device_type)
