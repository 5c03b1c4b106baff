"""Production and host meshes (``repro.launch.mesh``) as
:class:`~repro_torch.core.exchange.ShardMesh` es.

The reference's production mesh is 16 x 16 chips a pod (``"data"`` x
``"model"``), and 2 x 16 x 16 with a leading ``"pod"`` axis.  A
``ShardMesh`` has two axes, so the pod axis is the outer factor of the
shards axis: 2 x 16 = 32 shards, pod-major, which is the reference's
``("pod", "data")`` batch axes flattened in their order, so every rank's
block equals the reference's (``DP`` resolves to both batch axes there,
to the shards axis here).  The mesh keeps ``pods`` for the census.

Functions, not module-level meshes: building one touches no device.
"""
from __future__ import annotations

from typing import Optional

from ..core.exchange import ShardMesh, default_devices

POD = (16, 16)   # (data, model) ranks a pod


def make_production_mesh(multi_pod: bool = False, *,
                         abstract_rank: Optional[int] = None) -> ShardMesh:
    """The 16 x 16 production mesh (2 x 16 x 16 with ``multi_pod``).  With
    ``abstract_rank``, that rank of it on the meta device
    (:meth:`ShardMesh.abstract`, the dry run); without, the mesh over the
    initialized ``torch.distributed`` group, one process a rank
    (:meth:`ShardMesh.from_process_group`), which raises unless the group
    has 256 (512) ranks."""
    pods = 2 if multi_pod else 1
    data, model = POD
    if abstract_rank is not None:
        return ShardMesh.abstract(pods * data, model, rank=abstract_rank, pods=pods)
    import torch.distributed as dist
    world = dist.get_world_size()
    if world != pods * data * model:
        raise ValueError(f"the {'multi-pod ' if multi_pod else ''}production mesh needs "
                         f"{pods * data * model} ranks; the group has {world}")
    mesh = ShardMesh.from_process_group(model_axis=model)
    mesh.pods = pods
    return mesh


def make_host_mesh(model: int = 1, device=None) -> ShardMesh:
    """A small mesh over the visible cards (``device``'s list when the
    caller names a non-CUDA device): ``n // model`` x ``model`` ranks."""
    devs = default_devices(device)
    if model < 1 or model > len(devs):
        raise ValueError(f"model={model} for {len(devs)} device(s)")
    return ShardMesh(devs, max(1, len(devs) // model), model)


def mesh_device_count(mesh: ShardMesh) -> int:
    return mesh.n_shards * mesh.model_axis
