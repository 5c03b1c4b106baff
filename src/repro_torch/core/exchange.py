"""The shard mesh of sharded execution, driven from one process.

The reference runs :class:`~repro_torch.core.pipeline.ShardedRunner`'s
program under ``shard_map`` over a ``("shards",)`` or ``("shards",
"model")`` device mesh and exchanges values with ``jax.lax.all_gather``.
Here one Python process drives every shard: a :class:`ShardMesh` is the
ordered device list (shard ``k``, model rank ``m`` on
``devices[k * model_axis + m]``), each shard's work runs on its own device,
and every cross-shard move goes through :meth:`ShardMesh.all_gather`, which
counts its calls (``collectives``) where the reference counts all-gathers in
its compiled HLO.

The device list defaults to the visible cards and is never repeated
silently.  A mesh of logical shards on one card is an explicit list that
names the card K times (``["cuda:0"] * 4``), as the reference's CPU runs
name K forced host devices of one CPU.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from ..device import resolve

Device = Union[str, torch.device]


def default_devices(device: Optional[Device] = None) -> List[torch.device]:
    """The mesh an entry point uses when the caller names none: every
    visible card when ``device`` is CUDA (the default), else ``[device]``."""
    dev = resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


class ShardMesh:
    """``n_shards`` x ``model_axis`` devices and the one collective between
    them.

    Raises ``ValueError`` when the list holds fewer than
    ``n_shards * model_axis`` devices: a caller who wants K logical shards
    on fewer cards names the repeated devices itself.
    """

    def __init__(self, devices: Sequence[Device], n_shards: int,
                 model_axis: int = 1):
        if model_axis < 1:
            raise ValueError(f"model_axis must be >= 1, got {model_axis}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        devices = [torch.device(d) for d in devices]
        if n_shards * model_axis > len(devices):
            raise ValueError(
                f"n_devices={n_shards} x model_axis={model_axis} but the "
                f"mesh lists only {len(devices)} device(s); for logical "
                "shards on fewer cards pass an explicit devices= list that "
                "names a card more than once")
        self.n_shards = n_shards
        self.model_axis = model_axis
        self.devices = devices[:n_shards * model_axis]
        self.collectives = 0

    def shard_device(self, k: int) -> torch.device:
        """Where shard ``k``'s work runs (its model rank 0)."""
        return self.devices[k * self.model_axis]

    def all_gather(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """All-gather over the shards axis: ``bufs[k]`` lives on shard
        ``k``'s device; returns, on each shard's device, the (K, ...) stack.
        Under a 2-D mesh each model rank ships only its ``ceil(W / M)``
        slice of the last axis (padded to ``M * ceil(W / M)``) over the
        shards axis, and the full width is reassembled on rank 0.

        Shards that share a device share the returned tensor: callers read
        it and never write into it."""
        K, M = self.n_shards, self.model_axis
        if len(bufs) != K:
            raise ValueError(f"{len(bufs)} buffers for {K} shards")
        self.collectives += 1
        if M == 1:
            return self._stack(bufs, [self.shard_device(j) for j in range(K)])
        W = bufs[0].shape[-1]
        wp = -(-W // M)
        padded = [torch.nn.functional.pad(b, (0, wp * M - W)) for b in bufs]
        # model rank m of every shard ships its column slice over "shards"
        per_rank = [self._stack(
            [p[..., m * wp:(m + 1) * wp].to(self.devices[k * M + m])
             for k, p in enumerate(padded)],
            [self.devices[j * M + m] for j in range(K)]) for m in range(M)]
        # then one model-axis gather reassembles full width on each shard
        return [torch.cat([per_rank[m][j].to(self.shard_device(j))
                           for m in range(M)], dim=-1)[..., :W]
                for j in range(K)]

    @staticmethod
    def _stack(bufs: Sequence[torch.Tensor],
               targets: Sequence[torch.device]) -> List[torch.Tensor]:
        """The stack of ``bufs`` on each target device, built once per
        distinct device."""
        built: Dict[torch.device, torch.Tensor] = {}
        out = []
        for dev in targets:
            if dev not in built:
                built[dev] = torch.stack([b.to(dev) for b in bufs])
            out.append(built[dev])
        return out
