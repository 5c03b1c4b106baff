"""The shard mesh of sharded execution: one process, or one rank a shard.

The reference runs :class:`~repro_torch.core.pipeline.ShardedRunner`'s
program and the expert-parallel MoE under ``shard_map`` over a ``("shards",
"model")`` (MoE: ``("data", "model")``) device mesh and moves values with
``jax.lax`` collectives.  A :class:`ShardMesh` is that mesh in one of two
backends, with one meaning:

* **one process** (``ShardMesh(devices, n_shards, model_axis)``): the
  ordered device list, rank ``r = k * model_axis + m`` (shard ``k``, model
  rank ``m``) on ``devices[r]``; the process drives every rank, and a
  collective moves tensors between them with ``.to(device)``.  The list
  defaults to the visible cards and is never repeated silently: logical
  shards on one card are an explicit list that names it K times
  (``["cuda:0"] * 4``), as the reference's CPU runs name K forced host
  devices of one CPU.
* **a process group** (:meth:`ShardMesh.from_process_group`): one
  ``torch.distributed`` rank a mesh rank, the same numbering, each process
  driving only its own rank; a collective is the ``torch.distributed`` call
  over the axis's subgroup (``all_gather_into_tensor``,
  ``all_to_all_single``, ``all_reduce`` (sum or max), ``reduce_scatter_tensor``).  This is
  the idiom of a mesh that spans hosts (one controller process per host in
  the reference, ``launch/mesh.py``).
* **an abstract rank** (:meth:`ShardMesh.abstract`): one rank of a mesh
  that no process holds, on the ``meta`` device, for the dry run
  (``launch/dryrun.py``).  It takes the group backend's code path, each
  collective allocating its result as the group's does (a meta tensor of
  the result's shape), and moves nothing: no ``torch.distributed`` call is
  made.

Callers loop over :attr:`ShardMesh.local_ranks` (or
:attr:`ShardMesh.local_shards`): every rank in one process, one under a
group.  A collective takes one tensor per local rank (per local shard for
:meth:`ShardMesh.all_gather`) and returns one per local rank, and adds one
to :attr:`ShardMesh.collectives`, where the reference counts the
collectives of its compiled HLO.  A float8 payload goes over the wire as
its ``uint8`` bytes (gloo refuses float8).

Every backend also keeps a census of what the first local rank moves, as
the reference's ``collective_census`` reads it from the HLO: a count and
the result bytes of each collective, per device, by kind
(:data:`KINDS`: ``all-reduce`` for psum / pmean / pmax, ``all-gather``,
``reduce-scatter``, ``all-to-all``), a backward's transposed collectives
included (:meth:`ShardMesh.census`).  ``collectives`` counts the calls the
program makes; under a group a backward's transposes count there too,
while one process differentiates through its device copies and an
abstract rank counts its transposes as one process would, in the census
only.

Autograd passes through :meth:`ShardMesh.psum`, :meth:`~ShardMesh.pmean`,
:meth:`~ShardMesh.all_gather_axis`, :meth:`~ShardMesh.psum_scatter` and
:meth:`~ShardMesh.all_to_all` in both backends, each rank's gradient being
its share of the transposed collective, as ``jax.lax``'s transposes give
under ``shard_map``: a psum's backward is a psum, an all-gather's a
psum-scatter, a psum-scatter's an all-gather, an all-to-all's an
all-to-all.  One process differentiates through its device copies and
sums (ranks that share a device share one result, each through a view of
its own, so each rank's gradient reaches it as one addend, as under a
group); a group runs each transpose as a collective of its own
(:class:`_Transposed`), which adds one to ``collectives`` like any other,
so under a group the collectives of a backward count too.  Rank ``r``'s
gradients are the derivatives of the sum over ranks of what each rank
differentiates: a value replicated over an axis and differentiated on
every rank of it counts once a rank (``models.lm.loss_fn`` hands each rank
its share).  :meth:`ShardMesh.all_gather` (the sharded GNN exchange) stays
forward only under a group and raises when autograd records.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..device import resolve

Device = Union[str, torch.device]

#: the mesh's two axes; "data" (the reference MoE's name) is the shards axis
AXES = ("shards", "model")
_ALIASES = {"shards": "shards", "data": "shards", "model": "model"}
_WIRE = {torch.float8_e4m3fn: torch.uint8, torch.float8_e5m2: torch.uint8}
#: the reference census's kinds (``collective-permute`` never occurs here)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def default_devices(device: Optional[Device] = None) -> List[torch.device]:
    """The mesh an entry point uses when the caller names none: every
    visible card when ``device`` is CUDA (the default), else ``[device]``."""
    dev = resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


class _Transposed(torch.autograd.Function):
    """A group collective ``run`` whose backward is the collective
    ``transpose`` of the output gradient (both take and return this rank's
    one tensor)."""

    @staticmethod
    def forward(ctx, run, transpose, x):
        ctx.transpose = transpose
        return run(x)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.transpose(g.contiguous())


def _differentiable(run, transpose, x: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Transposed.apply(run, transpose, x)
    return run(x)


def _axis(axis: str) -> str:
    if axis not in _ALIASES:
        raise ValueError(f"unknown mesh axis {axis!r}; axes are {AXES} "
                         "('data' names the shards axis)")
    return _ALIASES[axis]


class ShardMesh:
    """``n_shards`` x ``model_axis`` ranks and the collectives between them.

    The one-process constructor raises ``ValueError`` when ``devices``
    holds fewer than ``n_shards * model_axis`` devices: a caller who wants
    K logical shards on fewer cards names the repeated devices itself.
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
        self.local_ranks = list(range(n_shards * model_axis))
        self.group = None
        self.is_abstract = False
        self.pods = 1
        self.collectives = 0
        self.reset_census()

    @classmethod
    def abstract(cls, n_shards: int, model_axis: int = 1, rank: int = 0,
                 pods: int = 1, device: Device = "meta") -> "ShardMesh":
        """Rank ``rank`` of an ``n_shards`` x ``model_axis`` mesh that no
        process holds, on the ``meta`` device: the dry run's one rank of a
        production mesh.  It drives only its own rank, as a group's process
        does; a collective returns a meta tensor of its result's shape and
        adds to the census.  ``pods`` > 1 splits the shards axis into
        ``pods`` equal pods, the outer factor (rank ``r``'s pod is ``r //
        (n_shards / pods * model_axis)``): the reference's ``("pod",
        "data")`` batch axes flattened pod-major, so every block equals the
        reference's; it is kept so the census can split cross-pod bytes
        out later.  On another ``device`` (tests that count its ops on real
        tensors) a collective's result is zeros, as if every peer held
        zeros."""
        if n_shards % pods:
            raise ValueError(f"{pods} pods do not split {n_shards} shards")
        if not 0 <= rank < n_shards * model_axis:
            raise ValueError(f"rank {rank} is not in a mesh of "
                             f"{n_shards * model_axis} ranks")
        mesh = cls([torch.device(device)] * (n_shards * model_axis), n_shards, model_axis)
        mesh.local_ranks = [rank]
        mesh.rank = rank
        mesh.is_abstract = True
        mesh.pods = pods
        return mesh

    @classmethod
    def from_process_group(cls, model_axis: int = 1, group=None,
                           device: Optional[Device] = None) -> "ShardMesh":
        """The mesh over an initialized ``torch.distributed`` group (the
        default group unless named): ``world_size / model_axis`` shards,
        group rank ``r`` holding shard ``r // model_axis`` and model rank
        ``r % model_axis``.  Its device is ``cuda:{LOCAL_RANK}`` unless the
        caller names another; the CPU only when asked for, and only on
        gloo (NCCL moves CUDA tensors alone).  Every rank must call this,
        in the same order as its other group creations: it makes the axis
        subgroups with ``torch.distributed.new_group``."""
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        if model_axis < 1 or world % model_axis:
            raise ValueError(f"model_axis={model_axis} does not divide the "
                             f"group's {world} ranks")
        dev = resolve(device if device is not None
                      else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        if dist.get_backend(group) == "nccl" and dev.type != "cuda":
            raise ValueError(f"an NCCL group moves CUDA tensors; got {dev}")
        M, K = model_axis, world // model_axis
        mesh = cls([dev] * world, K, M)
        mesh.local_ranks = [rank]
        mesh.group = group if group is not None else dist.group.WORLD
        mesh.rank = rank
        # every rank creates every subgroup, in one order; the axis that
        # spans the whole group reuses it
        granks = dist.get_process_group_ranks(mesh.group)
        mesh._axis_groups = {}
        for axis, members in (
                ("shards", [[k * M + m for k in range(K)] for m in range(M)]),
                ("model", [[k * M + m for m in range(M)] for k in range(K)])):
            for ranks in members:
                g = (mesh.group if len(ranks) == world else
                     dist.new_group([granks[i] for i in ranks]))
                if rank in ranks:
                    mesh._axis_groups[axis] = g
        return mesh

    # --------------------------------------------------------------- census
    def reset_census(self) -> None:
        self._census_bytes = dict.fromkeys(KINDS, 0)
        self._census_counts = dict.fromkeys(KINDS, 0)

    def census(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(result bytes, count) of the first local rank's collectives by
        kind since the last :meth:`reset_census`."""
        return dict(self._census_bytes), dict(self._census_counts)

    def _record(self, kind: str, nbytes: int) -> None:
        self._census_bytes[kind] += int(nbytes)
        self._census_counts[kind] += 1

    def _record_first(self, kind: str, out: Sequence[torch.Tensor],
                      backward: Optional[str] = None, scale: float = 1.0) -> None:
        """One process: the census of the first local rank's result
        ``out[0]``, and, where it records autograd, of the collective its
        backward would transpose to (``backward``, whose result is
        ``scale`` x the gradient's bytes)."""
        self._record(kind, _nbytes(out[0]))
        if backward is not None and out[0].requires_grad:
            out[0].register_hook(lambda g: self._record(backward, _nbytes(g) * scale))

    def _transpose(self, fn):
        """A collective's transpose, for its backward under a group or on an
        abstract rank: on an abstract rank it adds to the census only."""
        if not self.is_abstract:
            return fn

        def quiet(g):
            n = self.collectives
            out = fn(g)
            self.collectives = n
            return out
        return quiet

    # --------------------------------------------------------------- layout
    @property
    def per_rank(self) -> bool:
        """One process a rank (a group, or an abstract rank): each
        collective takes and returns this rank's one tensor."""
        return self.group is not None or self.is_abstract

    @property
    def local_shards(self) -> List[int]:
        """The shards this process drives, each once (its rank-0 device
        runs a shard's replicated compute in one process)."""
        return sorted({r // self.model_axis for r in self.local_ranks})

    def shard_device(self, k: int) -> torch.device:
        """Where shard ``k``'s work runs (its model rank 0's device in one
        process; this rank's device under a group)."""
        if self.per_rank:
            if k not in self.local_shards:
                raise ValueError(f"shard {k} is not driven by this rank")
            return self.devices[self.rank]
        return self.devices[k * self.model_axis]

    def rank_device(self, r: int) -> torch.device:
        """The device of mesh rank ``r`` (a local rank)."""
        return self.devices[r]

    def axis_size(self, axis: str) -> int:
        return self.n_shards if _axis(axis) == "shards" else self.model_axis

    def axis_index(self, r: int, axis: str) -> int:
        """Rank ``r``'s coordinate along ``axis``."""
        return (r // self.model_axis if _axis(axis) == "shards"
                else r % self.model_axis)

    def _peers(self, r: int, axis: str) -> List[int]:
        """The ranks along ``axis`` through ``r``, in axis order."""
        k, m = divmod(r, self.model_axis)
        if _axis(axis) == "shards":
            return [j * self.model_axis + m for j in range(self.n_shards)]
        return [k * self.model_axis + j for j in range(self.model_axis)]

    # ---------------------------------------------------------- collectives
    def all_gather(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """All-gather over the shards axis: ``bufs[i]`` lives on local shard
        ``local_shards[i]``'s device; returns, on each one's device, the
        (K, ...) stack of every shard's buffer.  Under a 2-D mesh each model
        rank ships only its ``ceil(W / M)`` slice of the last axis (padded
        to ``M * ceil(W / M)``) over the shards axis, and one gather over
        the model axis reassembles the full width.

        Shards that share a device share the returned tensor: callers read
        it and never write into it."""
        K, M = self.n_shards, self.model_axis
        local = self.local_shards
        if len(bufs) != len(local):
            raise ValueError(f"{len(bufs)} buffers for {len(local)} shards")
        self.collectives += 1
        if self.per_rank:
            if torch.is_grad_enabled() and bufs[0].requires_grad:
                raise NotImplementedError(
                    "the process-group mesh's shards all_gather is not "
                    "differentiable; run under torch.no_grad()")
            return [self._group_gather_shards(bufs[0])]
        el = bufs[0].element_size()
        if M == 1:
            self._record("all-gather", K * bufs[0].numel() * el)
            return self._stack(bufs, [self.shard_device(j) for j in range(K)])
        W = bufs[0].shape[-1]
        wp = -(-W // M)
        col = bufs[0].numel() // max(W, 1) * wp * K * el
        self._record("all-gather", col)
        self._record("all-gather", M * col)
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

    def _group_gather_shards(self, buf: torch.Tensor) -> torch.Tensor:
        M = self.model_axis
        if M == 1:
            return self._dist_gather(buf, "shards").reshape(
                self.n_shards, *buf.shape)
        W = buf.shape[-1]
        wp = -(-W // M)
        m = self.rank % M
        col = torch.nn.functional.pad(buf, (0, wp * M - W))[
            ..., m * wp:(m + 1) * wp]
        over_shards = self._dist_gather(col, "shards").reshape(
            self.n_shards, *col.shape)
        full = self._dist_gather(over_shards, "model").reshape(
            M, *over_shards.shape)
        return torch.cat(list(full), dim=-1)[..., :W]

    def all_to_all(self, xs: Sequence[torch.Tensor], axis: str
                   ) -> List[torch.Tensor]:
        """``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``: each local
        rank's (n, ...) tensor, n the axis size; rank at axis index ``i``
        gets the (n, ...) stack of every peer's ``[i]`` block."""
        n = self._begin(xs, axis)
        if any(x.shape[0] != n for x in xs):
            raise ValueError(f"all_to_all over {axis!r} needs a leading "
                             f"axis of {n}")
        if self.per_rank:
            def run(x):
                out = torch.empty_like(x)
                self._dist("all-to-all", dist.all_to_all_single, out, x.contiguous(), axis)
                return out
            return [_differentiable(
                run, self._transpose(lambda g: self.all_to_all([g], axis)[0]), xs[0])]
        dtype = xs[0].dtype
        wire = [x.view(_WIRE[dtype]) for x in xs] if dtype in _WIRE else xs
        out = []
        for r in self.local_ranks:
            i, dev = self.axis_index(r, axis), self.rank_device(r)
            y = torch.stack([self._of(wire, p)[i].to(dev) for p in self._peers(r, axis)])
            out.append(y.view(dtype) if dtype in _WIRE else y)
        self._record_first("all-to-all", out, "all-to-all")
        return out

    def psum(self, xs: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """``jax.lax.psum`` over ``axis``: on each local rank the sum of its
        peers' tensors (one process: in axis order)."""
        self._begin(xs, axis)
        return self._sum(xs, axis)

    def pmax(self, xs: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """``jax.lax.pmax`` over ``axis``: on each local rank the elementwise
        max of its peers' tensors.  No gradient: it serves the optimizer's
        per-row int8 scales, which nothing differentiates."""
        self._begin(xs, axis)
        if self.per_rank:
            out = xs[0].detach().contiguous().clone()
            self._dist("all-reduce", partial(dist.all_reduce, op=dist.ReduceOp.MAX), out,
                       None, axis)
            return [out]
        built: Dict[Tuple, torch.Tensor] = {}
        out = []
        for r in self.local_ranks:
            peers, dev = tuple(self._peers(r, axis)), self.rank_device(r)
            if (peers, dev) not in built:
                acc = self._of(xs, peers[0]).detach().to(dev)
                for p in peers[1:]:
                    acc = torch.maximum(acc, self._of(xs, p).detach().to(dev))
                built[peers, dev] = acc
            out.append(built[peers, dev])
        self._record_first("all-reduce", out)
        return out

    def pmean(self, xs: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """``jax.lax.pmean``: the psum over ``axis`` over its size."""
        n = self._begin(xs, axis)
        return [s / n for s in self._sum(xs, axis)]

    def psum_scatter(self, xs: Sequence[torch.Tensor], axis: str, dim: int
                     ) -> List[torch.Tensor]:
        """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
        tiled=True)``: the sum over ``axis``, cut into n blocks along
        ``dim``; rank at axis index ``i`` keeps block ``i``."""
        n = self._begin(xs, axis)
        if any(x.shape[dim] % n for x in xs):
            raise ValueError(f"dim {dim} does not split over {n} ranks")
        if self.per_rank:
            def run(x):
                x = x.movedim(dim, 0).contiguous()
                out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
                self._dist("reduce-scatter", dist.reduce_scatter_tensor, out, x, axis)
                return out.movedim(0, dim).contiguous()
            return [_differentiable(
                run, self._transpose(lambda g: self.all_gather_axis([g], axis, dim)[0]),
                xs[0])]
        out = [s.chunk(n, dim)[self.axis_index(r, axis)]
               for r, s in zip(self.local_ranks, self._sum(xs, axis, record=False))]
        self._record_first("reduce-scatter", out, "all-gather", n)
        return out

    def all_gather_axis(self, xs: Sequence[torch.Tensor], axis: str, dim: int
                        ) -> List[torch.Tensor]:
        """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the peers'
        tensors concatenated along ``dim`` in axis order."""
        n = self._begin(xs, axis)
        if self.per_rank:
            def run(x):
                x = x.movedim(dim, 0).contiguous()
                got = self._dist_gather(x, axis)
                return got.reshape(n * x.shape[0], *x.shape[1:]).movedim(0, dim).contiguous()
            return [_differentiable(
                run, self._transpose(lambda g: self.psum_scatter([g], axis, dim)[0]), xs[0])]
        built: Dict[Tuple, torch.Tensor] = {}
        out = []
        for r in self.local_ranks:
            peers, dev = tuple(self._peers(r, axis)), self.rank_device(r)
            if (peers, dev) not in built:
                built[peers, dev] = torch.cat(
                    [self._of(xs, p).to(dev) for p in peers], dim=dim)
            out.append(built[peers, dev].view_as(built[peers, dev]))
        self._record_first("all-gather", out, "reduce-scatter", 1 / n)
        return out

    # -------------------------------------------------------------- helpers
    def _begin(self, xs: Sequence[torch.Tensor], axis: str) -> int:
        if len(xs) != len(self.local_ranks):
            raise ValueError(f"{len(xs)} tensors for {len(self.local_ranks)} "
                             "local ranks")
        self.collectives += 1
        return self.axis_size(axis)

    def _of(self, xs: Sequence[torch.Tensor], r: int) -> torch.Tensor:
        return xs[self.local_ranks.index(r)]

    def _sum(self, xs: Sequence[torch.Tensor], axis: str, record: bool = True
             ) -> List[torch.Tensor]:
        if self.per_rank:
            def run(x):
                out = x.contiguous().clone()
                self._dist("all-reduce", dist.all_reduce, out, None, axis)
                return out
            return [_differentiable(run, self._transpose(lambda g: self.psum([g], axis)[0]),
                                    xs[0])]
        built: Dict[Tuple, torch.Tensor] = {}
        out = []
        for r in self.local_ranks:
            peers, dev = tuple(self._peers(r, axis)), self.rank_device(r)
            if (peers, dev) not in built:
                acc = self._of(xs, peers[0]).to(dev)
                for p in peers[1:]:
                    acc = acc + self._of(xs, p).to(dev)
                built[peers, dev] = acc
            out.append(built[peers, dev].view_as(built[peers, dev]))
        if record:
            self._record_first("all-reduce", out, "all-reduce")
        return out

    def _dist_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The concatenation along dim 0 of ``x`` over ``axis``'s
        subgroup."""
        x = x.contiguous()
        out = x.new_empty((self.axis_size(axis) * x.shape[0], *x.shape[1:]))
        self._dist("all-gather", dist.all_gather_into_tensor, out, x, axis)
        return out

    def _dist(self, kind: str, call, out: torch.Tensor, x: Optional[torch.Tensor],
              axis: str) -> None:
        """``call(out, x, group=<axis subgroup>)`` (``call(out, group=...)``
        when ``x`` is None: an in-place reduction) on the wire dtype's
        views, counted in the census as ``kind``; an abstract rank makes no
        call (``out`` is already of the result's shape)."""
        self._record(kind, _nbytes(out))
        if self.is_abstract:
            if out.device.type != "meta":
                out.zero_()
            return
        args = [t.view(_WIRE.get(t.dtype, t.dtype)) for t in (out, x)
                if t is not None]
        call(*args, group=self._axis_groups[_axis(axis)])

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
