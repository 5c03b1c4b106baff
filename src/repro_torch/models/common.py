"""Shared model substrate: parameter templates and their sharding specs,
norms, RoPE.

Parameters are declared as :class:`ParamLeaf` templates (shape, dtype, init
scale, logical spec) in nested dicts, the same trees as
``repro.models.common``; a layer stack is a leading axis added by
:func:`stack_templates`.  :func:`materialize` turns a template tree into
tensors on a device.

The spec half is the reference's over a
:class:`~repro_torch.core.exchange.ShardMesh`: ``"model"`` is the
tensor-parallel axis, ``DP`` (every batch axis) and ``DPM`` (every axis)
placeholders resolve against the mesh, whose shards axis is the
reference's ``"data"`` (and ``"pod"``) (:func:`resolve_spec`), and a mesh
axis that does not divide its dimension is dropped (:func:`sanitize_spec`).
:func:`shard_params` is the explicit form of the reference's
``NamedSharding`` placement: each local rank gets the block of every leaf
that its spec names, in a :class:`ShardedTree`; :func:`unshard_params`
undoes it, and :func:`shard_hint` checks or moves an activation to a
spec's layout.  :func:`abstractify` lays a template out with nothing
allocated (``meta`` blocks), for the dry run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve

DP = "__dp__"    # every batch axis of the mesh (its shards axis, "data")
DPM = "__dpm__"  # every mesh axis, batch then model (batch-sharded attention)


@dataclasses.dataclass(frozen=True)
class ParamLeaf:
    shape: Tuple[int, ...]
    spec: Tuple  # logical PartitionSpec entries (None / 'model' / DP)
    init: str = "normal"     # normal | zeros | ones | full
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)
    dtype: str = "bfloat16"

    def fan_in(self) -> int:
        return self.shape[-2] if len(self.shape) >= 2 else 1


def leaf(shape, spec=None, init="normal", scale=None, dtype="bfloat16") -> ParamLeaf:
    spec = tuple(spec) if spec is not None else (None,) * len(shape)
    assert len(spec) == len(shape), (shape, spec)
    return ParamLeaf(tuple(int(s) for s in shape), spec, init, scale, dtype)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_items(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_unflatten(like, flat):
    """The items of ``flat``, in :func:`tree_items` order, placed in a tree of
    ``like``'s structure (nested dicts)."""
    it = iter(flat)
    out: dict = {}
    for path, _ in tree_items(like):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = next(it)
    return out


def stack_templates(tree, n: int):
    """Add a leading layer axis to every leaf."""
    return tree_map(lambda l: ParamLeaf((n,) + l.shape, (None,) + l.spec,
                                        l.init, l.scale, l.dtype), tree)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def materialize(gen: torch.Generator, tree, dtype_override: Optional[str] = None,
                device=None):
    """Tensors for a template tree: normal leaves are N(0, 1) · scale (scale
    1/sqrt(fan_in) unless the leaf names one), drawn in float32 from ``gen``
    on ``device`` (``cuda`` unless the caller names another; see
    :func:`repro_torch.device.resolve`) and cast to the leaf's dtype (or
    ``dtype_override``).  ``gen`` must live on ``device``; it may be None
    for a tree without normal leaves (a cache).  The numbers differ from the
    reference's ``jax.random`` draws; to run both packages on the same
    weights, convert the reference's tree instead
    (:func:`repro_torch.convert.lm_params_from_reference`)."""
    device = resolve(device)

    def one(l: ParamLeaf):
        dt = torch_dtype(dtype_override or l.dtype)
        if l.init == "zeros":
            return torch.zeros(l.shape, dtype=dt, device=device)
        if l.init == "ones":
            return torch.ones(l.shape, dtype=dt, device=device)
        if l.init == "full":
            return torch.full(l.shape, l.scale, dtype=dt, device=device)
        scale = l.scale if l.scale is not None else 1.0 / math.sqrt(max(l.fan_in(), 1))
        t = torch.randn(l.shape, generator=gen, dtype=torch.float32, device=device)
        return t.mul_(scale).to(dt)

    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# specs and sharding over a ShardMesh
# ---------------------------------------------------------------------------

def resolve_spec(spec: Tuple, mesh) -> Tuple:
    """Replace the ``DP`` / ``DPM`` placeholders with the mesh's axes, as
    ``repro.models.common.resolve_spec`` does for a ("data", "model")
    mesh: ``DP`` -> ``"data"``, ``DPM`` -> ``("data", "model")``."""
    return tuple("data" if s == DP else ("data", "model") if s == DPM else s
                 for s in spec)


def spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, entry) -> int:
    n = 1
    for a in spec_axes(entry):
        n *= mesh.axis_size(a)
    return n


def sanitize_spec(spec: Tuple, shape, mesh) -> Tuple:
    """Drop the mesh axes that do not divide their dimension (3 KV heads on
    a 4-wide model axis): that dimension is replicated."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(e if dim % _axis_size(mesh, e) == 0 else None
                 for dim, e in zip(shape, spec))


def spec_tree(tree, mesh):
    """Each template leaf's spec, resolved against ``mesh``."""
    return tree_map(lambda l: resolve_spec(l.spec, mesh), tree)


def leaf_spec(l: ParamLeaf, mesh) -> Tuple:
    """A template leaf's resolved, sanitized spec: the layout it has on
    ``mesh``."""
    return sanitize_spec(resolve_spec(l.spec, mesh), l.shape, mesh)


def block_slices(spec: Tuple, shape, mesh, r: int) -> Tuple[slice, ...]:
    """Rank ``r``'s block of a value of ``shape`` laid out by the resolved,
    sanitized ``spec``: a dimension split over an axis tuple takes the
    block of the ranks' mixed-radix index, the first axis major."""
    out = []
    for dim, e in zip(shape, spec):
        idx, n = 0, 1
        for a in spec_axes(e):
            idx = idx * mesh.axis_size(a) + mesh.axis_index(r, a)
            n *= mesh.axis_size(a)
        out.append(slice(idx * (dim // n), (idx + 1) * (dim // n)))
    return tuple(out)


def _own_block(t: torch.Tensor, spec: Tuple, mesh, r: int) -> torch.Tensor:
    """Rank ``r``'s block of ``t`` on its device, contiguous; differentiable
    in ``t``.  Where ``r`` is its process's only rank and the block is the
    whole of ``t``, ``t`` itself (moved, if it lies elsewhere), which the
    train step updates in place as ``mesh=None``'s does; any other block
    shares no storage with ``t`` (ranks of one process update their blocks
    in place)."""
    sl = block_slices(spec, t.shape, mesh, r)
    dev = mesh.rank_device(r)
    if len(mesh.local_ranks) == 1 and all(s.stop - s.start == n for s, n in zip(sl, t.shape)):
        return t.to(dev).contiguous()
    b = t[sl].to(dev).contiguous()
    if b.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        b = b.clone()
    return b


@dataclasses.dataclass
class ShardedTree:
    """A tree split over a :class:`~repro_torch.core.exchange.ShardMesh`:
    ``blocks[j]`` is local rank ``mesh.local_ranks[j]``'s tree of blocks on
    its device, ``template`` the :class:`ParamLeaf` tree it was laid out by
    and ``specs`` each leaf's resolved, sanitized spec."""

    mesh: object
    template: Dict
    specs: Dict
    blocks: List[Dict]

    def sub(self, key: str) -> "ShardedTree":
        return ShardedTree(self.mesh, self.template[key], self.specs[key],
                           [b[key] for b in self.blocks])

    def __contains__(self, key: str) -> bool:
        return key in self.template

    def layer(self, i: int) -> "ShardedTree":
        """Layer ``i`` of a stacked tree (views, no copy)."""
        return ShardedTree(
            self.mesh,
            tree_map(lambda l: ParamLeaf(l.shape[1:], l.spec[1:], l.init, l.scale,
                                         l.dtype), self.template),
            tree_map(lambda s: s[1:], self.specs),
            [layer(b, i) for b in self.blocks])

    def n_layers(self) -> int:
        return next(l for _, l in tree_items(self.template)).shape[0]

    def local(self, key: str) -> List[torch.Tensor]:
        """Every local rank's block of leaf ``key``, as laid out."""
        return [b[key] for b in self.blocks]

    def gathered(self, key: str) -> Tuple[List[torch.Tensor], Tuple]:
        """Leaf ``key`` with its dimensions sharded over data (FSDP)
        all-gathered over data, where a layer uses it, and the spec it then
        has.  Autograd returns its gradient reduce-scattered."""
        xs, spec = self.local(key), self.specs[key]
        for dim, e in enumerate(spec):
            if "data" in spec_axes(e):
                if e != "data":
                    raise ValueError(f"{key}: spec {spec} shards a dim over data "
                                     "and another axis")
                xs = self.mesh.all_gather_axis(xs, "data", dim)
        return xs, tuple(None if e == "data" else e for e in spec)


def shard_params(params, template, mesh) -> ShardedTree:
    """Each local rank's block of every leaf of ``params`` (a tree of whole
    tensors of ``template``'s shapes), by the leaf's resolved, sanitized
    spec, on the rank's device.  A :class:`ShardedTree` is returned as it
    is.  Differentiable in the whole tensors: one process's gradients
    through the blocks come back summed over the copies."""
    if isinstance(params, ShardedTree):
        return params
    specs = tree_map(lambda l: leaf_spec(l, mesh), template)
    flat = list(tree_items(params))
    spec_flat = [s for _, s in tree_items(specs)]
    if len(flat) != len(spec_flat):
        raise ValueError(f"{len(flat)} leaves for a template of {len(spec_flat)}")
    blocks = [tree_unflatten(params, [_own_block(t, sp, mesh, r)
                                      for (_, t), sp in zip(flat, spec_flat)])
              for r in mesh.local_ranks]
    return ShardedTree(mesh, template, specs, blocks)


def shard_zeros(template, mesh, dtype_override: Optional[str] = None) -> ShardedTree:
    """A :class:`ShardedTree` of zeros by ``template`` (a cache, moments):
    each local rank allocates its blocks only."""
    specs = tree_map(lambda l: leaf_spec(l, mesh), template)

    def block(r):
        def one(l: ParamLeaf, sp):
            shape = [s.stop - s.start for s in block_slices(sp, l.shape, mesh, r)]
            return torch.zeros(shape, dtype=torch_dtype(dtype_override or l.dtype),
                               device=mesh.rank_device(r))
        return tree_unflatten(template, [one(l, sp) for (_, l), (_, sp) in
                                         zip(tree_items(template), tree_items(specs))])

    return ShardedTree(mesh, template, specs, [block(r) for r in mesh.local_ranks])


def abstractify(tree, mesh, dtype_override: Optional[str] = None) -> ShardedTree:
    """A template tree laid out on ``mesh`` with nothing allocated: each
    local rank's block of every leaf as a ``meta`` tensor of the block's
    shape (``block_slices`` of the leaf's resolved, sanitized spec) in the
    leaf's dtype (or ``dtype_override``), as the reference's
    ``abstractify`` gives ``ShapeDtypeStruct`` s with a ``NamedSharding``.
    The :class:`ShardedTree` carries each leaf's global shape (its
    template) and spec."""
    specs = tree_map(lambda l: leaf_spec(l, mesh), tree)

    def block(r):
        def one(l: ParamLeaf, sp):
            shape = [s.stop - s.start for s in block_slices(sp, l.shape, mesh, r)]
            return torch.empty(shape, dtype=torch_dtype(dtype_override or l.dtype),
                               device="meta")
        return tree_unflatten(tree, [one(l, sp) for (_, l), (_, sp) in
                                     zip(tree_items(tree), tree_items(specs))])

    return ShardedTree(mesh, tree, specs, [block(r) for r in mesh.local_ranks])


def unshard_params(sp: ShardedTree) -> Dict:
    """The whole tree back from its blocks, on local rank 0's device: each
    sharded dimension all-gathered over its axes (minor axis first).
    Every rank of a process-group mesh must call it."""
    mesh = sp.mesh
    out = []
    for (_, spec), xs in zip(tree_items(sp.specs),
                             zip(*[[t for _, t in tree_items(b)] for b in sp.blocks])):
        xs = list(xs)
        for dim, e in enumerate(spec):
            for a in reversed(spec_axes(e)):
                xs = mesh.all_gather_axis(xs, a, dim)
        out.append(xs[0])
    return tree_unflatten(sp.template, out)


class LoneRank:
    """``mesh=None`` as a body written for a mesh sees it: one rank on
    ``device``, holding every leaf whole.  It has no collectives: nothing of
    a :func:`lone_tree` is sharded, so a body run on one calls none."""

    n_shards = model_axis = 1
    local_ranks = local_shards = (0,)

    def __init__(self, device):
        self.device = device

    def axis_size(self, axis: str) -> int:
        return 1

    def axis_index(self, r: int, axis: str) -> int:
        return 0

    def rank_device(self, r: int):
        return self.device


def lone_tree(tree) -> ShardedTree:
    """Whole tensors (nested dicts) as the one block of a
    :class:`LoneRank`, as they are (no copy), every spec unsharded; a
    :class:`ShardedTree` is returned as it is."""
    if isinstance(tree, ShardedTree):
        return tree
    tmpl = tree_map(lambda t: ParamLeaf(tuple(t.shape), (None,) * t.dim(), dtype=str(
        t.dtype).replace("torch.", "")), tree)
    dev = next(t for _, t in tree_items(tree)).device
    return ShardedTree(LoneRank(dev), tmpl, tree_map(lambda l: l.spec, tmpl), [tree])


def on_ranks(p, x, state, mesh):
    """A block's arguments as its one body reads them: with ``mesh``, as
    they come (``p`` and ``state`` :class:`ShardedTree` s, ``x`` one tensor
    a local rank); without, a lone rank's (:func:`lone_tree`, ``[x]``)."""
    if mesh is not None:
        return p, x, state
    return lone_tree(p), [x], None if state is None else lone_tree(state)


def off_ranks(mesh, ys, states):
    """The inverse of :func:`on_ranks` on a block's outputs."""
    if mesh is not None:
        return ys, states
    return ys[0], None if states is None else states[0]


def _merge_ranges(ranges: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for lo, hi in ranges:
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        elif hi > lo:
            out.append((lo, hi))
    return out


def take(mesh, xs: Sequence[torch.Tensor], dim: int, sharded: bool, n: int,
         want: Callable[[int], Sequence[Tuple[int, int]]]) -> List[torch.Tensor]:
    """Each local rank's index ranges ``want(m)`` (m its model index) of a
    length-``n`` dimension ``dim``, concatenated in order.  ``xs`` hold one
    tensor a local rank: along ``dim`` its model rank's block of ``n`` when
    ``sharded``, else all of it.  Where every model rank finds what it wants
    in its own block, each slices it (a view); otherwise the blocks are
    all-gathered over model once and every rank slices the whole.  A rank
    that wants all of a whole dimension gets its tensor as it is."""
    M = mesh.model_axis if sharded else 1
    blk = n // M
    wants = [_merge_ranges(want(m)) for m in range(mesh.model_axis)]

    def inside(m):
        return all(m * blk <= lo and hi <= (m + 1) * blk for lo, hi in wants[m])

    if sharded and M > 1 and not all(inside(m) for m in range(M)):
        xs, sharded = mesh.all_gather_axis(list(xs), "model", dim), False
    out = []
    for x, r in zip(xs, mesh.local_ranks):
        m = mesh.axis_index(r, "model")
        base = m * blk if sharded else 0
        parts = [x.narrow(dim, lo - base, hi - lo) if (lo - base, hi - lo) != (0, x.shape[dim])
                 else x for lo, hi in wants[m]]
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim))
    return out


def take_leaf(sp: ShardedTree, key: str, dim: int,
              want: Callable[[int], Sequence[Tuple[int, int]]]) -> List[torch.Tensor]:
    """:func:`take` on leaf ``key`` of ``sp`` (its FSDP dimensions gathered
    first, :meth:`ShardedTree.gathered`)."""
    xs, spec = sp.gathered(key)
    n = sp.template[key].shape[dim]
    return take(sp.mesh, xs, dim, model_sharded(spec[dim]), n, want)


def whole(mesh, xs: Sequence[torch.Tensor], dim: int, sharded: bool) -> List[torch.Tensor]:
    """Blocks split over model along ``dim`` (when ``sharded``) all-gathered
    into the whole; whole ones as they are."""
    return mesh.all_gather_axis(list(xs), "model", dim) if sharded and mesh.model_axis > 1 \
        else list(xs)


def whole_leaf(sp: ShardedTree, key: str) -> List[torch.Tensor]:
    """Leaf ``key`` whole on every local rank."""
    xs, spec = sp.gathered(key)
    for dim, e in enumerate(spec):
        xs = whole(sp.mesh, xs, dim, model_sharded(e))
    return xs


def own_range(mesh, n: int, m: int, unit: int = 1) -> Tuple[int, int]:
    """Model rank ``m``'s share of ``n`` heads (x ``unit`` columns each):
    its block when the heads divide the model axis, else all of them (every
    rank computes them, as GSPMD replicates what a spec cannot split)."""
    M = mesh.model_axis
    if n % M:
        return 0, n * unit
    return m * (n // M) * unit, (m + 1) * (n // M) * unit


def rms_norm_split(mesh, hs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                   eps: float, width: int) -> List[torch.Tensor]:
    """:func:`rms_norm` over a ``width``-wide last dimension of which each
    rank holds a block (its ``hs`` and ``ws``): the mean square is the psum
    over model of each rank's sum of squares over ``width``.  Blocks that
    are the whole width take :func:`rms_norm` itself."""
    if hs[0].shape[-1] == width:
        return [rms_norm(h, w, eps) for h, w in zip(hs, ws)]
    fs = [h.float() for h in hs]
    ss = mesh.psum([(f * f).sum(-1, keepdim=True) for f in fs], "model")
    return [(f * torch.rsqrt(s / width + eps) * w.float()).to(h.dtype)
            for f, s, w, h in zip(fs, ss, ws, hs)]


def shard_hint(x, mesh, *spec):
    """The layout ``spec`` names (``DP`` resolved, indivisible axes
    dropped), as the reference's ``with_sharding_constraint``: a whole
    tensor is moved to it, one block a local rank on the rank's device;
    a list of blocks is checked to hold one a local rank, on its device.
    Without a mesh ``x`` is returned as it is."""
    if mesh is None:
        return x
    if isinstance(x, torch.Tensor):
        s = sanitize_spec(resolve_spec(spec, mesh), x.shape, mesh)
        return [x[block_slices(s, x.shape, mesh, r)].to(mesh.rank_device(r))
                for r in mesh.local_ranks]
    def on(t, d):
        return t.device.type == d.type and d.index in (None, t.device.index)

    if len(x) != len(mesh.local_ranks) or not all(
            on(t, mesh.rank_device(r)) for t, r in zip(x, mesh.local_ranks)):
        raise ValueError("blocks do not match the mesh's local ranks")
    return x


def join_blocks(xs: Sequence[torch.Tensor], mesh, device) -> torch.Tensor:
    """The rows of this process's data shards, in order, on ``device``:
    each local shard's block from its first local rank (model ranks hold
    the same rows), concatenated on dim 0."""
    first = {}
    for x, r in zip(xs, mesh.local_ranks):
        first.setdefault(mesh.axis_index(r, "data"), x)
    return torch.cat([first[k].to(device) for k in sorted(first)])


def whole_rows(xs: Sequence[torch.Tensor], mesh, device) -> torch.Tensor:
    """The whole value of blocks split over data on dim 0 (replicated over
    model), all-gathered over data, on ``device``."""
    return mesh.all_gather_axis(list(xs), "data", 0)[0].to(device)


def model_sharded(entry) -> bool:
    return "model" in spec_axes(entry)


def row_parallel(mesh, hs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                 w_spec: Tuple, *, full: bool) -> List[torch.Tensor]:
    """``h @ w`` where ``w`` (contraction dim first) is laid out by
    ``w_spec`` and each rank's ``h`` holds the whole contraction dim
    (``full``) or the model rank's block of it.  Rows sharded over model:
    each rank multiplies its block and the partial products are psummed
    over model; rows replicated: every rank multiplies the whole."""
    if model_sharded(w_spec[0]):
        if full:
            n = ws[0].shape[0]
            hs = [h[..., mesh.axis_index(r, "model") * n:(mesh.axis_index(r, "model") + 1) * n]
                  for h, r in zip(hs, mesh.local_ranks)]
        return mesh.psum([h @ w for h, w in zip(hs, ws)], "model")
    if not full:
        hs = mesh.all_gather_axis(hs, "model", hs[0].dim() - 1)
    return [h @ w for h, w in zip(hs, ws)]


def split_heads(mesh, ys: Sequence[torch.Tensor], n_heads: int, head_dim: int,
                sharded: bool) -> Tuple[List[torch.Tensor], List[range]]:
    """A projection's output, (B, S, columns), as heads: when its columns
    are sharded over model and the heads divide the axis, each rank's own
    heads; otherwise every head (sharded columns all-gathered over model
    first: they split mid-head).  Returns the (B, S, h, head_dim) tensors
    and each rank's global head indices."""
    M = mesh.model_axis
    if sharded and n_heads % M == 0:
        h = n_heads // M
        heads = [range(mesh.axis_index(r, "model") * h, (mesh.axis_index(r, "model") + 1) * h)
                 for r in mesh.local_ranks]
    else:
        if sharded:
            ys = mesh.all_gather_axis(ys, "model", ys[0].dim() - 1)
        heads = [range(n_heads)] * len(ys)
    return ([y.reshape(*y.shape[:-1], len(hd), head_dim) for y, hd in zip(ys, heads)],
            heads)


def select_heads(t: torch.Tensor, have: range, need: Sequence[int]) -> torch.Tensor:
    """The heads ``need`` of ``t`` (B, S, len(have), D), which holds heads
    ``have``: a view when ``need`` is runs of equal length of consecutive
    heads (flash attention's grouping), else one head per entry."""
    need = list(need)
    lo, hi = need[0], need[-1] + 1
    runs = [need.count(j) for j in range(lo, hi)]
    if len(set(runs)) == 1 and need == sorted(need):
        return t[:, :, lo - have.start:hi - have.start]
    idx = torch.as_tensor([j - have.start for j in need], device=t.device)
    return t.index_select(2, idx)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    h = x.float()
    h = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps)
    return (h * w.float()).to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    h = x.float()
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * w.float() + b.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_mrope(x, positions, sections: Tuple[int, int, int], theta: float):
    """Multimodal RoPE (Qwen2-VL) as ``repro.models.common.apply_mrope``
    defines it: the modality frontend is a stub, so the (t, h, w) position
    streams all carry the text position and the rotation is 1-D RoPE;
    ``sections`` is not read.  Nothing calls it, as in the reference, whose
    ``gqa_attention`` applies 1-D RoPE to the vlm family too."""
    cos, sin = rope_freqs(x.shape[-1], theta, positions)
    return apply_rope(x, cos, sin)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, dtype=torch.float32, device=device)


def cross_entropy(logits, labels, *, z_loss: float = 1e-4):
    """Mean token cross-entropy in float32 plus ``z_loss`` x logsumexp^2
    (logit drift control), as ``repro.models.common.cross_entropy``.
    logits: (..., V); labels: (...) int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    ce = lse - gold
    return (ce + z_loss * lse ** 2).mean()
