"""AdamW with global-norm clipping and optional compressed moments.

Ports ``repro.optim.adamw`` for one device.  ``state_bits=8`` stores the
first moment as int8 with a per-row float32 scale (m is zero-mean; linear
quantization is benign) and the second moment as bfloat16 (v spans many
orders of magnitude; bf16's exponent keeps the relative error ~0.4 %):
10 B/param of optimizer state become 3.1 B/param.  ``torch.round`` rounds
half to even, as ``jnp.round`` does.

The update's float32 arithmetic is the reference's, in the reference's
order.  It runs leaf by leaf and **in place**: each parameter and its
moments are overwritten, a large leaf in slices of whole rows of its last
axis (so the per-row int8 scales are unchanged), so the only transient is
one slice's float32 copy.  The reference returns new trees and donates the
old ones; here the caller's tensors are the new state.

On a :class:`~repro_torch.core.exchange.ShardMesh` the parameters and
moments are :class:`~repro_torch.models.common.ShardedTree` s: the moments
laid out by :func:`adamw_state_template` (under
``runtime_flags.OPT["zero1_opt_state"]`` each also split over data on its
largest unsharded dimension, ZeRO-1), the gradients in the moments'
layout and reduced (``launch.steps.make_train_step`` psum-scatters them
over data into it).  Each rank updates its block of every parameter, in
the same row slices, and the blocks split over data are all-gathered into
the whole parameter; the global norm is the psum over the mesh of each
rank's squares of the blocks it alone holds.  8-bit moments are laid out
as the 32-bit ones, their per-row scales by the parameter's spec with the
row axis whole: where a spec splits a row (its last axis over model, or
over data under ZeRO-1) its scale is the max over the ranks that hold its
pieces (:meth:`~repro_torch.core.exchange.ShardMesh.pmax`), and where
ZeRO-1 splits the rows over data the ranks' scales are all-gathered into
the scale block.
"""
from __future__ import annotations

import itertools
from typing import Any, Iterator, NamedTuple

import torch

from .. import runtime_flags
from ..models.common import (DP, ParamLeaf, ShardedTree, spec_axes, shard_params, shard_zeros,
                             tree_items, tree_map)

#: a larger leaf is updated in slices of at most this many elements
SLICE_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d: updates applied so far
    m: Any                  # first moments (float32, or int8 with m_scale)
    v: Any                  # second moments (float32, or bfloat16)
    m_scale: Any            # None (32-bit state) or per-row float32 scales
    v_scale: Any            # always None (kept for the reference's layout)


def _q8(x):
    """int8 quantize along the last axis; returns (q, scale)."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return torch.round(x / scale).to(torch.int8), scale.to(torch.float32)


def _dq8(q, scale):
    return q.to(torch.float32) * scale


def adamw_state_template(param_tree, state_bits: int = 32):
    """Template tree (:class:`ParamLeaf`) for m / v (+ scales) mirroring the
    parameters' specs, as ``repro.optim.adamw.adamw_state_template``: under
    ``runtime_flags.OPT["zero1_opt_state"]`` each moment also splits its
    largest unsharded dimension over the data axes (ZeRO-1)."""
    zero1 = runtime_flags.OPT["zero1_opt_state"]

    def _zero1_spec(l: ParamLeaf):
        if not zero1 or any(s == DP for s in l.spec):
            return l.spec  # already data-sharded (FSDP params)
        cand = [i for i, s in enumerate(l.spec) if s is None and l.shape[i] > 1]
        if not cand:
            return l.spec
        i = max(cand, key=lambda j: l.shape[j])
        return l.spec[:i] + (DP,) + l.spec[i + 1:]

    def moment(dt):
        return lambda l: ParamLeaf(l.shape, _zero1_spec(l), "zeros", None, dt)

    def scale(l: ParamLeaf):
        return ParamLeaf(l.shape[:-1] + (1,), l.spec[:-1] + (None,), "zeros", None, "float32")

    m = tree_map(moment("int8" if state_bits == 8 else "float32"), param_tree)
    v = tree_map(moment("bfloat16" if state_bits == 8 else "float32"), param_tree)
    ms = tree_map(scale, param_tree) if state_bits == 8 else None
    return {"step": ParamLeaf((), (), "zeros", None, "int32"),
            "m": m, "v": v, "m_scale": ms, "v_scale": None}


def shard_state(state: "AdamWState", params: ShardedTree) -> "AdamWState":
    """``state`` with whole moments laid out for ``params``' mesh by
    :func:`adamw_state_template` (read now); sharded moments as they are."""
    if isinstance(state.m, ShardedTree):
        return state
    bits = 32 if state.m_scale is None else 8
    t = adamw_state_template(params.template, bits)
    return AdamWState(step=state.step.to(params.mesh.rank_device(params.mesh.local_ranks[0])),
                      m=shard_params(state.m, t["m"], params.mesh),
                      v=shard_params(state.v, t["v"], params.mesh),
                      m_scale=None if bits == 32 else shard_params(state.m_scale, t["m_scale"],
                                                                   params.mesh),
                      v_scale=None)


def adamw_init(params, state_bits: int = 32) -> AdamWState:
    """Zero moments beside each parameter, on its device; for a
    :class:`ShardedTree`, each rank's blocks of moments laid out by
    :func:`adamw_state_template`."""
    if isinstance(params, ShardedTree):
        t = adamw_state_template(params.template, state_bits)
        dev = params.mesh.rank_device(params.mesh.local_ranks[0])
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=shard_zeros(t["m"], params.mesh), v=shard_zeros(t["v"], params.mesh),
                          m_scale=None if state_bits == 32 else shard_zeros(t["m_scale"],
                                                                            params.mesh),
                          v_scale=None)
    def zeros(dt, shape=None):
        return lambda p: torch.zeros(p.shape if shape is None else shape(p),
                                     dtype=dt, device=p.device)

    m = tree_map(zeros(torch.int8 if state_bits == 8 else torch.float32), params)
    v = tree_map(zeros(torch.bfloat16 if state_bits == 8 else torch.float32), params)
    ms = (tree_map(zeros(torch.float32, lambda p: p.shape[:-1] + (1,)), params)
          if state_bits == 8 else None)
    dev = next(t for _, t in tree_items(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=m, v=v, m_scale=ms, v_scale=None)


def _row_step(t: torch.Tensor) -> int:
    """Rows of ``t``'s last axis in a slice of at most :data:`SLICE_ELEMS`
    elements (at least one)."""
    return max(1, SLICE_ELEMS // t.shape[-1]) if t.dim() else 1


def _slices(t: torch.Tensor, step: int) -> Iterator[torch.Tensor]:
    """``t`` as rows of its last axis (a view: ``t`` is contiguous), ``step``
    rows a slice."""
    rows = t.view(-1, t.shape[-1]) if t.dim() else t.view(1, 1)
    for i in range(0, rows.shape[0], step):
        yield rows[i:i + step]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(sum(torch.sum(torch.square(s.float()))
                              for s in _slices(x.contiguous(), _row_step(x)))
                          for _, x in tree_items(tree)))


def adamw_update_impl(params, state: AdamWState, grads, lr, *,
                      b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                      weight_decay: float = 0.1, clip_norm: float = 1.0,
                      state_bits: int = 32):
    """One AdamW step in place.  Returns (params, new state, grad norm):
    ``params`` and the state's moment trees are the caller's tensors,
    overwritten; the new state has ``step`` + 1.  ``params`` a
    :class:`ShardedTree`: the mesh form of the module docstring, ``grads``
    a :class:`ShardedTree` in the moments' layout."""
    if isinstance(params, ShardedTree):
        return _update_sharded(params, state, grads, lr, b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay, clip_norm=clip_norm,
                               state_bits=state_bits)
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)

    def upd(p, g, m, v, msc):
        g = g.float() * scale
        m_f = _dq8(m, msc) if state_bits == 8 else m
        v_f = v.float() if state_bits == 8 else v
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * g * g
        upd_ = (m_f / bc1) / (torch.sqrt(v_f / bc2) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * upd_)
        if state_bits == 8:
            mq, ms2 = _q8(m_f)
            m.copy_(mq)
            msc.copy_(ms2)
            v.copy_(v_f)
        else:
            m.copy_(m_f)
            v.copy_(v_f)

    def leaves(tree):
        return [t for _, t in tree_items(tree)]

    flat_p = leaves(params)
    flat_ms = leaves(state.m_scale) if state_bits == 8 else [None] * len(flat_p)
    with torch.no_grad():
        for p, g, m, v, msc in zip(flat_p, leaves(grads), leaves(state.m),
                                   leaves(state.v), flat_ms):
            rows = _row_step(p)
            parts = [_slices(t, rows) for t in (p, g.contiguous(), m, v)]
            parts.append(_slices(msc, rows) if msc is not None else itertools.repeat(None))
            for args in zip(*parts):
                upd(*args)
    return params, AdamWState(step=step, m=state.m, v=state.v, m_scale=state.m_scale,
                              v_scale=None), gnorm


def _first_holder(mesh, r: int, spec) -> bool:
    """Whether rank ``r`` is the first, on every axis ``spec`` leaves
    replicated, to hold its block."""
    held = {a for e in spec for a in spec_axes(e)}
    return all(mesh.axis_index(r, a) == 0 for a in ("data", "model") if a not in held)


def zero1_dim(p_spec, m_spec):
    """The dimension a moment splits over data where its parameter does not
    (ZeRO-1), or None."""
    dims = [d for d, (pe, me) in enumerate(zip(p_spec, m_spec))
            if "data" in spec_axes(me) and "data" not in spec_axes(pe)]
    return dims[0] if dims else None


def _update_sharded(params: ShardedTree, state: AdamWState, grads: ShardedTree, lr, *,
                    b1, b2, eps, weight_decay, clip_norm, state_bits):
    mesh = params.mesh
    p_specs = [sp for _, sp in tree_items(params.specs)]
    m_specs = [sp for _, sp in tree_items(state.m.specs)]
    g_specs = [sp for _, sp in tree_items(grads.specs)]
    if g_specs != m_specs:
        raise ValueError("the gradients are not laid out as the moments")
    q8 = state_bits == 8

    def leaves(tree):
        return [t for _, t in tree_items(tree)]

    ps = [leaves(b) for b in params.blocks]
    gs = [leaves(b) for b in grads.blocks]
    ms = [leaves(b) for b in state.m.blocks]
    vs = [leaves(b) for b in state.v.blocks]
    scs = [leaves(b) for b in state.m_scale.blocks] if q8 else None
    sq = []
    for j, r in enumerate(mesh.local_ranks):
        dev = mesh.rank_device(r)
        tot = torch.zeros((), dtype=torch.float32, device=dev)
        for g, spec in zip(gs[j], g_specs):
            if _first_holder(mesh, r, spec):
                for part in _slices(g.contiguous(), _row_step(g)):
                    tot = tot + torch.sum(torch.square(part.float()))
        sq.append(tot)
    for axis in ("model", "data"):
        sq = mesh.psum(sq, axis)
    gnorms = [torch.sqrt(t) for t in sq]
    step = state.step + 1
    consts = []
    for gnorm in gnorms:
        stp = step.to(gnorm.device)
        consts.append((torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0),
                       1 - b1 ** stp.float(), 1 - b2 ** stp.float(),
                       torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)))
    with torch.no_grad():
        for li, (p_spec, m_spec) in enumerate(zip(p_specs, m_specs)):
            dim = zero1_dim(p_spec, m_spec)
            works, mscs = [], []
            for j, r in enumerate(mesh.local_ranks):
                p = ps[j][li]
                if dim is not None:
                    n = ms[j][li].shape[dim]
                    p = p.narrow(dim, mesh.axis_index(r, "data") * n, n)
                works.append(p if p.is_contiguous() else p.contiguous())
                if q8:
                    # the scales' rows are the parameter's; ZeRO-1 may split
                    # the moment's rows over data further
                    sc = scs[j][li]
                    if dim is not None and dim < sc.dim() - 1:
                        n = ms[j][li].shape[dim]
                        sc = sc.narrow(dim, mesh.axis_index(r, "data") * n, n).contiguous()
                    mscs.append(sc)
            rows = _row_step(works[0])
            parts = [[_slices(t, rows) for t in (works[j], gs[j][li].contiguous(), ms[j][li],
                                                vs[j][li])]
                     + [_slices(mscs[j], rows) if q8 else itertools.repeat(None)]
                     for j in range(len(works))]
            for slices in zip(*[zip(*pj) for pj in parts]):
                m_fs = []
                for (pw, gw, mw, vw, sw), (scale, bc1, bc2, lr_) in zip(slices, consts):
                    gw = gw.float() * scale
                    mf = _dq8(mw, sw) if q8 else mw
                    vf = vw.float() if q8 else vw
                    mf = b1 * mf + (1 - b1) * gw
                    vf = b2 * vf + (1 - b2) * gw * gw
                    u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps) + weight_decay * pw.float()
                    pw.copy_(pw.float() - lr_ * u)
                    vw.copy_(vf)
                    if q8:
                        m_fs.append(mf)
                    else:
                        mw.copy_(mf)
                if not q8:
                    continue
                # a row's int8 scale is its max |m| over every rank that
                # holds a piece of the row
                amax = [torch.amax(torch.abs(mf), dim=-1, keepdim=True) for mf in m_fs]
                for axis in spec_axes(m_spec[-1]):
                    amax = mesh.pmax(amax, axis)
                for (_, _, mw, _, sw), mf, a in zip(slices, m_fs, amax):
                    sc = torch.clamp(a, min=1e-12) / 127.0
                    mw.copy_(torch.round(mf / sc).to(torch.int8))
                    sw.copy_(sc)
            if q8 and dim is not None and dim < scs[0][li].dim() - 1:
                full = mesh.all_gather_axis(mscs, "data", dim)
                for j in range(len(full)):
                    scs[j][li].copy_(full[j])
            if dim is not None:
                works = mesh.all_gather_axis(works, "data", dim)
                for j in range(len(works)):
                    ps[j][li].copy_(works[j])
            else:
                for j, w in enumerate(works):
                    if w.data_ptr() != ps[j][li].data_ptr():
                        ps[j][li].copy_(w)
    return params, AdamWState(step=step, m=state.m, v=state.v, m_scale=state.m_scale,
                              v_scale=None), gnorms[0]


#: the update (no jit on this side; ``adamw_update_impl`` is the same function)
adamw_update = adamw_update_impl
