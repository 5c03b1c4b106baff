"""Routed MoE layer (DeepSeek V2/V3 family) and the dense FFNs.

Ports ``repro.models.moe``: token chunking and the capacity formula are the
reference's (moe.py:129,155-159).  Without a mesh the body is route ->
dispatch -> grouped FFN (the CUDA kernel on the card) -> combine
(``kernels.moe_dispatch.ops.moe_block``).  With a
:class:`~repro_torch.core.exchange.ShardMesh` of ``n_data`` shards x
``n_model`` model ranks it is the reference's expert-parallel body,
:func:`_local_moe` (moe.py:54): tokens split over the data shards, experts
``E / n_data`` a data shard and FFN columns ``f / n_model`` a model rank
(the blocks :func:`~repro_torch.models.common.shard_params` gives by
:func:`moe_template`'s specs), buckets exchanged by ``all_to_all`` over
data, the down projection reduced over model, and the
``moe_fp8_dispatch`` / ``moe_rs_combine`` options of
:mod:`repro_torch.runtime_flags`; the shared experts and the dense FFNs
are tensor parallel over model (column blocks in, row block out, a psum).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import runtime_flags
from ..configs.base import ArchConfig
from ..core.exchange import ShardMesh
from ..kernels.moe_dispatch import ops as moe_ops
from .common import (DP, ShardedTree, whole_rows, leaf, model_sharded, row_parallel,
                     shard_hint, shard_params)


def moe_template(cfg: ArchConfig) -> Dict:
    mo = cfg.moe
    d, f = cfg.d_model, mo.d_ff_expert
    t = {
        "router": leaf((d, mo.n_routed), (None, None), dtype="float32"),
        "wg": leaf((mo.n_routed, d, f), (DP, None, "model")),
        "wu": leaf((mo.n_routed, d, f), (DP, None, "model")),
        "wd": leaf((mo.n_routed, f, d), (DP, "model", None)),
    }
    if mo.aux_free_bias:
        t["router_bias"] = leaf((mo.n_routed,), (None,), init="zeros", dtype="float32")
    if mo.n_shared:
        fs = mo.d_ff_expert * mo.n_shared
        t["shared_wg"] = leaf((d, fs), (None, "model"))
        t["shared_wu"] = leaf((d, fs), (None, "model"))
        t["shared_wd"] = leaf((fs, d), ("model", None))
    return t


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Bucket rows per expert for a dispatch of ``n_tokens`` (moe.py:129)."""
    mo = cfg.moe
    return max(8, int(n_tokens * mo.top_k / mo.n_routed * mo.capacity_factor))


def _local_moe(cfg: ArchConfig, xs: Sequence[torch.Tensor], routers, router_biases,
               experts: Sequence[Tuple[torch.Tensor, ...]], *, mesh: ShardMesh,
               capacity: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The reference's per-device body (moe.py:54-132) on every local rank
    at once: ``xs[j]`` (T_loc, d), ``routers[j]`` (and the balancing bias,
    or None) and ``experts[j]`` = (wg, wu, wd) blocks on local rank
    ``mesh.local_ranks[j]``'s device.  Returns per local rank the (T_loc, d)
    output and the aux loss (pmean'd over data).

    The local SwiGLU runs :func:`~repro_torch.kernels.moe_dispatch.ops
    .grouped_ffn` (the CUDA kernel on the card) over the (E_loc, n_data * C,
    d) received buckets with every row counted live: the live rows of a
    local expert are a prefix of each source's C-row block, not of the
    whole, and a dead row is zero, so its output is zero too (SwiGLU(0) =
    0), as the reference's einsums give."""
    mo = cfg.moe
    E, n_data, n_model = mo.n_routed, mesh.n_shards, mesh.model_axis
    E_loc, C = E // n_data, capacity
    d = xs[0].shape[-1]
    rs = [moe_ops.route(x, router.to(x.dtype), mo.top_k, C, norm_topk=mo.norm_topk,
                        router_bias=bias)
          for x, router, bias in zip(xs, routers, router_biases)]
    bs = [moe_ops.dispatch(x, r, E, C).reshape(n_data, E_loc, C, d)
          for x, r in zip(xs, rs)]
    # ---- expert-parallel all_to_all over the data axis ----------------------
    fp8 = runtime_flags.OPT["moe_fp8_dispatch"]
    if fp8:
        # one scale a rank; the receiver multiplies every source's block by
        # its own, as the reference does (ROADMAP C.7)
        scales = [torch.clamp(b.abs().max(), min=1e-6) / 448.0 for b in bs]
        bs = [(b / s).to(torch.float8_e4m3fn) for b, s in zip(bs, scales)]
    if n_data > 1:
        bs = mesh.all_to_all(bs, "data")
    if fp8:
        bs = [b.to(x.dtype) * s for b, x, s in zip(bs, xs, scales)]
    # b[j] now holds source shard j's buckets for this rank's experts
    bs = [b.transpose(0, 1).reshape(E_loc, n_data * C, d) for b in bs]
    # ---- grouped FFN over local experts (ff sharded over model) -------------
    ys = []
    for b, (wg, wu, wd) in zip(bs, experts):
        live = torch.full((E_loc,), n_data * C, dtype=torch.int32, device=b.device)
        ys.append(moe_ops.grouped_ffn(b, wg, wu, wd, live))
    rs_mode = runtime_flags.OPT["moe_rs_combine"]
    if rs_mode and d % n_model == 0:
        # reduce-scatter and carry d / n_model through the return
        # all_to_all; one thin all-gather re-assembles the tokens
        ys = mesh.psum_scatter(ys, "model", dim=2)
        d_s = d // n_model
    else:
        ys = mesh.psum(ys, "model")
        d_s = d
    # ---- return path ---------------------------------------------------------
    ys = [y.reshape(E_loc, n_data, C, d_s).transpose(0, 1).contiguous() for y in ys]
    if n_data > 1:
        ys = mesh.all_to_all(ys, "data")
    outs = [moe_ops.combine(y.reshape(E, C, d_s), r, x.shape[0])
            for y, r, x in zip(ys, rs, xs)]
    if rs_mode and d_s != d:
        outs = mesh.all_gather_axis(outs, "model", dim=1)
    aux = [r.aux_loss for r in rs]
    if n_data > 1:
        aux = mesh.pmean(aux, "data")
    return outs, aux


def _moe_mesh(cfg: ArchConfig, sp: ShardedTree, xs: Sequence[torch.Tensor], *,
              mesh: ShardMesh, token_chunks: int):
    """The routed experts on each local rank's (T_loc, d) tokens, in
    ``token_chunks`` rounds of T_loc / token_chunks contiguous tokens when
    that divides, else one.  A block's routing, capacity and output depend
    on its own tokens only (the experts of every shard serve it through
    the all-to-all), so a round of each shard's next block gives every
    block the reference's result, whose chunks group the blocks across
    shards instead: no token moves between shards first.  The aux loss is
    the mean over rounds, as the reference's over chunks."""
    routers = sp.gathered("router")[0]
    biases = (sp.gathered("router_bias")[0] if "router_bias" in sp
              else [None] * len(xs))
    experts = list(zip(sp.local("wg"), sp.local("wu"), sp.local("wd")))
    T_loc = xs[0].shape[0]
    if runtime_flags.probe_stacks() is not None:
        token_chunks = 1  # cost probe: all tokens through one dispatch
    if not (token_chunks > 1 and T_loc % token_chunks == 0):
        token_chunks = 1
    T_blk = T_loc // token_chunks
    ys, auxs = [], []
    for c in range(token_chunks):
        o, a = _local_moe(cfg, [x[c * T_blk:(c + 1) * T_blk] for x in xs], routers, biases,
                          experts, mesh=mesh, capacity=capacity(cfg, T_blk))
        ys.append(o)
        auxs.append(a)
    ys = [torch.cat(parts) for parts in zip(*ys)]
    auxs = [torch.stack(parts).mean() for parts in zip(*auxs)]
    return ys, auxs


def moe_layer(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
              mesh: Optional[ShardMesh] = None,
              token_chunks: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Tokens go through the experts in
    ``token_chunks`` chunks when B * S divides by ``token_chunks * n_data``,
    else in one (one always while ``runtime_flags`` probes stacks).

    With a ``mesh`` (``p`` whole, sharded on entry by :func:`moe_template`,
    or a :class:`ShardedTree`): the reference's expert-parallel body,
    :func:`_local_moe`, on each data shard's tokens (:func:`_moe_mesh`),
    the shared experts tensor parallel over model.  ``x`` whole: its B * S
    tokens split in ``n_data`` contiguous blocks (the reference's ``P(data,
    None)``) and ``y`` all-gathered back over data, whole, on ``x``'s device;
    every rank of a process-group mesh passes the same ``x``.  ``x`` a list
    of one (B / n_data, S, d) block a local rank (the LM's layout): ``y``
    stays sharded over data, one block a local rank, as the reference's
    GSPMD keeps it, and so does the aux loss (pmean'd over data)."""
    mo = cfg.moe
    n_data = 1 if mesh is None else mesh.n_shards
    if mo.n_routed % n_data:
        raise ValueError(f"{mo.n_routed} experts do not split over {n_data} "
                         "data shards")
    if mesh is not None:
        sp = shard_params(p, moe_template(cfg), mesh)
        if isinstance(x, torch.Tensor):
            B, S, d = x.shape
            flat = shard_hint(x.reshape(B * S, d), mesh, DP, None)
            ys, aux = _moe_mesh(cfg, sp, flat, mesh=mesh, token_chunks=token_chunks)
            if mo.n_shared:
                ys = [y + sh for y, sh in zip(ys, _shared_mesh(sp, flat, mesh))]
            return whole_rows(ys, mesh, x.device).reshape(B, S, d), aux[0].to(x.device)
        shapes = [t.shape for t in x]
        ys, aux = _moe_mesh(cfg, sp, [t.reshape(-1, t.shape[-1]) for t in x], mesh=mesh,
                            token_chunks=token_chunks)
        ys = [y.reshape(sh) for y, sh in zip(ys, shapes)]
        if mo.n_shared:
            ys = [y + sh for y, sh in zip(ys, _shared_mesh(sp, x, mesh))]
        return ys, aux

    B, S, d = x.shape

    def body(x_blk):
        return moe_ops.moe_block(
            x_blk, p["router"].to(x_blk.dtype), p["wg"], p["wu"], p["wd"],
            top_k=mo.top_k, capacity=capacity(cfg, x_blk.shape[0]),
            norm_topk=mo.norm_topk, router_bias=p.get("router_bias"))

    flat = x.reshape(B * S, d)
    if runtime_flags.probe_stacks() is not None:
        token_chunks = 1  # cost probe: all tokens through one dispatch
    if token_chunks > 1 and (B * S) % token_chunks == 0:
        ys, auxs = zip(*(body(c) for c in flat.chunk(token_chunks)))
        y, aux = torch.cat(ys), torch.stack(auxs).mean()
    else:
        y, aux = body(flat)
    y = y.reshape(B, S, d)

    if mo.n_shared:
        h = F.silu((x @ p["shared_wg"]).float()).to(x.dtype)
        y = y + (h * (x @ p["shared_wu"])) @ p["shared_wd"]
    return y, aux


def _swiglu_mesh(sp: ShardedTree, xs, mesh, wg: str, wu: str, wd: str):
    """``(silu(x @ wg) * (x @ wu)) @ wd`` tensor parallel: each rank's column
    blocks of ``wg`` / ``wu``, its row block of ``wd``, a psum over model."""
    (gs, g_spec), (us, _), (ds, d_spec) = (sp.gathered(k) for k in (wg, wu, wd))
    hs = [F.silu((x @ g).float()).to(x.dtype) * (x @ u) for x, g, u in zip(xs, gs, us)]
    return row_parallel(mesh, hs, ds, d_spec, full=not model_sharded(g_spec[-1]))


def _shared_mesh(sp: ShardedTree, xs, mesh):
    return _swiglu_mesh(sp, xs, mesh, "shared_wg", "shared_wu", "shared_wd")


def count_dropped(cfg: ArchConfig, p: Dict, x: torch.Tensor, *, n_data: int = 1,
                  token_chunks: int = 4) -> int:
    """Token-expert assignments the capacity drops in ``moe_layer(cfg, p,
    x)`` over ``n_data`` data shards: its chunks, its split of a chunk into
    shard blocks and its per-shard capacity, routed again (a host sync; a
    diagnostic, not part of the layer)."""
    mo = cfg.moe
    flat = x.reshape(-1, x.shape[-1])
    if not (token_chunks > 1 and flat.shape[0] % (token_chunks * n_data) == 0):
        token_chunks = 1
    dropped = 0
    for chunk in flat.chunk(token_chunks):
        T_loc = chunk.shape[0] // n_data
        for i in range(n_data):
            r = moe_ops.route(chunk[i * T_loc:(i + 1) * T_loc], p["router"].to(x.dtype),
                              mo.top_k, capacity(cfg, T_loc), norm_topk=mo.norm_topk,
                              router_bias=p.get("router_bias"))
            dropped += int((~r.keep).sum())
    return dropped


_DENSE_SPECS = {"wg": (None, "model"), "wu": (None, "model"), "wd": ("model", None)}
_GELU_SPECS = {"w1": (None, "model"), "b1": ("model",), "w2": ("model", None), "b2": (None,)}


def dense_ffn_template(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {k: leaf(shape, _DENSE_SPECS[k])
            for k, shape in (("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d)))}


def _ffn_mesh(fn, template: Dict, p, x, mesh):
    """An FFN's mesh form: ``p`` whole (sharded on entry by ``template``) or
    a :class:`ShardedTree`, ``x`` whole (split over data, the output joined
    back) or one block a local rank (the output likewise)."""
    sp = shard_params(p, template, mesh)
    ys = fn(sp, shard_hint(x, mesh, DP, None, None), mesh)
    return whole_rows(ys, mesh, x.device) if isinstance(x, torch.Tensor) else ys


def _template_of(p: Dict, specs: Dict) -> Dict:
    return {k: leaf(t.shape, specs[k]) for k, t in p.items()}


def dense_ffn(p: Dict, x: torch.Tensor, *, mesh: Optional[ShardMesh] = None) -> torch.Tensor:
    """SwiGLU; with ``mesh`` tensor parallel (column blocks of ``wg`` /
    ``wu``, the row block of ``wd``, a psum over model; ``p`` and ``x`` as
    :func:`_ffn_mesh` takes them)."""
    if mesh is not None:
        tmpl = p.template if isinstance(p, ShardedTree) else _template_of(p, _DENSE_SPECS)
        return _ffn_mesh(lambda sp, xs, m: _swiglu_mesh(sp, xs, m, "wg", "wu", "wd"),
                         tmpl, p, x, mesh)
    h = F.silu((x @ p["wg"]).float()).to(x.dtype)
    return (h * (x @ p["wu"])) @ p["wd"]


def gelu_ffn_template(cfg: ArchConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": leaf((d, f), _GELU_SPECS["w1"]),
            "b1": leaf((f,), _GELU_SPECS["b1"], init="zeros"),
            "w2": leaf((f, d), _GELU_SPECS["w2"]),
            "b2": leaf((d,), _GELU_SPECS["b2"], init="zeros")}


def _gelu_mesh(sp: ShardedTree, xs, mesh):
    (w1s, s1), (b1s, _), (w2s, s2), (b2s, _) = (sp.gathered(k) for k in ("w1", "b1", "w2", "b2"))
    hs = [F.gelu((x @ w + b).float(), approximate="tanh").to(x.dtype)
          for x, w, b in zip(xs, w1s, b1s)]
    ys = row_parallel(mesh, hs, w2s, s2, full=not model_sharded(s1[-1]))
    return [y + b for y, b in zip(ys, b2s)]      # b2 once, after the psum


def gelu_ffn(p: Dict, x: torch.Tensor, *, mesh: Optional[ShardMesh] = None) -> torch.Tensor:
    """The whisper MLP; ``mesh`` as in :func:`dense_ffn` (``b1`` in column
    blocks, ``b2`` added once after the psum)."""
    if mesh is not None:
        tmpl = p.template if isinstance(p, ShardedTree) else _template_of(p, _GELU_SPECS)
        return _ffn_mesh(_gelu_mesh, tmpl, p, x, mesh)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu((x @ p["w1"] + p["b1"]).float(), approximate="tanh").to(x.dtype)
    return h @ p["w2"] + p["b2"]
