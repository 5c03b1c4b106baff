"""Routed MoE layer (DeepSeek V2/V3 family) and the dense FFNs.

Ports ``repro.models.moe``: token chunking and the capacity formula are the
reference's (moe.py:129,155-159).  Without a mesh the body is route ->
dispatch -> grouped FFN (the CUDA kernel on the card) -> combine
(``kernels.moe_dispatch.ops.moe_block``).  With a
:class:`~repro_torch.core.exchange.ShardMesh` of ``n_data`` shards x
``n_model`` model ranks it is the reference's expert-parallel body,
:func:`_local_moe` (moe.py:54): tokens split over the data shards, experts
``E / n_data`` a data shard and FFN columns ``f / n_model`` a model rank
(:func:`expert_shards`), buckets exchanged by ``all_to_all`` over data, the
down projection reduced over model, and the ``moe_fp8_dispatch`` /
``moe_rs_combine`` options of :mod:`repro_torch.runtime_flags`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import runtime_flags
from ..configs.base import ArchConfig
from ..core.exchange import ShardMesh
from ..kernels.moe_dispatch import ops as moe_ops
from .common import DP, leaf


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


def expert_shards(p: Dict, mesh: ShardMesh) -> List[Tuple[torch.Tensor, ...]]:
    """Each local rank's block of the routed experts, on its device: rank
    (i, m) holds experts ``i * E_loc`` to ``(i + 1) * E_loc`` and FFN columns
    ``m * f_loc`` to ``(m + 1) * f_loc`` — (E_loc, d, f_loc) of ``wg`` and
    ``wu``, (E_loc, f_loc, d) of ``wd``, the reference's in_specs
    ``P(data, None, "model")`` / ``P(data, "model", None)`` — contiguous,
    so the kernel reads them without a copy a chunk."""
    E, _, f = p["wg"].shape
    n_data, n_model = mesh.n_shards, mesh.model_axis
    if E % n_data or f % n_model:
        raise ValueError(f"{E} experts x {f} columns do not split over a "
                         f"{n_data} x {n_model} mesh")
    E_loc, f_loc = E // n_data, f // n_model
    out = []
    for r in mesh.local_ranks:
        i, m = divmod(r, n_model)
        e, c = slice(i * E_loc, (i + 1) * E_loc), slice(m * f_loc, (m + 1) * f_loc)
        dev = mesh.rank_device(r)
        out.append(tuple(w.to(dev).contiguous() for w in
                         (p["wg"][e, :, c], p["wu"][e, :, c], p["wd"][e, c, :])))
    return out


def _local_moe(cfg: ArchConfig, xs: Sequence[torch.Tensor], router, router_bias,
               experts: Sequence[Tuple[torch.Tensor, ...]], *, mesh: ShardMesh,
               capacity: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The reference's per-device body (moe.py:54-132) on every local rank
    at once: ``xs[j]`` (T_loc, d) and ``experts[j]`` on local rank
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
    rs = [moe_ops.route(x, router.to(x.device, x.dtype), mo.top_k, C,
                        norm_topk=mo.norm_topk,
                        router_bias=None if router_bias is None
                        else router_bias.to(x.device))
          for x in xs]
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


def moe_layer(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
              mesh: Optional[ShardMesh] = None,
              token_chunks: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Tokens go through the experts in
    ``token_chunks`` chunks when B * S divides by ``token_chunks * n_data``,
    else in one (one always while ``runtime_flags`` probes stacks).

    With a ``mesh`` each chunk's tokens split in ``n_data`` contiguous
    blocks, one a data shard (the reference's ``P(data, None)``), through
    :func:`_local_moe`; one all-gather over data returns every token's
    output to each rank, on ``x``'s device, because the port keeps the
    layers around the MoE whole on every rank (where the reference's
    GSPMD keeps y sharded).  Every rank of a process-group mesh calls this
    with the same ``x``."""
    mo = cfg.moe
    B, S, d = x.shape
    n_data = 1 if mesh is None else mesh.n_shards
    if mo.n_routed % n_data:
        raise ValueError(f"{mo.n_routed} experts do not split over {n_data} "
                         "data shards")
    if mesh is None:
        def body(x_blk):
            return moe_ops.moe_block(
                x_blk, p["router"].to(x_blk.dtype), p["wg"], p["wu"], p["wd"],
                top_k=mo.top_k, capacity=capacity(cfg, x_blk.shape[0]),
                norm_topk=mo.norm_topk, router_bias=p.get("router_bias"))
    else:
        experts = expert_shards(p, mesh)

        def body(x_blk):
            T_loc = x_blk.shape[0] // n_data
            xs = []
            for r in mesh.local_ranks:
                i = mesh.axis_index(r, "data")
                xs.append(x_blk[i * T_loc:(i + 1) * T_loc].to(mesh.rank_device(r)))
            outs, aux = _local_moe(cfg, xs, p["router"], p.get("router_bias"),
                                   experts, mesh=mesh,
                                   capacity=capacity(cfg, T_loc))
            y = mesh.all_gather_axis(outs, "data", dim=0)[0]
            return y.to(x_blk.device), aux[0].to(x_blk.device)

    flat = x.reshape(B * S, d)
    if runtime_flags.probe_stacks() is not None:
        token_chunks = 1  # cost probe: all tokens through one dispatch
    if token_chunks > 1 and (B * S) % (token_chunks * n_data) == 0:
        ys, auxs = zip(*(body(c) for c in flat.chunk(token_chunks)))
        y, aux = torch.cat(ys), torch.stack(auxs).mean()
    else:
        y, aux = body(flat)
    y = y.reshape(B, S, d)

    if mo.n_shared:
        h = F.silu((x @ p["shared_wg"]).float()).to(x.dtype)
        y = y + (h * (x @ p["shared_wu"])) @ p["shared_wd"]
    return y, aux


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


def dense_ffn_template(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": leaf((d, f), (None, "model")),
        "wu": leaf((d, f), (None, "model")),
        "wd": leaf((f, d), ("model", None)),
    }


def dense_ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu((x @ p["wg"]).float()).to(x.dtype)
    return (h * (x @ p["wu"])) @ p["wd"]


def gelu_ffn_template(cfg: ArchConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": leaf((d, f), (None, "model")),
            "b1": leaf((f,), ("model",), init="zeros"),
            "w2": leaf((f, d), ("model", None)),
            "b2": leaf((d,), (None,), init="zeros")}


def gelu_ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu((x @ p["w1"] + p["b1"]).float(), approximate="tanh").to(x.dtype)
    return h @ p["w2"] + p["b2"]
