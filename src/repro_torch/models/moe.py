"""Routed MoE layer (DeepSeek V2/V3 family) and the dense FFNs, one device.

Ports ``repro.models.moe``: token chunking and the capacity formula are the
reference's (moe.py:129,155-159); the per-device body is route -> dispatch
-> grouped FFN (the CUDA kernel on the card) -> combine
(``kernels.moe_dispatch.ops.moe_block``).  Expert and tensor parallelism
(``all_to_all``/``psum`` under ``shard_map``) and the ``moe_fp8_dispatch`` /
``moe_rs_combine`` options, which only change the collectives, wait for the
sharded port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
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


def moe_layer(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
              token_chunks: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Tokens go through the experts in
    ``token_chunks`` chunks when they divide evenly, else in one."""
    mo = cfg.moe
    B, S, d = x.shape

    def body(x_blk):
        return moe_ops.moe_block(
            x_blk, p["router"].to(x_blk.dtype), p["wg"], p["wu"], p["wd"],
            top_k=mo.top_k, capacity=capacity(cfg, x_blk.shape[0]),
            norm_topk=mo.norm_topk, router_bias=p.get("router_bias"))

    flat = x.reshape(B * S, d)
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
