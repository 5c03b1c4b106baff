"""Plain GAT (Velickovic et al., ICLR 2018), one head, stacked, float32.

Layer l: ``h = x W_l``; edge u -> v scores
``leaky_relu(a_src . h_u + a_dst . h_v, 0.2)``; a softmax over each
vertex's in-edges; ``x_v <- sum alpha_uv h_u``, 0 for a vertex with no
in-edge.  Departures from the paper, as the port's model has them: one
head, no self-loops, no nonlinearity between the layers.
"""
from __future__ import annotations

from typing import Dict

import torch

from gnnbench.reference.common import matmul


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    dims = [cfg["in_dim"]] + [cfg["hidden_dim"]] * (cfg["layers"] - 1) + [cfg["out_dim"]]
    out = {}
    for i in range(cfg["layers"]):
        out[f"l{i}.W"] = (dims[i], dims[i + 1])
        out[f"l{i}.a_src"] = (dims[i + 1], 1)
        out[f"l{i}.a_dst"] = (dims[i + 1], 1)
    return out


def program_inputs(src: torch.Tensor, dst: torch.Tensor, V: int,
                   x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The inputs the port's model declares: the features."""
    return {"x": x}


def forward(src: torch.Tensor, dst: torch.Tensor, V: int, x: torch.Tensor,
            params: Dict[str, torch.Tensor], cfg: Dict,
            precision: str = "fp32") -> torch.Tensor:
    src, dst = src.long(), dst.long()
    for i in range(cfg["layers"]):
        h = matmul(x, params[f"l{i}.W"], precision)
        s_src = matmul(h, params[f"l{i}.a_src"], precision)[:, 0]
        s_dst = matmul(h, params[f"l{i}.a_dst"], precision)[:, 0]
        e = torch.nn.functional.leaky_relu(s_src[src] + s_dst[dst], 0.2)
        top = e.new_full((V,), -torch.inf).scatter_reduce_(
            0, dst, e, "amax", include_self=True)
        p = torch.exp(e - top[dst])
        total = p.new_zeros((V,)).index_add_(0, dst, p)
        alpha = (p / total[dst])[:, None]
        x = h.new_zeros((V, h.shape[1])).index_add_(0, dst, h[src] * alpha)
    return x
