"""Plain GCN (Kipf & Welling, ICLR 2017), stacked, float32.

Layer l: ``x <- relu(D^-1/2 A D^-1/2 x W_l)``: each edge u -> v carries
``(x W_l)[u] * d(u) * d(v)`` with ``d = 1 / sqrt(max(in-degree, 1))``,
summed at v.  Departures from the paper, as the port's model has them:
no self-loops, both sides normalised by the in-degree, a ReLU after the
last layer too.  ``dnorm`` is recomputed here from the graph.
"""
from __future__ import annotations

from typing import Dict

import torch

from gnnbench.reference.common import matmul


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    dims = [cfg["in_dim"]] + [cfg["hidden_dim"]] * (cfg["layers"] - 1) + [cfg["out_dim"]]
    return {f"l{i}.W": (dims[i], dims[i + 1]) for i in range(cfg["layers"])}


def dnorm(dst: torch.Tensor, V: int) -> torch.Tensor:
    deg = torch.bincount(dst.long(), minlength=V).to(torch.float32)
    return 1.0 / torch.sqrt(deg.clamp(min=1.0))


def program_inputs(src: torch.Tensor, dst: torch.Tensor, V: int,
                   x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The inputs the port's model declares: features and ``dnorm``."""
    return {"x": x, "dnorm": dnorm(dst, V)[:, None]}


def forward(src: torch.Tensor, dst: torch.Tensor, V: int, x: torch.Tensor,
            params: Dict[str, torch.Tensor], cfg: Dict,
            precision: str = "fp32") -> torch.Tensor:
    src, dst = src.long(), dst.long()
    d = dnorm(dst, V)
    w = (d[src] * d[dst])[:, None]
    for i in range(cfg["layers"]):
        h = matmul(x, params[f"l{i}.W"], precision)
        x = torch.relu(h.new_zeros((V, h.shape[1])).index_add_(0, dst, h[src] * w))
    return x
