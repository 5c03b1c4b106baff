"""Plain R-GCN (Schlichtkrull et al., ESWC 2018, eqs. 2-3), stacked, float32.

Layer l: ``W_r = sum_b a_rb V_b``; then
``x_i <- relu( sum_r sum_{j in N_i^r} x_j W_r / c_ir + x_i W_0 )`` with
``c_ir = |N_i^r|``, the in-neighbours of i under relation r.  The R
relations are the graph's own R/2, in their direction, and each again as
an inverse: an edge j -> i of relation r also gives i -> j of relation
r + R/2.  Both the inverse edges and ``c_ir`` are made here from the
canonical typed edges.  Computed relation by relation, in blocks of at
most ``BLOCK`` edges, on the device of the inputs.  Every product is
float32 (``common.matmul``, TF32 off; TF32 in the control); each layer's
sum over a vertex's messages accumulates in float64 and is rounded to
float32 once: a hub of the cell's graph sums 75,565 messages, and a
float32 sum of them in another order moves its row by up to 1e-4 of the
largest output, which would measure the reference and not the program.
Departures from the paper, as the port's other stacked models have them:
a ReLU after the last layer too, and no output softmax.
"""
from __future__ import annotations

from typing import Dict

import torch

from gnnbench.reference.common import matmul

BLOCK = 1 << 18       # edges a product takes at most


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Per layer: bases ``V`` (B, F_in, F_out), coefficients ``a`` (R, B)
    and the self-connection ``W_self`` (F_in, F_out)."""
    dims = [cfg["in_dim"]] + [cfg["hidden_dim"]] * (cfg["layers"] - 1) + [cfg["out_dim"]]
    out = {}
    for i in range(cfg["layers"]):
        out[f"l{i}.V"] = (cfg["bases"], dims[i], dims[i + 1])
        out[f"l{i}.a"] = (cfg["relations"], cfg["bases"])
        out[f"l{i}.W_self"] = (dims[i], dims[i + 1])
    return out


def forward(src: torch.Tensor, dst: torch.Tensor, rel: torch.Tensor, V: int,
            x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: Dict,
            precision: str = "fp32") -> torch.Tensor:
    """``src``, ``dst``, ``rel``: the canonical edges and their relations
    in [0, R/2); ``x`` (V, F_in)."""
    R = cfg["relations"]
    s = torch.cat([src, dst]).long()
    d = torch.cat([dst, src]).long()
    r = torch.cat([rel, rel + R // 2]).long()
    _, pair, count = torch.unique(d * R + r, return_inverse=True, return_counts=True)
    norm = (1.0 / count.to(torch.float32))[pair][:, None]
    order = torch.argsort(r, stable=True)
    bounds = [0] + torch.cumsum(torch.bincount(r, minlength=R), 0).tolist()
    for i in range(cfg["layers"]):
        a, bases = params[f"l{i}.a"], params[f"l{i}.V"]
        w = matmul(a, bases.reshape(bases.shape[0], -1), precision).reshape(
            R, *bases.shape[1:])
        acc = x.new_zeros((V, w.shape[-1]), dtype=torch.float64)
        for k in range(R):
            for lo in range(bounds[k], bounds[k + 1], BLOCK):
                e = order[lo:min(lo + BLOCK, bounds[k + 1])]
                m = matmul(x[s[e]], w[k], precision) * norm[e]
                acc.index_add_(0, d[e], m.to(torch.float64))
        x = torch.relu(acc.to(x.dtype) + matmul(x, params[f"l{i}.W_self"], precision))
    return x
