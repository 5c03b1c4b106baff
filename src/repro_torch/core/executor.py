"""GNN execution engines, in PyTorch (port of ``repro.core.executor``).

* :func:`apply_compute` — the 19 vertex/edge ops every engine shares.
* :func:`run_reference` — whole-graph oracle (the classic programming
  model, "DGL-functional" semantics): every op over the full vertex/edge
  tensors.  It is the correctness oracle and the non-tiled baseline.
* :func:`run_tiled` — ZIPPER's tiled execution of the compiled
  :class:`~repro_torch.core.schedule.ScheduledProgram` over one tile set,
  in one call: a front end of the port's one tile interpreter,
  :mod:`.pipeline`'s, which :class:`~repro_torch.core.pipeline
  .PipelinedRunner` and :class:`~repro_torch.core.pipeline.ShardedRunner`
  drive too.

All compute in float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from ..convert import to_device
from ..device import resolve
from . import compiler as C
from .tiling import TileSet
from ..gnn.graphs import Graph

Array = torch.Tensor

_NEG_INF = -1e30  # used instead of -inf so max-reduce stays NaN-free on empty segments


# ---------------------------------------------------------------------------
# shared op semantics
# ---------------------------------------------------------------------------

def _bmm_edge(x: Array, et: Array, w: Array) -> Array:
    """Per-edge type-selected product: out[e] = x[e] @ w[type[e]], one
    matmul per edge type (never materialises a weight per edge)."""
    types = et[..., 0].long()
    out = x.new_zeros(x.shape[:-1] + (w.shape[-1],))
    for k in range(w.shape[0]):
        sel = types == k
        out[sel] = x[sel] @ w[k]
    return out


def apply_compute(op: str, attrs: Dict, params: Dict[str, Array],
                  args: Sequence[Array]) -> Array:
    if op == "matmul" or op == "gemv":
        return args[0] @ params[attrs["weight"]]
    if op == "bias_add":
        return args[0] + params[attrs["weight"]]
    if op == "bmm_edge":
        return _bmm_edge(args[0], args[1], params[attrs["weight"]])
    if op == "add":
        return args[0] + args[1]
    if op == "sub":
        return args[0] - args[1]
    if op == "mul":
        return args[0] * args[1]
    if op == "div":
        return args[0] / args[1]
    if op == "max2":
        return torch.maximum(args[0], args[1])
    if op == "min2":
        return torch.minimum(args[0], args[1])
    if op == "relu":
        return torch.relu(args[0])
    if op == "leaky_relu":
        return torch.where(args[0] > 0, args[0], attrs.get("slope", 0.2) * args[0])
    if op == "exp":
        return torch.exp(args[0])
    if op == "sigmoid":
        return torch.sigmoid(args[0])
    if op == "tanh":
        return torch.tanh(args[0])
    if op == "neg":
        return -args[0]
    if op == "identity":
        return args[0]
    if op == "sqrt":
        return torch.sqrt(args[0])
    if op == "rsqrt":
        return torch.rsqrt(args[0])
    raise NotImplementedError(op)


# ---------------------------------------------------------------------------
# whole-graph reference (oracle / non-tiled baseline)
# ---------------------------------------------------------------------------

def run_reference(tr, graph: Graph, inputs: Dict, params: Dict,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> List[Array]:
    """Evaluate trace ``tr`` over the whole graph on ``device`` (``cuda``
    unless named).  ``inputs``/``params`` may be numpy or tensors; autograd
    records the run when a tensor given requires grad."""
    dev = resolve(device)
    src = torch.as_tensor(graph.src, device=dev).long()
    dst = torch.as_tensor(graph.dst, device=dev).long()
    V = graph.n_vertices
    params = {k: to_device(v, dev) for k, v in params.items()}
    env: Dict[int, Array] = {}
    outs: List[Array] = []
    for n in tr.nodes:
        if n.op == "param":
            continue
        if n.op == "input":
            env[n.id] = to_device(inputs[n.attrs["name"]], dev)
        elif n.op == "output":
            outs.append(env[n.inputs[0]])
        elif n.op == "scatter_src":
            env[n.id] = env[n.inputs[0]][src]
        elif n.op == "scatter_dst":
            env[n.id] = env[n.inputs[0]][dst]
        elif n.op == "gather":
            e = env[n.inputs[0]]
            red = n.attrs["reduce"]
            if red == "sum":
                env[n.id] = e.new_zeros((V, e.shape[1])).index_add_(0, dst, e)
            elif red == "max":
                # empty segments -> -1e30, not -inf
                env[n.id] = e.new_full((V, e.shape[1]), _NEG_INF).scatter_reduce_(
                    0, dst[:, None].expand_as(e), e, "amax", include_self=True)
            elif red == "mean":
                s = e.new_zeros((V, e.shape[1])).index_add_(0, dst, e)
                c = e.new_zeros((V, 1)).index_add_(0, dst, e.new_ones((e.shape[0], 1)))
                env[n.id] = s / c.clamp_min(1.0)
            else:
                raise ValueError(red)
        elif n.op in ("matmul", "gemv", "bias_add"):
            w = tr.node(n.inputs[1])
            env[n.id] = apply_compute(n.op, {"weight": w.attrs["name"]}, params,
                                      [env[n.inputs[0]]])
        elif n.op == "bmm_edge":
            w = tr.node(n.inputs[1])
            env[n.id] = apply_compute("bmm_edge", {"weight": w.attrs["name"]}, params,
                                      [env[n.inputs[0]], env[n.inputs[2]]])
        else:
            env[n.id] = apply_compute(n.op, n.attrs, params, [env[i] for i in n.inputs])
    return outs


def run_tiled(compiled: C.CompiledGNN, graph: Graph, tiles: TileSet,
              inputs: Dict, params: Dict, kernel_dispatch: bool = True,
              device: Optional[Union[str, torch.device]] = None) -> List[Array]:
    """Interpret the compiled scheduled program over the tile set ``tiles``
    on ``device`` (``cuda`` unless named); returns the outputs as tensors
    there.  A one-call front end of the port's tile interpreter: a
    :class:`~repro_torch.core.pipeline.PipelinedRunner` built on ``tiles``
    and run once.

    ``kernel_dispatch=False`` forces every gather block onto the scan path
    (the paper's pure multi-phase schedule, no kernel blocks), which
    autograd differentiates; a kernel block refuses a gradient
    (:func:`~repro_torch.core.pipeline.kernel_gather`).
    ``inputs``/``params`` may be numpy or tensors.
    """
    from .pipeline import PipelinedRunner   # pipeline imports this module

    return PipelinedRunner(compiled, graph, tiles,
                           kernel_dispatch=kernel_dispatch,
                           device=device)(inputs, params)
