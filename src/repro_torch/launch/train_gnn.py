"""GNN training on one device: the counterpart of the reference's
``examples/train_gnn.py``.

    PYTHONPATH=src python -m repro_torch.launch.train_gnn --steps 200 \
        [--width 8192] [--graph ak2010] [--device cpu]

A 3-layer GCN (the paper's model family) with per-layer dense transforms,
64 -> width -> width -> classes, on a synthetic power-law graph (or the
stand-in of one of the paper's datasets, ``--graph``), trained on node
classification (logsumexp of the logits minus the gold logit, averaged)
with AdamW at a rate of 3e-3.  The forward and backward run through
:class:`~repro_torch.core.pipeline.PipelinedRunner` on its scan path
(``kernel_dispatch=False``, as the reference's runner takes it when given
no tile kernel): the tile kernels have no backward.

The model has 64 w + w^2 + w c parameters: 67.8 M at ``--width 8192``, the
reference's setting for real hardware.  (The reference's docstring speaks
of ~100 M from 1024 -> 8192 -> 8192 -> 1024 plus vertex embeddings; its
code builds the model above, and so does this one.)  Weights, features and
labels are drawn from ``default_rng(0)`` in the reference's order.
Eager, float32, TF32 off.  Runs on ``cuda`` unless ``--device`` names
another device.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import compiler, pipeline, tiling
from ..core.trace import GnnTrace, trace_model
from ..device import resolve
from ..gnn import graphs
from ..optim.adamw import AdamWState, adamw_init, adamw_update

IN_DIM = 64
LR = 3e-3

Runner = Callable[[Dict, Dict], List[torch.Tensor]]


def build_mlp_gcn(tr, g, in_dim, hidden, n_classes):
    """3-layer GCN with per-layer dense transforms (classic model)."""
    x = tr.input_vertex(in_dim, "x")
    dn = tr.input_vertex(1, "dnorm")
    h = x
    dims = [in_dim, hidden, hidden, n_classes]
    for i in range(3):
        w = tr.param(f"W{i}", (dims[i], dims[i + 1]))
        h = (h * dn).matmul(w)
        h = g.gather_sum(g.scatter_src(h))
        h = h * dn
        if i < 2:
            h = h.relu()
    tr.mark_output(h)


def trace_mlp_gcn(width: int, n_classes: int) -> GnnTrace:
    return trace_model(
        lambda t, gr: build_mlp_gcn(t, gr, IN_DIM, width, n_classes),
        name="gcn3")


def make_graph(name: Optional[str] = None, vertices: int = 4000,
               edges: int = 16000) -> graphs.Graph:
    """The stand-in of paper dataset ``name``, else the example's power-law
    graph of ``vertices`` / ``edges``."""
    if name:
        return graphs.paper_graph(name)
    return graphs.random_graph(vertices, edges, seed=0, model="powerlaw")


def init_problem(tr: GnnTrace, g: graphs.Graph, n_classes: int,
                 device) -> Tuple[Dict, Dict, torch.Tensor]:
    """Params (leaves that require grad), inputs ``x`` / ``dnorm`` and
    labels on ``device``, drawn from ``default_rng(0)`` in the reference's
    order: params N(0, 1) / sqrt(fan-in), then x, then labels."""
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    params = {n: tensor(rng.standard_normal(s) / np.sqrt(s[0])).requires_grad_()
              for n, s in tr.params.items()}
    deg = g.in_degrees().astype(np.float32)
    inputs = {"x": tensor(rng.standard_normal((g.n_vertices, IN_DIM))),
              "dnorm": tensor((1 / np.sqrt(np.maximum(deg, 1)))[:, None])}
    labels = torch.as_tensor(rng.integers(0, n_classes, g.n_vertices),
                             device=device)
    return params, inputs, labels


def gnn_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[label] over the vertices."""
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def gnn_train_step(runner: Runner, inputs: Dict, labels: torch.Tensor,
                   params: Dict[str, torch.Tensor], opt: AdamWState,
                   lr: float = LR) -> Tuple[torch.Tensor, torch.Tensor, AdamWState]:
    """One step: the loss and its gradients through ``runner`` (a
    ``runner(inputs, params) -> [logits]`` callable), then AdamW on
    ``params`` in place.  Returns (loss, gradient norm, optimizer state)."""
    loss = gnn_loss(runner(inputs, params)[0], labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    _, opt, gnorm = adamw_update(params, opt, dict(zip(params, grads)), lr)
    return loss.detach(), gnorm, opt


def scan_runner(tr: GnnTrace, g: graphs.Graph, device) -> pipeline.PipelinedRunner:
    """The example's runner: 4 x 4 sparse grid tiles, scan path."""
    return pipeline.PipelinedRunner(compiler.compile_gnn(tr), g,
                                    tiling.grid_tile(g, 4, 4, sparse=True),
                                    kernel_dispatch=False, device=device)


def train(g: graphs.Graph, *, width: int = 512, n_classes: int = 16,
          steps: int = 200, device=None, log=print) -> Tuple[List[float], Dict]:
    """The example's loop on ``g``: returns the losses and the params."""
    dev = resolve(device)
    tr = trace_mlp_gcn(width, n_classes)
    runner = scan_runner(tr, g, dev)
    params, inputs, labels = init_problem(tr, g, n_classes, dev)
    n_params = sum(p.numel() for p in params.values())
    log(f"params: {n_params/1e6:.1f}M   tiles: {runner.tiles.n_tiles}")
    opt = adamw_init(params)
    losses: List[float] = []
    t0 = time.time()
    for step in range(steps):
        loss, gnorm, opt = gnn_train_step(runner, inputs, labels, params, opt)
        losses.append(float(loss))
        if step % 20 == 0 or step == steps - 1:
            log(f"step {step:4d}  loss {losses[-1]:.4f}  gnorm {float(gnorm):.2f} "
                f" ({time.time()-t0:.1f}s)")
    log(f"final loss: {losses[-1]}")
    return losses, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--vertices", type=int, default=4000)
    ap.add_argument("--edges", type=int, default=16000)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--graph", choices=sorted(graphs.PAPER_DATASETS),
                    help="a paper dataset's stand-in (default: the power-law "
                         "graph of --vertices / --edges)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train(make_graph(args.graph, args.vertices, args.edges), width=args.width,
          n_classes=args.classes, steps=args.steps, device=args.device,
          log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
