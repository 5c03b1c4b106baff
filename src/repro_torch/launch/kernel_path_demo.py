"""A GCN layer and a GAT aggregation computed through the hand-written
tile kernels: the counterpart of the reference's
``examples/kernel_path_demo.py``.

    PYTHONPATH=src python -m repro_torch.launch.kernel_path_demo [--scale 0.05] [--device cpu]

The paper's core dataflow on the card:

  1. sparse-tile the degree-sorted graph (compaction: the paper's sparse
     tiling), 6 x 6 partitions;
  2. densify each tile's adjacency into a (Dmax x Smax) block;
  3. gather and transform the source embeddings per tile (the sFunction);
  4. one COO tile-SpMM call (``coo_spmm_kernel``) sums every tile into its
     destination partition; the dFunction (norm, ReLU) finishes the layer;
  5. a GAT aggregation over the same tiles through the COO online segment
     softmax (``softmax_plan_kernel<true>``): per-edge scores
     ``leaky_relu(a_src . h[src] + a_dst . h[dst])``, softmax over each
     destination's in-edges, times ``h[src]``.

Both are held against whole-graph oracles (segment sums and a segment
softmax over the edge list) at 1e-4, as the reference's demo holds its
kernel.  CUDA tensors launch the kernels; ``--device cpu`` runs their plain
versions.  Runs on ``cuda`` unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import reorder, tiling
from ..device import resolve
from ..gnn import graphs
from ..kernels.tile_spmm import kernel as K
from ..kernels.tile_spmm import ops as tops

TOL = 1e-4


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _parts_to_rows(out_parts: torch.Tensor, tiles) -> torch.Tensor:
    """(P, Dmax, F) partitions back to (V, F) vertex rows."""
    rows = []
    for p in range(tiles.n_dst_parts):
        rows.append(out_parts[p, :int(tiles.part_size[p])])
    return torch.cat(rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05,
                    help="fraction of ak2010's vertices in the stand-in graph")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    g0 = graphs.paper_graph("ak2010", scale=args.scale, seed=0)
    g = reorder.degree_sort(g0).graph
    tiles = tiling.grid_tile(g, 6, 6, sparse=True)
    print(f"graph {g.n_vertices}V/{g.n_edges}E -> {tiles.n_tiles} sparse tiles "
          f"(Smax={tiles.s_max}, Dmax={int(tiles.part_size.max())})")
    assert np.all(np.diff(tiles.part_start) == tiles.part_size[:-1])

    rng = np.random.default_rng(0)
    F_in, F_out = 64, 64
    x = rng.standard_normal((g.n_vertices, F_in)).astype(np.float32)
    W = (rng.standard_normal((F_in, F_out)) / np.sqrt(F_in)).astype(np.float32)
    a = (rng.standard_normal((2, F_out)) / np.sqrt(F_out)).astype(np.float32)
    deg = g.in_degrees().astype(np.float32)
    dnorm = torch.as_tensor((1 / np.sqrt(np.maximum(deg, 1)))[:, None], device=dev)
    src = torch.as_tensor(g.src, device=dev).long()
    dst = torch.as_tensor(g.dst, device=dev).long()
    V = g.n_vertices

    # offline: densify tiles (the paper's tiling pass)
    adj, flags = tops.densify_tiles(tiles)
    adj, flags = torch.as_tensor(adj, device=dev), torch.as_tensor(flags, device=dev)
    pid = torch.as_tensor(tiles.part_id, device=dev).to(torch.int32)

    # per-tile sFunction: gather + (x * dnorm) @ W on compacted sources
    h = (torch.as_tensor(x, device=dev) * dnorm) @ torch.as_tensor(W, device=dev)
    xsrc = tops.gather_sources(tiles, h)                       # (T, Smax, F)

    K.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    out_parts = tops.spmm(adj, xsrc, pid, flags, n_parts=tiles.n_dst_parts)
    _sync(dev)
    spmm_s = time.perf_counter() - t0
    out = torch.relu(_parts_to_rows(out_parts, tiles) * dnorm)
    seg = torch.zeros((V, F_out), device=dev).index_add_(0, dst, h[src])
    ref = torch.relu(seg * dnorm)
    err_spmm = float((out - ref).abs().max())
    print(f"tile SpMM ({dev.type}): {spmm_s * 1e3:.2f} ms -> {tuple(out_parts.shape)}; "
          f"max |kernel - oracle| = {err_spmm:.3e}")

    # GAT aggregation: per-edge scores, the COO online segment softmax
    av = torch.as_tensor(a, device=dev)
    e_score = torch.nn.functional.leaky_relu(h[src] @ av[0] + h[dst] @ av[1], 0.2)
    gid = torch.as_tensor(tiles.edge_gid, device=dev).long()
    n_edge = torch.as_tensor(tiles.n_edge, device=dev).to(torch.int32)
    live = torch.arange(gid.shape[1], device=dev)[None, :] < n_edge.long()[:, None]
    scores = torch.where(live, e_score[gid.clamp(0, g.n_edges - 1)],
                         torch.full_like(gid, -1e30, dtype=torch.float32))
    edge_dst = torch.as_tensor(tiles.edge_dst, device=dev).to(torch.int32)
    col = torch.as_tensor(tiles.edge_src, device=dev).to(torch.int32)
    dmax = int(tiles.part_size.max())
    _sync(dev)
    t0 = time.perf_counter()
    gat_parts = tops.gat_aggregate(edge_dst, n_edge, col, scores, xsrc, pid, flags,
                                   n_parts=tiles.n_dst_parts, dmax=dmax)
    _sync(dev)
    softmax_s = time.perf_counter() - t0
    gat = _parts_to_rows(gat_parts, tiles)
    m = torch.full((V,), -1e30, device=dev).scatter_reduce(0, dst, e_score, "amax")
    p = torch.exp(e_score - m[dst])
    den = torch.zeros(V, device=dev).index_add_(0, dst, p)
    num = torch.zeros((V, F_out), device=dev).index_add_(0, dst, p[:, None] * h[src])
    gat_ref = num / den.clamp_min(1e-30)[:, None]
    err_gat = float((gat - gat_ref).abs().max())
    print(f"segment softmax ({dev.type}): {softmax_s * 1e3:.2f} ms; "
          f"max |kernel - oracle| = {err_gat:.3e}")
    launches = dict(K.LAUNCHES)
    if dev.type == "cuda":
        print(f"kernel launches: {launches}")
    if not (err_spmm < TOL and err_gat < TOL):
        raise AssertionError(f"kernels off the oracle: SpMM {err_spmm:.3e}, "
                             f"softmax {err_gat:.3e} (limit {TOL})")
    print("OK — the ZIPPER tile dataflow on the tile kernels matches the oracles")
    return dict(err_spmm=err_spmm, err_gat=err_gat, spmm_s=spmm_s, softmax_s=softmax_s,
                launches=launches, gcn=out, gat=gat)


if __name__ == "__main__":
    main()
