#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), torch version;
2. build: compile ``csrc/tile_spmm.cu`` for sm_90a, with the seconds taken;
3. kernel checks: each of the four CUDA tile kernels against its plain
   PyTorch version on the card, at the shapes of phases 4 and 5, with its
   median time over CUDA-event-timed runs, the plain version's time, the
   time of one PyTorch library call where one exists, and its bound;
4. serving (COO tiles): ``InferenceServer`` on 2-layer gcn and gat at width
   128 over a batch of 16 power-law graphs (2,000 vertices, 16,000 edges
   each), submitted three times — one build, then cache hits — against the
   whole-graph oracle ``run_reference`` on the card;
5. whole graph (CSR tiles): ``run_pipelined`` on the coAuthorsDBLP stand-in
   (299,068 vertices, 977,676 edges) for 2-layer gcn and gat at width 128,
   against ``run_reference``.

Launch counters are set to 0 before phase 4 and read after phase 5; every
kernel must have launched there.  Then one ``{"kernels": [...]}`` line, the
``nvidia-smi`` name/power line, and last ``{"ok": true, "device": ...}``.
Any failure raises, so the exit code is nonzero and no ``ok`` line prints;
so does a machine without a visible CUDA device.  Weights and inputs come
from fixed seeds.  fp32 throughout, TF32 off.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
# |kernel - plain| <= abs + rel * (the plain version over |inputs|): both sum
# in fp32 in another order, and that difference scales with the terms'
# magnitudes, not with the result (a high-degree row's sum cancels)
KERNEL_TOL = (1e-4, 1e-4)
MODEL_TOL = {"gcn": 5e-4, "gat": 1e-4}   # vs the oracle, scaled by max(1, |ref|)
WIDTH = 128                    # the paper's embedding size (EMBED)
SOURCE = "src/repro_torch/kernels/tile_spmm/csrc/tile_spmm.cu"
REPLACES = {
    "tile_spmm": "src/repro/kernels/tile_spmm/kernel.py:67",
    "tile_spmm_csr": "src/repro/kernels/tile_spmm/kernel.py:172",
    "segment_softmax": "src/repro/kernels/tile_spmm/kernel.py:262",
    "segment_softmax_csr": "src/repro/kernels/tile_spmm/kernel.py:234",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event-timed calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_flops: float):
    """Least time (ms) on the card, and which term sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scaled_err(got, ref) -> float:
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main-path shapes
# ---------------------------------------------------------------------------

def kernel_checks(serve_tiles, csr_tiles, dev):
    import torch
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.kernels.tile_spmm import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = []

    def check(name, kernel, plain, magnitude, n_bytes, n_flops, library=None,
              note=None):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_abs = float(err.max())
        ok = bool((err <= KERNEL_TOL[0] + KERNEL_TOL[1] * magnitude()).all())
        require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        require(ok, f"{name}: max abs err {max_abs} over tolerance {KERNEL_TOL}")
        b_ms, b_by = bound(n_bytes, n_flops)
        row = dict(name=name, route="cuda", source=SOURCE,
                   replaces=REPLACES[name], max_abs_err=max_abs,
                   tol_abs=KERNEL_TOL[0], tol_rel=KERNEL_TOL[1],
                   ms=time_ms(kernel), plain_ms=time_ms(plain),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=None if library is None else time_ms(library),
                   shapes=note)
        emit(dict(phase="kernel_check", **row))
        rows.append(row)

    # -- COO operands at the serving batch's shapes (phase 4)
    ts = serve_tiles
    T, S, E, P = ts.n_tiles, ts.s_max, ts.e_max, ts.n_dst_parts
    D = int(ts.part_size.max())
    n_edge = int(ts.n_edge.sum())
    n_src = int(ts.n_src.sum())
    part_id = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
    flags = torch.as_tensor(K.tile_flags(ts.part_id), device=dev)
    edge_dst = torch.as_tensor(ts.edge_dst, device=dev).long()
    edge_src = torch.as_tensor(ts.edge_src, device=dev).long()
    n_edge_t = torch.as_tensor(ts.n_edge, device=dev).long()
    adj = ops.densify_edge_weights(randn(T, E), edge_dst, edge_src, n_edge_t,
                                   dmax=D, smax=S)
    xsrc = randn(T, S, WIDTH)
    out_bytes = P * D * WIDTH * 4
    check("tile_spmm",
          lambda: K.tile_spmm_cuda(adj, xsrc, part_id, flags, n_parts=P),
          lambda: ref.tile_spmm_ref(adj, xsrc, part_id, P),
          lambda: ref.tile_spmm_ref(adj.abs(), xsrc.abs(), part_id, P),
          adj.numel() * 4 + n_src * WIDTH * 4 + T * 4 + out_bytes,
          2 * WIDTH * n_edge,
          library=lambda: torch.bmm(adj, xsrc),
          note=dict(T=T, D=D, S=S, F=WIDTH, P=P, edges=n_edge,
                    library="torch.bmm(adj, xsrc): the per-tile product "
                            "without the partition sum"))

    scores = ops.densify_edge_scores(randn(T, E), edge_dst, n_edge_t, dmax=D)
    vals = randn(T, E, WIDTH)
    check("segment_softmax",
          lambda: K.segment_softmax_cuda(scores, vals, part_id, flags, n_parts=P),
          lambda: ref.segment_softmax_ref(scores, vals, part_id, P),
          lambda: ref.segment_softmax_ref(scores, vals.abs(), part_id, P),
          scores.numel() * 4 + n_edge * WIDTH * 4 + T * 4 + out_bytes,
          n_edge * (2 * WIDTH + 1),
          note=dict(T=T, D=D, E=E, F=WIDTH, P=P, edges=n_edge))
    del adj, xsrc, scores, vals

    # -- CSR operands at the whole-graph phase's shapes (phase 5); padded
    # edge slots hold NaN, which the kernels must never read
    ts = csr_tiles
    T, S, E, P = ts.n_tiles, ts.s_max, ts.e_max, ts.n_dst_parts
    D = int(ts.part_size.max())
    n_edge = int(ts.n_edge.sum())
    n_src = int(ts.n_src.sum())
    part_id = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
    flags = torch.as_tensor(K.tile_flags(ts.part_id), device=dev)
    row_ptr = torch.as_tensor(ts.row_ptr, dtype=torch.int32, device=dev)
    col = torch.as_tensor(ts.edge_src, dtype=torch.int32, device=dev)
    pad = (torch.arange(E, device=dev)[None, :]
           >= torch.as_tensor(ts.n_edge, device=dev)[:, None])
    w = randn(T, E).masked_fill_(pad, float("nan"))
    xsrc = randn(T, S, WIDTH)
    out_bytes = P * D * WIDTH * 4
    rp_bytes = row_ptr.numel() * 4
    # the library yardstick: one sparse (P*D, T*S) CSR product, built here
    # from the same edges (only the product is timed)
    t_e, slot, dest = ref._csr_edges(row_ptr, part_id, E)
    sp = torch.sparse_coo_tensor(
        torch.stack([dest, t_e * S + col.long()[t_e, slot]]), w[t_e, slot],
        (P * D, T * S)).coalesce().to_sparse_csr()
    x_flat = xsrc.view(T * S, WIDTH)
    check("tile_spmm_csr",
          lambda: K.tile_spmm_csr_cuda(row_ptr, col, w, xsrc, part_id, flags,
                                       n_parts=P),
          lambda: ref.tile_spmm_csr_ref(row_ptr, col, w, xsrc, part_id, P),
          lambda: ref.tile_spmm_csr_ref(row_ptr, col, w.abs(), xsrc.abs(),
                                        part_id, P),
          rp_bytes + n_edge * 8 + n_src * WIDTH * 4 + T * 4 + out_bytes,
          2 * WIDTH * n_edge,
          library=lambda: torch.sparse.mm(sp, x_flat),
          note=dict(T=T, D=D, S=S, E=E, F=WIDTH, P=P, edges=n_edge,
                    library="torch.sparse.mm of the (P*D, T*S) CSR matrix "
                            "of the same edges"))
    del sp, x_flat, xsrc, w

    s_e = randn(T, E).masked_fill_(pad, float("nan"))
    vals = randn(T, E, WIDTH)
    check("segment_softmax_csr",
          lambda: K.segment_softmax_csr_cuda(row_ptr, s_e, vals, part_id, flags,
                                             n_parts=P),
          lambda: ref.segment_softmax_csr_ref(row_ptr, s_e, vals, part_id, P),
          lambda: ref.segment_softmax_csr_ref(row_ptr, s_e, vals.abs(),
                                              part_id, P),
          rp_bytes + n_edge * (4 + WIDTH * 4) + T * 4 + out_bytes,
          n_edge * (2 * WIDTH + 2),
          note=dict(T=T, D=D, E=E, F=WIDTH, P=P, edges=n_edge))
    del vals, s_e
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def serving_phase(graphs, dev):
    import numpy as np
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M
    from repro_torch.kernels.tile_spmm.kernel import LAUNCHES
    from repro_torch.serve import InferenceServer, ShapeRegistry

    # the host half of every submit: merge the batch and tile it onto the
    # class's canonical shapes (the server repeats this per request)
    t0 = time.perf_counter()
    batch = G.batch_graphs(graphs)
    ShapeRegistry().canonical("shapes", batch.graph)
    host_tiling_s = time.perf_counter() - t0
    expect = {"gcn": "tile_spmm", "gat": "segment_softmax"}
    for name in ("gcn", "gat"):
        tr = M.trace_stacked(name, 2, WIDTH, WIDTH, WIDTH)
        params = M.init_params(tr, seed=0)
        inputs = [M.init_inputs(tr, g, seed=i) for i, g in enumerate(graphs)]
        before = LAUNCHES[expect[name]]
        torch.cuda.reset_peak_memory_stats()
        server = InferenceServer(compiler.compile_gnn(tr), params, device=dev)
        lat = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = server.submit(graphs, inputs)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        require(server.compile_count == 1 and server.cache_hits == 2,
                f"serving {name}: builds={server.compile_count} "
                f"hits={server.cache_hits}, expected 1 build then 2 hits")
        require(LAUNCHES[expect[name]] > before,
                f"serving {name}: kernel {expect[name]} never launched")
        got = torch.cat([o[0] for o in outs])
        merged = {k: np.concatenate([inp[k] for inp in inputs])
                  for k in inputs[0]}
        want = run_reference(tr, batch.graph, merged, params, device=dev)[0]
        require(got.shape == (batch.graph.n_vertices, WIDTH)
                and bool(torch.isfinite(got).all()),
                f"serving {name}: output shape {tuple(got.shape)} or non-finite")
        err = scaled_err(got, want)
        require(err <= MODEL_TOL[name],
                f"serving {name}: err {err} over {MODEL_TOL[name]}")
        warm = lat[1:]
        emit(dict(phase="serving", model=f"{name}_x2", layout="coo",
                  graphs=len(graphs), vertices=batch.graph.n_vertices,
                  edges=batch.graph.n_edges, cold_s=lat[0],
                  warm_p50_s=statistics.median(warm),
                  graphs_per_s=len(graphs) / statistics.median(warm),
                  host_tiling_s=host_tiling_s,
                  builds=server.compile_count, hits=server.cache_hits,
                  err_vs_oracle=err, tol=MODEL_TOL[name],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))


def whole_graph_phase(graph, tiles, dev):
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.core.pipeline import run_pipelined
    from repro_torch.gnn import models as M
    from repro_torch.kernels.tile_spmm.kernel import LAUNCHES

    expect = {"gcn": "tile_spmm_csr", "gat": "segment_softmax_csr"}
    for name in ("gcn", "gat"):
        tr = M.trace_stacked(name, 2, WIDTH, WIDTH, WIDTH)
        params = M.init_params(tr, seed=0)
        inputs = M.init_inputs(tr, graph, seed=0)
        before = LAUNCHES[expect[name]]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_pipelined(compiler.compile_gnn(tr), graph, tiles, inputs,
                            params, device=dev)[0]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        require(LAUNCHES[expect[name]] > before,
                f"whole graph {name}: kernel {expect[name]} never launched")
        want = run_reference(tr, graph, inputs, params, device=dev)[0]
        require(got.shape == (graph.n_vertices, WIDTH)
                and bool(torch.isfinite(got).all()),
                f"whole graph {name}: output shape {tuple(got.shape)} or non-finite")
        err = scaled_err(got, want)
        require(err <= MODEL_TOL[name],
                f"whole graph {name}: err {err} over {MODEL_TOL[name]}")
        emit(dict(phase="whole_graph", model=f"{name}_x2", layout="csr",
                  graph=graph.name, vertices=graph.n_vertices,
                  edges=graph.n_edges, run_s=run_s, err_vs_oracle=err,
                  tol=MODEL_TOL[name],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.gnn import graphs as G
    from repro_torch.core.tiling import grid_tile
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.serve import ShapeRegistry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count()))

    # 2. build
    t0 = time.perf_counter()
    K.library()
    log = K._build.library_path(K.SOURCE).with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas))

    # main-path inputs (host): the serving batch and the whole graph
    t0 = time.perf_counter()
    graphs = [G.random_graph(2000, 16000, seed=i, model="powerlaw")
              for i in range(16)]
    _, serve_tiles, _, _ = ShapeRegistry().canonical(
        "shapes", G.batch_graphs(graphs).graph)
    dblp = G.paper_graph("coAuthorsDBLP")
    csr_tiles = grid_tile(dblp, 64, 64, sparse=True, layout="csr")
    emit(dict(phase="tiling", seconds=time.perf_counter() - t0,
              serving=dict(tiles=serve_tiles.n_tiles, s_max=serve_tiles.s_max,
                           e_max=serve_tiles.e_max,
                           parts=serve_tiles.n_dst_parts,
                           d_max=int(serve_tiles.part_size.max())),
              whole_graph=dict(graph=dblp.name, tiles=csr_tiles.n_tiles,
                               s_max=csr_tiles.s_max, e_max=csr_tiles.e_max,
                               parts=csr_tiles.n_dst_parts,
                               d_max=int(csr_tiles.part_size.max()))))

    # 3. kernel checks
    rows = kernel_checks(serve_tiles, csr_tiles, dev)

    # 4-5. the main path, with launch counts
    K.reset_launches()
    serving_phase(graphs, dev)
    whole_graph_phase(dblp, csr_tiles, dev)
    launches = dict(K.LAUNCHES)
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: (launches[r["name"]] if k == "launches" else r[k])
                       for k in keys} for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
