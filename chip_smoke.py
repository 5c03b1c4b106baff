#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line or more:

1. device: the card's name and power limit (``nvidia-smi``), torch version;
2. build: compile the three ``csrc/*.cu`` sources for sm_90a side by side
   (one ``nvcc`` each), with the seconds taken and ``ptxas``' report;
3. kernel checks: each of the four CUDA tile kernels against its plain
   PyTorch version on the card, at the shapes of phases 4 and 5, with its
   median time over CUDA-event-timed runs, the plain version's time, the
   time of one PyTorch library call where one exists, and its bound; the
   edge plans are built first (their build times and host syncs are
   fields of their rows); the COO SpMM, given its partition runs, and the
   plan-walking kernels, given their plans, run once each with host syncs
   made errors; both segment softmaxes run on per-edge operands (padded
   slots NaN) against the plan walk; the COO SpMM also runs at the
   off-path shapes of ``COO_OFF_PATH``, the softmaxes at those of
   ``SOFTMAX_OFF_PATH``;
4. serving (COO tiles): ``InferenceServer`` on 2-layer gcn and gat at width
   128 over a batch of 16 power-law graphs (2,000 vertices, 16,000 edges
   each), submitted three times — one build, then cache hits — against the
   whole-graph oracle ``run_reference`` on the card, with the COO edge
   plan's build time (each gat submit builds one at bind);
5. whole graph (CSR tiles): ``run_pipelined`` on the coAuthorsDBLP stand-in
   (299,068 vertices, 977,676 edges) for 2-layer gcn and gat at width 128,
   against ``run_reference``.

6. LM kernel checks: the flash-attention and grouped-FFN kernels against
   their plain versions, in fp32 and bf16, at phase 7's shapes — flash
   (1, 4096, 128, 192 / v 128) causal (DeepSeek-V2 MLA prefill), (1, 4096,
   12, 128) with 2 KV heads causal (Qwen2-1.5B prefill), (4, 1, 12, 128)
   against a 40-slot cache with ``kv_len`` (its decode); grouped FFN over
   (160, 48, 5120) buckets with f 1536 and the live counts of a real
   routing of a 1,024-token prefill chunk, and over (160, 8, 5120) for a
   4-token decode step — plus two flash cases off the path: a causal GQA
   prefill of 1,000 tokens, whose length fits neither the query tile nor
   the key tile, and (2, 65 queries, 130 keys, 4 / 2 heads, head dim 256,
   causal, window 30, ``kv_len``), with the same timings and bounds as
   phase 3; the grouped FFN also at the off-path shapes of
   ``FFN_OFF_PATH``; elementwise limits scaled by each sum's rounding
   magnitude (see ``LM_KERNEL_TOL``); one flash call and one grouped-FFN
   call with host syncs made errors;
7. LM serving: for qwen2-1.5b (all 28 layers) and deepseek-v2-236b (full
   width, depth cut to 2 layers: the leading dense layer and one MoE
   layer), random fp32 weights from a seed; ``serve_requests`` with
   ``launch/serve.py``'s defaults (8 requests, batch 4, prompts of 4-24
   tokens from ``default_rng(0)``, 16 new tokens), tokens/s and the median
   decode-step latency; teacher-forced decode of an 8-token prompt against
   ``forward`` at every position (2e-3 dense, 5e-3 MLA, scaled by
   max(1, |ref|): the reference's own tolerances); ``make_prefill_step`` on
   one 4,096-token prompt, twice (first and warm seconds) with its peak
   memory; a ``torch.profiler`` breakdown of 8 decode steps and a prefill;
8. tiled: ``run_tiled`` (the interpreter engine) on phase 4's batch padded
   by the server's ``ShapeRegistry`` (40,000 V), tiled as served (COO) and
   by ``grid_tile(64, 64, layout="csr")``, 2-layer gcn and gat at width
   128, kernel dispatch on and off, each pass twice (first and warm
   seconds), against ``run_reference``;
9. async serving: ``AsyncInferenceServer`` with 2-layer gcn and gat
   (``max_batch=16``, warmed on the class), 64 single-graph requests of
   the class to each model with a 2 s deadline; the ``ServeMetrics``
   snapshot, 0 builds after warm-up, 4 sampled requests a model against
   ``run_reference`` of their graph;
10. autotune: ``tune_for_class`` for 2-layer gcn on phase 4's merged graph
   (24 simulator evaluations, the 2 finalists timed 5 times each by CUDA
   events on the card), then the class served through
   ``InferenceServer(tune_cache=...)``: the tuned registration key, the
   outputs against ``run_reference``, no build on a repeat submit.

Launch counters are set to 0 before phase 4 and read after phase 5, set to
0 again before phase 7 and read after it, and likewise around each of
phases 8, 9 and 10; every kernel must have launched on its path (in phase
8 all four tile kernels).  Then one ``{"kernels": [...]}`` line (all six,
launches of phases 4-5 and 7), the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": ...}``.
Any failure raises, so the exit code is nonzero and no ``ok`` line prints;
so does a machine without a visible CUDA device.  Weights and inputs come
from fixed seeds.  fp32 throughout (phase 6 adds bf16), TF32 off.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
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
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:112",
    "grouped_ffn": "src/repro/kernels/moe_dispatch/kernel.py:57",
}
LM_SOURCES = {
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "grouped_ffn": "src/repro_torch/kernels/moe_dispatch/csrc/grouped_ffn.cu",
}
# |kernel - plain| <= abs + rel * magnitude (+ BF16_ULP * |plain| in bf16),
# elementwise.  Both sides compute in fp32 from the same inputs, so in fp32
# they differ only by the order of their sums, whose rounding scales with the
# magnitude: what the sums' terms add up to in absolute value (flash: the
# plain version on |v|; grouped FFN: ffn_magnitude, stage by stage, with the
# gate/up errors carried through silu).  The magnitude bounds rounding errors
# that all align; real ones random-walk far below it: the plain versions in
# fp32 against fp64 at these shapes differ by 1.1e-6 of it (flash, where an
# error in a score moves its exp) and 1.2e-9 (grouped FFN), so rel leaves
# 5-80x room and still fails a wrong row by orders of magnitude.  In bf16 the
# same fp32 results are rounded to bf16, and two nearby fp32 values may
# round to neighbours one unit in the last place apart: 2^-7 of |plain|.
LM_KERNEL_TOL = {"flash_attention": (1e-6, 1e-5), "grouped_ffn": (1e-6, 1e-7)}
BF16_ULP = 2.0 ** -7
LM_MODEL_TOL = {"dense": 2e-3, "moe": 5e-3}   # decode vs forward, x max(1, |ref|)
PREFILL_LEN = 4096
# Off the path: shapes that reach the tail paths of the COO tile SpMM
# (phase 3) and the grouped FFN (phase 6), held at the same limits.
# COO: tiles per partition (a 0 is a partition with no tile), rows D,
# columns S (37: not a multiple of 4, so the adjacency is read a float a
# lane), width F (20: lanes past the row idle; 130: not a multiple of 4, x
# read a column a lane, in two 128-column slices).
COO_OFF_PATH = [
    dict(case="f20_s37", parts=(3, 0, 2, 4), D=70, S=37, F=20),
    dict(case="f130", parts=(2, 5, 0), D=64, S=584, F=130),
]
# Segment softmax off the path (phase 3), both layouts, on one graph tiled
# 4 x 3: destinations only in the lower half of the vertices (two
# partitions without a tile), a hub row of 3 x 128 + 50 parallel in-edges
# (split into 4 chunks), and in COO every edge into vertex ``dead_row`` and
# ~5 % of the others scored -2e29, below the liveness cut (a row with no
# live edge is 0); widths F 20 (lanes past the row idle) and 130 (not a
# multiple of 4: a column a lane, in 32-column slices).
SOFTMAX_GRAPH = dict(V=400, E=3000, hub=9, hub_edges=3 * 128 + 50, dead_row=20)
SOFTMAX_OFF_PATH = [dict(case="f20", F=20), dict(case="f130", F=130)]
DEAD_SCORE = -2e29
# grouped FFN: d and f multiples of 8 but not of the 32-deep contraction
# step nor of the 128 / 256-column tiles; C past the last full 8-row slice
# (44) and over two row tiles (72); counts mixing 0, C and partial ones
FFN_OFF_PATH = [
    dict(case="tails", C=44, d=200, f=72, counts=(0, 44, 17, 44, 1, 30, 8, 40)),
    dict(case="two_row_tiles", C=72, d=136, f=264, counts=(72, 0, 67, 5)),
]


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


def bound(n_bytes: float, n_flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    """Least time (ms) on the card, and which term sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def without_host_sync(fn):
    """Run ``fn`` once with PyTorch's host syncs turned into errors."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def count_host_syncs(fn):
    """Run ``fn`` once with PyTorch's host syncs turned into warnings;
    return its result and the number of syncs it made."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def build_timed(fn, times: int = 2):
    """Call ``fn`` (an edge-plan build) ``times`` times, host-timed to a
    synchronize; return the last result, the milliseconds of each call and
    the host syncs of one more call."""
    import torch
    ms = []
    for _ in range(times):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    _, syncs = count_host_syncs(fn)
    return out, ms, syncs


def softmax_off_path_tiles(layout: str):
    """The graph of ``SOFTMAX_GRAPH`` (numpy, seed 0) and its 4 x 3 tiles."""
    import numpy as np
    from repro_torch.core.tiling import grid_tile
    from repro_torch.gnn.graphs import Graph
    c = SOFTMAX_GRAPH
    rng = np.random.default_rng(0)
    src = np.concatenate([rng.integers(0, c["V"], c["E"]),
                          rng.integers(0, c["V"], c["hub_edges"])])
    dst = np.concatenate([rng.integers(0, c["V"] // 2, c["E"]),
                          np.full(c["hub_edges"], c["hub"])])
    g = Graph(src=src.astype(np.int32), dst=dst.astype(np.int32), n_vertices=c["V"])
    return g, grid_tile(g, 4, 3, sparse=True, layout=layout)


def scaled_err(got, ref) -> float:
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main-path shapes
# ---------------------------------------------------------------------------

def kernel_checks(serve_tiles, csr_tiles, dev):
    import numpy as np
    import torch
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.kernels.tile_spmm import ops, ref
    from repro_torch.kernels.tile_spmm.plan import coo_plan, csr_plan

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def padded_nan(t, ts):
        """``t`` (T, E, ...) with NaN in every padded edge slot of ``ts``."""
        pad = (torch.arange(t.shape[1], device=dev)[None, :]
               >= torch.as_tensor(ts.n_edge, device=dev)[:, None])
        return t.masked_fill_(pad, float("nan"))

    def plan_of(ts):
        """The edge plan of tiles ``ts`` on the card (as the runner's bind
        builds it), with its build times and host syncs."""
        P, D = ts.n_dst_parts, int(ts.part_size.max())
        pid = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
        if ts.layout == "csr":
            rp = torch.as_tensor(ts.row_ptr, dtype=torch.int32, device=dev)
            return build_timed(lambda: csr_plan(rp, pid, P, ts.e_max))
        ed = torch.as_tensor(ts.edge_dst, dtype=torch.int32, device=dev)
        ne = torch.as_tensor(ts.n_edge, dtype=torch.int32, device=dev)
        return build_timed(lambda: coo_plan(ed, ne, pid, P, D))

    rows = []

    def check(name, kernel, plain, magnitude, n_bytes, n_flops, library=None,
              note=None, primary=True, **extra):
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
                   shapes=note, **extra)
        emit(dict(phase="kernel_check", **row))
        if primary:
            rows.append(row)

    # -- COO operands at the serving batch's shapes (phase 4)
    ts = serve_tiles
    T, S, E, P = ts.n_tiles, ts.s_max, ts.e_max, ts.n_dst_parts
    D = int(ts.part_size.max())
    n_edge = int(ts.n_edge.sum())
    n_src = int(ts.n_src.sum())
    part_id = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
    part_ptr = torch.as_tensor(K.partition_ptr(ts.part_id, P), device=dev)
    flags = torch.as_tensor(K.tile_flags(ts.part_id), device=dev)
    edge_dst = torch.as_tensor(ts.edge_dst, device=dev).long()
    edge_src = torch.as_tensor(ts.edge_src, device=dev).long()
    n_edge_t = torch.as_tensor(ts.n_edge, device=dev).long()
    adj = ops.densify_edge_weights(randn(T, E), edge_dst, edge_src, n_edge_t,
                                   dmax=D, smax=S)
    xsrc = randn(T, S, WIDTH)
    out_bytes = P * D * WIDTH * 4

    def coo_spmm():
        return K.tile_spmm_cuda(adj, xsrc, part_id, flags, n_parts=P,
                                part_ptr=part_ptr)

    without_host_sync(coo_spmm)
    check("tile_spmm", coo_spmm,
          lambda: ref.tile_spmm_ref(adj, xsrc, part_id, P),
          lambda: ref.tile_spmm_ref(adj.abs(), xsrc.abs(), part_id, P),
          adj.numel() * 4 + n_src * WIDTH * 4 + T * 4 + out_bytes,
          2 * WIDTH * n_edge,
          library=lambda: torch.bmm(adj, xsrc),
          note=dict(T=T, D=D, S=S, F=WIDTH, P=P, edges=n_edge,
                    library="torch.bmm(adj, xsrc): the per-tile product "
                            "without the partition sum"))

    # the COO SpMM off the path (COO_OFF_PATH): ~0.5 % of the adjacency
    # nonzero, as on the path
    for c in COO_OFF_PATH:
        Tc, Dc, Sc, Fc = sum(c["parts"]), c["D"], c["S"], c["F"]
        Pc = len(c["parts"])
        pid_np = np.repeat(np.arange(Pc, dtype=np.int32), c["parts"])
        pid = torch.as_tensor(pid_np, device=dev)
        ptr = torch.as_tensor(K.partition_ptr(pid_np, Pc), device=dev)
        a = randn(Tc, Dc, Sc) * (torch.rand((Tc, Dc, Sc), generator=gen, device=dev) < 0.005)
        xc = randn(Tc, Sc, Fc)
        fl = torch.as_tensor(K.tile_flags(pid_np), device=dev)
        edges = int((a != 0).sum())
        check("tile_spmm",
              lambda: K.tile_spmm_cuda(a, xc, pid, fl, n_parts=Pc, part_ptr=ptr),
              lambda: ref.tile_spmm_ref(a, xc, pid, Pc),
              lambda: ref.tile_spmm_ref(a.abs(), xc.abs(), pid, Pc),
              a.numel() * 4 + xc.numel() * 4 + Tc * 4 + Pc * Dc * Fc * 4,
              2 * Fc * edges, library=lambda: torch.bmm(a, xc),
              note=dict(T=Tc, D=Dc, S=Sc, F=Fc, P=Pc, edges=edges,
                        tiles_per_partition=list(c["parts"])),
              primary=False, case=c["case"])
        del a, xc

    del adj, xsrc

    def softmax(name, ts, s_e, xsrc, built, primary=True, case=None):
        """One segment softmax on tiles ``ts``: per-edge scores ``s_e``
        (T, E), the tiles' column indices and the source replica ``xsrc``
        (T, S, F), walking the plan ``built`` (plan, build ms, host syncs)
        against the plan walk's plain version."""
        plan, plan_ms, plan_syncs = built
        coo = ts.layout == "coo"
        T, E = s_e.shape
        S, F = xsrc.shape[-2:]
        P, D = ts.n_dst_parts, int(ts.part_size.max())
        pid = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
        fl = torch.as_tensor(K.tile_flags(ts.part_id), device=dev)
        col = torch.as_tensor(ts.edge_src, dtype=torch.int32, device=dev)
        if coo:
            ed = torch.as_tensor(ts.edge_dst, dtype=torch.int32, device=dev)
            ne = torch.as_tensor(ts.n_edge, dtype=torch.int32, device=dev)

            def kernel():
                return K.segment_softmax_cuda(ed, ne, col, s_e, xsrc, pid, fl,
                                              n_parts=P, dmax=D, plan=plan)
        else:
            rp = torch.as_tensor(ts.row_ptr, dtype=torch.int32, device=dev)

            def kernel():
                return K.segment_softmax_csr_cuda(rp, col, s_e, xsrc, pid, fl,
                                                  n_parts=P, plan=plan)
        n_edge = plan.slot.numel()
        chunks = plan.split_ptr.diff()
        note = dict(T=T, D=D, S=S, E=E, F=F, P=P, layout=ts.layout,
                    edges=n_edge, groups=plan.group_ptr.numel() - 1,
                    zero_rows=plan.zero_row.numel(),
                    split_rows=plan.split_row.numel(),
                    most_chunks=int(chunks.max()) if chunks.numel() else 1,
                    partials=plan.n_partial, chunk_size=plan.chunk_size)
        library = None
        extra = {}
        if primary:
            without_host_sync(kernel)
            # the library yardstick, two calls: torch.sparse.softmax over
            # the (P*D, live edges) score matrix, then torch.sparse.mm with
            # the edges' source rows (the matrix and the rows are built here,
            # outside the timing)
            slot = plan.slot.long()
            s = s_e.reshape(-1)[slot]
            keep = torch.nonzero(s > ref._LIVE if coo else torch.isfinite(s)).flatten()
            rows_of = torch.repeat_interleave(
                torch.arange(P * D, device=dev), plan.row_start.diff().long())
            sp = torch.sparse_coo_tensor(
                torch.stack([rows_of[keep], torch.arange(keep.numel(), device=dev)]),
                s[keep], (P * D, keep.numel())).coalesce()
            vals = xsrc.reshape(T * S, F)[(slot[keep] // E) * S
                                          + col.reshape(-1).long()[slot[keep]]]

            def library():
                return torch.sparse.mm(torch.sparse.softmax(sp, 1), vals)

            extra = dict(library_max_abs_diff=float(
                (library().view(P, D, F) - kernel()).abs().max()))
            note["library"] = ("two calls: torch.sparse.softmax over the "
                               "(P*D, edges) score matrix, then torch.sparse.mm "
                               "with the edges' gathered source rows")
        check(name, kernel,
              lambda: ref.segment_softmax_plan_ref(plan, col, s_e, xsrc, P, coo=coo),
              lambda: ref.segment_softmax_plan_ref(plan, col, s_e, xsrc.abs(), P,
                                                   coo=coo),
              plan.nbytes + n_edge * 8 + int(ts.n_src.sum()) * F * 4
              + P * D * F * 4 + plan.n_partial * (F + 2) * 4,
              n_edge * (2 * F + 3), library=library, note=note,
              primary=primary, case=case, plan_first_ms=plan_ms[0],
              plan_ms=plan_ms[-1], plan_host_syncs=plan_syncs,
              plan_bytes=plan.nbytes, **extra)

    # the softmaxes off the path (SOFTMAX_OFF_PATH), both layouts
    for layout in ("coo", "csr"):
        g, tc = softmax_off_path_tiles(layout)
        built = plan_of(tc)
        dst_of = torch.as_tensor(g.dst, device=dev)[
            torch.as_tensor(tc.edge_gid, device=dev).long()]
        for c in SOFTMAX_OFF_PATH:
            s_c = padded_nan(randn(tc.n_tiles, tc.e_max), tc)
            if layout == "coo":
                dead = ((dst_of == SOFTMAX_GRAPH["dead_row"])
                        | (torch.rand(s_c.shape, generator=gen, device=dev) < 0.05))
                s_c = torch.where(dead & ~torch.isnan(s_c), DEAD_SCORE, s_c)
            softmax("segment_softmax" if layout == "coo" else "segment_softmax_csr",
                    tc, s_c, randn(tc.n_tiles, tc.s_max, c["F"]), built,
                    primary=False, case=f"{c['case']}_{layout}")

    # the COO softmax at the serving batch's shapes
    softmax("segment_softmax", ts, padded_nan(randn(T, E), ts),
            randn(T, S, WIDTH), plan_of(ts))

    # -- CSR operands at the whole-graph phase's shapes (phase 5); padded
    # edge slots hold NaN, which the kernels must never read
    ts = csr_tiles
    T, S, E, P = ts.n_tiles, ts.s_max, ts.e_max, ts.n_dst_parts
    D = int(ts.part_size.max())
    n_edge = int(ts.n_edge.sum())
    n_src = int(ts.n_src.sum())
    part_id = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
    part_ptr = torch.as_tensor(K.partition_ptr(ts.part_id, P), device=dev)
    flags = torch.as_tensor(K.tile_flags(ts.part_id), device=dev)
    row_ptr = torch.as_tensor(ts.row_ptr, dtype=torch.int32, device=dev)
    col = torch.as_tensor(ts.edge_src, dtype=torch.int32, device=dev)
    w = padded_nan(randn(T, E), ts)
    xsrc = randn(T, S, WIDTH)
    out_bytes = P * D * WIDTH * 4
    # the library yardstick: one sparse (P*D, T*S) CSR product, built here
    # from the same edges (only the product is timed)
    t_e, slot, dest = ref._csr_edges(row_ptr, part_id, E)
    sp = torch.sparse_coo_tensor(
        torch.stack([dest, t_e * S + col.long()[t_e, slot]]), w[t_e, slot],
        (P * D, T * S)).coalesce().to_sparse_csr()
    x_flat = xsrc.view(T * S, WIDTH)
    # the edge plan, built once per tile set (as PipelinedRunner.bind does):
    # the first build in the process, and a second one
    built = plan_of(ts)
    plan, plan_ms, plan_syncs = built

    def csr_spmm():
        return K.tile_spmm_csr_cuda(row_ptr, col, w, xsrc, part_id, flags,
                                    n_parts=P, plan=plan)

    without_host_sync(csr_spmm)
    check("tile_spmm_csr", csr_spmm,
          lambda: ref.tile_spmm_csr_ref(row_ptr, col, w, xsrc, part_id, P),
          lambda: ref.tile_spmm_csr_ref(row_ptr, col, w.abs(), xsrc.abs(),
                                        part_id, P),
          plan.nbytes + n_edge * 8 + n_src * WIDTH * 4 + out_bytes,
          2 * WIDTH * n_edge,
          library=lambda: torch.sparse.mm(sp, x_flat),
          note=dict(T=T, D=D, S=S, E=E, F=WIDTH, P=P, edges=n_edge,
                    groups=plan.group_ptr.shape[0] - 1,
                    zero_rows=plan.zero_row.shape[0],
                    split_rows=plan.split_row.shape[0],
                    partials=plan.n_partial, chunk_size=plan.chunk_size,
                    library="torch.sparse.mm of the (P*D, T*S) CSR matrix "
                            "of the same edges"),
          plan_first_ms=plan_ms[0], plan_ms=plan_ms[1], plan_host_syncs=plan_syncs,
          plan_bytes=plan.nbytes)
    del sp, x_flat, w

    # the CSR softmax on the same tiles, plan and source replica
    softmax("segment_softmax_csr", ts, padded_nan(randn(T, E), ts), xsrc, built)
    del xsrc, plan, built
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
    from repro_torch.kernels.tile_spmm.plan import coo_plan
    from repro_torch.serve import InferenceServer, ShapeRegistry

    # the host half of every submit: merge the batch and tile it onto the
    # class's canonical shapes (the server repeats this per request)
    t0 = time.perf_counter()
    batch = G.batch_graphs(graphs)
    _, tiles, _, _ = ShapeRegistry().canonical("shapes", batch.graph)
    host_tiling_s = time.perf_counter() - t0
    # the COO edge plan a gat submit builds at bind, from the tiles' arrays
    # on the card: three builds, and the host syncs of one
    pid = torch.as_tensor(tiles.part_id, dtype=torch.int32, device=dev)
    ed = torch.as_tensor(tiles.edge_dst, dtype=torch.int32, device=dev)
    ne = torch.as_tensor(tiles.n_edge, dtype=torch.int32, device=dev)
    _, plan_ms, plan_syncs = build_timed(
        lambda: coo_plan(ed, ne, pid, tiles.n_dst_parts, int(tiles.part_size.max())),
        times=3)
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
        plan = (dict(softmax_plan_ms=plan_ms, softmax_plan_host_syncs=plan_syncs)
                if name == "gat" else {})
        emit(dict(phase="serving", model=f"{name}_x2", layout="coo",
                  graphs=len(graphs), vertices=batch.graph.n_vertices,
                  edges=batch.graph.n_edges, cold_s=lat[0],
                  warm_p50_s=statistics.median(warm),
                  graphs_per_s=len(graphs) / statistics.median(warm),
                  host_tiling_s=host_tiling_s,
                  builds=server.compile_count, hits=server.cache_hits,
                  err_vs_oracle=err, tol=MODEL_TOL[name],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **plan))


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


# ---------------------------------------------------------------------------
# phase 6: the LM kernels against their plain versions at phase 7's shapes
# ---------------------------------------------------------------------------

def _flash_keep(B, Sq, Sk, causal, window, kv_len, dev):
    """(B, Sq, Sk) bool: the (query, key) pairs the masks keep, queries
    right-aligned against the keys."""
    import torch
    q_pos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=dev)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        keep &= k_pos <= q_pos
    if window is not None:
        keep &= k_pos > q_pos - window
    lens = torch.full((B,), Sk, device=dev) if kv_len is None else kv_len.long()
    return keep[None] & (k_pos[None] < lens[:, None, None])


def lm_kernel_checks(dense_cfg, moe_cfg, dev, *, prefill_len=PREFILL_LEN,
                     cache_len=40, decode_batch=4, runs=5):
    import dataclasses

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.moe_dispatch import kernel as GK
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.kernels.moe_dispatch.ref import grouped_ffn_magnitude, grouped_ffn_ref
    from repro_torch.models.moe import capacity

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    rows, failed = [], []

    def check(name, case, dtype, kernel, plain, magnitude, n_bytes, n_flops,
              library, library_label, shapes, primary):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        tol = LM_KERNEL_TOL[name]
        limit = tol[0] + tol[1] * magnitude().float()
        if dtype == "bfloat16":
            limit += BF16_ULP * want.abs()
        max_abs = float(err.max())
        worst = float((err / limit).max())       # <= 1 where the check holds
        if not bool(torch.isfinite(got).all()):
            failed.append(f"{name} {case} {dtype}: non-finite output")
        elif worst > 1:
            failed.append(f"{name} {case} {dtype}: max abs err {max_abs}, "
                          f"{worst:.3g} x its elementwise limit")
        del got, want, err, limit
        rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else FP32_FLOPS_PER_S
        b_ms, b_by = bound(n_bytes, n_flops, rate)
        row = dict(name=name, case=case, dtype=dtype, route="cuda",
                   source=LM_SOURCES[name], replaces=REPLACES[name],
                   max_abs_err=max_abs, err_over_limit=worst, tol_abs=tol[0],
                   tol_rel=tol[1], tol_ulp=BF16_ULP if dtype == "bfloat16" else 0.0,
                   ms=time_ms(kernel, runs, 1), plain_ms=time_ms(plain, runs, 1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, runs, 1),
                   library=library_label, shapes=shapes, primary=primary)
        emit(dict(phase="lm_kernel_check", **row))
        rows.append(row)
        torch.cuda.empty_cache()

    # -- flash attention: MLA prefill, GQA prefill, GQA decode (the path's
    # shapes), and two cases off the path: a prompt whose length fits
    # neither the 128-row query tile nor the 64-key tile, and the options
    # the path does not use (head dim 256, a sliding window, a partial last
    # query tile, kv_len)
    m = moe_cfg.mla
    flash_cases = [
        ("mla_prefill", 1, prefill_len, prefill_len, moe_cfg.n_heads, moe_cfg.n_heads,
         m.qk_nope + m.qk_rope, m.v_dim, True, None, None),
        ("gqa_prefill", 1, prefill_len, prefill_len, dense_cfg.n_heads,
         dense_cfg.n_kv_heads, dense_cfg.hdim, dense_cfg.hdim, True, None, None),
        ("gqa_decode", decode_batch, 1, cache_len, dense_cfg.n_heads,
         dense_cfg.n_kv_heads, dense_cfg.hdim, dense_cfg.hdim, False, None,
         [cache_len - (cache_len * i) // (2 * decode_batch) for i in range(decode_batch)]),
        ("gqa_ragged", 1, 1000, 1000, dense_cfg.n_heads, dense_cfg.n_kv_heads,
         dense_cfg.hdim, dense_cfg.hdim, True, None, None),
        ("window_d256", 2, 65, 130, 4, 2, 256, 256, True, 30, [110, 130]),
    ]
    for case, B, Sq, Sk, H, K, D, Dv, causal, window, kv_list in flash_cases:
        q32, k32, v32 = randn(B, Sq, H, D), randn(B, Sk, K, D), randn(B, Sk, K, Dv)
        kv_len = (None if kv_list is None
                  else torch.tensor(kv_list, dtype=torch.int32, device=dev))
        keep = _flash_keep(B, Sq, Sk, causal, window, kv_len, dev)
        # every query row keeps a key: a row with none is 0 from the kernel
        # (as from the Pallas kernel) and the masked rows' mean from the
        # plain version (as from the scan path)
        require(bool(keep.any(-1).all()), f"flash {case}: a query row keeps no key")
        pairs = int(keep.sum())
        kv_rows = B * Sk if kv_list is None else sum(min(Sk, n) for n in kv_list)
        # the library yardstick: SDPA on (B, H, S, D), K/V heads repeated to
        # H and the layout change made outside the timing; a boolean mask
        # wherever is_causal cannot say it
        mask = None if window is None and kv_len is None else keep[:, None]
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q, k, v = q32.to(tdt), k32.to(tdt), v32.to(tdt)
            v_abs = v.abs()
            el = q.element_size()
            n_bytes = el * (q.numel() + kv_rows * K * (D + Dv) + B * Sq * H * Dv) + \
                (0 if kv_len is None else 4 * B)
            qt = q.transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).repeat_interleave(H // K, dim=1).contiguous()
            vt = v.transpose(1, 2).repeat_interleave(H // K, dim=1).contiguous()
            opts = dict(causal=causal, window=window, kv_len=kv_len)
            if case == "gqa_prefill" and dtype == "float32":
                without_host_sync(lambda: FK.flash_attention_cuda(q, k, v, **opts))
            check("flash_attention", case, dtype,
                  lambda: FK.flash_attention_cuda(q, k, v, **opts),
                  lambda: flash_attention_ref(q, k, v, **opts),
                  lambda: flash_attention_ref(q, k, v_abs, **opts),
                  n_bytes, pairs * H * (2 * D + 2 * Dv),
                  library=lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None),
                  library_label="torch.nn.functional.scaled_dot_product_attention "
                                "(K/V repeated to H heads)",
                  shapes=dict(B=B, Sq=Sq, Sk=Sk, H=H, K=K, D=D, Dv=Dv, causal=causal,
                              window=window, kv_len=kv_list, pairs_per_head=pairs),
                  primary=(case == "mla_prefill" and dtype == "float32"))
            del q, k, v, v_abs, qt, kt, vt
        del q32, k32, v32, keep, mask

    # -- grouped FFN: a prefill chunk's buckets and a decode step's, with the
    # live counts of a real top-k routing
    mo = moe_cfg.moe
    E, d, f = mo.n_routed, moe_cfg.d_model, mo.d_ff_expert
    w32 = dict(wg=randn(E, d, f, scale=d ** -0.5), wu=randn(E, d, f, scale=d ** -0.5),
               wd=randn(E, f, d, scale=f ** -0.5))
    router = randn(d, E, scale=d ** -0.5)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        w = {k_: t.to(tdt) for k_, t in w32.items()}
        el = torch.finfo(tdt).bits // 8
        for case, n_tok in (("prefill_chunk", prefill_len // 4), ("decode", decode_batch)):
            cap = capacity(moe_cfg, n_tok)
            x = randn(n_tok, d)
            r = moe_ops.route(x, router, mo.top_k, cap, norm_topk=mo.norm_topk)
            buckets = moe_ops.dispatch(x, r, E, cap).to(tdt)
            counts = torch.clamp(r.counts, max=cap).to(torch.int32)
            live_rows = int(counts.sum())
            live_experts = int((counts > 0).sum())
            n_bytes = el * (live_experts * 3 * d * f + live_rows * d + E * cap * d) + 4 * E
            args = (buckets, w["wg"], w["wu"], w["wd"], counts)
            cfg = GK.launch_config(E, cap, d, f, tdt)
            issued = GK.issued_rows(counts.tolist(), cap, cfg)

            def library(b=buckets, w=w):
                h = torch.bmm(b, w["wg"])
                return torch.bmm(F.silu(h) * torch.bmm(b, w["wu"]), w["wd"])

            if case == "prefill_chunk" and dtype == "float32":
                without_host_sync(lambda: GK.grouped_ffn_cuda(*args))
            check("grouped_ffn", case, dtype,
                  lambda: GK.grouped_ffn_cuda(*args),
                  lambda: grouped_ffn_ref(*args),
                  lambda: grouped_ffn_magnitude(*args),
                  n_bytes, 2 * 3 * d * f * live_rows, library=library,
                  library_label=f"torch.bmm x3 + silu over all {E} experts, dead rows too",
                  shapes=dict(E=E, C=cap, d=d, f=f, tokens=n_tok, top_k=mo.top_k,
                              live_rows=live_rows, live_experts=live_experts,
                              issued_rows=issued, config=dataclasses.asdict(cfg)),
                  primary=(case == "prefill_chunk" and dtype == "float32"))
            del x, r, buckets, args
        del w
        # off the path (FFN_OFF_PATH): every row of the buckets nonzero, so
        # rows at or past the count must come out zero whatever they hold
        for c in FFN_OFF_PATH:
            Ec, C, dc, fc = len(c["counts"]), c["C"], c["d"], c["f"]
            a_ = (randn(Ec, C, dc).to(tdt), randn(Ec, dc, fc, scale=dc ** -0.5).to(tdt),
                  randn(Ec, dc, fc, scale=dc ** -0.5).to(tdt),
                  randn(Ec, fc, dc, scale=fc ** -0.5).to(tdt),
                  torch.tensor(c["counts"], dtype=torch.int32, device=dev))
            live_rows, live_experts = sum(c["counts"]), sum(n > 0 for n in c["counts"])
            check("grouped_ffn", c["case"], dtype,
                  lambda: GK.grouped_ffn_cuda(*a_),
                  lambda: grouped_ffn_ref(*a_),
                  lambda: grouped_ffn_magnitude(*a_),
                  el * (live_experts * 3 * dc * fc + live_rows * dc + Ec * C * dc) + 4 * Ec,
                  2 * 3 * dc * fc * live_rows,
                  library=lambda: torch.bmm(F.silu(torch.bmm(a_[0], a_[1]))
                                            * torch.bmm(a_[0], a_[2]), a_[3]),
                  library_label=f"torch.bmm x3 + silu over all {Ec} experts, dead rows too",
                  shapes=dict(E=Ec, C=C, d=dc, f=fc, counts=list(c["counts"]),
                              config=dataclasses.asdict(GK.launch_config(Ec, C, dc, fc, tdt))),
                  primary=False)
            del a_
    del w32, router
    torch.cuda.empty_cache()
    require(not failed, "; ".join(failed))
    return rows


# ---------------------------------------------------------------------------
# phase 7: LM serving, the path of the LM kernels
# ---------------------------------------------------------------------------

def device_breakdown(fn, n_calls: int = 1, top: int = 6):
    """Kernel time on the card while ``fn`` runs, from ``torch.profiler``:
    device ms and kernel launches per call, and the largest kernels by
    their share of the device time.  None where the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return dict(device_ms=total_us / 1e3 / n_calls,
                launches=sum(e.count for e in kernels) / n_calls,
                top=[dict(kernel=e.key[:80], share=e.self_device_time_total / total_us)
                     for e in kernels[:top]])


def lm_serving_phase(models, dev, *, prefill_len=PREFILL_LEN, requests=8, batch=4,
                     max_prompt=24, max_new=16, check_len=8):
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve_requests
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, tree_items

    for label, cfg in models:
        t0 = time.perf_counter()
        params = materialize(torch.Generator(device=dev).manual_seed(0),
                             lm.model_template(cfg), dtype_override="float32",
                             device=dev)
        n_params = sum(t.numel() for _, t in tree_items(params))
        init_s = time.perf_counter() - t0

        # serving with launch/serve.py's defaults
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, rng.integers(4, max_prompt + 1))
                   for _ in range(requests)]
        res = serve_requests(cfg, params, prompts, batch=batch, max_prompt=max_prompt,
                             max_new=max_new, device=dev)
        toks = np.concatenate([o.ravel() for o in res["tokens"]])
        require(toks.size == requests * max_new and toks.min() >= 0
                and toks.max() < cfg.vocab, f"serving {label}: bad tokens")

        # teacher-forced decode against forward
        tokens = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (1, check_len)), device=dev)
        out = lm.forward(cfg, params, {"tokens": tokens})
        full = out[0] if cfg.family == "moe" else out
        require(bool(torch.isfinite(full).all()), f"{label}: non-finite forward logits")
        cache = materialize(None, lm.cache_template(cfg, 1, check_len),
                            dtype_override="float32", device=dev)
        step = make_decode_step(cfg)
        err = 0.0
        for pos in range(check_len):
            logits, cache = step(params, cache, tokens[:, pos:pos + 1], pos)
            require(bool(torch.isfinite(logits).all()),
                    f"{label}: non-finite decode logits at {pos}")
            err = max(err, scaled_err(logits, full[:, pos]))
        tol = LM_MODEL_TOL[cfg.family]
        require(err <= tol, f"{label}: decode vs forward err {err} over {tol}")
        del out, full, cache

        # where a decode step's time goes: 8 steps of a batch at the serving
        # batch size, profiled; set against the unprofiled step p50
        cache = materialize(None, lm.cache_template(cfg, batch, max_prompt + max_new),
                            dtype_override="float32", device=dev)
        tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)

        def decode_steps(n=8):
            nonlocal cache, tok
            for pos in range(n):
                logits, cache = step(params, cache, tok, pos)
                tok = torch.argmax(logits, -1, keepdim=True)

        decode_steps(2)
        decode_prof = device_breakdown(decode_steps, 8)
        del cache

        # one long prompt through the prefill step: the first call (the
        # allocator grows to the prompt's activations), then a warm one
        prompt = {"tokens": torch.as_tensor(np.random.default_rng(4).integers(
            0, cfg.vocab, (1, prefill_len)), device=dev)}
        prefill = make_prefill_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prefill_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            nxt = prefill(params, prompt)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        require(tuple(nxt.shape) == (1, cfg.vocab) and bool(torch.isfinite(nxt).all()),
                f"{label}: prefill logits {tuple(nxt.shape)} or non-finite")
        prefill_mem_gb = torch.cuda.max_memory_allocated() / 1e9
        prefill_prof = device_breakdown(lambda: prefill(params, prompt))
        busy = (None if decode_prof is None
                else decode_prof["device_ms"] / 1e3 / res["step_p50_s"])
        emit(dict(phase="lm_serving", model=label, family=cfg.family,
                  layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
                  param_gb=4 * n_params / 1e9, init_s=init_s,
                  requests=requests, batch=batch, max_new=max_new,
                  serve_s=res["seconds"], tokens_per_s=res["tokens_per_s"],
                  decode_steps=len(res["step_s"]), step_p50_s=res["step_p50_s"],
                  decode_vs_forward_err=err, tol=tol, prefill_tokens=prefill_len,
                  prefill_first_s=prefill_s[0], prefill_s=prefill_s[1],
                  prefill_peak_mem_gb=prefill_mem_gb,
                  decode_device_busy_share=busy, decode_profile=decode_prof,
                  prefill_profile=prefill_prof))
        del params, nxt, prompt
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 8-10: the tiled interpreter, the async tier, the tuned route
# ---------------------------------------------------------------------------

def tiled_phase(graphs, dev, *, width=WIDTH, grid=64):
    """``run_tiled`` on the serving batch, as served (COO tiles of the
    server's canonical shapes) and as CSR tiles of the same padded graph,
    with kernel dispatch on and off, against ``run_reference``."""
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference, run_tiled
    from repro_torch.core.tiling import grid_tile
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M
    from repro_torch.serve import ShapeRegistry

    padded, coo_tiles, _, _ = ShapeRegistry().canonical(
        "shapes", G.batch_graphs(graphs).graph)
    csr_tiles = grid_tile(padded, grid, grid, sparse=True, layout="csr")
    for name in ("gcn", "gat"):
        tr = M.trace_stacked(name, 2, width, width, width)
        c = compiler.compile_gnn(tr)
        params = M.init_params(tr, seed=0)
        inputs = M.init_inputs(tr, padded, seed=0)
        want = run_reference(tr, padded, inputs, params, device=dev)[0]
        for tiles in (coo_tiles, csr_tiles):
            for dispatch in (True, False):
                secs = []
                for _ in range(2):              # the first pass, a warm one
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = run_tiled(c, padded, tiles, inputs, params,
                                    kernel_dispatch=dispatch, device=dev)[0]
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                what = f"tiled {name} {tiles.layout} dispatch={dispatch}"
                require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                        f"{what}: output shape {tuple(got.shape)} or non-finite")
                err = scaled_err(got, want)
                require(err <= MODEL_TOL[name], f"{what}: err {err} over {MODEL_TOL[name]}")
                emit(dict(phase="tiled", model=f"{name}_x2", layout=tiles.layout,
                          kernel_dispatch=dispatch, vertices=padded.n_vertices,
                          edges=padded.n_edges, tiles=tiles.n_tiles,
                          s_max=tiles.s_max, e_max=tiles.e_max,
                          first_s=secs[0], warm_s=secs[1], err_vs_oracle=err,
                          tol=MODEL_TOL[name]))
        del want, got
    torch.cuda.empty_cache()


def async_serving_phase(graphs, dev, *, width=WIDTH, max_batch=16,
                        deadline_s=2.0, samples=4):
    """``AsyncInferenceServer`` with 2-layer gcn and gat, warmed on the
    class, under ``len(graphs)`` single-graph requests to each model."""
    import numpy as np
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.gnn import models as M
    from repro_torch.serve import AsyncInferenceServer

    srv = AsyncInferenceServer(default_deadline_s=deadline_s, n_workers=2)
    traces = {}
    try:
        for name in ("gcn", "gat"):
            tr = traces[name] = M.trace_stacked(name, 2, width, width, width)
            srv.register_model(
                name, compiler.compile_gnn(tr), M.init_params(tr, seed=0),
                max_batch=max_batch, warmup_graphs=[graphs[0]], device=dev)
        t0 = time.perf_counter()
        srv.start()
        while not srv.warmup_done():
            require(time.perf_counter() - t0 < 300, "async: warm-up over 300 s")
            time.sleep(0.01)
        warmup_s = time.perf_counter() - t0
        require(srv.metrics.snapshot()["shed"].get("warmup-failed", 0) == 0,
                "async: a warm-up batch failed")
        builds = srv.cache.stats.compiles      # the shared cache's, both models
        inputs = {n: [M.init_inputs(traces[n], g, seed=i) for i, g in enumerate(graphs)]
                  for n in traces}
        t0 = time.perf_counter()
        tickets = {n: srv.submit_many(graphs, inputs[n], model=n, deadline_s=deadline_s)
                   for n in traces}
        outs = {n: [t.result(timeout=120) for t in ts] for n, ts in tickets.items()}
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        snap = srv.metrics.snapshot()
    finally:
        srv.close(timeout=120)
    for n, ts in tickets.items():
        require(all(t.ok for t in ts),
                f"async {n}: {sum(not t.ok for t in ts)} requests shed: {snap['shed']}")
    rebuilt = srv.cache.stats.compiles - builds
    require(builds == len(traces) and rebuilt == 0,
            f"async: {builds} builds in warm-up, {rebuilt} after it; expected "
            f"{len(traces)} then 0")
    errs = {}
    for n in traces:
        params = M.init_params(traces[n], seed=0)
        errs[n] = []
        for i in np.linspace(0, len(graphs) - 1, samples).astype(int):
            want = run_reference(traces[n], graphs[i], inputs[n][i], params, device=dev)[0]
            got = outs[n][i][0]
            require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                    f"async {n}: request {i} output shape or non-finite")
            errs[n].append(scaled_err(got, want))
        require(max(errs[n]) <= MODEL_TOL[n],
                f"async {n}: err {max(errs[n])} over {MODEL_TOL[n]}")
    emit(dict(phase="async_serving", models=["gcn_x2", "gat_x2"],
              requests_per_model=len(graphs), max_batch=max_batch,
              deadline_s=deadline_s, warmup_s=warmup_s, serve_s=serve_s,
              requests_per_s=2 * len(graphs) / serve_s,
              builds_at_warmup=builds, builds_after_warmup=rebuilt,
              cache=srv.cache.stats.as_dict(),
              latency_p50_s=snap["latency_s"]["p50"],
              latency_p99_s=snap["latency_s"]["p99"],
              batch_fill=snap["batch_fill"], shed=snap["shed"],
              queue_depth=snap["queue_depth"], queue_wait_s=snap["queue_wait_s"],
              metrics=snap, err_vs_oracle=errs, tol={n: MODEL_TOL[n] for n in traces}))
    torch.cuda.empty_cache()


def autotune_phase(graphs, dev, *, width=WIDTH, max_evals=24, top=2, repeats=5):
    """``tune_for_class`` for 2-layer gcn on the serving batch's merged
    graph (simulator search, then each finalist timed on the card by CUDA
    events), then the class served through the tuned route."""
    import numpy as np
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M
    from repro_torch.launch import autotune as AT
    from repro_torch.serve import InferenceServer, quantize, size_class

    tr = M.trace_stacked("gcn", 2, width, width, width)
    c = compiler.compile_gnn(tr)
    params = M.init_params(tr, seed=0)
    batch = G.batch_graphs(graphs)
    merged = batch.graph
    class_key = (c.name, c.n_layers, size_class(graphs[0]),
                 quantize(len(graphs), floor=1))
    cache = AT.TuneCache()
    t0 = time.perf_counter()
    res = AT.tune_for_class(c, merged, class_key, cache=cache,
                            inputs=M.init_inputs(tr, merged, seed=0), params=params,
                            max_shards=1, max_evals=max_evals, top=top,
                            repeats=repeats, device=dev)
    tune_s = time.perf_counter() - t0
    cfg = res.best.config
    require(len(res.confirmed) == min(top, len(res.trials))
            and all(t.wall_s and t.wall_s > 0 for t in res.confirmed),
            "autotune: a finalist has no wall-clock time")
    require(cache.get(AT.program_key(c, True), class_key) == cfg,
            "autotune: the winner is not in the tune cache")

    server = InferenceServer(c, params, tune_cache=cache, device=dev)
    inputs = [M.init_inputs(tr, g, seed=i) for i, g in enumerate(graphs)]
    lat = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = server.submit(graphs, inputs)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    tuned_key = ("tuned",) + cfg.key()
    require(any(tuned_key in k for k in server.shapes._shapes),
            f"autotune: no registration under {tuned_key}")
    require(server.compile_count == 1 and server.cache_hits == 1,
            f"autotune: builds={server.compile_count} hits={server.cache_hits}, "
            "expected 1 build then a hit")
    got = torch.cat([o[0] for o in outs])
    merged_in = {k: np.concatenate([inp[k] for inp in inputs]) for k in inputs[0]}
    want = run_reference(tr, merged, merged_in, params, device=dev)[0]
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"autotune: output shape {tuple(got.shape)} or non-finite")
    err = scaled_err(got, want)
    require(err <= MODEL_TOL["gcn"], f"autotune: err {err} over {MODEL_TOL['gcn']}")
    emit(dict(phase="autotune", model="gcn_x2", vertices=merged.n_vertices,
              edges=merged.n_edges, evals=res.n_evals, tune_s=tune_s,
              wall_clock="cuda_events" if dev.type == "cuda" else "perf_counter",
              repeats=repeats,
              finalists=[dict(config=t.config.to_dict(), cycles=t.cycles,
                              wall_s=t.wall_s) for t in res.confirmed],
              best=cfg.to_dict(), tuned_key=list(tuned_key),
              layout_signature=cache.entry(AT.program_key(c, True),
                                           class_key)["layout_signature"],
              serve_first_s=lat[0], serve_warm_s=lat[1],
              builds=server.compile_count, hits=server.cache_hits,
              err_vs_oracle=err, tol=MODEL_TOL["gcn"]))
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.gnn import graphs as G
    from repro_torch.core.tiling import grid_tile
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.moe_dispatch import kernel as GK
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

    # 2. build: one nvcc per source, all started at once, then load each
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        list(pool.map(_build.build, [m.SOURCE for m in (K, FK, GK)]))
    ptxas = {}
    for m in (K, FK, GK):
        m.library()
        log = _build.library_path(m.SOURCE).with_suffix(".log")
        ptxas[m.SOURCE.name] = [ln.strip() for ln in log.read_text().splitlines()
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

    # 6. LM kernel checks
    dense_cfg = get_config("qwen2-1.5b")
    moe_cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=2)
    lm_rows = lm_kernel_checks(dense_cfg, moe_cfg, dev)

    # 7. LM serving, with launch counts
    FK.reset_launches()
    GK.reset_launches()
    lm_serving_phase([("qwen2-1.5b", dense_cfg), ("deepseek-v2-236b_x2", moe_cfg)], dev)
    lm_launches = {**FK.LAUNCHES, **GK.LAUNCHES}
    for name, n in lm_launches.items():
        require(n > 0, f"kernel {name} was not launched on the LM serving path")
    launches.update(lm_launches)

    # 8. the tiled interpreter on the serving batch, with launch counts
    K.reset_launches()
    tiled_phase(graphs, dev)
    tiled_launches = dict(K.LAUNCHES)
    emit(dict(phase="tiled_launches", **tiled_launches))
    for name, n in tiled_launches.items():
        require(n > 0, f"kernel {name} was not launched by run_tiled")

    # 9. the async tier: 64 single-graph requests of the class, a model
    more = [G.random_graph(2000, 16000, seed=i, model="powerlaw")
            for i in range(len(graphs), 64)]
    K.reset_launches()
    async_serving_phase(graphs + more, dev)
    emit(dict(phase="async_serving_launches", **K.LAUNCHES))
    for name in ("tile_spmm", "segment_softmax"):
        require(K.LAUNCHES[name] > 0, f"kernel {name} was not launched by the async tier")

    # 10. the autotuner's wall-clock step and the tuned route
    K.reset_launches()
    autotune_phase(graphs, dev)
    emit(dict(phase="autotune_launches", **K.LAUNCHES))
    require(K.LAUNCHES["tile_spmm"] + K.LAUNCHES["tile_spmm_csr"] > 0,
            "no SpMM kernel was launched by the tuned route")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: (launches[r["name"]] if k == "launches" else r[k])
                       for k in keys}
                      for r in rows + [r for r in lm_rows if r["primary"]]]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
