"""The plan-walking CUDA kernels and the whole-graph runner on a card: the
flat-store form of the source operand (the (V, F) store read through
global columns) gives the bits of the replica form ((T, S, F) through
tile-local columns).  The CPU tests hold the plain versions to the same;
these need a CUDA card (marker ``chip``; ``python -m pytest -m chip
tests/test_torch_flat_source_card.py`` on one) and skip without it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import compiler as tcompiler
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.tiling import build_tiles
from repro_torch.gnn import graphs as tgraphs
from repro_torch.gnn import models as tmodels
from repro_torch.kernels.tile_spmm import kernel as tkernel
from repro_torch.kernels.tile_spmm import ops as tops
from repro_torch.kernels.tile_spmm.plan import CHUNK_SIZE, coo_plan, csr_plan

F = 128


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graph(seed: int):
    """A power-law graph of 20,000 vertices and 100,000 edges, plus 424
    in-edges of vertex 5 (a hub row over 4 chunks)."""
    base = tgraphs.random_graph(20_000, 100_000, seed=seed, model="powerlaw")
    hub = 3 * CHUNK_SIZE + 40
    src = np.concatenate([base.src, np.arange(hub, dtype=np.int32) % 500])
    dst = np.concatenate([base.dst, np.full(hub, 5, np.int32)])
    return tgraphs.Graph(src=src, dst=dst, n_vertices=20_000)


@pytest.mark.chip
@pytest.mark.parametrize("layout", ["csr", "coo"])
def test_the_kernels_read_the_replicas_rows_from_the_flat_store(layout):
    dev = _card()
    g = _graph(11)
    ts = build_tiles(g, 64, 64, layout=layout)[0]
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(g.n_vertices, F, generator=gen)
    T, E = ts.edge_src.shape
    real = np.arange(E)[None, :] < ts.n_edge[:, None]
    gcol = np.take_along_axis(ts.src_ids, ts.edge_src, axis=1)
    named = torch.as_tensor(np.unique(gcol[real])).long()
    # the store: NaN in every row no real edge names and in one row past V,
    # which every padded slot names
    store = torch.full((g.n_vertices + 1, F), float("nan"))
    store[named] = x[named]
    gcol = np.where(real, gcol, g.n_vertices)

    def d(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    xs, store = x[torch.as_tensor(ts.src_ids).long()].to(dev), store.to(dev)
    col, gcol = d(ts.edge_src, torch.int32), d(gcol, torch.int32)
    pid = d(ts.part_id, torch.int32)
    flags = d(tkernel.tile_flags(ts.part_id), torch.int32)
    scores = torch.randn(T, E, generator=gen).to(dev)
    P = ts.n_dst_parts
    outs = []
    if layout == "csr":
        rp = d(ts.row_ptr, torch.int32)
        plan = csr_plan(rp, pid, P, E)
        assert int(plan.split_ptr.diff().max()) >= 3
        w = torch.randn(T, E, generator=gen).to(dev)
        for c, src in ((col, xs), (gcol, store)):
            outs.append((tops.spmm_csr(rp, c, w, src, pid, flags, n_parts=P,
                                       plan=plan),
                         tops.gat_aggregate_csr(rp, c, scores, src, pid, flags,
                                                n_parts=P, plan=plan)))
    else:
        edst, n_edge = d(ts.edge_dst, torch.int32), d(ts.n_edge, torch.int32)
        dmax = int(ts.part_size.max())
        plan = coo_plan(edst, n_edge, pid, P, dmax)
        for c, src in ((col, xs), (gcol, store)):
            outs.append((tops.gat_aggregate(edst, n_edge, c, scores, src, pid,
                                            flags, n_parts=P, dmax=dmax,
                                            plan=plan),))
    torch.cuda.synchronize()
    for replica, flat in zip(*outs):
        assert torch.isfinite(replica).all()
        assert torch.equal(flat, replica)
    # and the kernels' own answer: the plain walk of the plan on the CPU
    plain = tops.R.segment_softmax_plan_ref(
        _cpu_plan(plan), col.cpu(), scores.cpu(), xs.cpu(), P,
        coo=layout == "coo")
    torch.testing.assert_close(outs[1][-1].cpu(), plain, rtol=1e-4, atol=1e-5)


def _cpu_plan(plan):
    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).cpu() for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)})


@pytest.mark.chip
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_the_whole_graph_runner_gives_the_replica_paths_bits(name, monkeypatch):
    """The runner on CSR tiles, flat source blocks: every kernel operand
    flat and no replica built, against the same runner made to hand the
    kernels replicas."""
    dev = _card()
    from repro_torch import spans

    g = _graph(13)
    tr = tmodels.trace_stacked(name, 2, F, F, F)
    params, inputs = tmodels.init_params(tr, seed=1), tmodels.init_inputs(tr, g, seed=2)
    tiles, ro = build_tiles(g, 64, 64, layout="csr")
    runner = tpipeline.PipelinedRunner(tcompiler.compile_gnn(tr), ro.graph, tiles,
                                       reordering=ro, device=dev)
    with torch.inference_mode():
        spans.enable()
        try:
            flat = runner(inputs, params)[0]
            torch.cuda.synchronize()
            assert spans.export()["counters"]["runner.src_rows_replicated"] == 0
        finally:
            spans.disable()
        replicate = tpipeline._Interpreter.source_operand
        monkeypatch.setattr(tpipeline._Interpreter, "source_operand",
                            lambda self, senv, nid, rows, kc, flat:
                            replicate(self, senv, nid, rows, kc, False))
        replica = runner(inputs, params)[0]
    assert torch.isfinite(flat).all()
    assert torch.equal(flat, replica)
