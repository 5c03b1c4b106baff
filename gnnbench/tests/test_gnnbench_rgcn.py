"""The R-GCN cell: its reference agrees with the port's oracle, its relation
law and work counts hold by hand, its readers give nothing for a program
without the relational path; on a card, the relation-grouped edge GEMM and
its backward against their plain versions at the cell's shapes, and a run
of the cell whose edge transforms sync nothing."""
import sys

import numpy as np
import pytest
import torch

from gnnbench import cell as C
from gnnbench import check, graphgen, work_rel
from gnnbench import run as R

CELL = "rgcn2-dblp-rel-whole"
CPU = torch.device("cpu")


def _reader(name):
    return C.import_file(C.HERE / "metrics" / f"{name}.py")


def test_reference_agrees_with_the_ports_oracle():
    from repro_torch.core.executor import run_reference
    from repro_torch.gnn import relational as RL

    cell = C.load_cell(CELL)
    cfg = dict(cell.config, in_dim=16, hidden_dim=16, out_dim=16, relations=14, bases=3)
    a = graphgen.random_graph(500, 3000, seed=3)
    rel = np.random.default_rng(3).integers(0, 7, a.n_edges).astype(np.int32)
    gen = torch.Generator().manual_seed(3)
    params = C.make_params(cell.reference.param_shapes(cfg), gen, CPU)
    x = torch.randn(500, 16, generator=gen)
    g, einp = RL.relational_graph(a.src, a.dst, rel, 500, 14)
    tr = RL.trace_rgcn(2, 16, 16, 16, 14)
    want = run_reference(tr, g, dict(einp, x=x), RL.combine_bases(params), device="cpu")[0]
    got = cell.reference.forward(torch.as_tensor(a.src), torch.as_tensor(a.dst),
                                 torch.as_tensor(rel), 500, x, params, cfg)
    assert check.rel_err(got, want) < 1e-5


def test_relations_follow_the_mix_law():
    cell = C.load_cell(CELL)
    drv, tr = cell.driver, cell.traffic
    rel = drv.relations(977_676, tr)
    assert np.array_equal(rel, drv.relations(977_676, tr))          # frozen
    share = np.bincount(rel, minlength=tr["relations"]) / len(rel)
    h = np.sum(1.0 / np.arange(1, 104))
    assert share[0] == pytest.approx(1 / h, abs=2e-3)              # ~19 %
    assert share[-1] == pytest.approx(1 / (103 * h), abs=3e-4)      # ~1,800 edges
    assert 2 * tr["relations"] == cell.config["relations"]


def test_work_counts_by_hand():
    # 10 messages, 3 vertices, width 4, 2 relations, 1 basis
    assert work_rel.relgemm_flops(10, 4, 4) == 2 * 10 * 16
    assert work_rel.relgemm_bytes(10, 4, 4, 2) == 10 * 8 * 4 + 80 + 2 * 16 * 4
    assert work_rel.relgemm_bound_s(10, 4, 4, 2) == pytest.approx(528 / 3.35e12)
    assert work_rel.layer_flops(3, 10, 4, 2, 1) == 320 + 96 + 64 + 80


def test_the_readers_give_nothing_without_the_relational_path(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)   # import fails
    reading = dict(profile=None, graphs=[(3, 10, 16)], layers=2, F=4, passes=1,
                   passes_s=1.0)
    for name in ("relgemm_roofline", "edge_gemm_rows.pass", "mfu.rel_pass"):
        assert _reader(name).read(reading) is None, name


def test_a_traced_cpu_run_reads_the_new_metrics(small):
    cell = small(C.load_cell(CELL))
    res = R.execute(cell, 2**31 + 9, 1.0, True, CPU, t0=0.0)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # two layers, each transforming every real message once
    assert got["edge_gemm_rows.pass"]["value"] == 2.0
    assert got["mfu.rel_pass"]["value"] > 0
    assert "relgemm_roofline" not in got          # no device trace here


# ---------------------------------------------------------------- on a card

def _zipf_types(E, R, gen):
    p = 1.0 / torch.arange(1, R + 1, dtype=torch.float64)
    return torch.multinomial(p / p.sum(), E, replacement=True, generator=gen)


@pytest.mark.chip
@pytest.mark.parametrize("E,R,empty,table", [(1_955_352, 206, (), 299_068),
                                             (1_955_352, 206, (), None),
                                             (5_000, 14, (3, 13), None)])
def test_the_relation_gemm_matches_its_plain_version(E, R, empty, table):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.relation_gemm import kernel as K
    from repro_torch.kernels.relation_gemm import ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(E)
    types = _zipf_types(E, R, gen)
    for r in empty:                       # relations without an edge
        types[types == r] = (r + 1) % R
    x = torch.randn(table or E, 128, generator=gen).to(dev)
    w = (torch.randn(R, 128, 128, generator=gen) / 128 ** 0.5).to(dev)
    plan = ops.relation_plan(types.to(dev), R)
    if table:                             # the cell's rows read in place
        plan = ops.read_rows(plan, torch.randint(0, table, (E,), generator=gen).to(dev))
    n0 = K.LAUNCHES["relation_gemm"]
    got = ops.relation_gemm(x, w, plan)
    torch.cuda.synchronize()
    assert K.LAUNCHES["relation_gemm"] == n0 + 1
    want = ops.relation_gemm_ref(x, w, plan)
    # each output is a 128-term float32 dot product; any two summation
    # orders differ by at most 2 gamma_K sum_k |x_k w_k| (gamma_K ~ K u,
    # u = 2^-24), which is checked element by element
    bound = 2 * 128 * 2.0 ** -24 * ops.relation_gemm_ref(x.abs(), w.abs(), plan)
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= bound).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.chip
@pytest.mark.parametrize("E,R,table", [(1_955_352, 206, 299_068), (5_000, 14, None)])
def test_the_relation_gemm_backward_matches_its_plain_version(E, R, table):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.relation_gemm import kernel as K
    from repro_torch.kernels.relation_gemm import ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(E + 1)
    types = _zipf_types(E, R, gen).to(dev)
    M = table or E
    rows = (torch.randint(0, M, (E,), generator=gen) if table
            else torch.arange(E)).to(dev)
    x = torch.randn(M, 128, generator=gen).to(dev).requires_grad_()
    w = (torch.randn(R, 128, 128, generator=gen) / 128 ** 0.5).to(dev).requires_grad_()
    dy = torch.randn(E, 128, generator=gen).to(dev)
    plan = ops.read_rows(ops.relation_plan(types, R), rows)
    n0 = dict(K.LAUNCHES)
    dx, dw = torch.autograd.grad(ops.relation_gemm(x, w, plan), (x, w), dy)
    torch.cuda.synchronize()
    # forward, dx (the same kernel, adding into x's rows) and dw: one each
    assert K.LAUNCHES["relation_gemm"] == n0["relation_gemm"] + 2
    assert K.LAUNCHES["relation_wgrad"] == n0["relation_wgrad"] + 1
    back = ops.RelationPlan(plan.dst_rows, plan.src_rows, plan.seg, plan.tile_off)
    wt = w.detach().transpose(1, 2)
    want_dx = ops.relation_gemm_ref(dy, wt, back, out=torch.zeros_like(x))
    want_dw = ops.relation_wgrad_ref(x.detach(), dy, plan)
    mag_dx = ops.relation_gemm_ref(dy.abs(), wt.abs(), back, out=torch.zeros_like(x))
    mag_dw = ops.relation_wgrad_ref(x.detach().abs(), dy.abs(), plan)
    # each entry is a float32 sum of n terms, added in another order (and
    # in blocks, atomically) than the plain version's, n = 128 terms per
    # edge times the edges that read the row (dx) or the relation's edges
    # (dw): they differ by at most 2 gamma_n sum |terms| (gamma_n = n u /
    # (1 - n u), u = 2^-24), where the rounding errors all align.  That
    # bound is loose for long sums; errors at random add to ~sqrt(n) u of
    # the largest entry, to which the largest difference is held (or to the
    # forward's 1e-5 of it, where that is more)
    u = 2.0 ** -24
    uses = torch.bincount(plan.src_rows.long(), minlength=M).max().item()
    seg = plan.seg.long()
    longest = (seg[1:] - seg[:-1]).max().item()
    for got, want, mag, n in ((dx, want_dx, mag_dx, 128 * uses),
                              (dw, want_dw, mag_dw, longest)):
        assert torch.isfinite(got).all()
        err = (got - want).abs()
        assert bool((err <= 2 * n * u / (1 - n * u) * mag).all())
        assert float(err.max()) <= max(1e-5, n ** 0.5 * u) * float(want.abs().max())


@pytest.mark.chip
def test_a_pass_of_the_cell_syncs_nothing_in_the_edge_transform(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import pipeline
    from repro_torch.kernels.relation_gemm import kernel as K

    calls = []
    plain = pipeline._Interpreter.bmm_edge

    def guarded(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = plain(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(out.shape[0])
        return out

    monkeypatch.setattr(pipeline._Interpreter, "bmm_edge", guarded)
    cell = C.load_cell(CELL)
    n0 = K.LAUNCHES["relation_gemm"]
    res = R.execute(cell, 2**31 + 29, 1.0, False, R.card_device(1), t0=0.0)
    passes = res["notes"]["passes"] + cell.traffic["feature_sets"]   # and the warm-up
    # one launch of the kernel a layer and pass, over every message
    assert len(calls) == 2 * passes == K.LAUNCHES["relation_gemm"] - n0
    assert set(calls) == {res["notes"]["messages"]}
    assert res["correct"], res["checks"]
