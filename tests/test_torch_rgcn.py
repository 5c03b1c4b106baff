"""R-GCN as published (``repro_torch.gnn.relational``) on the port's
whole-graph path, on the CPU at small sizes: ``PipelinedRunner`` against
the benchmark's plain reference (``gnnbench/reference/rgcn.py``) on seeded
weights, relations without edges and vertices without an in-edge of a
relation, inverse typing and ``enorm`` against counts made by hand, the
relation-grouped edge GEMM's plain version against a per-edge loop, its
backward and the runner's gradients against autograd of plain versions, and
the spans and counters a traced run records."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import compiler
from repro_torch.core.executor import run_reference
from repro_torch.core.pipeline import PipelinedRunner
from repro_torch.core.tiling import build_tiles
from repro_torch.gnn import graphs as G
from repro_torch.gnn import relational as RL
from repro_torch.kernels.relation_gemm import ops as rops

REPO = Path(__file__).resolve().parents[1]
V, E, R, B = 500, 3000, 14, 3


def _reference():
    """The benchmark's plain R-GCN, imported from its file."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(
        "gnnbench_reference_rgcn_test", REPO / "gnnbench" / "reference" / "rgcn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _case(F, seed=0, drop=()):
    """A powerlaw graph of V vertices and E canonical edges with relations
    in [0, R/2) (those in ``drop`` never drawn), features and the
    published parameters at width F."""
    a = G.random_graph(V, E, seed=seed)
    rng = np.random.default_rng(seed)
    keep = [r for r in range(R // 2) if r not in drop]
    rel = rng.choice(keep, size=a.n_edges).astype(np.int32)
    gen = torch.Generator().manual_seed(seed)
    cfg = dict(layers=2, in_dim=F, hidden_dim=F, out_dim=F, relations=R, bases=B)
    params = {k: torch.randn(s, generator=gen) / s[-2] ** 0.5
              for k, s in REF.param_shapes(cfg).items()}
    x = torch.randn(V, F, generator=gen)
    return a, rel, cfg, params, x


def _run(a, rel, F, params, x, layout="csr", kernel_dispatch=True):
    g, einp = RL.relational_graph(a.src, a.dst, rel, V, R)
    tiles, ro = build_tiles(g, 4, 4, layout=layout)
    runner = PipelinedRunner(compiler.compile_gnn(RL.trace_rgcn(2, F, F, F, R)),
                             ro.graph, tiles, kernel_dispatch=kernel_dispatch,
                             reordering=ro, device="cpu")
    with torch.inference_mode():
        return RL.run(runner, dict(einp, x=x), params)[0]


def _want(a, rel, cfg, params, x):
    return REF.forward(torch.as_tensor(a.src), torch.as_tensor(a.dst),
                       torch.as_tensor(rel), V, x, params, cfg)


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("F", [16, 128])
@pytest.mark.parametrize("kernel_dispatch", [True, False])
@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_runner_matches_the_plain_reference(layout, kernel_dispatch, F):
    a, rel, cfg, params, x = _case(F, seed=F)
    got = _run(a, rel, F, params, x, layout, kernel_dispatch)
    # float32 sums of up to hundreds of terms in other orders
    assert _rel_err(got, _want(a, rel, cfg, params, x)) < 1e-5


def test_runner_matches_the_ports_oracle():
    a, rel, cfg, params, x = _case(16, seed=5)
    g, einp = RL.relational_graph(a.src, a.dst, rel, V, R)
    want = run_reference(RL.trace_rgcn(2, 16, 16, 16, R), g, dict(einp, x=x),
                         RL.combine_bases(params), device="cpu")[0]
    assert _rel_err(_run(a, rel, 16, params, x), want) < 1e-5


def test_relations_without_edges_and_vertices_without_an_in_relation():
    # relation 2 (and its inverse 9) has no edge; vertex 0 has in-edges of
    # some relations only; the last vertex has no edge at all
    a, rel, cfg, params, x = _case(16, seed=7, drop=(2,))
    keep = (a.src != V - 1) & (a.dst != V - 1)
    a = G.Graph(src=a.src[keep], dst=a.dst[keep], n_vertices=V)
    rel = rel[keep]
    g, einp = RL.relational_graph(a.src, a.dst, rel, V, R)
    present = {int(t) for t in g.edge_type[g.dst == 0]}
    assert present and len(present) < R
    plan = rops.relation_plan(torch.as_tensor(einp["etype"][:, 0]), R)
    seg = plan.seg.tolist()
    assert seg[3] == seg[2] and seg[10] == seg[9] and seg[-1] == g.n_edges
    assert np.isfinite(einp["enorm"]).all()
    got = _run(a, rel, 16, params, x)
    want = _want(a, rel, cfg, params, x)
    assert _rel_err(got, want) < 1e-5
    # a vertex with no in-edge keeps only its self-connection
    lone = torch.relu(torch.relu(x[V - 1] @ params["l0.W_self"]) @ params["l1.W_self"])
    assert torch.allclose(got[V - 1], lone, atol=1e-6)


def test_inverse_typing_and_enorm_by_hand():
    # edges 0 -> 1 and 2 -> 1 of relation 0, 1 -> 2 of relation 1; R = 4
    src, dst, rel = np.array([0, 2, 1]), np.array([1, 1, 2]), np.array([0, 0, 1])
    s, d, et = RL.add_inverse_edges(src, dst, rel, 4)
    assert s.tolist() == [0, 2, 1, 1, 1, 2]
    assert d.tolist() == [1, 1, 2, 0, 2, 1]
    assert et.tolist() == [0, 0, 1, 2, 2, 3]
    # (1, r0) has two in-edges; (2, r1), (0, r2), (2, r2), (1, r3) one each
    assert RL.relation_norm(d, et, 4).tolist() == [0.5, 0.5, 1.0, 1.0, 1.0, 1.0]
    g, einp = RL.relational_graph(src, dst, rel, 3, 4)
    assert g.n_edges == 6 and g.edge_type.tolist() == et.tolist()
    assert einp["etype"].shape == einp["enorm"].shape == (6, 1)
    with pytest.raises(ValueError, match="even"):
        RL.add_inverse_edges(src, dst, rel, 3)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        RL.add_inverse_edges(src, dst, np.array([0, 2, 1]), 4)


@pytest.mark.parametrize("n_edges,n_rel", [(1, 1), (300, 7), (1000, 20)])
def test_plain_relation_gemm_matches_a_per_edge_loop(n_edges, n_rel):
    gen = torch.Generator().manual_seed(n_edges)
    types = torch.randint(0, n_rel, (n_edges,), generator=gen)
    types[types == n_rel // 2] = 0                    # an empty relation
    x = torch.randn(n_edges, 16, generator=gen)
    w = torch.randn(n_rel, 16, 8, generator=gen)
    plan = rops.relation_plan(types[:, None].float(), n_rel)
    want = torch.stack([x[e] @ w[types[e]] for e in range(n_edges)])
    assert torch.allclose(rops.relation_gemm(x, w, plan), want, atol=1e-5)
    # the grouping: relations in order, edges in order within one
    order = plan.src_rows.long()
    assert torch.equal(types[order], torch.sort(types, stable=True).values)
    assert plan.tile_off[-1] == sum(-(-int((types == r).sum()) // 128)
                                    for r in range(n_rel))


def test_plain_relation_gemm_reads_a_table_through_the_plan():
    # 400 edges over a table of 50 rows: the same as the gathered rows
    gen = torch.Generator().manual_seed(4)
    table = torch.randn(50, 16, generator=gen)
    rows = torch.randint(0, 50, (400,), generator=gen)
    types = torch.randint(0, 5, (400,), generator=gen)
    w = torch.randn(5, 16, 8, generator=gen)
    plan = rops.relation_plan(types, 5)
    got = rops.relation_gemm(table, w, rops.read_rows(plan, rows))
    assert torch.equal(got, rops.relation_gemm(table[rows], w, plan))


@pytest.mark.parametrize("table", [False, True])
def test_relation_gemm_backward_matches_autograd_of_a_per_edge_product(table):
    # 600 edges of 9 relations (relation 4 without an edge), reading edge
    # rows or a table of 40 rows that several edges share
    gen = torch.Generator().manual_seed(11)
    n_edges, n_rel, M = 600, 9, 40
    types = torch.randint(0, n_rel, (n_edges,), generator=gen)
    types[types == 4] = 0
    rows = (torch.randint(0, M, (n_edges,), generator=gen) if table
            else torch.arange(n_edges))
    x = torch.randn(M if table else n_edges, 16, generator=gen, requires_grad=True)
    w = torch.randn(n_rel, 16, 8, generator=gen, requires_grad=True)
    dy = torch.randn(n_edges, 8, generator=gen)
    plan = rops.relation_plan(types, n_rel)
    if table:
        plan = rops.read_rows(plan, rows)
    got = torch.autograd.grad(rops.relation_gemm(x, w, plan), (x, w), dy)
    want = torch.autograd.grad(torch.einsum("ek,eko->eo", x[rows], w[types]),
                               (x, w), dy)
    for g, ref in zip(got, want):
        assert torch.allclose(g, ref, atol=1e-5)
    assert not got[1][4].any()


@pytest.mark.parametrize("kernel_dispatch", [True, False])
def test_runner_gradients_match_the_plain_reference(kernel_dispatch):
    a, rel, cfg, params, x = _case(16, seed=3)
    leaves = [x.requires_grad_()] + [p.requires_grad_() for p in params.values()]
    probe = torch.randn(V, 16, generator=torch.Generator().manual_seed(1))
    g, einp = RL.relational_graph(a.src, a.dst, rel, V, R)
    tiles, ro = build_tiles(g, 4, 4, layout="csr")
    runner = PipelinedRunner(compiler.compile_gnn(RL.trace_rgcn(2, 16, 16, 16, R)),
                             ro.graph, tiles, kernel_dispatch=kernel_dispatch,
                             reordering=ro, device="cpu")
    out = RL.run(runner, dict(einp, x=x), params)[0]
    got = torch.autograd.grad((out * probe).sum(), leaves)
    want = torch.autograd.grad((_want(a, rel, cfg, params, x) * probe).sum(), leaves)
    for name, g_, w_ in zip(["x", *params], got, want):
        assert _rel_err(g_, w_) < 1e-5, name


def test_basis_combination_is_one_product_a_layer():
    a, rel, cfg, params, x = _case(16)
    got = RL.combine_bases(params)
    assert set(got) == {"l0.W_rel", "l0.W_self", "l1.W_rel", "l1.W_self"}
    want = torch.einsum("rb,bio->rio", params["l0.a"], params["l0.V"])
    assert torch.allclose(got["l0.W_rel"], want, atol=1e-6)
    assert dict(RL.trace_rgcn(2, 16, 16, 16, R).params) == {
        k: tuple(v.shape) for k, v in got.items()}


def test_a_traced_run_counts_the_edge_transform():
    a, rel, cfg, params, x = _case(16, seed=2)
    spans.enable()
    try:
        _run(a, rel, 16, params, x)
        rec = spans.export()
    finally:
        spans.disable()
    c = rec["counters"]
    assert c["runner.edges"] == 2 * a.n_edges
    assert c["runner.edge_gemm_rows"] == 2 * c["runner.edges"]     # two layers
    assert c["runner.rel_groups"] == R                              # once a run
    names = [s["name"] for s in rec["spans"]]
    assert names.count("runner.rel_plan") == 1 and names.count("rgcn.basis") == 1
    byid = {s["id"]: s for s in rec["spans"]}
    plan = next(s for s in rec["spans"] if s["name"] == "runner.rel_plan")
    assert byid[plan["parent"]]["name"] == "runner.run"
