"""The cells of BENCHMARK.json resolve to their files and run on the CPU."""
import json
import math
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnnbench import cell as C
from gnnbench import check, graphgen, work
from gnnbench import run as R

BENCH = C.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    cell = C.load_cell(name)
    assert cell.chips == 1
    assert callable(cell.driver.run) and callable(cell.reference.forward)
    assert set(cell.limits) and all("limit" in v for v in cell.limits.values())
    reported = {m.name for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(m.reader.read)
        assert m.entry["moves"] in reported


def test_benchmark_keeps_to_its_shapes():
    b = BENCH
    assert b["command"] == ["python3", "gnnbench/run.py"] and b["paths"] == ["gnnbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in b["end_to_end"]} == {"setup_s", "pass_ms", "p95_ms",
                                                    "served_per_s"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
    for c in b["configs"]:
        assert c["file"].startswith("gnnbench/") and c["reduced"] == []
        assert json.loads((C.REPO / c["file"]).read_text())["name"] == c["name"]
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and NAME.match(w["name"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu(name, small):
    cell = small(C.load_cell(name))
    res = R.execute(cell, 2**31 + 11, 1.0, False, CPU, t0=0.0)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m.name for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert not R.forbidden_modules()


@pytest.mark.parametrize("name", ["gcn2-dblp-whole", "gcn2-subgraph-open",
                                  "gat2-subgraph-open"])
def test_traced_run_reads_per_layer_metrics(name, small):
    cell = small(C.load_cell(name))
    res = R.execute(cell, 5, 1.0, True, CPU, t0=0.0)
    assert res["correct"]
    # no device here: the device readers find nothing and say nothing
    assert set(res["metrics"]) <= {m.name for m in cell.per_layer}
    assert not any("roofline" in k or k.startswith(("idle", "launches")) for k in res["metrics"])
    assert "busy_s" in res["device"] and "breakdown" in res


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_reference_agrees_with_the_port(model):
    from repro_torch.core.executor import run_reference
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M

    cfg = json.loads((C.HERE / "configs" / f"{model}2-w128.json").read_text())
    ref = C.import_file(C.HERE / "reference" / f"{model}.py")
    a = graphgen.random_graph(500, 3000, seed=3)
    gen = torch.Generator().manual_seed(3)
    params = C.make_params(ref.param_shapes(cfg), gen, CPU)
    x = torch.randn(500, 128, generator=gen)
    src, dst = torch.as_tensor(a.src), torch.as_tensor(a.dst)
    tr = M.trace_stacked(model, 2, 128, 128, 128)
    g = G.Graph(src=a.src, dst=a.dst, n_vertices=500)
    want = run_reference(tr, g, ref.program_inputs(src, dst, 500, x), params, device="cpu")[0]
    got = ref.forward(src, dst, 500, x, params, cfg)
    assert check.rel_err(got, want) < 1e-5


def test_frozen_generator_is_the_ports():
    from repro_torch.gnn.graphs import random_graph
    for model in ("powerlaw", "uniform"):
        a = graphgen.random_graph(700, 2100, seed=2**31 + 5, model=model)
        b = random_graph(700, 2100, seed=2**31 + 5, model=model)
        assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)


def test_sampled_neighbourhoods_keep_to_the_fanouts():
    g = graphgen.random_graph(3000, 12000, seed=4)
    indptr, nbrs = graphgen.undirected_csr(g, CPU)
    assert int(indptr[-1]) == len(nbrs) and len(nbrs) % 2 == 0
    deg = (indptr[1:] - indptr[:-1]).numpy()

    def draw(seed):
        return graphgen.sample_neighbourhoods(indptr, nbrs, [3, 16, 8], [25, 10],
                                              torch.Generator().manual_seed(seed))
    a, b, c = draw(1), draw(1), draw(2)
    assert all(np.array_equal(x.src, y.src) and x.n_vertices == y.n_vertices
               for x, y in zip(a, b))
    assert not all(np.array_equal(x.src, y.src) for x, y in zip(a, c))
    for r, k in zip(a, (3, 16, 8)):
        assert r.src.min() >= 0 and max(r.src.max(), r.dst.max()) < r.n_vertices
        # every vertex is a seed or an endpoint; no vertex takes more than
        # the first fan-out; at most 1 + 25 + 250 vertices a seed
        assert len(np.unique(np.concatenate([r.src, r.dst]))) <= r.n_vertices
        assert np.bincount(r.dst).max() <= 25
        assert r.n_vertices <= k * 276 and r.n_edges <= k * 275
        # the seeds come first, and each has a neighbour
        seeds = np.unique(r.dst[r.dst < k])
        assert r.dst[0] == 0 and np.array_equal(seeds, np.arange(len(seeds)))
    # a vertex with 25 or fewer neighbours is a seed with all of them
    lone = graphgen.sample_neighbourhoods(indptr, nbrs, [1], [25],
                                          torch.Generator().manual_seed(3))[0]
    assert lone.n_edges == lone.n_vertices - 1 and lone.n_edges in set(deg.tolist())


def test_every_seed_sends_the_same_requests_and_gaps(small):
    cell = small(C.load_cell("gcn2-subgraph-open"))
    d1 = cell.driver.make_data(cell, 1, CPU, 3.0)
    d2 = cell.driver.make_data(cell, 2, CPU, 3.0)

    def sizes(d):
        return sorted((g.n_vertices, g.n_edges) for g in d["graphs"])
    assert len(d1["graphs"]) == 60 and sizes(d1) == sizes(d2)
    assert [g.n_vertices for g in d1["graphs"]] != [g.n_vertices for g in d2["graphs"]]
    assert np.allclose(np.sort(np.diff(d1["due"])), np.sort(np.diff(d2["due"])))
    assert 2 < d1["due"][-1] < 3 and not np.array_equal(d1["due"], d2["due"])


def test_knee_rule():
    from gnnbench.control import sustained

    def res(p95_ms, trend, open_, failed=0):
        return dict(failed=failed, notes=dict(p95_ms=p95_ms, latency_trend=trend,
                                              open_at_last_arrival=open_))
    assert sustained(res(500, 1.0, 300), 1000, 2.0)
    assert not sustained(res(2100, 1.0, 300), 1000, 2.0)      # over the deadline
    assert not sustained(res(500, 1.5, 300), 1000, 2.0)       # latency grows
    assert not sustained(res(500, 1.0, 800), 1000, 2.0)       # a backlog
    assert not sustained(res(500, 1.0, 300, failed=1), 1000, 2.0)


def test_work_counts_by_hand():
    # 5 edges, 4 vertices, width 2
    V, E, F = 4, 5, 2
    assert work.aggregation_bytes(V, E, F, gat=False) == 5 * 8 + 4 * 2 * 4 * 2
    assert work.aggregation_bytes(V, E, F, gat=True) == 40 + 64 + 2 * 4 * 4
    assert work.aggregation_flops(V, E, F, gat=False) == 2 * 5 * 2
    assert work.layer_flops(V, E, F, gat=False) == 2 * 4 * 2 * 2 + 2 * 5 * 2
    assert work.layer_flops(V, E, F, gat=True) == 52 + 4 * 4 * 2 + 5 * 5
    assert work.aggregation_bound_s(V, E, F, False) == pytest.approx(104 / 3.35e12)


def test_percentile_and_error():
    assert check.nearest_rank(list(range(1, 101)), 95) == 95
    assert check.nearest_rank([3.0], 50) == 3.0
    want = torch.tensor([[1.0, -2.0]])
    assert check.rel_err(want.clone(), want) == 0.0
    assert check.rel_err(torch.tensor([[1.0, -1.0]]), want) == 0.5
    assert check.rel_err(torch.tensor([[math.nan, 0.0]]), want) == math.inf


def test_nothing_loads_jax_and_nothing_names_the_old_folder(small):
    cell = small(C.load_cell("gat2-dblp-whole"))
    R.execute(cell, 9, 0.5, False, CPU, t0=0.0)
    loaded = {m.split(".")[0] for m in sys.modules}
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in loaded
    old = "bench" + "marks"
    for path in C.HERE.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json"):
            assert not re.search(rf"\b{old}\b", path.read_text()), path


def test_without_a_card_the_run_prints_no_result(tmp_path):
    proc = subprocess.run([sys.executable, str(C.HERE / "run.py"), "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
