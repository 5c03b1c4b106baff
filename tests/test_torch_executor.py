"""The port's `run_tiled` against `repro`'s `run_tiled` and against the
port's `run_reference`, on the same numpy graphs, weights and inputs (CPU:
the kernels' plain versions; the reference's gathers run its Pallas kernels
in interpret mode, as `tests/test_schedule.py` runs them).

Tolerances are the reference's own (ARCHITECTURE.md "Invariants"): 5e-4
scaled by max(1, max|ref|), 1e-4 for the fused GAT softmax.  sage's
outputs reach ~1e30 on vertices without in-edges (the empty-max sentinel
through `W_neigh`, ROADMAP C.1), so the scaling is what holds it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compiler as jcompiler
from repro.core import executor as jexecutor
from repro.core import tiling as jtiling
from repro.gnn import graphs as jgraphs
from repro.gnn import models as jmodels
from repro_torch.core import compiler as tcompiler
from repro_torch.core import executor as texecutor
from repro_torch.core import tiling as ttiling
from repro_torch.gnn import models as tmodels
from repro_torch.kernels.tile_spmm import kernel as tkernel

MODELS = ("gcn", "gat", "sage", "ggnn", "rgcn", "gin")
DIM = 16


def _tol(name):
    return 1e-4 if name == "gat" else 5e-4


def _err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def _setup(name, n_layers, V=64, E=260, seed=3):
    etypes = 3 if jmodels.MODELS[name].needs_etype else None
    g = jgraphs.random_graph(V, E, seed=seed, model="powerlaw",
                             n_edge_types=etypes)
    if n_layers == 1:
        jtr, ttr = jmodels.trace_named(name, DIM, DIM), tmodels.trace_named(name, DIM, DIM)
    else:
        jtr = jmodels.trace_stacked(name, n_layers, DIM, DIM, DIM)
        ttr = tmodels.trace_stacked(name, n_layers, DIM, DIM, DIM)
    return g, jtr, ttr, jmodels.init_params(jtr, seed=1), jmodels.init_inputs(jtr, g, seed=2)


@pytest.mark.parametrize("kernel_dispatch", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("name", MODELS)
def test_run_tiled_matches_reference_engines(name, n_layers, layout,
                                             kernel_dispatch):
    g, jtr, ttr, params, inputs = _setup(name, n_layers)
    jts = jtiling.grid_tile(g, 3, 3, sparse=True, layout=layout)
    jout = jexecutor.run_tiled(jcompiler.compile_gnn(jtr), g, jts, inputs,
                               params, kernel_dispatch=kernel_dispatch)[0]

    tts = ttiling.grid_tile(g, 3, 3, sparse=True, layout=layout)
    tkernel.reset_launches()
    tout = texecutor.run_tiled(tcompiler.compile_gnn(ttr), g, tts, inputs,
                               params, kernel_dispatch=kernel_dispatch,
                               device="cpu")
    assert sum(tkernel.LAUNCHES.values()) == 0      # CPU: plain versions only
    tref = texecutor.run_reference(ttr, g, inputs, params, device="cpu")[0]
    assert len(tout) == 1 and tout[0].shape == tref.shape
    got = tout[0].numpy()
    assert _err(got, jout) < _tol(name)
    assert _err(got, tref.numpy()) < _tol(name)


@pytest.mark.parametrize("kernel", ["gcn", "gat"])
@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_kernel_gathers_call_the_wrappers_on_the_bound_operands(
        kernel, layout, monkeypatch):
    """Each kernel-tagged gather is ONE wrapper call over the whole tile
    set, on the operands the pipeline binds (the edge plan, partition
    runs), never the dense score block; partitions without a tile come out
    zero.  The graph's upper half of vertices has no in-edge, so whole
    partitions have no tile."""
    from repro_torch.kernels.tile_spmm import ops as tops

    g, jtr, ttr, params, inputs = _setup(kernel, 2, V=90, E=420)
    keep = g.dst < 45
    g = jgraphs.Graph(src=g.src[keep], dst=g.dst[keep], n_vertices=90)
    inputs = jmodels.init_inputs(jtr, g, seed=2)
    tiles = ttiling.grid_tile(g, 4, 3, sparse=True, layout=layout)
    assert set(tiles.part_id) < set(range(tiles.n_dst_parts))

    calls = []
    wrapper = {("gcn", "coo"): "spmm", ("gcn", "csr"): "spmm_csr",
               ("gat", "coo"): "gat_aggregate",
               ("gat", "csr"): "gat_aggregate_csr"}[kernel, layout]
    inner = getattr(tops, wrapper)

    def spy(*a, **k):
        calls.append(k)
        return inner(*a, **k)

    monkeypatch.setattr(tops, wrapper, spy)
    monkeypatch.setattr(tops, "densify_edge_scores", None)
    out = texecutor.run_tiled(tcompiler.compile_gnn(ttr), g, tiles, inputs,
                              params, device="cpu")[0].numpy()
    assert len(calls) == 2                        # one call a layer
    assert all(("plan" in k) != (wrapper == "spmm") for k in calls)
    oracle = jexecutor.run_reference(jtr, g, inputs, params)[0]
    assert _err(out, oracle) < _tol(kernel)


def test_run_tiled_runs_on_cuda_unless_told_otherwise():
    """With no card visible, omitting ``device`` raises instead of quietly
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    g, _, ttr, params, inputs = _setup("gcn", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texecutor.run_tiled(tcompiler.compile_gnn(ttr), g,
                            ttiling.grid_tile(g, 2, 2), inputs, params)
