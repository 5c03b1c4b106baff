"""The port's `InferenceServer` against `repro.serve.InferenceServer` on the
same request stream: equal outputs, equal cache hit/miss/build counts, and
the routes the port does not have yet refuse loudly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compiler as jcompiler
from repro.gnn import graphs as jgraphs
from repro.gnn import models as jmodels
from repro.serve import InferenceServer as JServer
from repro_torch.core import compiler as tcompiler
from repro_torch.gnn import models as tmodels
from repro_torch.kernels.tile_spmm import kernel as tkernel
from repro_torch.serve import InferenceServer as TServer
from repro_torch.serve import ProgramCache

DIM = 16


def _servers(name, n_layers=1, **kw):
    if n_layers == 1:
        jtr, ttr = jmodels.trace_named(name, DIM, DIM), tmodels.trace_named(name, DIM, DIM)
    else:
        jtr = jmodels.trace_stacked(name, n_layers, DIM, DIM, DIM)
        ttr = tmodels.trace_stacked(name, n_layers, DIM, DIM, DIM)
    params = jmodels.init_params(jtr, seed=0)
    js = JServer(jcompiler.compile_gnn(jtr), params, **kw)
    ts = TServer(tcompiler.compile_gnn(ttr), params, device="cpu", **kw)
    return jtr, params, js, ts


def _stream(tr, name, n, v=48, e=200, seed0=0):
    etypes = 3 if jmodels.MODELS[name].needs_etype else None
    gs = [jgraphs.random_graph(v, e, seed=seed0 + k, model="powerlaw",
                               n_edge_types=etypes) for k in range(n)]
    return gs, [jmodels.init_inputs(tr, g, seed=seed0 + k)
                for k, g in enumerate(gs)]


def _assert_same(name, jouts, touts):
    tol = 1e-4 if name == "gat" else 5e-4
    assert len(jouts) == len(touts)
    for jo, to in zip(jouts, touts):
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            a = np.asarray(a)
            assert tuple(b.shape) == a.shape
            err = float(np.max(np.abs(a - b.numpy()), initial=0.0))
            if name == "sage":      # -1e30 empty-max sentinel (ROADMAP C.1)
                err /= max(1.0, float(np.max(np.abs(a), initial=0.0)))
            assert err < tol, (name, err)


@pytest.mark.parametrize("name,n_layers", [
    ("gcn", 1), ("gcn", 2), ("gat", 1), ("gat", 2), ("sage", 1),
    ("ggnn", 2), ("rgcn", 1), ("gin", 2)])
def test_stream_matches_reference_server(name, n_layers):
    """Three requests of one size class, then one of a bigger class: the
    same outputs and the same hit/miss/build counts as `repro`."""
    jtr, _, js, ts = _servers(name, n_layers)
    tkernel.reset_launches()
    stream = [_stream(jtr, name, 4, seed0=s) for s in (0, 40, 80)]
    stream.append(_stream(jtr, name, 3, v=300, e=1400, seed0=7))
    for gs, ins in stream:
        _assert_same(name, js.submit(gs, ins), ts.submit(gs, ins))
    for attr in ("compile_count", "cache_hits", "cache_misses"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    assert (ts.compile_count, ts.cache_hits) == (2, 2)
    st_j, st_t = js.stats(), ts.stats()
    for k in ("requests", "graphs", "batches", "cache_size", "n_layers"):
        assert st_t[k] == st_j[k], k
    assert sum(tkernel.LAUNCHES.values()) == 0      # CPU: plain versions only


def test_repeated_stream_zero_rebuilds():
    jtr, _, _, ts = _servers("gcn")
    for req in range(6):
        ts.submit(*_stream(jtr, "gcn", 5, seed0=req * 50))
    assert ts.compile_count == 1 and ts.cache_hits == 5
    runner = next(iter(ts.cache._entries.values()))
    assert runner.jit_cache_size() == 1


def test_mixed_sizes_request_params_and_edgeless_graphs():
    """Mixed size classes in one submit keep request order; per-request
    params override the server's; edgeless graphs serve too."""
    jtr, params, js, ts = _servers("gat")
    small, s_in = _stream(jtr, "gat", 2, seed0=1)
    big, b_in = _stream(jtr, "gat", 2, v=260, e=900, seed0=2)
    empty = jgraphs.Graph(src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                          n_vertices=5)
    gs = [small[0], big[0], empty, small[1], big[1]]
    ins = [s_in[0], b_in[0], jmodels.init_inputs(jtr, empty, seed=3),
           s_in[1], b_in[1]]
    other = jmodels.init_params(jtr, seed=5)
    _assert_same("gat", js.submit(gs, ins, params=other),
                 ts.submit(gs, ins, params=other))


def test_shared_cache_keeps_layer_counts_apart():
    cache = ProgramCache(capacity=8)
    jtr1, p1, _, s1 = _servers("gcn", 1, cache=cache)
    jtr2, p2, _, s2 = _servers("gcn", 2, cache=cache)
    s1.submit(*_stream(jtr1, "gcn", 3))
    s2.submit(*_stream(jtr2, "gcn", 3))
    assert len(cache) == 2 and cache.stats.compiles == 2


def test_unported_routes_raise():
    tr = tmodels.trace_named("gcn", DIM, DIM)
    params = tmodels.init_params(tr)
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        TServer("gcn", params, shard_devices=2, device="cpu")
    with pytest.raises(ValueError, match="n_layers"):
        TServer(tcompiler.compile_gnn(tr), params, n_layers=2, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        TServer(tcompiler.compile_gnn(tr),
                {k: np.zeros((3, 3), np.float32) for k in params}, device="cpu")


def test_server_runs_on_cuda_unless_told_otherwise():
    """With no card visible, a server built without ``device`` raises
    instead of quietly serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    tr = tmodels.trace_named("gcn", DIM, DIM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TServer("gcn", tmodels.init_params(tr))
