"""The port's `ShardedRunner` against `repro` on the same numpy graphs,
weights and inputs, on meshes of CPU devices named explicitly
(``["cpu"] * K``: K logical shards driven from one process).

Held here: parity with reference `run_pipelined` and the port's
`run_reference` for six models x dispatch on/off x 1-2 layers x K in
{1, 2, 4}; parity with reference `ShardedRunner` on a forced 4-host-device
mesh (a subprocess, since the device count binds at jax's first import);
the shard layout's caps and signature; one counted exchange per layer
(`exchange_census`); rebinding; empty shards and edgeless graphs; the
serving engine's sharded route; `confirm_wallclock` with a sharded
finalist.  Tolerance: the reference's REL_TOL 1e-4, relative to
max(1, max|ref|) — sage relative to max|ref| (ROADMAP C.1: the -1e30
empty-max sentinel reaches its outputs).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compiler as jcompiler
from repro.core import pipeline as jpipeline
from repro.core import tiling as jtiling
from repro.gnn import graphs as jgraphs
from repro.gnn import models as jmodels
from repro_torch.core import compiler as tcompiler
from repro_torch.core import executor as texecutor
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import tiling as ttiling
from repro_torch.core.analysis import exchange_census, verify_exchange
from repro_torch.core.exchange import ShardMesh
from repro_torch.gnn import graphs as tgraphs
from repro_torch.gnn import models as tmodels
from repro_torch.kernels.tile_spmm import kernel as tkernel

MODELS = ("gcn", "gat", "sage", "ggnn", "rgcn", "gin")
DIM = 16
REL_TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


def _rel_err(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.max(np.abs(want)))
    return float(np.max(np.abs(got - want))) / (scale if name == "sage"
                                                 else max(1.0, scale))


def _traces(name, n_layers, dim=DIM):
    if n_layers == 1:
        return jmodels.trace_named(name, dim, dim), tmodels.trace_named(name, dim, dim)
    return (jmodels.trace_stacked(name, n_layers, dim, dim, dim),
            tmodels.trace_stacked(name, n_layers, dim, dim, dim))


def _graph():
    return jgraphs.random_graph(150, 600, seed=3, model="powerlaw",
                                n_edge_types=3)


def _cpu(k):
    return dict(devices=["cpu"] * k, device="cpu")


_REFERENCE = {}


def _reference(name, n_layers):
    """Reference `run_pipelined` (scan) on the bucketed 5 x 5 tiles, and the
    port's oracle, once per (model, layers)."""
    if (name, n_layers) not in _REFERENCE:
        g = _graph()
        jtr, ttr = _traces(name, n_layers)
        params = jmodels.init_params(jtr, seed=1)
        inputs = jmodels.init_inputs(jtr, g, seed=2)
        bt = jtiling.bucket_tiles(jtiling.grid_tile(g, 5, 5, sparse=True), 3)
        ref = np.asarray(jpipeline.run_pipelined(
            jcompiler.compile_gnn(jtr), g, bt, inputs, params,
            kernel_dispatch=False)[0])
        oracle = texecutor.run_reference(ttr, g, inputs, params,
                                         device="cpu")[0].numpy()
        _REFERENCE[name, n_layers] = (g, ttr, params, inputs, ref, oracle)
    return _REFERENCE[name, n_layers]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("dispatch", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("name", MODELS)
def test_sharded_matches_reference_engines(name, n_layers, dispatch, n_shards):
    g, ttr, params, inputs, ref, oracle = _reference(name, n_layers)
    c = tcompiler.compile_gnn(ttr)
    bt = ttiling.bucket_tiles(ttiling.grid_tile(g, 5, 5, sparse=True), 3)
    tkernel.reset_launches()
    r = tpipeline.ShardedRunner(c, g, bt, n_shards, kernel_dispatch=dispatch,
                                **_cpu(n_shards))
    out = r(inputs, params)
    assert sum(tkernel.LAUNCHES.values()) == 0      # CPU: plain versions only
    assert len(out) == 1 and tuple(out[0].shape) == ref.shape
    assert out[0].device.type == "cpu"
    assert _rel_err(name, out[0], ref) < REL_TOL
    assert _rel_err(name, out[0], oracle) < REL_TOL
    # one counted exchange per layer: the static census, XLA's combiner
    # included, is what the runner's deferred drains come to
    assert r.mesh.collectives == exchange_census(
        c.schedule(dispatch)).n_collectives == n_layers


# ---------------------------------------------------------------------------
# against reference ShardedRunner on a forced 4-host-device mesh
# ---------------------------------------------------------------------------

_FORCED_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.core import compiler, pipeline, tiling
    from repro.gnn import graphs, models

    g = graphs.random_graph(150, 600, seed=3, model="powerlaw", n_edge_types=3)
    bt = tiling.bucket_tiles(tiling.grid_tile(g, 5, 5, sparse=True), 3)
    csr, ro = tiling.build_tiles(g, 5, 5, reorder="degree", layout="csr",
                                 n_buckets=3)
    out = {}
    for name in ("gcn", "gat", "sage"):
        tr = models.trace_stacked(name, 2, 16, 16, 16)
        c = compiler.compile_gnn(tr)
        params = models.init_params(tr, seed=1)
        inputs = models.init_inputs(tr, g, seed=2)
        runs = {
            "mincut": pipeline.ShardedRunner(c, g, bt, 4, mode="mincut",
                                             kernel_dispatch=True),
            "csr_degree": pipeline.ShardedRunner(
                c, ro.graph, csr, 4, kernel_dispatch=True, reordering=ro),
            "mesh2d": pipeline.ShardedRunner(c, g, bt, 2, mode="mincut",
                                             model_axis=2,
                                             kernel_dispatch=True),
        }
        for label, r in runs.items():
            out[f"{name}/{label}"] = np.asarray(r(inputs, params)[0])
    np.savez(sys.argv[1], **out)
""")

FORCED_CASES = [(n, c) for n in ("gcn", "gat", "sage")
                for c in ("mincut", "csr_degree", "mesh2d")]


@pytest.fixture(scope="module")
def forced_mesh_outputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("forced") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _FORCED_MESH, str(path)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name,case", FORCED_CASES)
def test_matches_reference_sharded_runner_on_forced_mesh(
        forced_mesh_outputs, name, case):
    """Mincut at K=4 over bucketed COO tiles, CSR + degree reorder at K=4,
    and a 2 x 2 ("shards", "model") mincut mesh, kernels on."""
    tg = tgraphs.random_graph(150, 600, seed=3, model="powerlaw",
                              n_edge_types=3)
    ttr = tmodels.trace_stacked(name, 2, DIM, DIM, DIM)
    c = tcompiler.compile_gnn(ttr)
    params = tmodels.init_params(ttr, seed=1)
    inputs = tmodels.init_inputs(ttr, tg, seed=2)
    if case == "csr_degree":
        ts, ro = ttiling.build_tiles(tg, 5, 5, reorder="degree", layout="csr",
                                     n_buckets=3)
        r = tpipeline.ShardedRunner(c, ro.graph, ts, 4, reordering=ro,
                                    **_cpu(4))
    else:
        bt = ttiling.bucket_tiles(ttiling.grid_tile(tg, 5, 5, sparse=True), 3)
        K, M = (4, 1) if case == "mincut" else (2, 2)
        r = tpipeline.ShardedRunner(c, tg, bt, K, mode="mincut", model_axis=M,
                                    **_cpu(K * M))
    out = r(inputs, params)[0]
    assert _rel_err(name, out, forced_mesh_outputs[f"{name}/{case}"]) < REL_TOL
    assert r.mesh.collectives == 2


# ---------------------------------------------------------------------------
# layout, census, rebinding, validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("mode", ["cost", "mincut", "contiguous"])
def test_shard_layout_matches_reference(mode, layout):
    """Caps, stacked tile arrays, presence masks, send sets and the layout
    signature equal the reference's, over K in {1, 2, 3, 4, 8} (8 > P:
    empty shards); under mode="cost" a shard's partitions are not
    contiguous in global order and its local slots stay partition-major."""
    g = jgraphs.random_graph(300, 1500, seed=0, model="powerlaw")
    jbt, _ = jtiling.build_tiles(g, 6, 6, layout=layout, n_buckets=3)
    tbt, _ = ttiling.build_tiles(g, 6, 6, layout=layout, n_buckets=3)
    kernels = frozenset({"pallas_spmm", "pallas_segment_softmax"})
    for K in (1, 2, 3, 4, 8):
        for quant in (False, True):
            jplan = jtiling.plan_shards(jbt, K, mode=mode)
            tplan = ttiling.plan_shards(tbt, K, mode=mode)
            jops, jrepl, jcaps = jpipeline._shard_layout(jbt, jplan, quant,
                                                         kernels)
            tops, trepl, tcaps = tpipeline._shard_layout(tbt, tplan, quant,
                                                         kernels)
            assert tcaps == jcaps, (K, quant)
            for key in ("pad_ids", "send_slots"):
                if key in jops:
                    np.testing.assert_array_equal(tops[key], jops[key])
            for key in jrepl:
                np.testing.assert_array_equal(trepl[key], jrepl[key])
            for jb, tb in zip(jops["buckets"] + [jops["softmax"]],
                              tops["buckets"] + [tops["softmax"]]):
                for key in ("src_ids", "edge_src", "edge_dst", "edge_gid",
                            "n_edge", "part_id", "local_pid"):
                    np.testing.assert_array_equal(tb[key], jb[key])
                np.testing.assert_array_equal(tb["pmask"], jb["pmask"] > 0)
                for k in range(K):
                    assert np.all(np.diff(tb["local_pid"][k]) >= 0)
            assert (tpipeline.shard_layout_signature(
                        tbt, K, mode, quant, True, tuple(sorted(kernels)))
                    == jpipeline.shard_layout_signature(
                        jbt, K, mode, quant, True, tuple(sorted(kernels))))


@pytest.mark.parametrize("name", MODELS)
def test_collectives_equal_the_census(name):
    """Every model, both schedules, 1-3 layers, K = 4 mincut: one counted
    exchange per layer, the census holds with no error diagnostic, and the
    restricted exchange ships fewer rows than the full layout."""
    g = tgraphs.random_graph(150, 600, seed=3, model="powerlaw",
                             n_edge_types=3)
    ts = ttiling.grid_tile(g, 6, 6, sparse=True)
    for n_layers in (1, 2, 3):
        _, ttr = _traces(name, n_layers)
        c = tcompiler.compile_gnn(ttr)
        params = tmodels.init_params(ttr, seed=1)
        inputs = tmodels.init_inputs(ttr, g, seed=2)
        for dispatch in (True, False):
            sp = c.schedule(dispatch)
            r = tpipeline.ShardedRunner(c, g, ts, 4, mode="mincut",
                                        kernel_dispatch=dispatch, **_cpu(4))
            r(inputs, params)
            assert r.mesh.collectives == exchange_census(sp).n_collectives \
                == n_layers, (n_layers, dispatch)
            r(inputs, params)
            assert r.mesh.collectives == 2 * n_layers
            diags = verify_exchange(sp, tiles=ts, plan=r.plan)
            assert not [d for d in diags if d.severity == "error"]
            assert r.caps[-1] < r.plan.n_local_parts * r.dmax


def test_bind_and_run_with_without_rebuild():
    """A structurally-identical tile set rebinds: same outputs as a fresh
    runner, same signature; the caps and validation errors."""
    jtr, ttr = _traces("gcn", 2)
    c = tcompiler.compile_gnn(ttr)
    params = jmodels.init_params(jtr)
    g1 = tgraphs.random_graph(120, 480, seed=4, model="powerlaw")
    g2 = tgraphs.random_graph(120, 480, seed=5, model="powerlaw")
    # g3: every edge lands in the first destination partition
    rng = np.random.default_rng(0)
    g3 = tgraphs.Graph(src=rng.integers(0, 120, 480).astype(np.int32),
                       dst=rng.integers(0, 30, 480).astype(np.int32),
                       n_vertices=120)
    ts = [ttiling.grid_tile(g, 4, 4, sparse=True) for g in (g1, g2, g3)]
    env = (max(t.n_tiles for t in ts), max(t.s_max for t in ts),
           max(t.e_max for t in ts))
    t1, t2, t3 = (ttiling.pad_tileset(t, *env) for t in ts)
    r = tpipeline.ShardedRunner(c, g1, t1, 2, mode="contiguous",
                                quantize_tile_cap=True, **_cpu(2))
    i2 = tmodels.init_inputs(ttr, g2)
    warm = r.run_with(t2, i2, params)[0]
    fresh = tpipeline.ShardedRunner(c, g2, t2, 2, mode="contiguous",
                                    quantize_tile_cap=True, **_cpu(2))
    assert _rel_err("gcn", warm, fresh(i2, params)[0]) < REL_TOL
    want = texecutor.run_reference(ttr, g2, i2, params, device="cpu")[0]
    assert _rel_err("gcn", warm, want) < REL_TOL
    assert r.signature == fresh.signature
    # exact (unquantized) caps: g3's shard 1 owns no real tile
    exact = tpipeline.ShardedRunner(c, g1, t1, 2, mode="contiguous", **_cpu(2))
    assert t3.shape_signature() == t1.shape_signature()
    with pytest.raises(ValueError, match="capacities changed"):
        exact.bind(t3)
    with pytest.raises(ValueError, match="not structurally identical"):
        r.bind(ttiling.grid_tile(g1, 3, 3, sparse=True))
    with pytest.raises(ValueError, match="reordering mode"):
        _, ro = ttiling.build_tiles(g1, 4, 4, reorder="degree")
        r.bind(t1, reordering=ro)
    # never repeated silently: a one-device CPU mesh holds one shard
    with pytest.raises(ValueError, match="lists only 1 device"):
        tpipeline.ShardedRunner(c, g1, t1, 2, device="cpu")
    with pytest.raises(ValueError, match="lists only 3 device"):
        tpipeline.ShardedRunner(c, g1, t1, 2, model_axis=2, **_cpu(3))
    with pytest.raises(ValueError, match="model_axis must be"):
        tpipeline.ShardedRunner(c, g1, t1, 1, model_axis=0, **_cpu(1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipeline.ShardedRunner(c, g1, t1, 1)


def test_mesh_all_gather_counts_and_splits_columns():
    """The 1-D gather stacks per shard; the 2-D gather ships each model
    rank's ceil(W / M) slice (W = 7, M = 2: one column of padding) and
    reassembles the full width; every call counts once."""
    bufs = [torch.arange(14.0).reshape(2, 7) + 100 * k for k in range(3)]
    want = torch.stack(bufs)
    one = ShardMesh(["cpu"] * 3, 3)
    got = one.all_gather(bufs)
    assert len(got) == 3 and all(torch.equal(x, want) for x in got)
    two = ShardMesh(["cpu"] * 6, 3, model_axis=2)
    got = two.all_gather(bufs)
    assert all(torch.equal(x, want) for x in got)
    assert (one.collectives, two.collectives) == (1, 1)
    with pytest.raises(ValueError, match="2 buffers for 3 shards"):
        one.all_gather(bufs[:2])


@pytest.mark.parametrize("dispatch", [True, False], ids=["kernels", "scan"])
def test_empty_shards_and_edgeless_graphs(dispatch):
    """More shards than destination partitions under mincut (trailing
    shards own nothing), a graph with no edges and a one-vertex graph."""
    jtr, ttr = _traces("gcn", 2)
    c = tcompiler.compile_gnn(ttr)
    params = jmodels.init_params(jtr)
    g = tgraphs.random_graph(90, 360, seed=9, model="powerlaw")
    ts = ttiling.grid_tile(g, 3, 3, sparse=True)
    assert min(len(p) for p in ttiling.plan_shards(ts, 4, "mincut")
               .parts_of_shard) == 0
    inputs = tmodels.init_inputs(ttr, g)
    want = texecutor.run_reference(ttr, g, inputs, params, device="cpu")[0]
    r = tpipeline.ShardedRunner(c, g, ts, 4, mode="mincut",
                                kernel_dispatch=dispatch, **_cpu(4))
    assert _rel_err("gcn", r(inputs, params)[0], want) < REL_TOL
    for g in (tgraphs.Graph(src=np.empty(0, np.int32),
                            dst=np.empty(0, np.int32), n_vertices=6),
              tgraphs.Graph(src=np.zeros(1, np.int32),
                            dst=np.zeros(1, np.int32), n_vertices=1)):
        inputs = tmodels.init_inputs(ttr, g)
        want = texecutor.run_reference(ttr, g, inputs, params, device="cpu")[0]
        ts = ttiling.grid_tile(g, 2, 2, sparse=True)
        ts = ttiling.pad_tileset(ts, max(ts.n_tiles, 2), max(ts.s_max, 8),
                                 max(ts.e_max, 8))
        out = tpipeline.run_sharded(c, g, ts, inputs, params, n_devices=2,
                                    kernel_dispatch=dispatch, **_cpu(2))
        assert _rel_err("gcn", out[0], want) < REL_TOL, g.n_vertices


# ---------------------------------------------------------------------------
# the serving route and the autotuner's sharded finalists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_serving_sharded_route(name):
    """Large classes go sharded, small ones stay single-device, repeats hit
    the warm sharded runner; outputs equal the unsharded server's and the
    oracle's, and the two routes' cache keys differ."""
    from repro_torch.serve import InferenceServer
    jtr, ttr = _traces(name, 2)
    params = jmodels.init_params(jtr)
    c = tcompiler.compile_gnn(ttr)
    sharded = InferenceServer(c, params, shard_devices=4,
                              shard_mesh_devices=["cpu"] * 4,
                              shard_min_vertices=256, device="cpu")
    plain = InferenceServer(c, params, device="cpu")
    for rnd in range(3):
        gs = ([tgraphs.random_graph(120 + rnd, 500, seed=10 * rnd + i)
               for i in range(3)]
              + [tgraphs.random_graph(16, 60, seed=20 * rnd + i)
                 for i in range(2)])
        ins = [tmodels.init_inputs(ttr, g, seed=i) for i, g in enumerate(gs)]
        got, base = sharded.submit(gs, ins), plain.submit(gs, ins)
        for g, inp, a, b in zip(gs, ins, got, base):
            want = texecutor.run_reference(ttr, g, inp, params, device="cpu")[0]
            assert _rel_err(name, a[0], b[0]) < REL_TOL
            assert _rel_err(name, a[0], want) < REL_TOL
    st = sharded.stats()
    assert st["sharded_batches"] == 3 and st["batches"] == 6
    # the sharded route amortizes: later rounds hit warm runners
    assert sharded.compile_count <= 3 and sharded.cache_hits >= 3
    # a sharded runner's key carries the shard layout and never equals
    # the unsharded route's; the small class keys both servers alike
    entries = sharded.cache._entries
    routes = {type(r).__name__: k for k, r in entries.items()}
    assert set(routes) == {"ShardedRunner", "PipelinedRunner"}
    assert routes["ShardedRunner"][-2][:2] == ("shardlayout", 4)
    assert routes["ShardedRunner"] not in plain.cache._entries
    assert routes["PipelinedRunner"] in plain.cache._entries


def test_shared_cache_keeps_meshes_apart():
    """Two servers on one program cache that name different mesh devices
    build a runner each: neither reuses a runner bound to the other's
    devices, and both agree."""
    from repro_torch.serve import InferenceServer, ProgramCache
    jtr, ttr = _traces("gcn", 2)
    params = jmodels.init_params(jtr)
    c = tcompiler.compile_gnn(ttr)
    gs = [tgraphs.random_graph(120, 500, seed=i) for i in range(3)]
    ins = [tmodels.init_inputs(ttr, g, seed=i) for i, g in enumerate(gs)]
    cache = ProgramCache(capacity=8)
    outs = {}
    for dev in ("cpu", "cpu:0"):
        srv = InferenceServer(c, params, shard_devices=4,
                              shard_mesh_devices=[dev] * 4,
                              shard_min_vertices=256, cache=cache, device=dev)
        outs[dev] = srv.submit(gs, ins)
        assert srv.stats()["sharded_batches"] == 1
    assert len(cache) == 2 and cache.stats.compiles == 2
    meshes = {tuple(r.mesh.devices) for r in cache._entries.values()}
    assert meshes == {(torch.device("cpu"),) * 4, (torch.device("cpu:0"),) * 4}
    for a, b in zip(outs["cpu"], outs["cpu:0"]):
        assert _rel_err("gcn", a[0], b[0]) < REL_TOL


def test_tuned_shard_count_caps_the_mesh():
    """A tuned class with 2 shards on a 4-shard server runs a 2-shard
    runner (the tuned count caps the mesh and never raises it), keyed
    apart from the default route, with the oracle's outputs."""
    from repro_torch.launch import autotune as AT
    from repro_torch.serve import InferenceServer, quantize, size_class
    jtr, ttr = _traces("gcn", 2)
    params = jmodels.init_params(jtr)
    c = tcompiler.compile_gnn(ttr)
    gs = [tgraphs.random_graph(120, 500, seed=i) for i in range(3)]
    ins = [tmodels.init_inputs(ttr, g, seed=i) for i, g in enumerate(gs)]
    class_key = (c.name, c.n_layers, size_class(gs[0]),
                 quantize(len(gs), floor=1))
    for tuned_shards, want_shards in ((2, 2), (8, 4)):
        cache = AT.TuneCache()
        cache.put(AT.program_key(c, True), class_key, AT.TileConfig(
            n_dst_parts=8, n_src_parts=4, n_buckets=2, n_shards=tuned_shards))
        srv = InferenceServer(c, params, shard_devices=4,
                              shard_mesh_devices=["cpu"] * 4,
                              shard_min_vertices=256, tune_cache=cache,
                              device="cpu")
        outs = srv.submit(gs, ins)
        (key, runner), = srv.cache._entries.items()
        assert type(runner).__name__ == "ShardedRunner"
        assert runner.n_devices == want_shards
        assert key[-1][0] == "tuned" and key[-2][:2] == ("shardlayout",
                                                        want_shards)
        for g, inp, out in zip(gs, ins, outs):
            want = texecutor.run_reference(ttr, g, inp, params, device="cpu")[0]
            assert _rel_err("gcn", out[0], want) < REL_TOL


def test_confirm_wallclock_times_a_sharded_finalist(monkeypatch):
    """A 2-shard finalist runs a ShardedRunner over the named mesh and gets
    a wall clock; with the default mesh (one CPU device) it clamps to a
    PipelinedRunner."""
    from repro_torch.launch import autotune as AT
    jtr, ttr = _traces("gcn", 2)
    c = tcompiler.compile_gnn(ttr)
    g = tgraphs.random_graph(120, 480, seed=4)
    trial = AT.padded_cost(c, g, AT.TileConfig(n_shards=2, shard_mode="mincut"))
    built = []
    for cls in ("ShardedRunner", "PipelinedRunner"):
        real = getattr(tpipeline, cls)
        monkeypatch.setattr(tpipeline, cls, lambda *a, _r=real, **kw: (
            built.append(_r.__name__) or _r(*a, **kw)))
    inputs, params = tmodels.init_inputs(ttr, g), tmodels.init_params(ttr)
    out = AT.confirm_wallclock(c, g, [trial], inputs, params, top=1,
                               repeats=2, **_cpu(2))
    assert out == [trial] and trial.wall_s > 0
    trial.wall_s = None
    AT.confirm_wallclock(c, g, [trial], inputs, params, top=1, repeats=1,
                         device="cpu")
    assert trial.wall_s > 0
    assert built == ["ShardedRunner", "PipelinedRunner"]
