"""The port's autotuner (`repro_torch.launch.autotune`, a copy of the
reference's whose `confirm_wallclock` times the port's `PipelinedRunner`)
and the copied planners it stands on, on `device="cpu"`: the cases of
`tests/test_autotune.py`, each held against `repro` on the same graphs —
the same simulated cycles (the golden file included, read only), the same
hill-climb trials, the same recorded layout signature — and the tuned
`InferenceServer` route against `repro`'s oracle."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compiler as jcompiler
from repro.core import executor as jexecutor
from repro.core import isa as jisa
from repro.core import simulator as jsimulator
from repro.core import tiling as jtiling
from repro.gnn import graphs as jgraphs
from repro.gnn import models as jmodels
from repro.launch import autotune as JAT
from repro.serve import InferenceServer as JServer
from repro_torch.core import compiler as tcompiler
from repro_torch.core import isa as tisa
from repro_torch.core import simulator as tsimulator
from repro_torch.core import tiling as ttiling
from repro_torch.gnn import graphs as tgraphs
from repro_torch.gnn import models as tmodels
from repro_torch.launch import autotune as AT
from repro_torch.serve import InferenceServer, quantize, size_class

DIM = 16
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "simulator.json")


def _compiled(name, n_layers=1, dim=DIM):
    """(reference trace, port compiled, reference compiled)."""
    if n_layers == 1:
        jtr, ttr = jmodels.trace_named(name, dim, dim), tmodels.trace_named(name, dim, dim)
    else:
        jtr = jmodels.trace_stacked(name, n_layers, dim, dim, dim)
        ttr = tmodels.trace_stacked(name, n_layers, dim, dim, dim)
    return jtr, tcompiler.compile_gnn(ttr), jcompiler.compile_gnn(jtr)


def _graph(v=200, e=800, seed=2):
    return tgraphs.random_graph(v, e, seed=seed, model="powerlaw")


def _trials(trials):
    return [(t.config.key(), t.cycles, t.balance, t.exchange_cycles)
            for t in trials]


# ---------------------------------------------------------------------------
# the copied cost model: same cycles as the reference
# ---------------------------------------------------------------------------

def test_simulated_cycles_match_reference_and_golden():
    """The golden file's configuration (cit-Patents-like, 2-layer stacks,
    6 x 6 grid): barrier, pipelined and 4-chip sharded schedules and the
    kernel-dispatch schedule under both edge layouts simulate to exactly
    the reference's cycles and the frozen golden numbers."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    tg = tgraphs.paper_graph("cit-Patents", scale=0.001, seed=0, n_edge_types=3)
    jg = jgraphs.paper_graph("cit-Patents", scale=0.001, seed=0, n_edge_types=3)
    ts, jts = ttiling.grid_tile(tg, 6, 6, sparse=True), jtiling.grid_tile(jg, 6, 6, sparse=True)
    ts_csr, jts_csr = ttiling.csr_tiles(ts), jtiling.csr_tiles(jts)
    for name in jmodels.PAPER_MODELS:
        tc = tcompiler.compile_gnn(tmodels.trace_stacked(name, 2, 16, 16, 16))
        jc = jcompiler.compile_gnn(jmodels.trace_stacked(name, 2, 16, 16, 16))
        got, want = {}, {}
        for out, isa, sim, c, t, t_csr in (
                (got, tisa, tsimulator, tc, ts, ts_csr),
                (want, jisa, jsimulator, jc, jts, jts_csr)):
            sde = isa.emit_sde(c.schedule(False))
            barrier = sim.simulate_model(sde, t)
            shard = sim.simulate_sharded(sde, t, n_chips=4)
            out.update(
                barrier_cycles=barrier.cycles, macs=barrier.macs,
                pipelined_cycles=sim.simulate_model(
                    sde, t, inter_layer="pipelined").cycles,
                sharded4_cycles=shard.cycles,
                sharded4_exchange_cycles=shard.exchange_cycles,
                sharded4_mincut_cycles=sim.simulate_sharded(
                    sde, t, n_chips=4, mode="mincut").cycles,
                kernel_coo_cycles=sim.simulate_model(
                    isa.emit_sde(c.schedule(True)), t, padded=True).cycles)
            kern_csr = sim.simulate_model(
                isa.emit_sde(c.schedule(True), layout="csr"), t_csr, padded=True)
            out.update(kernel_csr_cycles=kern_csr.cycles,
                       kernel_csr_read=kern_csr.offchip_read)
        assert got == want, name
        assert {k: got[k] for k in golden[name]} == golden[name], name


def test_shard_layout_signature_matches_reference():
    from repro.core import pipeline as jpipeline
    from repro_torch.core import pipeline as tpipeline

    g = _graph(300, 1400, seed=5)
    for layout in ("coo", "csr"):
        tt = ttiling.build_tiles(g, 8, 4, layout=layout, n_buckets=3)[0]
        jt = jtiling.build_tiles(g, 8, 4, layout=layout, n_buckets=3)[0]
        for n, mode, quant, kernels in ((1, "cost", False, ()),
                                        (2, "contiguous", True, ("pallas_spmm",)),
                                        (4, "mincut", False,
                                         ("pallas_segment_softmax",))):
            kw = dict(mode=mode, quantize_tile_cap=quant, kernel_dispatch=True,
                      kernels=kernels)
            assert (tpipeline.shard_layout_signature(tt, n, **kw)
                    == jpipeline.shard_layout_signature(jt, n, **kw))


# ---------------------------------------------------------------------------
# search harness
# ---------------------------------------------------------------------------

def test_tileconfig_and_trial_roundtrip():
    cfg = AT.TileConfig(16, 8, 2, 4)
    assert AT.TileConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.key() == (16, 8, 2, 4, "identity", "coo", "cost")
    _, tc, jc = _compiled("gcn")
    t = AT.padded_cost(tc, _graph(), cfg)
    assert t.cycles > 0 and t.config is cfg
    assert t.to_dict()["config"] == cfg.to_dict()
    jt = JAT.padded_cost(jc, _graph(), JAT.TileConfig(16, 8, 2, 4))
    assert _trials([t]) == _trials([jt])


def test_neighbors_step_one_ladder_rung_and_respect_caps():
    cfg = AT.TileConfig()                     # (8, 8, 4, 1)
    g = _graph()
    moves = AT.neighbors(cfg, g, max_shards=2)
    keys = {m.key() for m in moves}
    assert keys == {m.key() for m in JAT.neighbors(JAT.TileConfig(), g,
                                                   max_shards=2)}
    assert (4, 8, 4, 1, "identity", "coo", "cost") in keys
    assert (16, 8, 4, 1, "identity", "coo", "cost") in keys
    assert (8, 8, 4, 2, "identity", "coo", "cost") in keys  # shards cap at 2
    assert (8, 8, 4, 4, "identity", "coo", "cost") not in keys  # no 4-shard
    assert (8, 8, 4, 1, "degree", "coo", "cost") in keys
    assert (8, 8, 4, 1, "identity", "csr", "cost") in keys
    assert not any(m.shard_mode == "mincut" for m in moves)
    sharded = AT.TileConfig(n_shards=2)
    assert (8, 8, 4, 2, "identity", "coo", "mincut") in \
        {m.key() for m in AT.neighbors(sharded, g, max_shards=2)}
    scan_moves = AT.neighbors(cfg, g, max_shards=2, kernel_dispatch=False)
    assert all(m.layout == "coo" for m in scan_moves)
    assert any(m.reorder == "degree" for m in scan_moves)
    for m in moves:
        assert sum(a != b for a, b in zip(m.key(), cfg.key())) == 1
    with pytest.raises(ValueError, match="unknown shard mode"):
        AT.TileConfig(shard_mode="zigzag")
    tiny = tgraphs.random_graph(12, 30, seed=0)
    assert all(m.n_dst_parts <= 12 and m.n_src_parts <= 12
               for m in AT.neighbors(cfg, tiny))


@pytest.mark.parametrize("name,kernel_dispatch", [
    ("gcn", True), ("gat", True), ("sage", False)])
def test_hillclimb_matches_reference_and_beats_the_default(name, kernel_dispatch):
    """The same trials (configs, cycles, balance, exchange) in the same
    order as the reference's hill-climb on the same graph; deterministic,
    never worse than the default config."""
    _, tc, jc = _compiled(name, 2)
    g = _graph()
    a = AT.hillclimb(tc, g, max_evals=24, kernel_dispatch=kernel_dispatch)
    b = AT.hillclimb(tc, g, max_evals=24, kernel_dispatch=kernel_dispatch)
    ref = JAT.hillclimb(jc, g, max_evals=24, kernel_dispatch=kernel_dispatch)
    assert _trials(a) == _trials(b) == _trials(ref)
    default = AT.padded_cost(tc, g, AT.TileConfig(),
                             kernel_dispatch=kernel_dispatch)
    assert a[0].cycles <= default.cycles
    assert len(a) <= 24


def test_autotune_confirms_finalists_by_wallclock():
    jtr, tc, _ = _compiled("gcn")
    g = _graph(120, 480, seed=4)
    inputs = jmodels.init_inputs(jtr, g)
    params = jmodels.init_params(jtr)
    res = AT.autotune(tc, g, inputs=inputs, params=params,
                      max_evals=6, top=2, repeats=1, device="cpu")
    assert res.n_evals == len(res.trials) <= 6
    assert len(res.confirmed) == 2 and all(
        t.wall_s is not None and t.wall_s > 0 for t in res.confirmed)
    assert res.best in res.confirmed          # measured winner, not simulated
    assert res.to_dict()["best"]["wall_s"] == res.best.wall_s


def test_confirm_wallclock_runs_on_cuda_unless_told_otherwise():
    """With no card visible, the wall-clock step refuses to time the CPU
    in the card's place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    jtr, tc, _ = _compiled("gcn")
    g = _graph(120, 480, seed=4)
    trials = AT.hillclimb(tc, g, max_evals=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AT.confirm_wallclock(tc, g, trials, jmodels.init_inputs(jtr, g),
                             jmodels.init_params(jtr))


# ---------------------------------------------------------------------------
# tune cache
# ---------------------------------------------------------------------------

def test_tune_cache_roundtrips_and_keys_dispatch_variants_apart(tmp_path):
    _, c, jc = _compiled("gat", 2)
    assert AT.program_key(c, True) == JAT.program_key(jc, True)
    cache = AT.TuneCache()
    cfg = AT.TileConfig(8, 4, 2, 4)
    cache.put(AT.program_key(c, True), ("cls", 256), cfg,
              layout_signature=("shardlayout", 4), cycles=123)
    cache.put(AT.program_key(c, False), ("cls", 256), AT.TileConfig())
    assert len(cache) == 2
    assert cache.get(AT.program_key(c, True), ("cls", 256)) == cfg
    assert cache.get(AT.program_key(c, False), ("cls", 256)) == AT.TileConfig()
    assert cache.get(AT.program_key(c, True), ("other", 1)) is None
    entry = cache.entry(AT.program_key(c, True), ("cls", 256))
    assert entry["layout_signature"] == repr(("shardlayout", 4))
    assert entry["cycles"] == 123

    path = str(tmp_path / "tune.json")
    cache.save(path)
    loaded = AT.TuneCache.load(path)
    assert len(loaded) == 2
    assert loaded.get(AT.program_key(c, True), ("cls", 256)) == cfg
    assert loaded.entry(AT.program_key(c, True), ("cls", 256)) == entry
    # the reference reads what the port writes
    assert JAT.TuneCache.load(path).to_json() == cache.to_json()


def test_tune_for_class_records_the_reference_entry():
    """Without IO the cheapest simulated trial wins in both packages: the
    same config, cycles and shard-layout signature land under the same
    program + class key."""
    _, c, jc = _compiled("gcn", 2)
    g = _graph()
    cache, jcache = AT.TuneCache(), JAT.TuneCache()
    res = AT.tune_for_class(c, g, ("powerlaw", 256), cache=cache, max_evals=8)
    JAT.tune_for_class(jc, g, ("powerlaw", 256), cache=jcache, max_evals=8)
    entry = cache.entry(AT.program_key(c, True), ("powerlaw", 256))
    assert AT.TileConfig.from_dict(entry["config"]) == res.best.config
    assert entry["cycles"] == res.best.cycles
    assert "shardlayout" in entry["layout_signature"]
    assert "True" in entry["layout_signature"]     # kernel_dispatch recorded
    assert cache.to_json() == jcache.to_json()


# ---------------------------------------------------------------------------
# serving: the tuned route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,layout,reorder", [
    ("gcn", "coo", "identity"), ("gcn", "csr", "degree"),
    ("gat", "csr", "identity")])
def test_server_routes_tuned_class_and_stays_conformant(name, layout, reorder):
    jtr, c, jc = _compiled(name)
    gs = [jgraphs.random_graph(48, 200, seed=k, model="powerlaw")
          for k in range(3)]
    ins = [jmodels.init_inputs(jtr, g, seed=k) for k, g in enumerate(gs)]
    params = jmodels.init_params(jtr)

    class_key = (c.name, c.n_layers, size_class(gs[0]),
                 quantize(len(gs), floor=1))
    tuned_cfg = AT.TileConfig(n_dst_parts=4, n_src_parts=4, n_buckets=2,
                              n_shards=1, reorder=reorder, layout=layout)
    cache, jcache = AT.TuneCache(), JAT.TuneCache()
    cache.put(AT.program_key(c, True), class_key, tuned_cfg)
    jcache.put(JAT.program_key(jc, True), class_key,
               JAT.TileConfig(**tuned_cfg.to_dict()))

    srv = InferenceServer(c, params, tune_cache=cache, device="cpu")
    outs = srv.submit(gs, ins)
    jouts = JServer(jc, params, tune_cache=jcache).submit(gs, ins)
    tol = 1e-4 if name == "gat" else 5e-4
    for g, inp, out, jout in zip(gs, ins, outs, jouts):
        ref = np.asarray(jexecutor.run_reference(jtr, g, inp, params)[0])
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert float(np.max(np.abs(out[0].numpy() - ref))) / scale < tol
        assert float(np.max(np.abs(out[0].numpy() - jout[0]))) / scale < tol
    # the registration landed under the tuned key, on the tuned grid
    tuned_regs = [k for k in srv.shapes._shapes
                  if ("tuned",) + tuned_cfg.key() in k]
    assert tuned_regs, list(srv.shapes._shapes)
    # repeated stream: the built runner serves it, nothing new is built
    compiles = srv.compile_count
    srv.submit(gs, ins)
    assert srv.compile_count == compiles == 1
    assert srv.cache_hits >= 1
    # an untuned server of the same model takes the default route and
    # never registers under the tuned key
    srv2 = InferenceServer(c, params, device="cpu")
    srv2.submit(gs, ins)
    assert not any(("tuned",) + tuned_cfg.key() in k
                   for k in srv2.shapes._shapes)


# ---------------------------------------------------------------------------
# the completed tiling copy under the autotuner sweep
# ---------------------------------------------------------------------------

def test_bucket_count_is_deterministic_under_autotuner_sweep():
    g = _graph(150, 600, seed=9)
    for n_dst in (2, 4, 8, 16):
        ts = ttiling.grid_tile(g, n_dst, n_dst, sparse=True)
        for nb in (2, 3, 4, 7, 8):
            bt = ttiling.bucket_tiles(ts, nb)
            assert bt.n_buckets == min(nb, ts.n_tiles), (n_dst, nb, ts.n_tiles)
            assert sum(b.n_tiles for b in bt.buckets) == ts.n_tiles
            assert all(b.n_tiles > 0 for b in bt.buckets)


def test_quantize_buckets_snaps_shapes_and_matches_reference():
    g = _graph(150, 600, seed=9)
    bt = ttiling.bucket_tiles(ttiling.grid_tile(g, 4, 4, sparse=True), 3)
    qt = ttiling.quantize_buckets(bt, pad_multiple=8)
    jqt = jtiling.quantize_buckets(
        jtiling.bucket_tiles(jtiling.grid_tile(g, 4, 4, sparse=True), 3),
        pad_multiple=8)
    assert qt.shape_signature() == jqt.shape_signature()
    assert qt.n_buckets == bt.n_buckets
    for qb, b in zip(qt.buckets, bt.buckets):
        assert qb.n_tiles == b.n_tiles
        for dim in (qb.s_max, qb.e_max):       # pow2, >= pad_multiple
            assert dim >= 8 and (dim & (dim - 1)) == 0
        assert qb.s_max >= b.s_max and qb.e_max >= b.e_max
        np.testing.assert_array_equal(qb.n_edge[: b.n_tiles],
                                      b.n_edge[: b.n_tiles])
