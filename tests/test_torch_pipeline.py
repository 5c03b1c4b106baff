"""The port's `run_pipelined` and `run_reference` against `repro`'s, on the
same numpy graphs, weights and inputs (CPU: the kernels' plain versions).

Tolerances are the reference's own (ARCHITECTURE.md "Invariants"): 5e-4
absolute against the oracle, 1e-4 for the fused GAT softmax.  sage is held
relative to max|ref|: `gather_max` clamps empty segments to -1e30 and
`W_neigh` carries that into outputs near 1e30 (ROADMAP C.1), in both
packages alike.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compiler as jcompiler
from repro.core import executor as jexecutor
from repro.core import pipeline as jpipeline
from repro.core import tiling as jtiling
from repro.gnn import graphs as jgraphs
from repro.gnn import models as jmodels
from repro_torch.core import compiler as tcompiler
from repro_torch.core import executor as texecutor
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import tiling as ttiling
from repro_torch.gnn import models as tmodels
from repro_torch.kernels.tile_spmm import kernel as tkernel

MODELS = ("gcn", "gat", "sage", "ggnn", "rgcn", "gin")
DIM = 16


def _tol(name):
    return 1e-4 if name == "gat" else 5e-4


def _err(name, got, want, scaled=False):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    if name == "sage" or scaled:
        err /= max(1.0, float(np.max(np.abs(want))))
    return err


def _setup(name, n_layers, V=64, E=260):
    etypes = 3 if jmodels.MODELS[name].needs_etype else None
    g = jgraphs.random_graph(V, E, seed=3, model="powerlaw", n_edge_types=etypes)
    if n_layers == 1:
        jtr, ttr = jmodels.trace_named(name, DIM, DIM), tmodels.trace_named(name, DIM, DIM)
    else:
        jtr = jmodels.trace_stacked(name, n_layers, DIM, DIM, DIM)
        ttr = tmodels.trace_stacked(name, n_layers, DIM, DIM, DIM)
    params = jmodels.init_params(jtr, seed=1)
    inputs = jmodels.init_inputs(jtr, g, seed=2)
    return g, jtr, ttr, params, inputs


@pytest.mark.parametrize("kernel_dispatch", [True, False], ids=["kernels", "scan"])
@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("name", MODELS)
def test_pipelined_matches_reference_engines(name, n_layers, layout,
                                             kernel_dispatch):
    g, jtr, ttr, params, inputs = _setup(name, n_layers)
    oracle = np.asarray(jexecutor.run_reference(jtr, g, inputs, params)[0])
    jts = jtiling.grid_tile(g, 3, 3, sparse=True, layout=layout)
    jout = np.asarray(jpipeline.run_pipelined(
        jcompiler.compile_gnn(jtr), g, jts, inputs, params,
        kernel_dispatch=kernel_dispatch)[0])

    tts = ttiling.grid_tile(g, 3, 3, sparse=True, layout=layout)
    tkernel.reset_launches()
    tout = tpipeline.run_pipelined(tcompiler.compile_gnn(ttr), g, tts, inputs,
                                   params, kernel_dispatch=kernel_dispatch,
                                   device="cpu")
    assert sum(tkernel.LAUNCHES.values()) == 0      # CPU: plain versions only
    assert len(tout) == 1 and tuple(tout[0].shape) == oracle.shape
    got = tout[0].numpy()
    # 3-layer outputs reach ~6e3 (rgcn), where one fp32 ulp is 4.9e-4 and
    # the reference's own runner is 1.5e-3 off its oracle: held relative to
    # max|ref| there, as reference `tests/test_multilayer.py` holds stacks
    scaled = n_layers == 3
    assert _err(name, got, oracle, scaled) < _tol(name)
    assert _err(name, got, jout, scaled) < _tol(name)

    tref = texecutor.run_reference(ttr, g, inputs, params, device="cpu")[0]
    assert _err(name, tref.numpy(), oracle, scaled) < _tol(name)


def _layer_by_layer_oracle(name, n_layers, g, inputs, params):
    """Chain n_layers SINGLE-layer whole-graph references of `repro`: layer
    l's output becomes layer l+1's input, per-layer params stripped of
    their prefix (reference `tests/test_multilayer.py:30`)."""
    x = np.asarray(inputs["x"])
    for layer in range(n_layers):
        prefix = f"l{layer}."
        p_l = {k[len(prefix):]: v for k, v in params.items()
               if k.startswith(prefix)}
        inp_l = {"x": x}
        for shared in ("dnorm", "etype"):
            if shared in inputs:
                inp_l[shared] = inputs[shared]
        x = np.asarray(jexecutor.run_reference(
            jmodels.trace_named(name, DIM, DIM), g, inp_l, p_l)[0])
    return x


@pytest.mark.parametrize("n_layers", [2, 3])
@pytest.mark.parametrize("name", MODELS)
def test_stacked_engines_match_layer_by_layer_oracle(name, n_layers):
    """Both tiled engines of the port (run_tiled on the tile set, the
    runner on its size buckets), with and without kernel dispatch, against
    chained single-layer references, as reference
    `tests/test_multilayer.py:112` holds its engines."""
    g = jgraphs.random_graph(150, 600, seed=3, model="powerlaw", n_edge_types=3)
    ttr = tmodels.trace_stacked(name, n_layers, DIM, DIM, DIM)
    jtr = jmodels.trace_stacked(name, n_layers, DIM, DIM, DIM)
    params, inputs = jmodels.init_params(jtr), jmodels.init_inputs(jtr, g)
    oracle = _layer_by_layer_oracle(name, n_layers, g, inputs, params)
    c = tcompiler.compile_gnn(ttr)
    ts = ttiling.grid_tile(g, 4, 4, sparse=True)
    bt = ttiling.bucket_tiles(ts, 3)
    for kd in (False, True):
        out_t = texecutor.run_tiled(c, g, ts, inputs, params,
                                    kernel_dispatch=kd, device="cpu")[0]
        assert _err_rel(out_t.numpy(), oracle) < 1e-4, (name, "run_tiled", kd)
        out_p = tpipeline.run_pipelined(c, g, bt, inputs, params,
                                        kernel_dispatch=kd, device="cpu")[0]
        assert _err_rel(out_p.numpy(), oracle) < 1e-4, (name, "pipelined", kd)


def _err_rel(got, want):
    return float(np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want)))))


@pytest.mark.parametrize("name,reorder,n_buckets", [
    ("gcn", "degree", None), ("gat", "degree", 3), ("sage", None, 3),
    ("rgcn", "degree", 2), ("gin", "out", 3)])
@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_reorder_and_buckets_match_oracle(name, reorder, n_buckets, layout):
    """Degree reordering (inputs permuted in, outputs back) and size
    buckets (per-bucket kernel calls summed) leave the result unchanged."""
    g, jtr, ttr, params, inputs = _setup(name, 2, V=90, E=420)
    oracle = np.asarray(jexecutor.run_reference(jtr, g, inputs, params)[0])
    tiles, ro = ttiling.build_tiles(g, 3, 3, reorder=reorder,
                                    n_buckets=n_buckets, layout=layout)
    out = tpipeline.run_pipelined(tcompiler.compile_gnn(ttr), ro.graph, tiles,
                                  inputs, params, reordering=ro, device="cpu")
    assert _err(name, out[0].numpy(), oracle) < _tol(name)


def test_bind_run_with_reuses_one_runner():
    """A same-signature tile set runs through the built runner (no rebuild)
    and matches a fresh runner; a different signature is refused."""
    name = "gat"
    _, _, ttr, params, _ = _setup(name, 2)
    c = tcompiler.compile_gnn(ttr)
    gs = [jgraphs.random_graph(64, 260, seed=s) for s in (5, 6)]
    ts = [ttiling.pad_tileset(t, 12, 40, 64) for t in
          (ttiling.grid_tile(g, 3, 3, layout="csr") for g in gs)]
    assert ts[0].shape_signature() == ts[1].shape_signature()
    runner = tpipeline.PipelinedRunner(c, gs[0], ts[0], device="cpu")
    inputs = tmodels.init_inputs(ttr, gs[1], seed=9)
    warm = runner.run_with(ts[1], inputs, params)[0]
    fresh = tpipeline.run_pipelined(c, gs[1], ts[1], inputs, params,
                                    device="cpu")[0]
    assert runner.jit_cache_size() == 1
    assert runner.signature[1] == ts[1].shape_signature()
    torch.testing.assert_close(warm, fresh, rtol=0, atol=0)
    with pytest.raises(ValueError, match="structurally identical"):
        runner.bind(ttiling.grid_tile(gs[1], 2, 2, layout="csr"))


@pytest.mark.parametrize("name", ["gcn", "gin"])
def test_csr_bind_carries_the_plan(name, monkeypatch):
    """On CSR tiles `bind` builds each bucket's CSR plan and partition runs
    once; every SpMM call walks that plan (the kernel's order) and the
    result still matches the oracle, on a graph whose hub row is split into
    chunks."""
    from repro_torch.kernels.tile_spmm import ops as tops
    from repro_torch.kernels.tile_spmm import plan as tplan
    g, jtr, ttr, params, inputs = _setup(name, 2, V=90, E=420)
    hub = 2 * tplan.CHUNK_SIZE          # parallel in-edges of vertex 7
    src = np.concatenate([g.src, np.arange(hub, dtype=np.int32) % 90])
    dst = np.concatenate([g.dst, np.full(hub, 7, np.int32)])
    g = jgraphs.Graph(src=src, dst=dst, n_vertices=90)
    inputs = jmodels.init_inputs(jtr, g, seed=2)
    oracle = np.asarray(jexecutor.run_reference(jtr, g, inputs, params)[0])
    tiles = ttiling.build_tiles(g, 3, 3, n_buckets=2, layout="csr")[0]
    runner = tpipeline.PipelinedRunner(tcompiler.compile_gnn(ttr), g, tiles,
                                       device="cpu")
    operands = runner.bind(tiles)
    kcs = operands[1]
    assert len(kcs) == 2 and any(kc["plan"].split_row.numel() for kc in kcs)
    for kc, b in zip(kcs, tiles.buckets):
        np.testing.assert_array_equal(
            kc["part_ptr"].numpy()[1:], np.cumsum(np.bincount(
                b.part_id, minlength=tiles.n_dst_parts)))
    plans = []
    walk = tops.R.tile_spmm_csr_plan_ref
    monkeypatch.setattr(tops.R, "tile_spmm_csr_plan_ref",
                        lambda plan, *a: plans.append(plan) or walk(plan, *a))
    got = runner(inputs, params, operands=operands)[0].numpy()
    assert len(plans) == 4 and {id(p) for p in plans} == {id(kc["plan"]) for kc in kcs}
    assert _err(name, got, oracle) < _tol(name)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_gat_bind_walks_one_softmax_plan(layout, monkeypatch):
    """On gat, `bind` builds the softmax batch's edge plan once (coo_plan or
    csr_plan, over the unbucketed tiles); every softmax call walks that plan
    (the kernel's order); the runner never densifies scores and builds no
    (T, D, E) score block and no (T, E, F) value block; the result matches
    the oracle, on a graph whose hub row of parallel edges spans 3 chunks."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.tile_spmm import ops as tops
    from repro_torch.kernels.tile_spmm import plan as tplan
    g, jtr, ttr, params, inputs = _setup("gat", 2, V=90, E=420)
    hub = 3 * tplan.CHUNK_SIZE + 10      # parallel in-edges of vertex 7
    src = np.concatenate([g.src, np.arange(hub, dtype=np.int32) % 30])
    dst = np.concatenate([g.dst, np.full(hub, 7, np.int32)])
    g = jgraphs.Graph(src=src, dst=dst, n_vertices=90)
    inputs = jmodels.init_inputs(jtr, g, seed=2)
    oracle = np.asarray(jexecutor.run_reference(jtr, g, inputs, params)[0])
    tiles = ttiling.build_tiles(g, 3, 3, n_buckets=2, layout=layout)[0]
    runner = tpipeline.PipelinedRunner(tcompiler.compile_gnn(ttr), g, tiles,
                                       device="cpu")

    def refuse(*a, **k):
        raise AssertionError("densify_edge_scores on the gat path")

    monkeypatch.setattr(tops, "densify_edge_scores", refuse)
    builder = "csr_plan" if layout == "csr" else "coo_plan"
    built = []
    build = getattr(tpipeline, builder)
    monkeypatch.setattr(tpipeline, builder,
                        lambda *a, **k: built.append(1) or build(*a, **k))
    operands = runner.bind(tiles)
    plan = operands[3]["plan"]
    assert len(built) == 1
    assert int(plan.split_ptr.diff().max()) >= 3
    assert plan.slot.numel() == g.n_edges      # the unbucketed batch's edges

    walks = []
    walk = tops.R.segment_softmax_plan_ref
    monkeypatch.setattr(tops.R, "segment_softmax_plan_ref",
                        lambda p, *a, **k: walks.append(p) or walk(p, *a, **k))
    T, E = tiles.source.edge_src.shape
    dense = {(T, runner.dmax, E), (T, E, DIM)}
    shapes = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(o, torch.Tensor):
                    shapes.append(tuple(o.shape))
            return out

    with Shapes():
        got = runner(inputs, params, operands=operands)[0].numpy()
    assert len(walks) == 2 and all(w is plan for w in walks)
    assert shapes and not dense & set(shapes)
    assert _err("gat", got, oracle) < _tol("gat")


def test_entry_points_run_on_cuda_unless_told_otherwise():
    """With no card visible, omitting ``device`` raises instead of quietly
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    g, _, ttr, params, inputs = _setup("gcn", 1)
    c = tcompiler.compile_gnn(ttr)
    ts = ttiling.grid_tile(g, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.run_pipelined(c, g, ts, inputs, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.PipelinedRunner(c, g, ts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texecutor.run_reference(ttr, g, inputs, params)
