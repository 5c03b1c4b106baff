"""GNN gradients and training through the port against `repro`'s
`jax.grad`, on the same numpy graphs, weights and inputs, on the CPU.

Held here, each gradient leaf within 5e-4 x max(1, max|g_ref|) (the
engines' forward tolerance):

* the scan path (`PipelinedRunner(kernel_dispatch=False)`) for gcn, gin,
  ggnn, rgcn and sage (its loss over rows with in-degree >= 1: ROADMAP
  C.1), the stacked gcn / gin at 2 and 3 layers over bucketed tiles and the
  training example's 3-layer GCN, on COO and CSR tiles;
* gat against the reference's `run_reference` (ROADMAP C.5: on these
  graphs the reference's scan path, and its `ShardedRunner`, give NaN; the
  port's gradient is finite);
* `run_tiled(kernel_dispatch=False)` and `run_reference`, and
  `ShardedRunner(kernel_dispatch=False)` on `["cpu"] * K` against the
  reference's `ShardedRunner` on a forced 4-host-device mesh (a
  subprocess);
* with kernel dispatch on, the port refuses a gradient exactly where the
  reference's `jax.grad` raises, and 1-layer gin (whose SpMM reads only the
  input) trains through the kernels' plain versions;
* 5 steps of `launch.train_gnn` against the reference example's loop
  rebuilt from reference modules;
* serving and the autotuner's wall-clock step record no autograd graph.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import compiler as jcompiler
from repro.core import executor as jexecutor
from repro.core import pipeline as jpipeline
from repro.core import tiling as jtiling
from repro.core.trace import trace_model as jtrace_model
from repro.gnn import graphs as jgraphs
from repro.gnn import models as jmodels
from repro.optim import adamw as jadamw
from repro_torch.core import compiler as tcompiler
from repro_torch.core import executor as texecutor
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import tiling as ttiling
from repro_torch.gnn import graphs as tgraphs
from repro_torch.gnn import models as tmodels
from repro_torch.launch import autotune as AT
from repro_torch.launch import train_gnn
from repro_torch.serve import InferenceServer

DIM = 16
GRAD_TOL = 5e-4
ROOT = Path(__file__).resolve().parents[1]
# gat's graph: the reference's scan-path gradient is NaN on it (C.5), in
# its PipelinedRunner and its ShardedRunner alike
GRAPH = dict(n_vertices=300, n_edges=1200, seed=0, model="powerlaw",
             n_edge_types=3)
# the sharded tests' graph: the reference's ShardedRunner is finite on it
SHARDED_GRAPH = dict(n_vertices=200, n_edges=800, seed=3)


def _graphs(**kw):
    kw = {**GRAPH, **kw}
    return jgraphs.random_graph(**kw), tgraphs.random_graph(**kw)


def _traces(name, n_layers, dim=DIM):
    if n_layers == 1:
        return jmodels.trace_named(name, dim, dim), tmodels.trace_named(name, dim, dim)
    return (jmodels.trace_stacked(name, n_layers, dim, dim, dim),
            tmodels.trace_stacked(name, n_layers, dim, dim, dim))


def _tiles(g, tg, layout, n_buckets=None, grid=4):
    jt = jtiling.grid_tile(g, grid, grid, sparse=True, layout=layout)
    tt = ttiling.grid_tile(tg, grid, grid, sparse=True, layout=layout)
    if n_buckets:
        jt, tt = jtiling.bucket_tiles(jt, n_buckets), ttiling.bucket_tiles(tt, n_buckets)
    return jt, tt


def _loss_terms(g, dim, rows=None):
    """Weights of the loss sum(out * w) and its row mask (all rows unless
    ``rows``)."""
    w = np.random.default_rng(7).standard_normal((g.n_vertices, dim)).astype(np.float32)
    mask = np.ones((g.n_vertices, 1), np.float32) if rows is None else \
        rows[:, None].astype(np.float32)
    return w * mask


def _ref_grads(fn, params, w):
    return {k: np.asarray(v) for k, v in jax.grad(
        lambda p: jnp.sum(fn(p)[0] * w))(
            {k: jnp.asarray(v) for k, v in params.items()}).items()}


def _port_grads(fn, params, w):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    torch.sum(fn(tp)[0] * torch.as_tensor(w)).backward()
    return {k: v.grad.numpy() for k, v in tp.items()}


def _assert_grads_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k]).all(), k
        lim = GRAD_TOL * max(1.0, float(np.max(np.abs(want[k]))))
        err = float(np.max(np.abs(got[k] - want[k])))
        assert err <= lim, (k, err, lim)


def _case(name, n_layers=1, layout="coo", n_buckets=None, grid=4, **graph):
    g, tg = _graphs(**graph)
    jtr, ttr = _traces(name, n_layers)
    params = jmodels.init_params(jtr, seed=1)
    inputs = jmodels.init_inputs(jtr, g, seed=2)
    rows = g.in_degrees() >= 1 if name == "sage" else None
    jt, tt = _tiles(g, tg, layout, n_buckets, grid)
    return g, tg, jtr, ttr, params, inputs, _loss_terms(g, DIM, rows), jt, tt


# ---------------------------------------------------------------------------
# the scan path against the reference's scan path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("name", ["gcn", "gin", "ggnn", "rgcn", "sage"])
def test_scan_gradients_match_reference(name, layout):
    g, tg, jtr, ttr, params, inputs, w, jt, tt = _case(name, layout=layout)
    jr = jpipeline.PipelinedRunner(jcompiler.compile_gnn(jtr), g, jt,
                                   kernel_dispatch=False)
    tr = tpipeline.PipelinedRunner(tcompiler.compile_gnn(ttr), tg, tt,
                                   kernel_dispatch=False, device="cpu")
    _assert_grads_equal(_port_grads(lambda p: tr(inputs, p), params, w),
                        _ref_grads(lambda p: jr(inputs, p), params, w))


@pytest.mark.parametrize("n_layers", [2, 3])
@pytest.mark.parametrize("name", ["gcn", "gin"])
def test_stacked_scan_gradients_match_reference(name, n_layers):
    """Over 3 size buckets: the accumulators are shared across buckets."""
    g, tg, jtr, ttr, params, inputs, w, jt, tt = _case(name, n_layers,
                                                       n_buckets=3)
    jr = jpipeline.PipelinedRunner(jcompiler.compile_gnn(jtr), g, jt,
                                   kernel_dispatch=False)
    tr = tpipeline.PipelinedRunner(tcompiler.compile_gnn(ttr), tg, tt,
                                   kernel_dispatch=False, device="cpu")
    _assert_grads_equal(_port_grads(lambda p: tr(inputs, p), params, w),
                        _ref_grads(lambda p: jr(inputs, p), params, w))


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_training_keeps_source_blocks_per_slot(layout, monkeypatch):
    """Where the tiles' padded source rows are at least V, a call under
    autograd still evaluates the 3-layer GCN's source blocks per slot, so
    its gradients sum in the reference's order and hold the reference's;
    the same call under inference mode runs each transform once over the
    V rows of the flat store and gives the same output."""
    g, tg, jtr, ttr, params, inputs, w, jt, tt = _case("gcn", 3, layout=layout)
    jr = jpipeline.PipelinedRunner(jcompiler.compile_gnn(jtr), g, jt,
                                   kernel_dispatch=False)
    tr = tpipeline.PipelinedRunner(tcompiler.compile_gnn(ttr), tg, tt,
                                   kernel_dispatch=False, device="cpu")
    operands = tr.bind(tt)
    assert tg.n_vertices <= operands[-1][0]
    rows = []
    real = tpipeline.apply_compute

    def record(op, attrs, p, args):
        if "weight" in attrs:
            rows.append((attrs["weight"], tuple(args[0].shape[:-1])))
        return real(op, attrs, p, args)

    monkeypatch.setattr(tpipeline, "apply_compute", record)
    outs = []

    def fn(p):
        outs.append(tr(inputs, p, operands=operands)[0])
        return outs[-1:]

    got = _port_grads(fn, params, w)
    assert rows and all(r == tuple(tt.src_ids.shape) for _, r in rows)
    _assert_grads_equal(got, _ref_grads(lambda p: jr(inputs, p), params, w))
    rows.clear()
    with torch.inference_mode():
        flat = tr(inputs, params, operands=operands)[0]
    assert sorted(rows) == [(f"l{i}.W", (tg.n_vertices,)) for i in range(3)]
    torch.testing.assert_close(flat, outs[0].detach())


def _ref_build_mlp_gcn(tr, g, in_dim, hidden, n_classes):
    """examples/train_gnn.py's model, as the reference example builds it."""
    x = tr.input_vertex(in_dim, "x")
    dn = tr.input_vertex(1, "dnorm")
    h = x
    dims = [in_dim, hidden, hidden, n_classes]
    for i in range(3):
        wt = tr.param(f"W{i}", (dims[i], dims[i + 1]))
        h = (h * dn).matmul(wt)
        h = g.gather_sum(g.scatter_src(h))
        h = h * dn
        if i < 2:
            h = h.relu()
    tr.mark_output(h)


def _ref_mlp_gcn(width, classes):
    return jtrace_model(lambda t, gr: _ref_build_mlp_gcn(t, gr, 64, width, classes),
                        name="gcn3")


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_mlp_gcn_scan_gradients_match_reference(layout):
    g, tg = _graphs(n_edge_types=None)
    jtr = _ref_mlp_gcn(32, 16)
    ttr = train_gnn.trace_mlp_gcn(32, 16)
    assert dict(ttr.params) == dict(jtr.params)
    params = jmodels.init_params(jtr, seed=1)
    inputs = jmodels.init_inputs(jtr, g, seed=2)
    w = _loss_terms(g, 16)
    jt, tt = _tiles(g, tg, layout)
    jr = jpipeline.PipelinedRunner(jcompiler.compile_gnn(jtr), g, jt)
    tr = tpipeline.PipelinedRunner(tcompiler.compile_gnn(ttr), tg, tt,
                                   kernel_dispatch=False, device="cpu")
    _assert_grads_equal(_port_grads(lambda p: tr(inputs, p), params, w),
                        _ref_grads(lambda p: jr(inputs, p), params, w))


# the example's graph on chip_smoke phase 13's 8 x 8 tiles
EXAMPLE_GRAPH_8X8 = dict(n_vertices=4000, n_edges=16000, seed=0,
                         n_edge_types=None, grid=8)


@pytest.mark.parametrize("layout,case", [("coo", "graph"), ("csr", "graph"),
                                         ("coo", "example_8x8")])
def test_gat_scan_gradients_finite_and_match_reference_oracle(layout, case):
    """The reference's scan path gives NaN here (ROADMAP C.5); the port's
    gradient is finite and equals the reference `run_reference`'s."""
    graph = EXAMPLE_GRAPH_8X8 if case == "example_8x8" else {}
    g, tg, jtr, ttr, params, inputs, w, jt, tt = _case("gat", 2, layout=layout,
                                                       **graph)
    jr = jpipeline.PipelinedRunner(jcompiler.compile_gnn(jtr), g, jt,
                                   kernel_dispatch=False)
    ref_scan = _ref_grads(lambda p: jr(inputs, p), params, w)
    assert not all(np.isfinite(v).all() for v in ref_scan.values())
    tr = tpipeline.PipelinedRunner(tcompiler.compile_gnn(ttr), tg, tt,
                                   kernel_dispatch=False, device="cpu")
    _assert_grads_equal(
        _port_grads(lambda p: tr(inputs, p), params, w),
        _ref_grads(lambda p: jexecutor.run_reference(jtr, g, inputs, p),
                   params, w))


# ---------------------------------------------------------------------------
# the other engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gcn", "gat", "ggnn"])
@pytest.mark.parametrize("engine", ["run_tiled", "run_reference"])
def test_engine_gradients_match_reference(engine, name):
    g, tg, jtr, ttr, params, inputs, w, jt, tt = _case(name, 2)
    if engine == "run_tiled":
        jc, tc = jcompiler.compile_gnn(jtr), tcompiler.compile_gnn(ttr)
        want = _ref_grads(lambda p: jexecutor.run_tiled(
            jc, g, jt, inputs, p, kernel_dispatch=False), params, w)
        got = _port_grads(lambda p: texecutor.run_tiled(
            tc, tg, tt, inputs, p, kernel_dispatch=False, device="cpu"), params, w)
    else:
        want = _ref_grads(lambda p: jexecutor.run_reference(jtr, g, inputs, p),
                          params, w)
        got = _port_grads(lambda p: texecutor.run_reference(
            ttr, tg, inputs, p, device="cpu"), params, w)
    _assert_grads_equal(got, want)


_FORCED_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core import compiler, pipeline, tiling
    from repro.gnn import graphs, models

    g = graphs.random_graph(200, 800, seed=3, model="powerlaw", n_edge_types=3)
    tiles = tiling.grid_tile(g, 4, 4, sparse=True)
    w = np.random.default_rng(7).standard_normal((200, 16)).astype(np.float32)
    out = {}
    for name in ("gcn", "gat"):
        tr = models.trace_stacked(name, 2, 16, 16, 16)
        c = compiler.compile_gnn(tr)
        params = {k: jnp.asarray(v) for k, v in models.init_params(tr, seed=1).items()}
        inputs = models.init_inputs(tr, g, seed=2)
        for k in (2, 4):
            r = pipeline.ShardedRunner(c, g, tiles, k, kernel_dispatch=False)
            grads = jax.grad(lambda p: jnp.sum(r(inputs, p)[0] * w))(params)
            for leaf, v in grads.items():
                out[f"{name}/{k}/{leaf}"] = np.asarray(v)
    # gat on the C.5 graph: the reference's ShardedRunner shares its NaN
    g = graphs.random_graph(300, 1200, seed=0, model="powerlaw", n_edge_types=3)
    w = np.random.default_rng(7).standard_normal((300, 16)).astype(np.float32)
    tr = models.trace_stacked("gat", 2, 16, 16, 16)
    r = pipeline.ShardedRunner(compiler.compile_gnn(tr), g,
                               tiling.grid_tile(g, 4, 4, sparse=True), 4,
                               kernel_dispatch=False)
    params = {k: jnp.asarray(v) for k, v in models.init_params(tr, seed=1).items()}
    grads = jax.grad(lambda p: jnp.sum(r(models.init_inputs(tr, g, seed=2), p)[0] * w))(params)
    out["c5_finite"] = np.array(all(np.isfinite(np.asarray(v)).all()
                                    for v in grads.values()))
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def forced_mesh_grads(tmp_path_factory):
    path = tmp_path_factory.mktemp("forced") / "grads.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _FORCED_MESH, str(path)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_sharded_gradients_match_reference_sharded_runner(forced_mesh_grads,
                                                          name, K):
    """K shards on one device share its exchanged buffers: each shard's
    cotangent must add into them."""
    _, tg, _, ttr, params, inputs, w, _, tt = _case(name, 2, **SHARDED_GRAPH)
    r = tpipeline.ShardedRunner(tcompiler.compile_gnn(ttr), tg, tt, K,
                                kernel_dispatch=False, devices=["cpu"] * K,
                                device="cpu")
    want = {leaf: forced_mesh_grads[f"{name}/{K}/{leaf}"] for leaf in params}
    _assert_grads_equal(_port_grads(lambda p: r(inputs, p), params, w), want)
    assert r.mesh.collectives == 2


def test_sharded_gat_gradient_finite_where_reference_sharded_is_nan(
        forced_mesh_grads):
    """On the C.5 graph the reference's ShardedRunner gives NaN too; the
    port's 4-shard gradient equals the reference `run_reference`'s."""
    assert not forced_mesh_grads["c5_finite"]
    g, tg, jtr, ttr, params, inputs, w, _, tt = _case("gat", 2)
    r = tpipeline.ShardedRunner(tcompiler.compile_gnn(ttr), tg, tt, 4,
                                kernel_dispatch=False, devices=["cpu"] * 4,
                                device="cpu")
    _assert_grads_equal(
        _port_grads(lambda p: r(inputs, p), params, w),
        _ref_grads(lambda p: jexecutor.run_reference(jtr, g, inputs, p),
                   params, w))


# ---------------------------------------------------------------------------
# kernel dispatch: no gradient through a tile kernel
# ---------------------------------------------------------------------------

def _dispatch_fns(name, n_layers, layout, engine):
    g, tg, jtr, ttr, params, inputs, w, jt, tt = _case(name, n_layers,
                                                       layout=layout)
    jc, tc = jcompiler.compile_gnn(jtr), tcompiler.compile_gnn(ttr)
    if engine == "PipelinedRunner":
        jr = jpipeline.PipelinedRunner(jc, g, jt, kernel_dispatch=True)
        tr = tpipeline.PipelinedRunner(tc, tg, tt, kernel_dispatch=True,
                                       device="cpu")
        return (lambda p: jr(inputs, p)), (lambda p: tr(inputs, p)), params, w
    return ((lambda p: jexecutor.run_tiled(jc, g, jt, inputs, p,
                                           kernel_dispatch=True)),
            (lambda p: texecutor.run_tiled(tc, tg, tt, inputs, p,
                                           kernel_dispatch=True, device="cpu")),
            params, w)


@pytest.mark.parametrize("engine", ["PipelinedRunner", "run_tiled"])
@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("name", ["gcn", "gat", "ggnn"])
def test_kernel_dispatch_refuses_gradient_as_reference(name, layout, engine):
    jf, tf, params, w = _dispatch_fns(name, 1, layout, engine)
    with pytest.raises(NotImplementedError):
        _ref_grads(jf, params, w)
    with pytest.raises(NotImplementedError, match="kernel_dispatch=False"):
        _port_grads(tf, params, w)
    # without autograd recording the same call runs the kernels
    with torch.no_grad():
        out = tf({k: torch.tensor(v, requires_grad=True)
                  for k, v in params.items()})[0]
    assert out.grad_fn is None and torch.isfinite(out).all()


@pytest.mark.parametrize("engine", ["PipelinedRunner", "run_tiled"])
@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_gin_trains_through_kernel_dispatch_as_reference(layout, engine):
    """1-layer gin's SpMM reads only the input: no cotangent crosses the
    kernel, so both packages train with dispatch on."""
    jf, tf, params, w = _dispatch_fns("gin", 1, layout, engine)
    _assert_grads_equal(_port_grads(tf, params, w), _ref_grads(jf, params, w))


# ---------------------------------------------------------------------------
# the training example
# ---------------------------------------------------------------------------

def _adamw_step_limit(m, v, lr, step, tol, *, b1=0.9, b2=0.95, eps=1e-8):
    """Elementwise: how far one AdamW update at rate ``lr`` may move when
    the moments ``m``, ``v`` after step ``step`` are each within ``tol`` of
    their leaf's largest entry (chip_smoke's ``_adamw_param_limit``
    without its ulp).  u = m^ / (sqrt(v^) + eps) with m^ within dm and
    sqrt(v^) + eps within [lo, hi] moves by at most dm / lo + |m^| (hi -
    lo) / (lo hi)."""
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    mh, vh = np.abs(m) / bc1, v / bc2
    dm, dv = tol * float(mh.max()), tol * float(vh.max())
    lo = np.sqrt(np.maximum(vh - dv, 0.0)) + eps
    hi = np.sqrt(vh + dv) + eps
    return lr * (dm / lo + mh * (hi - lo) / (lo * hi))


def _reference_loop(g, width, classes, steps):
    """examples/train_gnn.py's loop, from reference modules: losses, the
    accumulated per-step update limits, final params."""
    tr = _ref_mlp_gcn(width, classes)
    runner = jpipeline.PipelinedRunner(jcompiler.compile_gnn(tr), g,
                                       jtiling.grid_tile(g, 4, 4, sparse=True))
    rng = np.random.default_rng(0)
    params = {n: jnp.asarray(rng.standard_normal(s) / np.sqrt(s[0]), jnp.float32)
              for n, s in tr.params.items()}
    deg = g.in_degrees().astype(np.float32)
    inputs = {"x": jnp.asarray(rng.standard_normal((g.n_vertices, 64)), jnp.float32),
              "dnorm": jnp.asarray((1 / np.sqrt(np.maximum(deg, 1)))[:, None])}
    labels = jnp.asarray(rng.integers(0, classes, g.n_vertices))

    def loss_fn(p):
        logits = runner(inputs, p)[0]
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
        return (lse - gold).mean()

    opt = jadamw.adamw_init(params)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    losses, limits = [], {n: 0.0 for n in params}
    for step in range(steps):
        loss, grads = value_and_grad(params)
        params, opt, _ = jadamw.adamw_update(params, opt, grads, train_gnn.LR)
        losses.append(float(loss))
        for n in params:
            limits[n] = limits[n] + _adamw_step_limit(
                np.asarray(opt.m[n]), np.asarray(opt.v[n]), train_gnn.LR,
                step + 1, 1e-4)
    return losses, limits, {n: np.asarray(v) for n, v in params.items()}


@pytest.mark.parametrize("width", [32, 2048])
def test_train_gnn_matches_reference_loop(width):
    """5 steps on 300 V / 1,200 E: losses within 1e-5 (relative), params
    within the sum of the steps' AdamW limits (moments within 1e-4 of their
    largest entry) + one fp32 ulp.  At width 2,048 the reference's own loss
    rises after its first step (AdamW at 3e-3 on wide layers), and the
    port's with it."""
    kw = dict(n_vertices=300, n_edges=1200, seed=0, model="powerlaw")
    want_losses, limits, want = _reference_loop(jgraphs.random_graph(**kw),
                                                width, 16, 5)
    losses, params = train_gnn.train(tgraphs.random_graph(**kw), width=width,
                                     n_classes=16, steps=5, device="cpu",
                                     log=lambda s: None)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    if width == 2048:
        assert want_losses[1] > want_losses[0]
    for n, p in params.items():
        p = p.detach().numpy()
        lim = limits[n] + np.finfo(np.float32).eps * np.abs(want[n])
        assert np.all(np.abs(p - want[n]) <= lim), n


def test_train_gnn_cli_prints_the_reference_lines(capsys):
    train_gnn.main(["--device", "cpu", "--width", "16", "--vertices", "200",
                    "--edges", "800", "--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "params: 0.0M   tiles: 16"
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "0"], ["step", "2"]]
    assert lines[-1].startswith("final loss: ")
    assert np.isfinite(float(lines[-1].split()[-1]))


def test_train_gnn_counts_the_codes_params():
    """64 -> 8192 -> 8192 -> 16: 67.8 M params, as the code builds it."""
    tr = train_gnn.trace_mlp_gcn(8192, 16)
    assert sum(int(np.prod(s)) for s in tr.params.values()) == 67_764_224
    assert dict(tr.params) == dict(_ref_mlp_gcn(8192, 16).params)


# ---------------------------------------------------------------------------
# serving and the autotuner record no graph
# ---------------------------------------------------------------------------

def test_inference_server_records_no_graph():
    jtr, ttr = _traces("gcn", 2)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in jmodels.init_params(jtr, seed=1).items()}
    srv = InferenceServer(tcompiler.compile_gnn(ttr), params, device="cpu")
    gs = [tgraphs.random_graph(48, 200, seed=s, model="powerlaw") for s in range(3)]
    outs = srv.submit(gs, [tmodels.init_inputs(ttr, g, seed=s)
                           for s, g in enumerate(gs)])
    assert all(o.grad_fn is None and not o.requires_grad
               for per_graph in outs for o in per_graph)


def test_confirm_wallclock_records_no_graph(monkeypatch):
    jtr, ttr = _traces("gcn", 2)
    tc = tcompiler.compile_gnn(ttr)
    _, g = _graphs(n_vertices=120, n_edges=480, n_edge_types=None)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in jmodels.init_params(jtr, seed=1).items()}
    seen = []
    run = tpipeline.PipelinedRunner._run

    def recording(self, *a):
        outs = run(self, *a)
        seen.extend(o.grad_fn is None and not o.requires_grad for o in outs)
        return outs

    monkeypatch.setattr(tpipeline.PipelinedRunner, "_run", recording)
    trials = AT.hillclimb(tc, g, max_evals=2)
    done = AT.confirm_wallclock(tc, g, trials, tmodels.init_inputs(ttr, g), params,
                                top=1, repeats=2, device="cpu")
    assert done and seen and all(seen)
