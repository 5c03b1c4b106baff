"""The port's example modules (`repro_torch.launch.quickstart`,
`kernel_path_demo`, `serve_gnn`, `serve_async`) against the reference's
example code on the same seeds at reduced sizes: outputs and errors
against the oracles, simulator cycles, served outputs and cache counters,
structured sheds; and a fresh process that runs a reduced dry-run cell, a
hill-climb variant and the quickstart loads nothing of jax or repro."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_quickstart_outputs_and_modelled_cycles_equal_the_reference():
    from repro.core import compiler, executor, isa, simulator, tiling
    from repro.core.streams import TPU_V5E_LIKE, HWConfig
    from repro.gnn import graphs, models
    from repro_torch.launch import quickstart

    got = quickstart.main(["--device", "cpu", "--scale", "0.02"])
    g0 = graphs.paper_graph("ak2010", scale=0.02, seed=0)
    tr = models.trace_stacked("gcn", 2)
    c = compiler.compile_gnn(tr)
    tiles, r = tiling.build_tiles(g0, 8, 8, sparse=True, reorder="degree")
    inputs = {k: (r.permute_vertex_features(v) if v.shape[0] == g0.n_vertices else v)
              for k, v in models.init_inputs(tr, g0).items()}
    ref = np.asarray(executor.run_reference(tr, r.graph, inputs, models.init_params(tr))[0])
    assert got["err_tiled"] <= got["limit"] and got["err_pipelined"] <= got["limit"]
    assert np.abs(_np(got["outputs"]) - ref).max() <= 5e-4 * max(1.0, np.abs(ref).max())
    sde = isa.emit_sde(c.plan)
    for label, hw in [("ZIPPER (paper cfg)", HWConfig()), ("TPU-v5e-like", TPU_V5E_LIKE)]:
        s = simulator.simulate_model(sde, tiles, hw)
        p = simulator.simulate_model(sde, tiles, hw, inter_layer="pipelined")
        assert got["sim"][label]["barrier_cycles"] == s.cycles
        assert got["sim"][label]["pipelined_cycles"] == p.cycles
        assert got["sim"][label]["energy_mj"] == s.energy_mj


def test_kernel_path_demo_equals_the_reference_kernels():
    """The GCN layer against the reference's `tile_spmm_pallas` and the GAT
    aggregation against its `segment_softmax_pallas` (interpret mode) on
    the same tiles, features and scores."""
    import jax.numpy as jnp
    from repro.core import reorder, tiling
    from repro.gnn import graphs
    from repro.kernels.tile_spmm import ops as jops
    from repro_torch.launch import kernel_path_demo

    got = kernel_path_demo.main(["--device", "cpu", "--scale", "0.02"])
    assert got["err_spmm"] < 1e-4 and got["err_gat"] < 1e-4
    g = reorder.degree_sort(graphs.paper_graph("ak2010", scale=0.02, seed=0)).graph
    tiles = tiling.grid_tile(g, 6, 6, sparse=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((g.n_vertices, 64)).astype(np.float32)
    W = (rng.standard_normal((64, 64)) / 8).astype(np.float32)
    a = (rng.standard_normal((2, 64)) / 8).astype(np.float32)
    dnorm = (1 / np.sqrt(np.maximum(g.in_degrees().astype(np.float32), 1)))[:, None]
    h = (x * dnorm) @ W
    adj, flags = jops.densify_tiles(tiles)
    xsrc = jops.gather_sources(tiles, jnp.asarray(h))
    parts = np.asarray(jops.spmm(jnp.asarray(adj), xsrc, jnp.asarray(tiles.part_id),
                                 jnp.asarray(flags), n_parts=tiles.n_dst_parts))
    rows = np.concatenate([parts[p, :int(tiles.part_size[p])]
                           for p in range(tiles.n_dst_parts)])
    np.testing.assert_allclose(_np(got["gcn"]), np.maximum(rows * dnorm, 0), atol=1e-5)

    e = h[g.src] @ a[0] + h[g.dst] @ a[1]
    e = np.where(e > 0, e, 0.2 * e).astype(np.float32)
    gid = np.clip(tiles.edge_gid, 0, g.n_edges - 1)
    dense = jops.densify_edge_scores(jnp.asarray(e[gid]), jnp.asarray(tiles.edge_dst),
                                     jnp.asarray(tiles.n_edge),
                                     dmax=int(tiles.part_size.max()))
    vals = jnp.take_along_axis(xsrc, jnp.asarray(tiles.edge_src)[..., None], axis=1)
    gparts = np.asarray(jops.gat_aggregate(dense, vals, jnp.asarray(tiles.part_id),
                                           jnp.asarray(flags), n_parts=tiles.n_dst_parts))
    grows = np.concatenate([gparts[p, :int(tiles.part_size[p])]
                            for p in range(tiles.n_dst_parts)])
    np.testing.assert_allclose(_np(got["gat"]), grows, atol=1e-5)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_serve_gnn_outputs_and_counters_equal_the_reference(model):
    from repro.core import compiler
    from repro.gnn import graphs, models
    from repro.serve import InferenceServer
    from repro_torch.launch import serve_gnn

    got = serve_gnn.main(["--device", "cpu", "--model", model, "--requests", "2",
                          "--batch", "3", "--vertices", "24", "--edges", "96"])
    tr = models.trace_named(model)
    server = InferenceServer(compiler.compile_gnn(tr), models.init_params(tr))
    for req in range(2):
        gs = [graphs.random_graph(24, 96, seed=req * 1000 + k, model="powerlaw")
              for k in range(3)]
        outs = server.submit(gs, [models.init_inputs(tr, g, seed=req * 1000 + k)
                                  for k, g in enumerate(gs)])
    assert got["err"] <= serve_gnn.TOL
    for o_t, o_j in zip(got["outputs"], outs):
        for a, b in zip(o_t, o_j):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=5e-4 * max(
                1.0, float(np.abs(np.asarray(b)).max())))
    want = server.stats()
    for k in ("requests", "graphs", "batches", "cache_size", "n_layers"):
        assert got["stats"][k] == want[k], k
    for k in ("hits", "misses", "compiles", "evictions"):
        assert got["stats"]["cache"][k] == want["cache"][k], k


def test_serve_async_results_and_sheds_equal_the_reference():
    from repro.core import executor
    from repro.gnn import models
    from repro.serve import AsyncInferenceServer, Overloaded
    from repro_torch.launch import serve_async

    got = serve_async.main(["--device", "cpu", "--requests", "4", "--deadline", "0.5"])
    assert got["served"] == got["n"] == 8 and got["err"] <= serve_async.TOL
    reqs = {m: serve_async.make_requests(m, 4, v=48, e=192) for m in ("gcn", "gat")}
    for m in ("gcn", "gat"):
        tr = models.trace_named(m)
        for k in (0, 3):
            g, ins = reqs[m][k]
            ref = executor.run_reference(tr, g, ins, models.init_params(tr))
            for a, b in zip(got["results"][m, k], ref):
                np.testing.assert_allclose(_np(a), np.asarray(b), atol=5e-4 * max(
                    1.0, float(np.abs(np.asarray(b)).max())))
    for policy in ("reject-new", "drop-oldest"):
        tiny = AsyncInferenceServer(max_queue=4, shed_policy=policy, default_deadline_s=0.5)
        tiny.register_model("gcn", "gcn", models.init_params(models.trace_named("gcn")),
                            max_batch=4)
        tix = [tiny.submit(g, ins) for g, ins in reqs["gcn"][:8]]
        tiny.close(drain=False)
        shed = [t.result() for t in tix if not t.ok]
        want = (len(shed), sorted({s.reason for s in shed if isinstance(s, Overloaded)}))
        assert tuple(got["sheds"][policy]) == want, policy
    assert got["cache"]["compiles"] == 2


def test_dryrun_hillclimb_and_quickstart_load_neither_jax_nor_repro(tmp_path):
    code = f"""
import sys, json, pathlib, dataclasses
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import SHAPES
from repro_torch.core.exchange import ShardMesh
from repro_torch.launch import dryrun, hillclimb, mesh, quickstart
from repro_torch.launch import kernel_path_demo, serve_async, serve_gnn
SHAPES["t_train"] = (16, 4, "train")
out = pathlib.Path({str(tmp_path)!r})
cfg = reduced(get_config("deepseek-v2-236b"))
rec = dryrun.run_cell("deepseek-v2-236b", "t_train", "single", cfg=cfg,
                      mesh=ShardMesh.abstract(2, 2), report_dir=out)
var = hillclimb.run_variant("deepseek-v2-236b", "t_train", "moe_rs_combine+mb2", cfg=cfg,
                            mesh=ShardMesh.abstract(2, 2), report_dir=out)
q = quickstart.main(["--device", "cpu", "--scale", "0.02"])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(json.dumps(dict(cell=rec["status"], variant=var["status"], bad=bad)))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"cell": "ok", "variant": "ok", "bad": []}
