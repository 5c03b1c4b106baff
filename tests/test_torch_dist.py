"""The port's mesh across processes on the CPU: `ShardMesh` over
`torch.distributed` gloo ranks (one rank a mesh rank), against the
one-process mesh and against `repro` under `shard_map` on a forced
4-host-device mesh.

Held here, on 2 and 4 gloo ranks spawned with `torch.multiprocessing`
(each run with a `FileStore` in its own temporary directory, a timeout on
the group and a deadline on the join, so a hung rank fails the test):
- `ShardedRunner` (gcn, gat, sage, gin x kernel dispatch, mincut plans over
  bucketed tiles; and a 2 x 2 shards x model mesh) equals the one-process
  `ShardMesh` run bit for bit and reference `ShardedRunner` at 5e-4 relative
  to max(1, max|ref|); each rank's `collectives` equals the census and every
  rank derives the same plan;
- `compressed_psum` over two error-feedback steps equals the reference's at
  fp32 rounding; `ShardMesh.pmax` over either axis equals the one-process
  mesh's bit for bit;
- expert-parallel `moe_layer` at (data, model) = (2, 1), (2, 2), (4, 1) —
  and, in one process, also (1, 1) — plain, under `moe_rs_combine` and under
  `moe_fp8_dispatch`, equals reference `moe_layer` on Auto-axis meshes of
  the same shape, at a capacity where tokens are dropped (so (4, 1) differs
  from (1, 1)); `lm.forward(mesh=...)` of the reduced deepseek-v2 likewise.

Nothing of `repro` is imported at module level: the spawned ranks import
this module to find their entry point and must load no jax.  The reference
runs once, in a subprocess that forces 4 host devices before its first jax
import, beside the ranks.
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import runtime_flags
from repro_torch.configs import get_config, reduced
from repro_torch.core import compiler as tcompiler
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import tiling as ttiling
from repro_torch.core.analysis import exchange_census
from repro_torch.core.exchange import ShardMesh
from repro_torch.distributed.compression import compressed_psum, dequantize_grads, \
    quantize_grads
from repro_torch.gnn import graphs as tgraphs
from repro_torch.gnn import models as tmodels
from repro_torch.models import lm
from repro_torch.models import moe as tmoe
from repro_torch.models.common import materialize, tree_items, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]
GNN_MODELS = ("gcn", "gat", "sage", "gin")
DIM = 16
REL_TOL = 5e-4                      # the engines' parity limit
WORLDS = (2, 4)
MOE_MESHES = ((1, 1), (2, 1), (2, 2), (4, 1))
MOE_FLAGS = ("plain", "moe_rs_combine", "moe_fp8_dispatch")
MOE_TOL = 1e-5                      # fp32 rounding of the same sums
CP_SHAPES = {"a": (6, 5), "b/c": (11,)}
DEADLINE_S = 300


def _moe_cfg():
    """Reduced deepseek-v2 at capacity factor 1.0: 128 tokens in one chunk
    over 8 experts, top-2, so a shard's busiest experts overflow."""
    cfg = reduced(get_config("deepseek-v2-236b"))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))


def _inputs(path):
    """The numpy inputs every process reads: MoE weights and tokens, the
    reduced deepseek-v2's weights (the port's `materialize`, seed 0) and
    tokens, gradients for compressed_psum (per world, step and rank)."""
    rng = np.random.default_rng(0)
    cfg = _moe_cfg()
    d, E, f, fs = cfg.d_model, cfg.moe.n_routed, cfg.moe.d_ff_expert, \
        cfg.moe.d_ff_expert * cfg.moe.n_shared

    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrs = {"moe/router": w(d, E, scale=d ** -0.5),
            "moe/wg": w(E, d, f, scale=d ** -0.5), "moe/wu": w(E, d, f, scale=d ** -0.5),
            "moe/wd": w(E, f, d, scale=f ** -0.5),
            "moe/shared_wg": w(d, fs, scale=d ** -0.5),
            "moe/shared_wu": w(d, fs, scale=d ** -0.5),
            "moe/shared_wd": w(fs, d, scale=fs ** -0.5),
            "x": w(2, 64, d, scale=1.0)}
    lcfg = reduced(get_config("deepseek-v2-236b"))
    for keys, t in tree_items(materialize(torch.Generator().manual_seed(0),
                                          lm.model_template(lcfg), "float32", "cpu")):
        arrs["lmw/" + "/".join(keys)] = t.numpy()
    arrs["lm/tokens"] = rng.integers(0, lcfg.vocab, (2, 16)).astype(np.int32)
    for n in WORLDS:
        for step in range(2):
            for key, shape in CP_SHAPES.items():
                scale = 1e-3 if key == "b/c" else 1.0
                arrs[f"cp/{n}/{step}/{key}"] = w(n, *shape, scale=scale)
    np.savez(path, **arrs)


def _load(tmp):
    with np.load(Path(tmp) / "inputs.npz") as z:
        return {k: z[k] for k in z.files}


def _moe_params(arrs):
    return {k.split("/", 1)[1]: torch.as_tensor(v) for k, v in arrs.items()
            if k.startswith("moe/")}


def _cp_trees(arrs, n, step, rank):
    return {"a": torch.as_tensor(arrs[f"cp/{n}/{step}/a"][rank]),
            "b": {"c": torch.as_tensor(arrs[f"cp/{n}/{step}/b/c"][rank])}}


def _gnn(name):
    g = tgraphs.random_graph(150, 600, seed=3, model="powerlaw", n_edge_types=3)
    tr = tmodels.trace_stacked(name, 2, DIM, DIM, DIM)
    bt = ttiling.bucket_tiles(ttiling.grid_tile(g, 5, 5, sparse=True), 3)
    return (g, tcompiler.compile_gnn(tr), bt, tmodels.init_params(tr, seed=1),
            tmodels.init_inputs(tr, g, seed=2))


def _gnn_cases(world):
    """(name, dispatch, K, M) a world runs: K = world shards, and on 4 ranks
    a 2 x 2 shards x model mesh."""
    cases = [(n, d, world, 1) for n in GNN_MODELS for d in (True, False)]
    if world == 4:
        cases += [(n, True, 2, 2) for n in ("gcn", "gat")]
    return cases


def _plan_key(r):
    return tuple(tuple(int(p) for p in parts) for parts in r.plan.parts_of_shard)


def _set_flag(flag):
    for key in MOE_FLAGS[1:]:
        runtime_flags.OPT[key] = key == flag


def _run_moe(mesh, arrs, flag, token_chunks=1):
    _set_flag(flag)
    try:
        return tmoe.moe_layer(_moe_cfg(), _moe_params(arrs), torch.as_tensor(arrs["x"]),
                              mesh=mesh, token_chunks=token_chunks)
    finally:
        _set_flag("plain")


# ---------------------------------------------------------------------------
# one gloo rank
# ---------------------------------------------------------------------------

def _pmax_input(rank):
    """Rank ``rank``'s (3, 5) tensor for ``pmax``: every entry's max falls on
    some rank, with ties (the rounded values repeat across ranks)."""
    return torch.as_tensor(np.round(np.random.default_rng(40 + rank)
                                    .standard_normal((3, 5)), 1), dtype=torch.float32)


def _rank_main(rank, world, tmp):
    """Entry point of a spawned rank: every case of its world, results to
    ``rank{world}_{rank}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store{world}", world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    arrs = _load(tmp)
    out = {}
    meshes = {M: ShardMesh.from_process_group(M, device="cpu") for M in (1, 2)
              if world % M == 0}
    with torch.no_grad():
        for name, dispatch, K, M in _gnn_cases(world):
            g, c, bt, params, inputs = _gnn(name)
            mesh = meshes[M]
            mesh.collectives = 0
            r = tpipeline.ShardedRunner(c, g, bt, mode="mincut", kernel_dispatch=dispatch,
                                        mesh=mesh)
            out[f"gnn/{name}/{dispatch}/{K}x{M}"] = (r(inputs, params)[0],
                                                     mesh.collectives, _plan_key(r))
        for M, axis in ((1, "shards"), (2, "model"), (2, "shards")):
            if M in meshes:
                mesh = meshes[M]
                mesh.collectives = 0
                got = mesh.pmax([_pmax_input(rank)], axis)[0]
                out[f"pmax/{M}/{axis}"] = (got, mesh.collectives)
        mesh = meshes[1]
        mesh.collectives, res = 0, None
        for step in range(2):
            means, res = compressed_psum([_cp_trees(arrs, world, step, rank)], mesh,
                                         "shards", res)
            out[f"cp/{step}"] = (means[0], res[0])
        out["cp/collectives"] = mesh.collectives
        for n_data, n_model in MOE_MESHES:
            if n_data * n_model != world:
                continue
            mesh = meshes[n_model]
            for flag in MOE_FLAGS:
                out[f"moe/{n_data}x{n_model}/{flag}"] = _run_moe(mesh, arrs, flag)
    out["jax_or_repro_modules"] = sorted(m for m in sys.modules
                               if m.startswith("jax") or m.split(".")[0] == "repro")
    torch.save(out, f"{tmp}/rank{world}_{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference, once, on a forced 4-host-device mesh
# ---------------------------------------------------------------------------

_PRELUDE = """
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
tmp, out = sys.argv[1], {}
z = dict(np.load(os.path.join(tmp, "inputs.npz")))
"""

# reference ShardedRunner, K = 4 mincut over bucketed tiles
_REFERENCE_GNN = _PRELUDE + textwrap.dedent("""
    from repro.core import compiler, pipeline, tiling
    from repro.gnn import graphs, models

    g = graphs.random_graph(150, 600, seed=3, model="powerlaw", n_edge_types=3)
    bt = tiling.bucket_tiles(tiling.grid_tile(g, 5, 5, sparse=True), 3)
    for name in ("gcn", "gat", "sage", "gin"):
        tr = models.trace_stacked(name, 2, 16, 16, 16)
        c = compiler.compile_gnn(tr)
        params = models.init_params(tr, seed=1)
        inputs = models.init_inputs(tr, g, seed=2)
        for dispatch in (True, False):
            r = pipeline.ShardedRunner(c, g, bt, 4, mode="mincut",
                                       kernel_dispatch=dispatch)
            out[f"gnn/{name}/{dispatch}/4"] = np.asarray(r(inputs, params)[0])
    np.savez(os.path.join(tmp, "ref_gnn.npz"), **out)
""")

# reference compressed_psum, moe_layer and lm.forward under shard_map
_REFERENCE_LM = _PRELUDE + textwrap.dedent("""
    from repro import runtime_flags
    from repro.configs import get_config, reduced
    from repro.distributed.compression import compressed_psum
    from repro.jax_compat import shard_map
    from repro.models import lm, moe

    def body(gs, rs):
        gs, rs = (jax.tree.map(lambda a: a[0], t) for t in (gs, rs))
        m, r = compressed_psum(gs, "pod", rs)
        return jax.tree.map(lambda a: a[None], (m, r))

    for n in (2, 4):
        mesh = jax.make_mesh((n,), ("pod",), devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,))
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                               out_specs=(P("pod"), P("pod")), check_vma=False))
        res = None
        for step in range(2):
            g_ = {"a": z[f"cp/{n}/{step}/a"], "b": {"c": z[f"cp/{n}/{step}/b/c"]}}
            # step 0's residuals are zeros: g + 0 quantizes as g does
            mean, res = fn(g_, jax.tree.map(np.zeros_like, g_) if res is None else res)
            for key, a in (("mean/a", mean["a"]), ("mean/b/c", mean["b"]["c"]),
                           ("res/a", res["a"]), ("res/b/c", res["b"]["c"])):
                out[f"cp/{n}/{step}/{key}"] = np.asarray(a)

    def meshes(shapes):
        for shape in shapes:
            yield shape, jax.make_mesh(shape, ("data", "model"),
                                       devices=jax.devices()[:shape[0] * shape[1]],
                                       axis_types=(AxisType.Auto, AxisType.Auto))

    cfg = reduced(get_config("deepseek-v2-236b"))
    mcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    p = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in z.items()
         if k.startswith("moe/")}
    for (nd, nm), mesh in meshes(((1, 1), (2, 1), (2, 2), (4, 1))):
        for flag in ("plain", "moe_rs_combine", "moe_fp8_dispatch"):
            for key in ("moe_rs_combine", "moe_fp8_dispatch"):
                runtime_flags.OPT[key] = key == flag
            y, aux = jax.jit(lambda p, x: moe.moe_layer(mcfg, p, x, mesh=mesh,
                                                        token_chunks=1))(p, z["x"])
            out[f"moe/{nd}x{nm}/{flag}/y"] = np.asarray(y)
            out[f"moe/{nd}x{nm}/{flag}/aux"] = np.asarray(aux)
    for key in ("moe_rs_combine", "moe_fp8_dispatch"):
        runtime_flags.OPT[key] = False

    w = {}
    for key, a in z.items():
        if key.startswith("lmw/"):
            node = w
            *path, leaf = key[4:].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(a)
    for (nd, nm), mesh in meshes(((2, 2), (4, 1))):
        logits, aux = jax.jit(lambda w, t: lm.forward(cfg, w, {"tokens": t},
                                                      mesh=mesh))(w, z["lm/tokens"])
        out[f"lm/{nd}x{nm}/logits"] = np.asarray(logits)
        out[f"lm/{nd}x{nm}/aux"] = np.asarray(aux)
    np.savez(os.path.join(tmp, "ref_lm.npz"), **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the reference subprocess and the 2- and 4-rank gloo worlds side
    by side; returns ({world: [per-rank results]}, reference arrays, the
    inputs)."""
    tmp = tmp_path_factory.mktemp("dist")
    _inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    refs = [subprocess.Popen([sys.executable, "-c", src, str(tmp)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src in (_REFERENCE_GNN, _REFERENCE_LM)]
    ctxs = {w: mp.start_processes(_rank_main, args=(w, str(tmp)), nprocs=w, join=False,
                                  start_method="spawn") for w in WORLDS}
    deadline = time.monotonic() + DEADLINE_S
    try:
        for w, ctx in ctxs.items():
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    pytest.fail(f"the {w}-rank gloo world did not finish in {DEADLINE_S} s")
        for ref in refs:
            _, err = ref.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert ref.returncode == 0, err[-3000:]
    finally:
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
    ranks = {w: [torch.load(tmp / f"rank{w}_{r}.pt", weights_only=False) for r in range(w)]
             for w in WORLDS}
    ref = {**np.load(tmp / "ref_gnn.npz"), **np.load(tmp / "ref_lm.npz")}
    return ranks, ref, _load(tmp)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _one_process(name, dispatch, K, M):
    g, c, bt, params, inputs = _gnn(name)
    r = tpipeline.ShardedRunner(c, g, bt, K, mode="mincut", kernel_dispatch=dispatch,
                                model_axis=M, devices=["cpu"] * (K * M), device="cpu")
    with torch.no_grad():
        out = r(inputs, params)[0]
    return out, r, c.schedule(dispatch)


# ---------------------------------------------------------------------------
# ShardedRunner on gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dispatch,K,M",
                         sorted({c for w in WORLDS for c in _gnn_cases(w)}, key=str))
def test_sharded_runner_on_gloo_ranks(runs, name, dispatch, K, M):
    """Every rank returns the one-process mesh's output bit for bit, counts
    the census's collectives and derives the same plan; at K = 4 the output
    also equals reference ShardedRunner's on the forced 4-device mesh (the
    one-process mesh at K = 2 is held against the reference's engines in
    tests/test_torch_sharded.py)."""
    ranks, ref, _ = runs
    want, r, sp = _one_process(name, dispatch, K, M)
    census = exchange_census(sp).n_collectives
    for res in ranks[K * M]:
        out, collectives, plan = res[f"gnn/{name}/{dispatch}/{K}x{M}"]
        assert torch.equal(out, want)
        assert collectives == census == 2
        assert plan == _plan_key(r)
    assert r.mesh.collectives == census
    if (K, M) == (4, 1):
        assert _rel_err(want, ref[f"gnn/{name}/{dispatch}/4"]) < REL_TOL


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_load_neither_jax_nor_repro(runs, world):
    ranks, _, _ = runs
    assert all(res["jax_or_repro_modules"] == [] for res in ranks[world])


def test_group_mesh_layout_and_refusals(tmp_path):
    """A one-rank gloo group: the mesh's layout, the one-process mesh's
    answers for each collective and its gradient, and the refusals (a model
    axis that does not divide the group, NCCL on the CPU is not asked here,
    a gradient through the shards all_gather)."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        mesh = ShardMesh.from_process_group(device="cpu")
        assert (mesh.n_shards, mesh.model_axis, mesh.local_ranks, mesh.local_shards) == \
            (1, 1, [0], [0])
        one = ShardMesh(["cpu"], 1)
        x = torch.arange(12.0).reshape(1, 3, 4)
        for got, want in ((mesh.all_gather([x]), one.all_gather([x])),
                          (mesh.all_to_all([x], "data"), one.all_to_all([x], "data")),
                          (mesh.psum([x], "model"), one.psum([x], "model")),
                          (mesh.pmean([x], "shards"), one.pmean([x], "shards")),
                          (mesh.psum_scatter([x], "model", 2),
                           one.psum_scatter([x], "model", 2)),
                          (mesh.all_gather_axis([x], "data", 1),
                           one.all_gather_axis([x], "data", 1))):
            assert torch.equal(got[0], want[0])
        f8 = mesh.all_to_all([x.to(torch.float8_e4m3fn)], "data")[0]
        assert f8.dtype == torch.float8_e4m3fn and torch.equal(f8.float(), x)
        assert (mesh.collectives, one.collectives) == (7, 6)
        with pytest.raises(ValueError, match="does not divide"):
            ShardMesh.from_process_group(2, device="cpu")
        with pytest.raises(ValueError, match="unknown mesh axis"):
            mesh.psum([x], "pod")
        # autograd passes through the axis collectives (each backward is its
        # transposed collective, counted) and refuses the shards all_gather
        before = mesh.collectives
        for call in (lambda m, t: m.psum([t], "model"),
                     lambda m, t: m.all_gather_axis([t], "data", 1),
                     lambda m, t: m.psum_scatter([t], "model", 2),
                     lambda m, t: m.all_to_all([t], "data")):
            grads = []
            for m in (mesh, one):
                t = x.clone().requires_grad_()
                (call(m, t)[0] * x).sum().backward()
                grads.append(t.grad)
            assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], x)
        assert mesh.collectives - before == 8
        with pytest.raises(NotImplementedError, match="not differentiable"):
            mesh.all_gather([x.reshape(-1).clone().requires_grad_()])
        with pytest.raises(ValueError, match="not driven by this rank"):
            mesh.shard_device(1)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ShardMesh.from_process_group()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_matches_reference(runs, world):
    """Two error-feedback steps over 2 and 4 gloo ranks and over the
    one-process mesh: means and residuals equal the reference's under
    shard_map at fp32 rounding; one psum a leaf."""
    ranks, ref, arrs = runs
    mesh = ShardMesh(["cpu"] * world, world)
    res = None
    for step in range(2):
        trees = [_cp_trees(arrs, world, step, r) for r in range(world)]
        means, res = compressed_psum(trees, mesh, "shards", res)
        for r in range(world):
            got_mean, got_res = ranks[world][r][f"cp/{step}"]
            for key, got, one in (("a", got_mean["a"], means[r]["a"]),
                                  ("b/c", got_mean["b"]["c"], means[r]["b"]["c"])):
                want = ref[f"cp/{world}/{step}/mean/{key}"][r]
                assert _rel_err(got, want) < 1e-6 and _rel_err(one, want) < 1e-6
            for key, got, one in (("a", got_res["a"], res[r]["a"]),
                                  ("b/c", got_res["b"]["c"], res[r]["b"]["c"])):
                want = ref[f"cp/{world}/{step}/res/{key}"][r]
                assert torch.equal(got, one)
                assert _rel_err(got, want) < 1e-6
    assert mesh.collectives == 4
    assert all(res["cp/collectives"] == 4 for res in ranks[world])


@pytest.mark.parametrize("M,axis", [(1, "shards"), (2, "model"), (2, "shards")])
@pytest.mark.parametrize("world", WORLDS)
def test_pmax_on_gloo_ranks_matches_one_process(runs, world, M, axis):
    """``ShardMesh.pmax`` (the 8-bit moments' row scales) under the group:
    each rank's result equals the one-process mesh's for that rank, bit for
    bit, and counts one collective."""
    ranks, _, _ = runs
    mesh = ShardMesh(["cpu"] * world, world // M, M)
    want = mesh.pmax([_pmax_input(r) for r in range(world)], axis)
    assert mesh.collectives == 1
    for r in range(world):
        got, n = ranks[world][r][f"pmax/{M}/{axis}"]
        assert torch.equal(got, want[r]) and n == 1
    peers = [r for r in range(world) if mesh.axis_index(r, "model") == 0] \
        if axis == "shards" else list(range(M))
    np.testing.assert_array_equal(
        want[0].numpy(), np.max([_pmax_input(r).numpy() for r in peers], axis=0))


def test_compressed_psum_of_one_rank_is_dequantize_of_quantize():
    """What chip_smoke checks on one NCCL rank: over an axis of one, the
    mean is dequantize(quantize(g)) and the residual quantize's, bit for
    bit."""
    g = {"w": torch.randn(7, 9, generator=torch.Generator().manual_seed(0)),
         "b": {"c": torch.linspace(-3e-3, 2e-3, 5)}}
    mesh = ShardMesh(["cpu"], 1)
    (mean,), (res,) = compressed_psum([g], mesh, "shards")
    q, s, want_res = quantize_grads(g)
    want = dequantize_grads(q, s)
    for a, b in ((mean["w"], want["w"]), (mean["b"]["c"], want["b"]["c"]),
                 (res["w"], want_res["w"]), (res["b"]["c"], want_res["b"]["c"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", MOE_FLAGS)
@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_moe_layer_matches_reference(runs, shape, flag):
    """One process (and, where the mesh has 2 or 4 ranks, every gloo rank)
    against reference moe_layer on the Auto-axis mesh of the same shape."""
    ranks, ref, arrs = runs
    n_data, n_model = shape
    key = f"moe/{n_data}x{n_model}/{flag}"
    want_y, want_aux = ref[f"{key}/y"], ref[f"{key}/aux"]
    mesh = ShardMesh(["cpu"] * (n_data * n_model), n_data, n_model)
    with torch.no_grad():
        y, aux = _run_moe(mesh, arrs, flag)
    assert y.shape == want_y.shape and y.dtype == torch.float32
    if flag == "moe_fp8_dispatch":      # the option took effect on both sides
        assert _rel_err(want_y, ref[f"moe/{n_data}x{n_model}/plain/y"]) > 100 * MOE_TOL
    assert _rel_err(y, want_y) < MOE_TOL and _rel_err(aux, want_aux) < MOE_TOL
    results = [(y, aux)]
    if n_data * n_model in ranks:
        results += [res[key] for res in ranks[n_data * n_model]]
    for ry, raux in results[1:]:
        assert _rel_err(ry, want_y) < MOE_TOL and _rel_err(raux, want_aux) < MOE_TOL
        assert _rel_err(ry, y) < MOE_TOL
    # collectives of the body: all_to_all out and back when n_data > 1,
    # the model reduction, the rs path's gather, the aux pmean, the shared
    # experts' psum over model, the token gather
    rs = flag == "moe_rs_combine" and n_model > 1
    assert mesh.collectives == 2 * (n_data > 1) + 1 + rs + (n_data > 1) + 1 + 1


def test_moe_meshes_drop_tokens_and_differ(runs):
    """The capacity drops assignments at every mesh shape, and the (4, 1)
    result differs from the (1, 1) one (the test can tell the meshes
    apart); the reference's do the same."""
    _, ref, arrs = runs
    x = torch.as_tensor(arrs["x"])
    drops = {n: tmoe.count_dropped(_moe_cfg(), _moe_params(arrs), x, n_data=n,
                                   token_chunks=1) for n in (1, 2, 4)}
    assert all(v > 0 for v in drops.values()), drops
    one = ref["moe/1x1/plain/y"]
    assert _rel_err(ref["moe/4x1/plain/y"], one) > 100 * MOE_TOL
    mesh = ShardMesh(["cpu"] * 4, 4)
    with torch.no_grad():
        y4, _ = _run_moe(mesh, arrs, "plain")
        y1, _ = _run_moe(ShardMesh(["cpu"], 1), arrs, "plain")
        y0, _ = _run_moe(None, arrs, "plain")
    assert _rel_err(y4, y1) > 100 * MOE_TOL
    assert _rel_err(y1, y0) < MOE_TOL          # (1, 1) is the mesh-less layer


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_lm_forward_with_a_mesh_matches_reference(runs, shape):
    """lm.forward(mesh=...) of the reduced deepseek-v2 (one dense and one
    MoE layer, the default 4 token chunks) against the reference's forward
    on the Auto-axis mesh of that shape; loss_fn takes the mesh too."""
    _, ref, arrs = runs
    cfg = reduced(get_config("deepseek-v2-236b"))
    tmpl = lm.model_template(cfg)
    params = tree_unflatten(tmpl, [torch.as_tensor(arrs["lmw/" + "/".join(path)])
                                   for path, _ in tree_items(tmpl)])
    tokens = torch.as_tensor(arrs["lm/tokens"]).long()
    mesh = ShardMesh(["cpu"] * (shape[0] * shape[1]), *shape)
    with torch.no_grad():
        logits, aux = lm.forward(cfg, params, {"tokens": tokens}, mesh=mesh)
        loss = lm.loss_fn(cfg, params, {"tokens": tokens}, mesh=mesh)
    key = f"lm/{shape[0]}x{shape[1]}"
    assert _rel_err(logits, ref[f"{key}/logits"]) < MOE_TOL
    assert _rel_err(aux, ref[f"{key}/aux"]) < MOE_TOL
    assert torch.isfinite(loss)


def test_concurrent_builds_of_one_source_run_nvcc_once(tmp_path, monkeypatch):
    """K ranks of a host building one kernel source: the build lock lets one
    compile (a stand-in compiler here, which counts its runs and takes half
    a second) while the others wait and load its library."""
    import threading
    from repro_torch.kernels import _build

    runs = tmp_path / "runs"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo run >> {runs}\n"
                    "sleep 0.5\n"
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    fake.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(_build.build(src)))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(paths) == 3 and len(set(paths)) == 1
    assert paths[0].read_text() == "built\n"
    assert runs.read_text().count("run") == 1
