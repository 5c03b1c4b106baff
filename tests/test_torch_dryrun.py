"""The port's dry run on the meta device (`repro_torch.launch.dryrun`,
`hillclimb`, `mesh`) against `repro.launch.dryrun`'s contract.

* Layouts at production size: for every config x shape x {16 x 16, 2 x 16
  x 16} the port's rank-0 block of every leaf of params, optimizer state,
  cache and batch has the shape and dtype of the reference's
  `shard_shape` on a device-less `AbstractMesh` (Auto axes, built here:
  ROADMAP C.2), with and without FSDP + ZeRO-1; `make_batch_specs` and
  `layer_stack_sizes` equal the reference's.
* Census and FLOPs on reduced configs: the abstract rank's census equals
  what the one-process mesh moves for rank 0 on real CPU tensors, call for
  call, and its FLOP count equals the same step's on CPU tensors; on a
  dense cut where every split divides, rank FLOPs x ranks equal the
  mesh-less step's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import all_configs as j_all_configs  # noqa: E402
from repro.configs.base import shape_applicable as j_applicable  # noqa: E402
from repro_torch import runtime_flags as T_FLAGS  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core.exchange import ShardMesh  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, mesh_device_count  # noqa: E402
from repro_torch.launch.steps import (abstract_state, make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step, maybe_fsdp,
                                      opt_state_bits)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import materialize, shard_params, tree_items  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402

ARCHS = sorted(j_all_configs())
FLAG_SETS = {"plain": {}, "fsdp_zero1": {"fsdp_params": True, "zero1_opt_state": True}}


def _ref_mesh(kind):
    from jax.sharding import AbstractMesh
    if kind == "single":
        return AbstractMesh((16, 16), ("data", "model"))
    return AbstractMesh((2, 16, 16), ("pod", "data", "model"))


def _ref_leaves(tree):
    """(path, block shape, dtype name) of a reference tree of ShapeDtypeStructs."""
    out = []
    for path, sds in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "name", None)) for k in path)
        out.append((keys, tuple(sds.sharding.shard_shape(sds.shape)), str(sds.dtype)))
    return out


def _port_leaves(st, prefix=()):
    return [(prefix + path, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in tree_items(st.blocks[0])]


def _with_flags(flags):
    from repro import runtime_flags as J_FLAGS
    old = (dict(J_FLAGS.OPT), dict(T_FLAGS.OPT))
    J_FLAGS.OPT.update(flags)
    T_FLAGS.OPT.update(flags)
    return J_FLAGS, old


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
@pytest.mark.parametrize("mesh_kind", ["single", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_blocks_equal_the_reference_shard_shapes(arch, mesh_kind, flags):
    from repro.configs.base import get_config as j_get_config
    from repro.launch.steps import abstract_state as j_abstract_state
    J_FLAGS, old = _with_flags(FLAG_SETS[flags])
    try:
        jm = _ref_mesh(mesh_kind)
        tm = make_production_mesh(mesh_kind == "multipod", abstract_rank=0)
        assert mesh_device_count(tm) == jm.size
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        for shape in J_SHAPES:
            if not j_applicable(jcfg, shape)[0]:
                continue
            for with_opt in (False, True):
                jp, jo, jc, jb = j_abstract_state(jcfg, jm, shape, with_opt=with_opt)
                tp, to, tc, tb = abstract_state(tcfg, tm, shape, with_opt=with_opt)
                assert _port_leaves(tp) == _ref_leaves(jp), (shape, "params")
                assert _port_leaves(tb) == _ref_leaves(jb), (shape, "batch")
                assert (jc is None) == (tc is None)
                if jc is not None:
                    assert _port_leaves(tc) == _ref_leaves(jc), (shape, "cache")
                assert (jo is None) == (to is None)
                if jo is not None:
                    want = _ref_leaves(jo)
                    got = [(("step",), tuple(to.step.shape), "int32")]
                    for name in ("m", "v", "m_scale"):
                        if getattr(to, name) is not None:
                            got += _port_leaves(getattr(to, name), (name,))
                    assert to.v_scale is None and jo.v_scale is None
                    assert sorted(got) == sorted(want), (shape, "opt")
                    assert all(t.device.type == "meta" for _, t in tree_items(to.m.blocks[0]))
    finally:
        J_FLAGS.OPT.clear()
        J_FLAGS.OPT.update(old[0])
        T_FLAGS.OPT.clear()
        T_FLAGS.OPT.update(old[1])


def test_batch_specs_and_stack_sizes_equal_the_reference():
    from jax.sharding import PartitionSpec
    from repro.configs.base import get_config as j_get_config
    from repro.data.pipeline import make_batch_specs as j_specs
    from repro.models.lm import layer_stack_sizes as j_sizes
    from repro_torch.data.pipeline import make_batch_specs
    for kind in ("single", "multipod"):
        jm = _ref_mesh(kind)
        tm = make_production_mesh(kind == "multipod", abstract_rank=0)
        for arch in ARCHS:
            jcfg, tcfg = j_get_config(arch), get_config(arch)
            assert lm.layer_stack_sizes(tcfg) == j_sizes(jcfg)
            for shape in J_SHAPES:
                want = j_specs(jcfg, shape, jm)
                got = make_batch_specs(tcfg, shape, tm)
                assert sorted(want) == sorted(got.template)
                for k, sds in want.items():
                    l = got.template[k]
                    assert l.shape == sds.shape and l.dtype == str(sds.dtype)
                    # the port's shards axis is the reference's batch axes
                    jspec = tuple(sds.sharding.spec) + (None,) * (len(l.shape)
                                                                  - len(sds.sharding.spec))
                    tspec = tuple(("pod", "data") if e == "data" and kind == "multipod"
                                  else e for e in got.specs[k])
                    assert PartitionSpec(*tspec) == PartitionSpec(*jspec), (arch, shape, k)
                    assert tuple(got.blocks[0][k].shape) == sds.sharding.shard_shape(sds.shape)


# ---------------------------------------------------------------------------
# census and FLOPs on reduced cells
# ---------------------------------------------------------------------------

CELLS = {"train": (16, 8, "train"), "prefill": (16, 4, "prefill"),
         "decode": (16, 8, "decode")}
MESHES = {"2x2": dict(n_shards=2, model_axis=2, pods=1),
          "2pods": dict(n_shards=4, model_axis=2, pods=2)}


@pytest.fixture()
def cell_shapes():
    for k, v in CELLS.items():
        SHAPES[f"t_{k}"] = v
    yield
    for k in CELLS:
        SHAPES.pop(f"t_{k}", None)


def _cfg(arch):
    cfg = reduced(get_config(arch))
    if cfg.moe is not None:  # every data shard of the two-pod mesh holds experts
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_routed=8))
    return cfg


def _real_blocks(st, gen, scale=0.05):
    """CPU tensors of an abstract tree's block shapes: normal * scale for
    floats, token ids below 256 for ints (the reduced vocabulary)."""
    def one(t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * scale).to(t.dtype)
        return torch.randint(0, 256, t.shape, generator=gen).to(t.dtype)
    blocks = [{k: v for k, v in _map(b, one).items()} for b in st.blocks]
    return dataclasses.replace(st, blocks=blocks)


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _abstract_cpu_args(cfg, mesh, shape):
    """abstract_state's trees as real CPU blocks (params random, moments and
    cache zeros, tokens in the vocabulary)."""
    from repro_torch.optim.adamw import AdamWState
    gen = torch.Generator().manual_seed(0)
    params, opt, cache, batch = abstract_state(cfg, mesh, shape,
                                               with_opt=SHAPES[shape][2] == "train")
    params = _real_blocks(params, gen)
    if opt is not None:
        z = lambda t: dataclasses.replace(t, blocks=[_map(b, lambda x: torch.zeros(
            x.shape, dtype=x.dtype)) for b in t.blocks])
        opt = AdamWState(step=torch.zeros((), dtype=torch.int32), m=z(opt.m), v=z(opt.v),
                         m_scale=None if opt.m_scale is None else z(opt.m_scale), v_scale=None)
    if cache is not None:
        cache = dataclasses.replace(cache, blocks=[_map(b, lambda x: torch.zeros(
            x.shape, dtype=x.dtype)) for b in cache.blocks])
    return params, opt, cache, _real_blocks(batch, gen)


def _run(cfg, mesh, shape, params, opt, cache, rows):
    S, B, kind = SHAPES[shape]
    counter = dryrun.StepCounter()
    mesh.reset_census()
    n0 = mesh.collectives
    with counter:
        if kind == "train":
            make_train_step(cfg, mesh)(params, opt, rows)
        elif kind == "prefill":
            make_prefill_step(cfg, mesh)(params, rows)
        else:
            make_decode_step(cfg, mesh)(params, cache, rows["tokens"], S - 1)
    return counter.flops, mesh.census(), mesh.collectives - n0


def _logical_run(cfg, mesh, shape):
    """The same cell on the one-process mesh of CPU ranks, whole inputs."""
    S, B, kind = SHAPES[shape]
    gen = torch.Generator().manual_seed(0)
    tmpl = maybe_fsdp(lm.model_template(cfg))
    params = shard_params(materialize(gen, tmpl, device="cpu"), tmpl, mesh)
    opt = adamw_init(params, opt_state_bits(cfg)) if kind == "train" else None
    cache = lm.init_cache(cfg, B, S, mesh=mesh) if kind == "decode" else None
    S_tok = S - lm.VLM_PATCHES if cfg.family == "vlm" else S
    rows = {"tokens": torch.randint(0, 256, (B, 1 if kind == "decode" else S_tok),
                                    generator=gen).to(torch.int32)}
    return _run(cfg, mesh, shape, params, opt, cache, rows)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b", "zamba2-2.7b"])
def test_abstract_census_and_flops_equal_real_runs(arch, mesh_name, cell_shapes):
    cfg = _cfg(arch)
    m = MESHES[mesh_name]
    for kind in CELLS:
        shape = f"t_{kind}"
        meta = ShardMesh.abstract(**m)
        rec = dryrun.run_step(cfg, meta, shape)
        census = meta.census()
        # the same step of the abstract rank on CPU tensors counts the same
        cpu = ShardMesh.abstract(**m, device="cpu")
        params, opt, cache, batch = _abstract_cpu_args(cfg, cpu, shape)
        c_flops, c_census, c_calls = _run(cfg, cpu, shape, params, opt, cache, batch.blocks[0])
        assert rec["flops"] == c_flops, (kind, rec["flops"], c_flops)
        assert census == c_census and rec["collectives"] == c_calls, kind
        # rank 0 of the one-process mesh moves what the abstract rank 0 counts
        logical = ShardMesh(["cpu"] * (m["n_shards"] * m["model_axis"]), m["n_shards"],
                            m["model_axis"])
        _, l_census, l_calls = _logical_run(cfg, logical, shape)
        assert l_census == census, (kind, l_census, census)
        assert l_calls == rec["collectives"], kind
        assert rec["memory"]["argument_size_in_bytes"] > 0 and rec["fits"]
        assert rec["kernels"].get("flash_attention", {}).get("calls", 0) > 0 or \
            cfg.family == "moe" and kind == "decode"


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_census_of_every_collective_agrees_across_backends(shape):
    """Each collective, the sharded GNN exchange included, counts the same
    kinds and result bytes for rank 0 on the one-process mesh, on an
    abstract rank and on an abstract rank over CPU tensors, forward and
    (through autograd) backward."""
    K, M = shape
    gen = torch.Generator().manual_seed(0)
    meshes = [ShardMesh(["cpu"] * (K * M), K, M), ShardMesh.abstract(K, M),
              ShardMesh.abstract(K, M, device="cpu")]
    got = []
    for mesh in meshes:
        dev = mesh.rank_device(mesh.local_ranks[0])
        n = len(mesh.local_ranks)
        x = [torch.randn(4, 6, 8, generator=gen).to(dev).requires_grad_() for _ in range(n)]
        outs = [mesh.psum(x, "model"), mesh.pmean(x, "data"),
                mesh.all_gather_axis(x, "model", 2), mesh.psum_scatter(x, "data", 0),
                mesh.all_to_all([t[:K].reshape(K, -1) for t in x], "data"),
                mesh.pmax([t.detach() for t in x], "model")]
        loss = sum(o.float().sum() for os_ in outs[:5] for o in os_)
        torch.autograd.grad(loss, x)
        with torch.no_grad():
            mesh.all_gather([t.detach()[0] for t in x][:len(mesh.local_shards)])
        got.append((mesh.census(), mesh.collectives))
    assert got[0] == got[1] == got[2]
    assert got[0][0][1]["reduce-scatter"] == 2 and got[0][0][1]["all-gather"] == (
        3 if M == 1 else 4)


def test_rank_flops_times_ranks_equal_the_meshless_step(cell_shapes):
    """Train and decode (a mesh's prefill projects only the last position
    onto the vocabulary, the mesh-less one every position)."""
    cfg = _cfg("qwen2-1.5b")
    assert cfg.n_heads % 2 == 0 and cfg.n_kv_heads % 2 == 0 and cfg.vocab % 2 == 0
    for kind in ("train", "decode"):
        shape = f"t_{kind}"
        S, B, _ = SHAPES[shape]
        rank = dryrun.run_step(cfg, ShardMesh.abstract(2, 2), shape)["flops"]
        gen = torch.Generator().manual_seed(0)
        params = materialize(gen, lm.model_template(cfg), device="cpu")
        counter = dryrun.StepCounter()
        with counter:
            if kind == "train":
                rows = {"tokens": torch.randint(0, 256, (B, S), generator=gen).to(torch.int32)}
                make_train_step(cfg)(params, adamw_init(params), rows)
            else:
                tokens = torch.randint(0, 256, (B, 1), generator=gen).to(torch.int32)
                make_decode_step(cfg)(params, lm.init_cache(cfg, B, S, device="cpu"), tokens,
                                      S - 1)
        assert rank * 4 == counter.flops, (kind, rank * 4, counter.flops)


def test_probe_extrapolates_to_the_full_count(cell_shapes):
    """Every stack of a dense and a hybrid cut is linear in its depth, so
    the probes' totals equal the full step's FLOPs and census."""
    for arch in ("qwen2-1.5b", "zamba2-2.7b"):
        cfg = dataclasses.replace(_cfg(arch), n_layers=6 if arch == "zamba2-2.7b" else 3)
        mesh = ShardMesh.abstract(2, 2)
        full = dryrun.run_step(cfg, mesh, "t_prefill", track_memory=False)
        probe = dryrun._probe_costs(cfg, mesh, "t_prefill")
        assert probe["stack_sizes"] == lm.layer_stack_sizes(cfg)
        assert probe["totals"]["flops"] == full["flops"], arch
        assert probe["totals"]["coll_all-reduce"] == full["collective_bytes"]["all-reduce"]
        assert T_FLAGS.PROBE["stack_counts"] is None


def test_the_static_shape_expert_count_equals_bincount():
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    rng = np.random.default_rng(0)
    for T, d, E, k in ((64, 16, 8, 2), (37, 8, 5, 3), (256, 32, 64, 6)):
        x = torch.as_tensor(rng.standard_normal((T, d)), dtype=torch.float32)
        w = torch.as_tensor(rng.standard_normal((d, E)), dtype=torch.float32)
        r = moe_ops.route(x, w, k, capacity=8)
        top_i = torch.topk(torch.softmax((x @ w).float(), -1), k, dim=-1).indices
        want = torch.bincount(top_i.reshape(-1), minlength=E)
        assert r.counts.dtype == want.dtype and torch.equal(r.counts, want)


def test_run_cell_records_and_skips(tmp_path, cell_shapes):
    cfg = _cfg("deepseek-v2-236b")
    rec = dryrun.run_cell("deepseek-v2-236b", "t_train", "single", cfg=cfg,
                          mesh=ShardMesh.abstract(2, 2), report_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert (tmp_path / "single" / "deepseek-v2-236b__t_train.json").exists()
    assert rec["kernels"]["grouped_ffn"]["calls"] > 0
    mem = rec["memory"]
    assert mem["alias_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert rec["probe"]["stack_sizes"] == {"layers": 2, "dense_layers": 1}
    skip = dryrun.run_cell("qwen2-1.5b", "long_500k", "multipod", report_dir=tmp_path)
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]


def test_hillclimb_tokens_errors_and_flag_restore(tmp_path, cell_shapes):
    cfg = _cfg("deepseek-v2-236b")
    before = dict(T_FLAGS.OPT)
    with pytest.raises(ValueError, match="unknown variant token"):
        hillclimb.run_variant("deepseek-v2-236b", "t_train", "mb2+bogus", cfg=cfg,
                              mesh=ShardMesh.abstract(2, 2), report_dir=tmp_path)
    assert T_FLAGS.OPT == before
    got, mb, flags = hillclimb.parse_variant(cfg, "moe_rs_combine+mb2+cap2.0")
    assert mb == 2 and flags["moe_rs_combine"] and got.moe.capacity_factor == 2.0
    rec = hillclimb.run_variant("deepseek-v2-236b", "t_train", "moe_rs_combine+mb2", cfg=cfg,
                                mesh=ShardMesh.abstract(2, 2), report_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["microbatches"] == 2 and T_FLAGS.OPT == before
    base = hillclimb.run_variant("deepseek-v2-236b", "t_train", "baseline", cfg=cfg,
                                 mesh=ShardMesh.abstract(2, 2), report_dir=tmp_path)
    # the flag moves the MoE's combine to a reduce-scatter
    assert rec["collective_counts"]["reduce-scatter"] > base["collective_counts"]["reduce-scatter"]


def test_a_parameter_the_loss_does_not_read_trains_as_in_the_reference():
    """ROADMAP C.10: command-r's parallel block never reads `ln2`; the
    reference's `jax.grad` gives it a zero gradient, and the port's step
    (mesh-less and on a (1, 1) mesh) now does too, where it raised."""
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.launch import steps as jsteps
    from repro.models import lm as jlm
    from repro.models.common import materialize as j_materialize
    from repro.optim import adamw as jadamw
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.models.common import unshard_params

    jcfg = j_reduced(j_get_config("command-r-35b"))
    cfg = reduced(get_config("command-r-35b"))
    assert cfg.parallel_block
    np_tree = jax.tree.map(np.array, j_materialize(
        jax.random.PRNGKey(0), jlm.model_template(jcfg), dtype_override="float32"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jp = jax.tree.map(jnp.asarray, np_tree)
    jp, _, jm = jax.jit(jsteps.make_train_step(jcfg, jmesh, peak_lr=1e-2, total_steps=4))(
        jp, jadamw.adamw_init(jp), {"tokens": jnp.asarray(tokens)})
    want = {path: np.asarray(a) for path, a in tree_items(jp)}
    for mesh in (None, ShardMesh(["cpu"], 1, 1)):
        tp = lm_params_from_reference(np_tree, cfg, device="cpu")
        if mesh is not None:
            tp = shard_params(tp, lm.model_template(cfg), mesh)
        step = make_train_step(cfg, mesh, peak_lr=1e-2, total_steps=4)
        tp, _, tm = step(tp, adamw_init(tp), {"tokens": torch.as_tensor(tokens)})
        if mesh is not None:
            tp = unshard_params(tp)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4 * max(1, float(jm["loss"]))
        for path, t in tree_items(tp):
            w = want[path]
            assert np.abs(t.detach().numpy() - w).max() <= 1e-4 * max(1.0, np.abs(w).max()), path
