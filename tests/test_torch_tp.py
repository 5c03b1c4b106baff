"""The LM laid out by its specs on the port's one-process `ShardMesh`,
against `mesh=None` and against `repro` under an Auto-axis mesh of forced
host devices.

Held here, fp32, inputs from numpy seeds:
- `resolve_spec` / `sanitize_spec` / `spec_tree` equal the reference's on
  every leaf of every config's model and cache templates, under
  `maybe_fsdp` and of `adamw_state_template` under ZeRO-1 (the reference
  reads only `mesh.axis_names` and `mesh.shape`, so a plain stand-in serves
  it); `shard_params` then `unshard_params` is the identity;
- GQA, MLA, the dense and GELU FFNs, the shared experts and `lm.forward` /
  `loss_fn` (value and every whole leaf's gradient) / `decode_step` at
  (data, model) = (1, 2), (2, 2), (2, 4) against `mesh=None` at `MOE_TOL`
  (deepseek-v2 against `mesh=None` routing the same token blocks), and
  against the reference's `forward`, `jax.value_and_grad(loss_fn)` and
  `decode_step` (at (2, 4)) on the Auto-axis mesh of that shape for
  reduced qwen2, smollm, qwen2-vl (16 stub patches) and deepseek-v2, and
  at (2, 4) smollm at 6 heads / 3 KV heads, which a 4-wide model axis
  divides neither of: `_attn_batch_spec`'s two branches;
- `make_train_step(cfg, mesh)`: the scenario of `tests/test_opt_flags.py`
  (reduced smollm, 8 x 16 tokens), plain and under `zero1_opt_state` +
  `fsdp_params` with 2 microbatches, two steps' losses, grad norms,
  moments and parameters against `mesh=None` and against the reference's
  `make_train_step` on the same mesh; ZeRO-1 halves rank 0's moment bytes
  over a data axis of 2;
- the MoE `combine` (ROADMAP C.8) is a fixed-order token-major sum.

The reference runs once, in a subprocess that forces 8 host devices before
its first jax import, while the tests of this module that do not read it
run.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import runtime_flags as j_flags
from repro.configs import all_configs as j_all_configs
from repro.kernels.moe_dispatch import ops as j_moe_ops
from repro.launch import steps as j_steps
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.optim import adamw as j_adamw
from repro_torch import runtime_flags
from repro_torch.configs import all_configs, get_config, reduced
from repro_torch.core.exchange import ShardMesh
from repro_torch.kernels.moe_dispatch import ops as moe_ops
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw as tadamw

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 2), (2, 4))
REF_MESHES = MESHES                 # the reference's runs (its decode at the last)
SPEC_MESHES = ((1, 2), (2, 2), (2, 4), (4, 1))
MOE_TOL = 1e-5            # fp32 rounding of the same sums, x max(1, max|ref|)
BATCH, SEQ = 8, 16        # 8 rows split over every axis of a (2, 4) mesh
ROWS = 4                  # the other archs' rows: 2 a data shard
PATCHES = 16              # vlm stub patches ahead of the tokens (any count goes)
DECODE_STEPS, CACHE_LEN = 3, 8
ARCHS = ("qwen2-1.5b", "smollm-135m", "smollm-6h", "qwen2-vl-72b", "deepseek-v2-236b")
TRAIN_SETTINGS = {"plain": ((), 1), "zero1_fsdp_mb2": (("zero1_opt_state", "fsdp_params"), 2)}
TRAIN_MESH = (2, 4)


def _cfg(arch):
    """The reduced config; "smollm-6h" is reduced smollm at 6 heads and 3 KV
    heads (head dim 16)."""
    if arch == "smollm-6h":
        return dataclasses.replace(reduced(get_config("smollm-135m")), n_heads=6,
                                   n_kv_heads=3)
    return reduced(get_config(arch))


def _rel_err(got, want):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _mesh(shape):
    return ShardMesh(["cpu"] * (shape[0] * shape[1]), *shape)


def _weights(arch, seed=0):
    """The port's fp32 weights of ``arch`` (its own ``materialize``), whole."""
    cfg = _cfg(arch)
    return C.materialize(torch.Generator().manual_seed(seed), lm.model_template(cfg),
                         "float32", "cpu")


def _batch(arch, seed=1):
    cfg = _cfg(arch)
    rng = np.random.default_rng(seed)
    rows = BATCH if arch == "smollm-6h" else ROWS
    b = {"tokens": rng.integers(0, cfg.vocab, (rows, SEQ)).astype(np.int64)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal((rows, PATCHES, cfg.d_model)) \
            .astype(np.float32)
    return b


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the reference, once, on forced host devices
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import runtime_flags
    from repro.configs import get_config, reduced
    from repro.launch.steps import make_train_step
    from repro.models import lm
    from repro.models.common import cross_entropy, materialize
    from repro.optim.adamw import adamw_init

    tmp = sys.argv[1]
    z = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = {}

    def cfg_of(arch):
        if arch == "smollm-6h":
            return dataclasses.replace(reduced(get_config("smollm-135m")), n_heads=6,
                                       n_kv_heads=3)
        return reduced(get_config(arch))

    def tree(prefix):
        w = {}
        for key, a in z.items():
            if key.startswith(prefix):
                node = w
                *path, leaf = key[len(prefix):].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(a)
        return w

    def flat(prefix, t):
        for k in sorted(t):
            if isinstance(t[k], dict):
                flat(prefix + k + "/", t[k])
            else:
                out[prefix + k] = np.asarray(t[k])

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             devices=jax.devices()[:shape[0] * shape[1]],
                             axis_types=(AxisType.Auto, AxisType.Auto))

    for arch in %(archs)r:
        cfg = cfg_of(arch)
        w = tree(f"w/{arch}/")
        b = {k.split("/")[-1]: jnp.asarray(v) for k, v in z.items()
             if k.startswith(f"b/{arch}/")}
        for shape in %(meshes)r:
            if arch == "smollm-6h" and shape != (2, 4):
                continue
            m = mesh_of(shape)
            key = f"{arch}/{shape[0]}x{shape[1]}"
            # lm.loss_fn, with the forward's logits kept: one compile
            def loss(w, b):
                o = lm.forward(cfg, w, b, mesh=m)
                logits, aux = (o if cfg.family == "moe" else (o, 0.0))
                extra = 1e-3 * aux if cfg.family == "moe" and not cfg.moe.aux_free_bias \
                    else 0.0
                return cross_entropy(logits[:, :-1], b["tokens"][:, 1:]) + extra, logits
            (l, o), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(w, b)
            out[key + "/logits"] = np.asarray(o)
            out[key + "/loss"] = np.asarray(l)
            flat(key + "/grad/", g)
            if shape != %(meshes)r[-1]:
                continue
            cache = materialize(jax.random.PRNGKey(0),
                                lm.cache_template(cfg, b["tokens"].shape[0], %(cache_len)d),
                                dtype_override="float32")
            step = jax.jit(lambda w, c, t, p: lm.decode_step(cfg, w, c, t, p, mesh=m))
            for pos in range(%(steps)d):
                logits, cache = step(w, cache, b["tokens"][:, pos:pos + 1], pos)
                out[f"{key}/decode/{pos}"] = np.asarray(logits)
        if arch == "smollm-6h":
            m = mesh_of((2, 4))
            runtime_flags.OPT["attn_batch_shard"] = True
            o = jax.jit(lambda w, b: lm.forward(cfg, w, b, mesh=m))(w, b)
            runtime_flags.OPT["attn_batch_shard"] = False
            out[f"{arch}/2x4/batch_shard/logits"] = np.asarray(o)

    cfg = cfg_of("smollm-135m")
    m = mesh_of(%(train_mesh)r)
    for name, (flags, mb) in %(settings)r.items():
        for k in flags:
            runtime_flags.OPT[k] = True
        w = tree("w/smollm-135m/")
        opt = adamw_init(w)
        step = jax.jit(make_train_step(cfg, m, peak_lr=1e-2, total_steps=4, microbatches=mb))
        for i in range(2):
            w, opt, met = step(w, opt, {"tokens": jnp.asarray(z[f"train/tokens/{i}"])})
            out[f"train/{name}/loss/{i}"] = np.asarray(met["loss"])
            out[f"train/{name}/grad_norm/{i}"] = np.asarray(met["grad_norm"])
        for k in flags:
            runtime_flags.OPT[k] = False
        flat(f"train/{name}/params/", w)
        flat(f"train/{name}/m/", opt.m)
        flat(f"train/{name}/v/", opt.v)
    np.savez(os.path.join(tmp, "ref.npz"), **out)
""") % dict(archs=ARCHS, meshes=REF_MESHES, cache_len=CACHE_LEN, steps=DECODE_STEPS,
            train_mesh=TRAIN_MESH, settings=TRAIN_SETTINGS)


def _train_tokens(i):
    cfg = _cfg("smollm-135m")
    return np.random.default_rng(10 + i).integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    """Starts the reference subprocess on this module's inputs; tests that
    read it wait through :func:`ref`."""
    tmp = tmp_path_factory.mktemp("tp")
    arrs = {}
    for arch in ARCHS:
        for path, t in C.tree_items(_weights(arch)):
            arrs[f"w/{arch}/" + "/".join(path)] = t.numpy()
        for k, v in _batch(arch).items():
            arrs[f"b/{arch}/{k}"] = v.astype(np.int32) if k == "tokens" else v
    for i in range(2):
        arrs[f"train/tokens/{i}"] = _train_tokens(i)
    np.savez(tmp / "inputs.npz", **arrs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {"proc": proc, "tmp": tmp, "out": None}
    yield box
    if proc.poll() is None:
        proc.kill()


@pytest.fixture
def ref(ref_proc):
    if ref_proc["out"] is None:
        _, err = ref_proc["proc"].communicate(timeout=600)
        assert ref_proc["proc"].returncode == 0, err[-3000:]
        ref_proc["out"] = dict(np.load(ref_proc["tmp"] / "ref.npz"))
    return ref_proc["out"]


# the fixture starts early: the first test of the module asks for it
def test_reference_starts(ref_proc):
    assert ref_proc["proc"].poll() in (None, 0)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _stand_in(shape):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": shape[0], "model": shape[1]})


def _templates(name, t_cfg, j_cfg):
    """(label, port template, reference template) pairs of one config: the
    model, a cache of 3 and of 8 rows, the model under FSDP and the AdamW
    moments of it under ZeRO-1."""
    out = [("model", lm.model_template(t_cfg), jlm.model_template(j_cfg))]
    for b in (3, 8):
        out.append((f"cache{b}", lm.cache_template(t_cfg, b, 64),
                    jlm.cache_template(j_cfg, b, 64)))
    for flags in (runtime_flags.OPT, j_flags.OPT):
        flags["fsdp_params"] = flags["zero1_opt_state"] = True
    try:
        tf = tsteps.maybe_fsdp(lm.model_template(t_cfg))
        jf = j_steps.maybe_fsdp(jlm.model_template(j_cfg))
        out.append(("fsdp", tf, jf))
        out.append(("zero1_m", tadamw.adamw_state_template(tf)["m"],
                    j_adamw.adamw_state_template(jf)["m"]))
    finally:
        for flags in (runtime_flags.OPT, j_flags.OPT):
            flags["fsdp_params"] = flags["zero1_opt_state"] = False
    return out


def _jax_leaves(tree):
    return [l for l in jax.tree.leaves(tree, is_leaf=jcommon.is_leaf)]


@pytest.mark.parametrize("shape", SPEC_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(all_configs()))
def test_specs_match_reference(name, shape):
    """Every leaf's resolved spec (``spec_tree``) and its sanitized layout
    equal the reference's, on the full-size templates."""
    t_cfg, j_cfg = all_configs()[name], j_all_configs()[name]
    mesh, stand_in = _mesh(shape), _stand_in(shape)
    for label, tt, jt in _templates(name, t_cfg, j_cfg):
        t_leaves = [l for _, l in C.tree_items(tt)]
        j_leaves = _jax_leaves(jt)
        assert len(t_leaves) == len(j_leaves), label
        t_specs = [s for _, s in C.tree_items(C.spec_tree(tt, mesh))]
        j_specs = jax.tree.leaves(jcommon.spec_tree(jt, stand_in),
                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for tl, jl, ts, js in zip(t_leaves, j_leaves, t_specs, j_specs):
            assert tl.shape == jl.shape and tl.spec == jl.spec, label
            assert ts == tuple(js), (label, tl, ts, js)
            got = C.sanitize_spec(C.resolve_spec(tl.spec, mesh), tl.shape, mesh)
            want = jcommon.sanitize_spec(jcommon.resolve_spec(jl.spec, stand_in), jl.shape,
                                         stand_in)
            assert got == tuple(want) + (None,) * (len(got) - len(tuple(want))), (label, tl)


@pytest.mark.parametrize("shape", MESHES + ((4, 1),), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "smollm-6h", "deepseek-v2-236b",
                                  "whisper-large-v3", "xlstm-1.3b", "zamba2-2.7b"])
def test_shard_then_unshard_is_the_identity(arch, shape):
    """Every rank's block is its slice of the leaf, a copy of its own; the
    blocks reassemble the whole; ``shard_zeros`` allocates the same blocks."""
    p = _weights(arch)
    tmpl = tsteps.maybe_fsdp(lm.model_template(_cfg(arch)))
    mesh = _mesh(shape)
    sp = C.shard_params(p, tmpl, mesh)
    assert C.shard_params(sp, tmpl, mesh) is sp
    back = C.unshard_params(sp)
    for (_, a), (_, b) in zip(C.tree_items(back), C.tree_items(p)):
        assert torch.equal(a, b)
    zeros = C.shard_zeros(tmpl, mesh)
    ptrs = set()
    for blk, zb in zip(sp.blocks, zeros.blocks):
        for (_, a), (_, z) in zip(C.tree_items(blk), C.tree_items(zb)):
            assert a.shape == z.shape and a.is_contiguous()
            assert a.untyped_storage().data_ptr() not in ptrs
            ptrs.add(a.untyped_storage().data_ptr())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b"])
def test_a_lone_rank_takes_whole_leaves_as_they_are(arch):
    """A process's only rank that holds a leaf whole gets the tensor itself
    (no copy of the weights a call), and unsharding gives it back."""
    p = _weights(arch)
    sp = C.shard_params(p, lm.model_template(_cfg(arch)), _mesh((1, 1)))
    for (_, a), (_, b) in zip(C.tree_items(sp.blocks[0]), C.tree_items(p)):
        assert a is b
    for (_, a), (_, b) in zip(C.tree_items(C.unshard_params(sp)), C.tree_items(p)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# modules against mesh=None
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "smollm-6h", "qwen3-32b"])
def test_gqa_attention_matches_no_mesh(arch, shape):
    """Prefill, then three decode steps on a sharded cache, against the
    mesh-less attention (bias, heads or KV heads that do not divide, qk
    norm)."""
    cfg = _cfg(arch)
    p = _weights(arch)["layers"]
    p = C.layer(p["attn"], 0)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((4, 8, cfg.d_model)),
                        dtype=torch.float32)
    pos = torch.arange(8)
    mesh = _mesh(shape)
    with torch.no_grad():
        want, _ = A.gqa_attention(cfg, p, x, pos)
        got, _ = A.gqa_attention(cfg, p, x, pos, mesh=mesh)
        assert _rel_err(got, want) < MOE_TOL
        cw = C.materialize(None, A.gqa_cache_template(cfg, 4, CACHE_LEN), "float32", "cpu")
        cg = C.shard_zeros(A.gqa_cache_template(cfg, 4, CACHE_LEN), mesh, "float32")
        for i in range(3):
            w, _ = A.gqa_attention(cfg, p, x[:, i:i + 1], pos[i:i + 1], cache=cw,
                                   cache_index=i)
            g, _ = A.gqa_attention(cfg, p, x[:, i:i + 1], pos[i:i + 1], mesh=mesh,
                                   cache=cg, cache_index=i)
            assert _rel_err(g, w) < MOE_TOL


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mla_attention_matches_no_mesh(shape):
    """MLA prefill with heads over model, then the absorbed decode on the
    sequence-sharded latent cache (ranks whose slice lies past the filled
    prefix hold only masked scores and weigh 0) against the mesh-less MLA."""
    cfg = _cfg("deepseek-v2-236b")
    p = C.layer(_weights("deepseek-v2-236b")["layers"]["attn"], 0)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 8, cfg.d_model)),
                        dtype=torch.float32)
    pos = torch.arange(8)
    mesh = _mesh(shape)
    tmpl = A.mla_cache_template(cfg, 2, CACHE_LEN)
    with torch.no_grad():
        want, _ = A.mla_attention(cfg, p, x, pos)
        got, _ = A.mla_attention(cfg, p, x, pos, mesh=mesh)
        assert _rel_err(got, want) < MOE_TOL
        cw = C.materialize(None, tmpl, "float32", "cpu")
        cg = C.shard_zeros(tmpl, mesh, "float32")
        assert cg.blocks[0]["ckv"].shape[1] == CACHE_LEN // shape[1]
        for i in range(CACHE_LEN):
            w, _ = A.mla_attention(cfg, p, x[:, i:i + 1], pos[i:i + 1], cache=cw,
                                   cache_index=i)
            g, _ = A.mla_attention(cfg, p, x[:, i:i + 1], pos[i:i + 1], mesh=mesh,
                                   cache=cg, cache_index=i)
            assert torch.isfinite(g).all() and _rel_err(g, w) < MOE_TOL


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ffns_and_shared_experts_match_no_mesh(shape):
    """SwiGLU and the whisper GELU MLP (``b2`` added once, not once a rank)
    tensor parallel, and the MoE layer with its shared experts tensor
    parallel, against the mesh-less ones."""
    rng = np.random.default_rng(4)
    mesh = _mesh(shape)
    x = torch.as_tensor(rng.standard_normal((4, 6, 64)), dtype=torch.float32)
    dense = {k: torch.as_tensor(rng.standard_normal(s) * 0.1, dtype=torch.float32)
             for k, s in (("wg", (64, 96)), ("wu", (64, 96)), ("wd", (96, 64)))}
    gelu = {k: torch.as_tensor(rng.standard_normal(s) * 0.1, dtype=torch.float32)
            for k, s in (("w1", (64, 96)), ("b1", (96,)), ("w2", (96, 64)), ("b2", (64,)))}
    with torch.no_grad():
        assert _rel_err(MOE.dense_ffn(dense, x, mesh=mesh), MOE.dense_ffn(dense, x)) < MOE_TOL
        assert _rel_err(MOE.gelu_ffn(gelu, x, mesh=mesh), MOE.gelu_ffn(gelu, x)) < MOE_TOL
        cfg = _cfg("deepseek-v2-236b")
        p = C.layer(_weights("deepseek-v2-236b")["layers"]["moe"], 0)
        xm = x.reshape(2, 12, 64)
        # one chunk a data shard: the mesh routes the blocks mesh=None routes
        want, want_aux = MOE.moe_layer(cfg, p, xm, token_chunks=shape[0])
        got, aux = MOE.moe_layer(cfg, p, xm, mesh=mesh, token_chunks=1)
        assert _rel_err(got, want) < MOE_TOL and _rel_err(aux, want_aux) < MOE_TOL


def _moe_blocks_of(n_data):
    """``moe_layer`` taking n_data x its chunks: a mesh-less run that routes
    the token blocks a mesh of n_data shards routes."""
    layer = MOE.moe_layer

    def moe_layer(cfg, p, x, mesh=None, token_chunks=4):
        return layer(cfg, p, x, mesh=mesh, token_chunks=token_chunks * n_data)
    return layer, moe_layer


@functools.lru_cache(maxsize=None)
def _no_mesh_run(arch, n_data):
    """``mesh=None``'s loss, every leaf's gradient, forward output and
    three decode steps' logits (deepseek-v2 routing the token blocks of
    ``n_data`` shards), once per (arch, n_data)."""
    cfg = _cfg(arch)
    p = _weights(arch)
    b = _t(_batch(arch))
    leaves = [t.requires_grad_() for _, t in C.tree_items(p)]
    layer, blocks = _moe_blocks_of(n_data)
    MOE.moe_layer = blocks
    try:
        loss = lm.loss_fn(cfg, p, b)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            out = lm.forward(cfg, p, b)
    finally:
        MOE.moe_layer = layer
    steps = []
    with torch.no_grad():
        cache = lm.init_cache(cfg, b["tokens"].shape[0], CACHE_LEN, dtype="float32",
                              device="cpu")
        for pos in range(DECODE_STEPS):
            steps.append(lm.decode_step(cfg, p, cache, b["tokens"][:, pos:pos + 1], pos)[0])
    return loss.detach(), grads, out, steps


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_no_mesh(arch, shape):
    """``forward`` and ``loss_fn`` (its value, and through the sharding
    copies the gradient of every whole leaf) and three decode steps against
    ``mesh=None`` (deepseek-v2: routing the same token blocks)."""
    cfg = _cfg(arch)
    p = _weights(arch)
    b = _t(_batch(arch))
    leaves = [t.requires_grad_() for _, t in C.tree_items(p)]
    mesh = _mesh(shape)
    want, g_want, out_want, steps = _no_mesh_run(arch, shape[0])
    got = lm.loss_fn(cfg, p, b, mesh=mesh)
    g_got = torch.autograd.grad(got, leaves)
    assert _rel_err(got, want) < MOE_TOL
    for (path, _), a, c in zip(C.tree_items(p), g_got, g_want):
        assert _rel_err(a, c) < MOE_TOL, path
    with torch.no_grad():
        out = lm.forward(cfg, p, b, mesh=mesh)
        if cfg.family == "moe":
            (out, aux), (out_want, aux_want) = out, out_want
            assert _rel_err(aux, aux_want) < MOE_TOL
        assert _rel_err(out, out_want) < MOE_TOL
        cache = lm.init_cache(cfg, b["tokens"].shape[0], CACHE_LEN, dtype="float32",
                              mesh=mesh)
        for pos, w in enumerate(steps):
            g, cache = lm.decode_step(cfg, p, cache, b["tokens"][:, pos:pos + 1], pos,
                                      mesh=mesh)
            assert _rel_err(g, w) < MOE_TOL


def reckoned_collectives(cfg, mesh):
    """A dense forward's collectives: per layer an all-gather over model for
    each of q / k / v whose heads do not divide the axis but whose columns
    do, the psums after ``wo`` and ``wd``; then the lookup's psum and the
    logits' all-gather."""
    M = mesh.model_axis
    per_layer = 2 + sum(1 for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)
                        if n % M and (n * cfg.hdim) % M == 0)
    return cfg.n_layers * per_layer + 2


@pytest.mark.parametrize("shape", MESHES + ((1, 1),), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "smollm-6h"])
def test_dense_forward_collectives(arch, shape):
    cfg, mesh = _cfg(arch), _mesh(shape)
    with torch.no_grad():
        lm.forward(cfg, _weights(arch), _t(_batch(arch)), mesh=mesh)
    assert mesh.collectives == reckoned_collectives(cfg, mesh)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _adamw_param_limit(p, m, v, lr, step, tol, b1=0.9, b2=0.95, eps=1e-8):
    """How far params may lie from another run's after AdamW step ``step``
    when the moments are each within ``tol`` of their leaf's largest entry
    (the update moves by at most dm / lo + |m^| (hi - lo) / (lo hi)), plus
    one fp32 ulp."""
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    mh, vh = m.abs() / bc1, v / bc2
    dm, dv = tol * float(mh.max()), tol * float(vh.max())
    lo = torch.sqrt(torch.clamp(vh - dv, min=0.0)) + eps
    hi = torch.sqrt(vh + dv) + eps
    return lr * (dm / lo + mh * (hi - lo) / (lo * hi)) + torch.finfo(torch.float32).eps * p.abs()


def _two_steps(mesh, setting):
    flags, mb = TRAIN_SETTINGS[setting]
    cfg = _cfg("smollm-135m")
    for k in flags:
        runtime_flags.OPT[k] = True
    try:
        p = _weights("smollm-135m")
        opt = tadamw.adamw_init(p)
        step = tsteps.make_train_step(cfg, mesh, peak_lr=1e-2, total_steps=4,
                                      microbatches=mb)
        metrics = []
        for i in range(2):
            p, opt, m = step(p, opt, {"tokens": torch.as_tensor(_train_tokens(i)).long()})
            metrics.append(m)
    finally:
        for k in flags:
            runtime_flags.OPT[k] = False
    return p, opt, metrics


def test_zero1_halves_the_moments_a_rank_holds():
    """Over a data axis of 2 ZeRO-1 splits each moment over data: rank 0's
    moment bytes halve (every leaf of reduced smollm has a dimension that 2
    divides); FSDP splits the parameters the same way."""
    mesh = _mesh((2, 2))
    sp = C.shard_params(_weights("smollm-135m"), lm.model_template(_cfg("smollm-135m")), mesh)

    def rank0_bytes(tree):
        return sum(t.numel() * t.element_size() for _, t in C.tree_items(tree.blocks[0]))

    plain = tadamw.adamw_init(sp)
    runtime_flags.OPT["zero1_opt_state"] = True
    try:
        zero1 = tadamw.adamw_init(sp)
    finally:
        runtime_flags.OPT["zero1_opt_state"] = False
    assert 2 * rank0_bytes(zero1.m) == rank0_bytes(plain.m)
    assert 2 * rank0_bytes(zero1.v) == rank0_bytes(plain.v)


# ---------------------------------------------------------------------------
# ROADMAP C.8: the MoE combine
# ---------------------------------------------------------------------------

def _routing(seed=5, T=40, d=16, E=8, k=3, C_=6):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((T, d)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((d, E)), dtype=torch.float32)
    r = moe_ops.route(x, w, k, C_)
    y = torch.as_tensor(rng.standard_normal((E, C_, d)), dtype=torch.float32)
    return x, w, r, y, (E, k, C_)


def test_combine_is_the_fixed_order_token_major_sum():
    """``combine`` adds each token's ``top_k`` weighted expert rows left to
    right in its choice order, bit for bit, and drops the rows the capacity
    dropped."""
    x, w, r, y, (E, k, C_) = _routing()
    T, d = x.shape[0], y.shape[-1]
    flat = torch.cat([y.reshape(E * C_, d), torch.zeros(1, d)])
    vals = flat[r.bucket_idx] * (r.weight * r.keep)[:, None]
    # the sorted assignments back in token-major order, from the routing's
    # own top-k choices and their stable sort by expert
    top_i = torch.topk(torch.softmax(x @ w, dim=-1), k, dim=-1)[1]
    order = torch.sort(top_i.reshape(-1), stable=True)[1]
    by_token = torch.empty_like(vals)
    by_token[order] = vals
    by_token = by_token.reshape(T, k, d)
    want = by_token[:, 0]
    for j in range(1, k):
        want = want + by_token[:, j]
    assert torch.equal(moe_ops.combine(y, r, T), want)
    assert (~r.keep).any()


def test_combine_matches_the_reference_and_the_scatter_gradient():
    """Against the reference's ``combine`` (its ``segment_sum``) at fp32
    rounding, and its gradient through the routing weights equals that of
    the scatter-add it replaces."""
    x, w, r, y, (E, k, C_) = _routing(seed=6)
    T, d = x.shape[0], y.shape[-1]
    jr = j_moe_ops.route(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), k, C_)
    want = j_moe_ops.combine(jnp.asarray(y.numpy()), jr, T)
    assert _rel_err(moe_ops.combine(y, r, T), np.asarray(want)) < 1e-6
    weight = r.weight.clone().requires_grad_()
    rw = dataclasses.replace(r, weight=weight)
    dy = torch.as_tensor(np.random.default_rng(7).standard_normal((T, d)), dtype=torch.float32)
    (g_new,) = torch.autograd.grad((moe_ops.combine(y, rw, T) * dy).sum(), weight)
    flat = torch.cat([y.reshape(E * C_, d), torch.zeros(1, d)])
    vals = flat[r.bucket_idx] * (weight * r.keep)[:, None]
    old = torch.zeros(T, d).index_add_(0, r.token_idx, vals)
    (g_old,) = torch.autograd.grad((old * dy).sum(), weight)
    assert torch.equal(g_new, g_old)


# ---------------------------------------------------------------------------
# nothing of jax or repro on the mesh path
# ---------------------------------------------------------------------------

def test_mesh_path_loads_neither_jax_nor_repro(tmp_path):
    """Forward, a ZeRO-1 + FSDP train step, a per-host checkpoint and its
    elastic restore, ``serve_requests``, and the audio, ssm and hybrid
    families' forward and decode step on a mesh load nothing of jax or
    repro."""
    code = textwrap.dedent(f"""
        import sys, torch, numpy as np
        from repro_torch import runtime_flags
        from repro_torch.checkpointing import restore_checkpoint, save_checkpoint
        from repro_torch.configs import get_config, reduced
        from repro_torch.core.exchange import ShardMesh
        from repro_torch.launch.serve import serve_requests
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import lm
        from repro_torch.models.common import materialize
        from repro_torch.optim.adamw import adamw_init
        cfg = reduced(get_config("qwen2-1.5b"))
        p = materialize(torch.Generator().manual_seed(0), lm.model_template(cfg),
                        "float32", "cpu")
        mesh = ShardMesh(["cpu"] * 4, 2, 2)
        tok = torch.zeros((4, 8), dtype=torch.long)
        lm.forward(cfg, p, {{"tokens": tok}}, mesh=mesh)
        runtime_flags.OPT["zero1_opt_state"] = runtime_flags.OPT["fsdp_params"] = True
        sp, opt, _ = make_train_step(cfg, mesh)(p, adamw_init(p), {{"tokens": tok}})
        save_checkpoint(r"{tmp_path}", 1, {{"params": sp, "opt": opt}})
        restore_checkpoint(r"{tmp_path}", 1, {{"params": p}}, mesh=ShardMesh(["cpu"] * 4, 4, 1),
                           shardings={{"params": lm.model_template(cfg)}})
        serve_requests(cfg, p, [np.arange(4)] * 2, batch=2, max_prompt=4, max_new=2,
                       mesh=mesh)
        for arch in ("whisper-large-v3", "xlstm-1.3b", "zamba2-2.7b"):
            c = reduced(get_config(arch))
            w = materialize(torch.Generator().manual_seed(0), lm.model_template(c),
                            "float32", "cpu")
            b = {{"tokens": tok}}
            if c.family == "audio":
                b["frames"] = torch.zeros((4, c.enc_len, c.d_model))
            lm.forward(c, w, b, mesh=mesh)
            lm.decode_step(c, w, lm.init_cache(c, 4, 8, dtype="float32", mesh=mesh),
                           tok[:, :1], 0, mesh=mesh)
        bad = [m for m in sys.modules if m.startswith("jax") or m == "repro"
               or m.startswith("repro.")]
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# against the reference (last: its subprocess runs while the tests above do)
# ---------------------------------------------------------------------------

REF_CASES = [(a, s) for a in ARCHS for s in REF_MESHES if a != "smollm-6h" or s == (2, 4)]


@pytest.mark.parametrize("arch,shape", REF_CASES, ids=lambda c: c if isinstance(c, str)
                         else f"{c[0]}x{c[1]}")
def test_lm_matches_reference(arch, shape, ref):
    """``forward``, ``loss_fn`` and its gradient leaf by leaf (and, at (2,
    4), three decode steps) against the reference on the Auto-axis mesh of
    the same shape."""
    cfg = _cfg(arch)
    p = _weights(arch)
    b = _t(_batch(arch))
    key = f"{arch}/{shape[0]}x{shape[1]}"
    mesh = _mesh(shape)
    leaves = [t.requires_grad_() for _, t in C.tree_items(p)]
    loss = lm.loss_fn(cfg, p, b, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    assert _rel_err(loss, ref[key + "/loss"]) < MOE_TOL
    for (path, _), g in zip(C.tree_items(p), grads):
        assert _rel_err(g, ref[key + "/grad/" + "/".join(path)]) < MOE_TOL, path
    with torch.no_grad():
        out = lm.forward(cfg, p, b, mesh=mesh)
        assert _rel_err(out[0] if cfg.family == "moe" else out, ref[key + "/logits"]) < MOE_TOL
        if shape != REF_MESHES[-1]:
            return
        cache = lm.init_cache(cfg, b["tokens"].shape[0], CACHE_LEN, dtype="float32",
                              mesh=mesh)
        for pos in range(DECODE_STEPS):
            logits, cache = lm.decode_step(cfg, p, cache, b["tokens"][:, pos:pos + 1], pos,
                                           mesh=mesh)
            assert _rel_err(logits, ref[f"{key}/decode/{pos}"]) < MOE_TOL


@pytest.mark.parametrize("flag", [False, True], ids=["heads", "batch_shard"])
def test_attn_batch_spec_branches(flag, ref, monkeypatch):
    """6 heads on a 4-wide model axis: without ``attn_batch_shard`` the
    projections are gathered and the attention replicated; with it (8 rows
    divide 2 x 4) the batch splits over every axis.  Both equal ``mesh=None``
    and the reference's forward under the same flag."""
    cfg = _cfg("smollm-6h")
    mesh = _mesh((2, 4))
    assert A._attn_batch_spec(cfg, mesh, BATCH) == ("__dp__", "model")
    monkeypatch.setitem(runtime_flags.OPT, "attn_batch_shard", flag)
    assert A._attn_batch_spec(cfg, mesh, BATCH) == (("__dpm__", None) if flag
                                                    else ("__dp__", "model"))
    assert A._attn_batch_spec(cfg, mesh, BATCH - 4) == ("__dp__", "model")
    calls = []
    to_batch = A._columns_to_batch
    monkeypatch.setattr(A, "_columns_to_batch", lambda *a: (calls.append(1), to_batch(*a))[1])
    p, b = _weights("smollm-6h"), _t(_batch("smollm-6h"))
    with torch.no_grad():
        got = lm.forward(cfg, p, b, mesh=mesh)
        want = lm.forward(cfg, p, b)
    assert bool(calls) == flag
    assert _rel_err(got, want) < MOE_TOL
    key = "smollm-6h/2x4/batch_shard/logits" if flag else "smollm-6h/2x4/logits"
    assert _rel_err(got, ref[key]) < MOE_TOL


@pytest.mark.parametrize("setting", sorted(TRAIN_SETTINGS))
def test_train_step_matches_no_mesh_and_reference(setting, ref):
    """Two steps on the (2, 4) mesh: losses and grad norms at ``MOE_TOL``,
    moments at ``MOE_TOL`` of their leaf's largest entry and parameters
    within what those moment errors let the second update move them, against
    ``mesh=None``'s steps and the reference's ``make_train_step`` on the
    same mesh under the same flags."""
    mesh = _mesh(TRAIN_MESH)
    sp, sopt, sm = _two_steps(mesh, setting)
    p, m, v = (C.unshard_params(t) for t in (sp, sopt.m, sopt.v))
    wp, wopt, wm = _two_steps(None, "plain")
    lr = float(sm[1]["lr"])
    assert lr > 0
    for i in range(2):
        for k in ("loss", "grad_norm"):
            assert _rel_err(sm[i][k], wm[i][k].detach()) < MOE_TOL
            assert _rel_err(sm[i][k], ref[f"train/{setting}/{k}/{i}"]) < MOE_TOL
    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    for path, _ in C.tree_items(p):
        key = "/".join(path)
        ref_leaf = {n: torch.as_tensor(ref[f"train/{setting}/{n}/{key}"])
                    for n in ("params", "m", "v")}
        for who, want in (("no_mesh", {n: leaf(t, path) for n, t in
                                       (("params", wp), ("m", wopt.m), ("v", wopt.v))}),
                          ("reference", ref_leaf)):
            for n, got in (("m", leaf(m, path)), ("v", leaf(v, path))):
                assert float((got - want[n]).abs().max()) <= \
                    MOE_TOL * float(want[n].abs().max()), (who, n, key)
            limit = _adamw_param_limit(want["params"], want["m"], want["v"], lr, 2, MOE_TOL)
            assert bool(((leaf(p, path) - want["params"]).abs() <= limit).all()), (who, key)
