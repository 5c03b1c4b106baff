"""The audio, ssm and hybrid families laid out by their specs on the port's
one-process `ShardMesh`, against `mesh=None` and against `repro` under an
Auto-axis mesh of forced host devices; 8-bit AdamW moments on a mesh.

Held here, fp32, reduced configs, inputs from numpy seeds:
- whisper-large-v3 (with frames), xlstm-1.3b and zamba2-2.7b at (data,
  model) = (1, 2) and (2, 4): `lm.forward`, `loss_fn` (value and every
  whole leaf's gradient) and three `decode_step`s (whisper on a seeded
  cross cache; zamba2 on a 2-slot ring, so its third step wraps) against
  `mesh=None` at `MOE_TOL` and against the reference's `forward`,
  `jax.value_and_grad(loss_fn)` and `decode_step` on the Auto-axis mesh of
  the same shape at the family tolerance of `tests/test_torch_lm_families.py`
  (`TOL`);
- `make_prefill_step(cfg, mesh)` against the mesh-less step;
- the one body a block: a one-rank mesh equals `mesh=None` bit for bit, and
  a planted fault (the RMS norms over a split width without their psum)
  rises past the limit;
- the collectives of a forward equal `chip_smoke.family_collectives`, and
  under FSDP that plus one gather a use of each data-split leaf (zamba2's
  shared block once a super-block);
- `make_train_step(cfg, mesh)` for zamba2 at (2, 2), plain and under ZeRO-1
  + FSDP with 2 microbatches, two steps against `mesh=None` and the
  reference;
- 8-bit moments (`opt_state_bits` forced to 8 in both packages) on reduced
  deepseek-v2 at (2, 2) and (1, 2): the int8 codes and per-row scales of
  `m` against the reference's, and ZeRO-1's rows split over data.

Sequences are 16 tokens, a multiple of the reduced chunk (16): a partial
last chunk makes the reference's mLSTM gradient NaN (ROADMAP C.9; the
port's stays finite, `test_padded_chunk_gradient_is_finite_where_the_
reference_is_nan`).  The reference runs
once, in a subprocess that forces 8 host devices before its first jax
import (one process a family, one for the zamba2 steps and one for the 8-bit
steps at each mesh, side by side), while the tests of this module that do
not read it run.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import runtime_flags
from repro_torch.configs import get_config, reduced
from repro_torch.core.exchange import ShardMesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as C
from repro_torch.models import lm
from repro_torch.models import mamba2 as M2
from repro_torch.models import xlstm as XL
from repro_torch.optim import adamw as tadamw

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCHS = ("whisper-large-v3", "xlstm-1.3b", "zamba2-2.7b")
MESHES = ((1, 2), (2, 4))
MOE_TOL = 1e-5            # fp32 rounding of the same sums, x max(1, max|ref|)
TOL = 1e-4                # the families' limit against the reference (test_torch_lm_families)
ROWS, SEQ = 4, 16
NAN_SEQ = 40              # a partial last chunk of the reduced 16
DECODE_STEPS = 3
CACHE_LEN = {"whisper-large-v3": 8, "xlstm-1.3b": 8, "zamba2-2.7b": 2}   # zamba2: 2-slot ring
TRAIN_ARCH, TRAIN_MESH = "zamba2-2.7b", (2, 2)
TRAIN_SETTINGS = {"plain": ((), 1), "zero1_fsdp_mb2": (("zero1_opt_state", "fsdp_params"), 2)}
Q8_ARCH, Q8_MESHES = "deepseek-v2-236b", ((2, 2), (1, 2))
TRAIN_ROWS = 8


def _cfg(arch):
    return reduced(get_config(arch))


def _rel_err(got, want):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _mesh(shape):
    return ShardMesh(["cpu"] * (shape[0] * shape[1]), *shape)


def _weights(arch, seed=0):
    return C.materialize(torch.Generator().manual_seed(seed), lm.model_template(_cfg(arch)),
                         "float32", "cpu")


def _batch(arch, seq=SEQ, seed=1):
    cfg = _cfg(arch)
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (ROWS, seq)).astype(np.int64)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((ROWS, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return b


def _cross(arch):
    """A seeded non-zero cross cache (n_layers, B, enc_len, K, Dh)."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(7)
    shape = (cfg.n_layers, ROWS, cfg.enc_len, cfg.n_kv_heads, cfg.hdim)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _train_tokens(arch, i):
    return np.random.default_rng(10 + i).integers(
        0, _cfg(arch).vocab, (TRAIN_ROWS, SEQ)).astype(np.int32)


# ---------------------------------------------------------------------------
# the reference, once, on forced host devices
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import runtime_flags
    from repro.configs import get_config, reduced
    from repro.launch import steps
    from repro.models import lm
    from repro.models.common import cross_entropy, materialize
    from repro.optim.adamw import adamw_init

    tmp, part = sys.argv[1], sys.argv[2]
    z = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = {}

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
                a = jnp.asarray(t[k])
                out[prefix + k] = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                                             else a)

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             devices=jax.devices()[:shape[0] * shape[1]],
                             axis_types=(AxisType.Auto, AxisType.Auto))

    def value_and_grad(cfg, m):
        def loss(w, b):
            o = lm.forward(cfg, w, b, mesh=m)
            return cross_entropy(o[:, :-1], b["tokens"][:, 1:]), o
        return jax.jit(jax.value_and_grad(loss, has_aux=True))

    for arch in [a for a in %(archs)r if a == part]:
        cfg = reduced(get_config(arch))
        w = tree(f"w/{arch}/")
        b = {k.split("/")[-1]: jnp.asarray(v) for k, v in z.items()
             if k.startswith(f"b/{arch}/")}
        for shape in %(meshes)r:
            m = mesh_of(shape)
            key = f"{arch}/{shape[0]}x{shape[1]}"
            (l, o), g = value_and_grad(cfg, m)(w, b)
            out[key + "/logits"] = np.asarray(o)
            out[key + "/loss"] = np.asarray(l)
            flat(key + "/grad/", g)
            cache = materialize(jax.random.PRNGKey(0),
                                lm.cache_template(cfg, b["tokens"].shape[0],
                                                  %(cache_len)r[arch]),
                                dtype_override="float32")
            if cfg.family == "audio":
                cache["cross"] = {k: jnp.asarray(z[f"cross/{k}"]) for k in ("k", "v")}
            step = jax.jit(lambda w, c, t, p: lm.decode_step(cfg, w, c, t, p, mesh=m))
            for pos in range(%(steps)d):
                logits, cache = step(w, cache, b["tokens"][:, pos:pos + 1], pos)
                out[f"{key}/decode/{pos}"] = np.asarray(logits)
        if arch == "xlstm-1.3b":
            # a partial last chunk: the padded forget logits overflow exp
            (l, _), g = value_and_grad(cfg, mesh_of((1, 2)))(
                w, {"tokens": jnp.asarray(z["nan/tokens"])})
            out["nan/loss"] = np.asarray(l)
            flat("nan/grad/", g)

    def train(arch, m, name, flags, mb, bits=32):
        cfg = reduced(get_config(arch))
        for k in flags:
            runtime_flags.OPT[k] = True
        steps.opt_state_bits = lambda c: bits
        w = tree(f"w/{arch}/")
        opt = adamw_init(w, bits)
        step = jax.jit(steps.make_train_step(cfg, m, peak_lr=1e-2, total_steps=4,
                                             microbatches=mb))
        for i in range(2):
            w, opt, met = step(w, opt, {"tokens": jnp.asarray(z[f"train/{arch}/{i}"])})
            out[f"{name}/loss/{i}"] = np.asarray(met["loss"])
            out[f"{name}/grad_norm/{i}"] = np.asarray(met["grad_norm"])
        for k in flags:
            runtime_flags.OPT[k] = False
        flat(f"{name}/params/", w)
        flat(f"{name}/m/", opt.m)
        flat(f"{name}/v/", opt.v)
        if bits == 8:
            flat(f"{name}/m_scale/", opt.m_scale)

    for name, (flags, mb) in %(settings)r.items() if part == "train" else ():
        train(%(train_arch)r, mesh_of(%(train_mesh)r), f"train/{name}", flags, mb)
    for shape in [s for s in %(q8_meshes)r if part == f"q8/{s[0]}x{s[1]}"]:
        train(%(q8_arch)r, mesh_of(shape), f"q8/{shape[0]}x{shape[1]}", (), 1, bits=8)
    np.savez(os.path.join(tmp, f"ref_{part.replace('/', '_')}.npz"), **out)
""") % dict(archs=ARCHS, meshes=MESHES, cache_len=CACHE_LEN, steps=DECODE_STEPS,
            settings=TRAIN_SETTINGS, train_arch=TRAIN_ARCH, train_mesh=TRAIN_MESH,
            q8_arch=Q8_ARCH, q8_meshes=Q8_MESHES)


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    """Starts the reference subprocess on this module's inputs; tests that
    read it wait through :func:`ref`."""
    tmp = tmp_path_factory.mktemp("tpf")
    arrs = {}
    for arch in ARCHS + (Q8_ARCH,):
        for path, t in C.tree_items(_weights(arch)):
            arrs[f"w/{arch}/" + "/".join(path)] = t.numpy()
    for arch in ARCHS:
        for k, v in _batch(arch).items():
            arrs[f"b/{arch}/{k}"] = v.astype(np.int32) if k == "tokens" else v
    for k, v in _cross("whisper-large-v3").items():
        arrs[f"cross/{k}"] = v
    arrs["nan/tokens"] = _batch("xlstm-1.3b", NAN_SEQ)["tokens"].astype(np.int32)
    for arch in (TRAIN_ARCH, Q8_ARCH):
        for i in range(2):
            arrs[f"train/{arch}/{i}"] = _train_tokens(arch, i)
    np.savez(tmp / "inputs.npz", **arrs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    # one process a part, side by side: each family's forwards and decodes,
    # the zamba2 steps, the 8-bit steps at each mesh
    parts = ARCHS + ("train",) + tuple(f"q8/{a}x{b}" for a, b in Q8_MESHES)
    procs = {part: subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp), part],
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True) for part in parts}
    box = {"procs": procs, "tmp": tmp, "out": None}
    yield box
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()


@pytest.fixture
def ref(ref_proc):
    if ref_proc["out"] is None:
        out = {}
        for part, proc in ref_proc["procs"].items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            out.update(np.load(ref_proc["tmp"] / f"ref_{part.replace('/', '_')}.npz"))
        ref_proc["out"] = out
    return ref_proc["out"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads at these widths, beside the reference's processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# the fixture starts early: the first test of the module asks for it
def test_reference_starts(ref_proc):
    assert all(p.poll() in (None, 0) for p in ref_proc["procs"].values())


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _seed_cross(cache, arch, mesh=None):
    """Write the seeded cross cache into ``cache`` (whole, or each rank's
    block of a sharded one)."""
    cross = {k: torch.as_tensor(v) for k, v in _cross(arch).items()}
    if mesh is None:
        for k, v in cross.items():
            cache["cross"][k].copy_(v)
        return
    sub = cache.sub("cross")
    whole = C.shard_params(cross, sub.template, mesh)
    for blk, src in zip(sub.blocks, whole.blocks):
        for k in ("k", "v"):
            blk[k].copy_(src[k])


def _decode(arch, p, mesh=None):
    cfg = _cfg(arch)
    tokens = torch.as_tensor(_batch(arch)["tokens"])
    cache = lm.init_cache(cfg, ROWS, CACHE_LEN[arch], dtype="float32", device="cpu",
                          mesh=mesh)
    if cfg.family == "audio":
        _seed_cross(cache, arch, mesh)
    out = []
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            logits, cache = lm.decode_step(cfg, p, cache, tokens[:, pos:pos + 1], pos,
                                           mesh=mesh)
            out.append(logits)
    return out


_NO_MESH = {}


def _no_mesh_run(arch):
    """``mesh=None``'s loss, every leaf's gradient, forward and decode logits,
    once per arch."""
    if arch not in _NO_MESH:
        cfg, p, b = _cfg(arch), _weights(arch), _t(_batch(arch))
        leaves = [t.requires_grad_() for _, t in C.tree_items(p)]
        loss = lm.loss_fn(cfg, p, b)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            out = lm.forward(cfg, p, b)
        _NO_MESH[arch] = (loss.detach(), grads, out, _decode(arch, _weights(arch)))
    return _NO_MESH[arch]


def _mesh_run(arch, shape):
    cfg, p, b = _cfg(arch), _weights(arch), _t(_batch(arch))
    mesh = _mesh(shape)
    leaves = [t.requires_grad_() for _, t in C.tree_items(p)]
    loss = lm.loss_fn(cfg, p, b, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        out = lm.forward(cfg, p, b, mesh=mesh)
    return p, loss.detach(), grads, out, _decode(arch, _weights(arch), mesh)


_MESH_RUNS = {}


def _cached_mesh_run(arch, shape):
    if (arch, shape) not in _MESH_RUNS:
        _MESH_RUNS[arch, shape] = _mesh_run(arch, shape)
    return _MESH_RUNS[arch, shape]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_family_matches_no_mesh(arch, shape):
    """``forward``, ``loss_fn`` (its value and every whole leaf's gradient
    through the sharding copies) and three decode steps on a sharded cache
    against ``mesh=None``."""
    want, g_want, out_want, dec_want = _no_mesh_run(arch)
    p, got, g_got, out, dec = _cached_mesh_run(arch, shape)
    assert _rel_err(got, want) < MOE_TOL
    for (path, _), a, c in zip(C.tree_items(p), g_got, g_want):
        assert _rel_err(a, c) < MOE_TOL, path
    assert _rel_err(out, out_want) < MOE_TOL
    for g, w in zip(dec, dec_want):
        assert _rel_err(g, w) < MOE_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_on_a_mesh_matches_no_mesh(arch):
    """``make_prefill_step(cfg, mesh)`` (frames passed through for whisper)
    against the mesh-less prefill step's next-token logits at (2, 2)."""
    cfg, b = _cfg(arch), _t(_batch(arch))
    with torch.no_grad():
        got = tsteps.make_prefill_step(cfg, _mesh((2, 2)))(_weights(arch), b)
        want = tsteps.make_prefill_step(cfg)(_weights(arch), b)
    assert got.shape == (ROWS, cfg.vocab) and _rel_err(got, want) < MOE_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_equals_no_mesh_bit_for_bit(arch):
    """A (1, 1) mesh runs the same body on whole blocks: forward, loss and
    decode equal ``mesh=None``'s bit for bit."""
    cfg, b = _cfg(arch), _t(_batch(arch))
    mesh = _mesh((1, 1))
    with torch.no_grad():
        assert torch.equal(lm.forward(cfg, _weights(arch), b, mesh=mesh),
                           lm.forward(cfg, _weights(arch), b))
        assert torch.equal(lm.loss_fn(cfg, _weights(arch), b, mesh=mesh),
                           lm.loss_fn(cfg, _weights(arch), b))
    for g, w in zip(_decode(arch, _weights(arch), mesh), _decode(arch, _weights(arch))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
def test_norm_without_its_psum_is_caught(arch, monkeypatch):
    """A planted fault: the RMS norms over a width split by heads
    normalised over each rank's block alone.  Nothing raises (each rank's
    output keeps its shape), but the forward leaves ``mesh=None`` by far
    more than the limit at (1, 2) and at (2, 4)."""
    def local_norm(mesh, hs, ws, eps, width):
        return [C.rms_norm(h, w, eps) for h, w in zip(hs, ws)]

    cfg, b = _cfg(arch), _t(_batch(arch))
    want = _no_mesh_run(arch)[2]       # the unplanted meshes match it (above)
    with torch.no_grad():
        for mod in (M2, XL):
            monkeypatch.setattr(mod, "rms_norm_split", local_norm)
        for shape in MESHES:
            assert _rel_err(lm.forward(cfg, _weights(arch), b, mesh=_mesh(shape)),
                            want) > 100 * MOE_TOL


@pytest.mark.parametrize("shape", ((1, 1), (1, 2), (2, 2), (2, 4), (1, 8)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_collectives_match_the_reckoning(arch, shape):
    """One forward's collectives equal ``chip_smoke.family_collectives``
    (at (1, 8) xlstm's 4 heads and zamba2's 4 attention heads do not divide
    the axis: the replicated branches)."""
    cfg, mesh = _cfg(arch), _mesh(shape)
    with torch.no_grad():
        got = lm.forward(cfg, _weights(arch), _t(_batch(arch)), mesh=mesh)
    assert mesh.collectives == chip_smoke.family_collectives(cfg, mesh)
    assert _rel_err(got, _no_mesh_run(arch)[2]) < MOE_TOL


def test_fsdp_gathers_the_shared_block_at_each_application():
    """Under FSDP every leaf split over data is all-gathered where a block
    uses it: each Mamba2 layer's once, the weight-shared attention / MLP
    block's once a super-block (it is applied at each), ``embed``, ``head``
    and ``ln_f`` once.  Zamba2 at width 256, so that its leaves reach
    FSDP's 256: one forward's collectives are the reckoning plus those
    gathers, and its logits equal ``mesh=None``'s."""
    cfg = dataclasses.replace(_cfg("zamba2-2.7b"), d_model=256)
    mesh = _mesh((2, 2))
    p = C.materialize(torch.Generator().manual_seed(0), lm.model_template(cfg), "float32",
                      "cpu")
    runtime_flags.OPT["fsdp_params"] = True
    try:
        tmpl = tsteps.maybe_fsdp(lm.model_template(cfg))
    finally:
        runtime_flags.OPT["fsdp_params"] = False
    n_super = cfg.n_layers // cfg.shared_attn_every
    uses = {"layers": cfg.n_layers, "shared": n_super}
    gathers = sum(uses.get(path[0], 1) for path, l in C.tree_items(tmpl)
                  if any("data" in C.spec_axes(e) for e in C.leaf_spec(l, mesh)))
    assert gathers > 2 * n_super
    b = _t(_batch("zamba2-2.7b"))
    with torch.no_grad():
        got = lm.forward(cfg, C.shard_params(p, tmpl, mesh), b, mesh=mesh)
        want = lm.forward(cfg, p, b)
    assert mesh.collectives == chip_smoke.family_collectives(cfg, mesh) + gathers
    assert _rel_err(got, want) < MOE_TOL


def test_padded_chunk_gradient_is_finite_where_the_reference_is_nan(ref):
    """ROADMAP C.9: at 40 tokens (a partial last chunk of 16) the mLSTM pads
    the forget logits with -30 and the chunk's decay exp overflows above
    the diagonal.  The reference selects after the exp, so its backward
    multiplies the masked zero by inf: NaN gradients.  The port selects
    before the exp (the same forward): its gradients, with a mesh or none,
    are finite and equal the reference's on every leaf where those are."""
    cfg, b = _cfg("xlstm-1.3b"), _t(_batch("xlstm-1.3b", NAN_SEQ))
    nan_in_ref = [path for path, _ in C.tree_items(_weights("xlstm-1.3b"))
                  if np.isnan(ref["nan/grad/" + "/".join(path)]).any()]
    assert nan_in_ref
    for mesh in (None, _mesh((1, 2))):
        p = _weights("xlstm-1.3b")
        leaves = [t.requires_grad_() for _, t in C.tree_items(p)]
        loss = lm.loss_fn(cfg, p, b, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves)
        assert _rel_err(loss, ref["nan/loss"]) < TOL
        for (path, _), g in zip(C.tree_items(p), grads):
            want = ref["nan/grad/" + "/".join(path)]
            if path in nan_in_ref:
                assert bool(torch.isfinite(g).all()), path
            else:
                assert _rel_err(g, want) < TOL, path


# ---------------------------------------------------------------------------
# training and 8-bit moments
# ---------------------------------------------------------------------------

def _two_steps(arch, mesh, flags=(), mb=1, bits=32):
    cfg = _cfg(arch)
    for k in flags:
        runtime_flags.OPT[k] = True
    try:
        p = _weights(arch)
        opt = tadamw.adamw_init(p, bits)
        step = tsteps.make_train_step(cfg, mesh, peak_lr=1e-2, total_steps=4, microbatches=mb)
        metrics = []
        for i in range(2):
            p, opt, m = step(p, opt, {"tokens": torch.as_tensor(_train_tokens(arch, i)).long()})
            metrics.append(m)
    finally:
        for k in flags:
            runtime_flags.OPT[k] = False
    if mesh is not None:
        p = C.unshard_params(p)
        opt = opt._replace(m=C.unshard_params(opt.m), v=C.unshard_params(opt.v),
                           m_scale=None if bits == 32 else C.unshard_params(opt.m_scale))
    return p, opt, metrics


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("setting", sorted(TRAIN_SETTINGS))
def test_train_step_matches_no_mesh_and_reference(setting, ref):
    """zamba2, two steps at (2, 2): losses and grad norms at ``MOE_TOL``,
    ``m`` at ``MOE_TOL`` of its leaf's largest entry, ``v`` (quadratic in the
    gradient) at twice that, and parameters
    within what those moment errors let the second update move them
    (``chip_smoke._adamw_param_limit``), against ``mesh=None`` and the
    reference's ``make_train_step`` on the same mesh under the same flags."""
    flags, mb = TRAIN_SETTINGS[setting]
    p, opt, sm = _two_steps(TRAIN_ARCH, _mesh(TRAIN_MESH), flags, mb)
    wp, wopt, wm = _two_steps(TRAIN_ARCH, None)
    lr = float(sm[1]["lr"])
    for i in range(2):
        for k in ("loss", "grad_norm"):
            assert _rel_err(sm[i][k], wm[i][k].detach()) < MOE_TOL
            assert _rel_err(sm[i][k], ref[f"train/{setting}/{k}/{i}"]) < MOE_TOL
    for path, _ in C.tree_items(p):
        key = "/".join(path)
        ref_leaf = {n: torch.as_tensor(ref[f"train/{setting}/{n}/{key}"])
                    for n in ("params", "m", "v")}
        for who, want in (("no_mesh", {n: _leaf(t, path) for n, t in
                                       (("params", wp), ("m", wopt.m), ("v", wopt.v))}),
                          ("reference", ref_leaf)):
            for n, got in (("m", _leaf(opt.m, path)), ("v", _leaf(opt.v, path))):
                # v is quadratic in the gradient: twice its relative rounding
                tol = MOE_TOL * (2 if n == "v" else 1)
                assert float((got - want[n]).abs().max()) <= \
                    tol * float(want[n].abs().max()), (who, n, key)
            limit = chip_smoke._adamw_param_limit(want["params"], want["m"], want["v"], lr, 2,
                                                  MOE_TOL)
            assert bool(((_leaf(p, path) - want["params"]).abs() <= limit).all()), (who, key)


@pytest.mark.parametrize("shape", Q8_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_8bit_moments_on_a_mesh_match_reference(shape, ref, monkeypatch):
    """Reduced deepseek-v2 with ``opt_state_bits`` forced to 8 in both
    packages: two steps on the mesh; ``m``'s int8 codes equal the
    reference's but where the two packages' fp32 rounding straddles a half
    step (18 of 223,360 codes at (2, 2), each one step), its per-row scales (each the max over the ranks that hold
    a piece of the row, ``ShardMesh.pmax``) within ``MOE_TOL`` (fp32
    rounding of the gradients they scale), ``v`` (bf16) within one bf16 ulp
    plus ``MOE_TOL`` of its leaf's largest entry (as the 32-bit moments are
    judged), the losses at ``MOE_TOL``."""
    monkeypatch.setattr(tsteps, "opt_state_bits", lambda cfg: 8)
    mesh = _mesh(shape)
    p, opt, sm = _two_steps(Q8_ARCH, mesh, bits=8)
    name = f"q8/{shape[0]}x{shape[1]}"
    for i in range(2):
        for k in ("loss", "grad_norm"):
            assert _rel_err(sm[i][k], ref[f"{name}/{k}/{i}"]) < MOE_TOL
    codes = flipped = 0
    for path, m in C.tree_items(opt.m):
        key = "/".join(path)
        assert m.dtype == torch.int8
        step = np.abs(m.numpy().astype(np.int64) - ref[f"{name}/m/{key}"].astype(np.int64))
        assert step.max() <= 1, key
        codes, flipped = codes + step.size, flipped + int(step.sum())
        scale, want = _leaf(opt.m_scale, path), torch.as_tensor(ref[f"{name}/m_scale/{key}"])
        assert scale.shape == want.shape
        assert bool(((scale - want).abs() <= MOE_TOL * want.abs()).all()), key
        v, vw = _leaf(opt.v, path), torch.as_tensor(ref[f"{name}/v/{key}"])
        assert v.dtype == torch.bfloat16
        assert bool(((v.float() - vw).abs() <= 2 ** -7 * vw.abs()
                     + MOE_TOL * vw.abs().max()).all()), key
    # a code rounds the other way only where its unrounded value lies
    # within the gradients' rounding (MOE_TOL x |value| <= MOE_TOL x 127)
    # of a half step: at most that share of the codes
    assert codes > 100_000 and flipped <= 2 * MOE_TOL * 127 * codes, (flipped, codes)


def test_8bit_scales_span_the_ranks_of_a_row(monkeypatch):
    """Under ZeRO-1 the moments of a leaf split over data where its rows do
    not: each rank holds part of a row, yet every rank's scale block equals
    the mesh-less run's (a row's max over its pieces), and the int8 codes
    stay within one step."""
    mesh = _mesh((2, 2))
    runtime_flags.OPT["zero1_opt_state"] = True
    try:
        sp = C.shard_params(_weights(Q8_ARCH), lm.model_template(_cfg(Q8_ARCH)), mesh)
        t = tadamw.adamw_state_template(sp.template, 8)
    finally:
        runtime_flags.OPT["zero1_opt_state"] = False
    split_rows = [path for (path, l), (_, s) in zip(C.tree_items(t["m"]),
                                                   C.tree_items(sp.specs))
                  if l.spec[-1] == C.DP and "data" not in C.spec_axes(s[-1])]
    assert split_rows, "no leaf's rows split over data under ZeRO-1"
    monkeypatch.setattr(tsteps, "opt_state_bits", lambda cfg: 8)
    p, opt, _ = _two_steps(Q8_ARCH, mesh, ("zero1_opt_state",), bits=8)
    wp, wopt, _ = _two_steps(Q8_ARCH, _mesh((2, 1)), bits=8)
    for path, m in C.tree_items(opt.m):
        sc, wsc = _leaf(opt.m_scale, path), _leaf(wopt.m_scale, path)
        assert float(((sc - wsc).abs() / wsc.abs()).max()) < 1e-5, path
        assert int((m.int() - _leaf(wopt.m, path).int()).abs().max()) <= 1, path


# ---------------------------------------------------------------------------
# against the reference (last: its subprocess runs while the tests above do)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_family_matches_reference(arch, shape, ref):
    """``forward``, ``loss_fn`` and its gradient leaf by leaf and three decode
    steps against the reference on the Auto-axis mesh of the same shape."""
    p, loss, grads, out, dec = _cached_mesh_run(arch, shape)
    key = f"{arch}/{shape[0]}x{shape[1]}"
    assert _rel_err(loss, ref[key + "/loss"]) < TOL
    for (path, _), g in zip(C.tree_items(p), grads):
        assert _rel_err(g, ref[key + "/grad/" + "/".join(path)]) < TOL, path
    assert _rel_err(out, ref[key + "/logits"]) < TOL
    for pos, logits in enumerate(dec):
        assert _rel_err(logits, ref[f"{key}/decode/{pos}"]) < TOL
