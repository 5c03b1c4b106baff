"""The port's vlm, audio, ssm and hybrid LM families against `repro.models.lm`.

Reduced configs on the CPU, on the same weights: the reference's
`materialize` output reaches the port through `lm_params_from_reference`.
The reference runs on a (1, 1) ("data", "model") mesh with Auto axes that
this file builds itself, as `tests/test_torch_lm.py` does (`make_host_mesh`
gives Explicit axes, which `with_sharding_constraint` refuses under the
installed jax).  Inputs come from numpy seeds.

Tolerance: TOL = 1e-4 x max(1, max|ref|), elementwise max abs difference.
Both sides compute in float32 in another order of summation (einsum and
matmul shapes, Python loops in place of `lax.scan`), which leaves ~1e-6 at
these sizes; 1e-4 is the port's LM limit (`tests/test_torch_lm.py`).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AxisType

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mamba2 as jm2
from repro.models import xlstm as jxl
from repro.models.common import materialize as j_materialize
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.serve import serve_requests
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm
from repro_torch.models import mamba2 as tm2
from repro_torch.models import xlstm as txl
from repro_torch.models.common import materialize

ROOT = Path(__file__).resolve().parents[1]
FAMILY_ARCHS = ["qwen2-vl-72b", "whisper-large-v3", "xlstm-1.3b", "zamba2-2.7b"]
TOL = 1e-4   # x max(1, |ref|)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} over {tol} x {scale}"


def _t(a):
    """numpy -> torch (token arrays as int64)."""
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype.kind == "i" else a)


_WEIGHTS = {}


def _model(arch, seed=0):
    """(port cfg, reference cfg, reference params, port params), cached."""
    if (arch, seed) not in _WEIGHTS:
        jcfg = j_reduced(j_get_config(arch))
        np_tree = jax.tree.map(np.array, j_materialize(
            jax.random.PRNGKey(seed), jlm.model_template(jcfg), dtype_override="float32"))
        _WEIGHTS[arch, seed] = (reduced(get_config(arch)), jcfg,
                                jax.tree.map(jnp.asarray, np_tree),
                                lm_params_from_reference(np_tree, reduced(get_config(arch)),
                                                         device="cpu"))
    return _WEIGHTS[arch, seed]


def _batch(cfg, B, S, seed, patches=True):
    """numpy batch: tokens, plus patch_embeds (vlm) or frames (audio)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm" and patches:
        b["patch_embeds"] = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return b


# ---------------------------------------------------------------------------
# the model entry points
# ---------------------------------------------------------------------------

# S = 40 crosses the reduced chunk (16) with a partial last chunk (ssm,
# hybrid) and the reduced attention window (32, hybrid)
FORWARD_CASES = [("qwen2-vl-72b", True, 12), ("qwen2-vl-72b", False, 12),
                 ("whisper-large-v3", True, 12), ("xlstm-1.3b", True, 40),
                 ("zamba2-2.7b", True, 40)]


@pytest.mark.parametrize("arch,patches,S", FORWARD_CASES)
def test_forward_matches_reference(arch, patches, S, mesh):
    cfg, jcfg, jp, tp = _model(arch)
    b = _batch(cfg, 2, S, seed=3, patches=patches)
    want = jax.jit(lambda p, bb: jlm.forward(jcfg, p, bb, mesh=mesh))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = lm.forward(cfg, tp, {k: _t(v) for k, v in b.items()})
    assert got.shape == (2, S, cfg.vocab)
    _close(got, want)


def _cross_cache(cfg, B, seed=7):
    """Seeded non-zero cross-attention K/V (n_layers, B, enc_len, K, Dh)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, cfg.enc_len, cfg.n_kv_heads, cfg.hdim)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}


# (arch, steps, cache slots): hybrid runs 40 steps into a 48-slot cache, so
# its 32-slot ring (the reduced window) wraps at step 32
DECODE_CASES = [("qwen2-vl-72b", 12, 12), ("whisper-large-v3", 12, 12),
                ("xlstm-1.3b", 20, 20), ("zamba2-2.7b", 40, 48)]


@pytest.mark.parametrize("arch,steps,max_len", DECODE_CASES)
def test_teacher_forced_decode_matches_reference(arch, steps, max_len, mesh):
    """Every step's logits equal the reference decode step's on the same
    cache history; audio with a non-zero cross cache."""
    cfg, jcfg, jp, tp = _model(arch)
    B = 2
    tokens = _batch(cfg, B, steps, seed=5)["tokens"]
    jstep = jax.jit(j_make_decode_step(jcfg, mesh))
    jc = j_materialize(jax.random.PRNGKey(1), jlm.cache_template(jcfg, B, max_len),
                       dtype_override="float32")
    tc = materialize(None, lm.cache_template(cfg, B, max_len), dtype_override="float32",
                     device="cpu")
    if cfg.family == "audio":
        cross = _cross_cache(cfg, B)
        jc["cross"] = {k: jnp.asarray(v) for k, v in cross.items()}
        for k, v in cross.items():
            tc["cross"][k].copy_(torch.as_tensor(v))
    if cfg.family == "hybrid":
        assert tc["shared"]["k"].shape[2] == cfg.attn_window == 32 < steps
    step = make_decode_step(cfg)
    for pos in range(steps):
        want, jc = jstep(jp, jc, jnp.asarray(tokens[:, pos:pos + 1]),
                         jnp.asarray(pos, jnp.int32))
        got, tc = step(tp, tc, _t(tokens[:, pos:pos + 1]), pos)
        _close(got, want)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_step_matches_reference(arch, mesh):
    """`make_prefill_step` passes patch_embeds / frames through."""
    cfg, jcfg, jp, tp = _model(arch)
    b = _batch(cfg, 2, 10, seed=11)
    want = jax.jit(j_make_prefill_step(jcfg, mesh))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = make_prefill_step(cfg)(tp, {k: _t(v) for k, v in b.items()})
    assert got.shape == (2, cfg.vocab)
    _close(got, want)


def _reference_serve(jcfg, mesh, jp, prompts, batch, max_prompt, max_new):
    """The greedy tokens of the reference serving loop
    (`repro.launch.serve.main`'s) driven by its decode step."""
    step = jax.jit(j_make_decode_step(jcfg, mesh))
    queue, outs = list(prompts), []
    while queue:
        reqs, queue = queue[:batch], queue[batch:]
        B = len(reqs)
        lens = np.array([len(p) for p in reqs])
        padded = np.zeros((B, max_prompt), np.int32)
        for i, p in enumerate(reqs):
            padded[i, :len(p)] = p
        cache = j_materialize(jax.random.PRNGKey(1),
                              jlm.cache_template(jcfg, B, max_prompt + max_new),
                              dtype_override="float32")
        for pos in range(int(lens.max())):
            logits, cache = step(jp, cache, jnp.asarray(padded[:, pos:pos + 1]),
                                 jnp.asarray(pos, jnp.int32))
        out = np.zeros((B, max_new), np.int32)
        tok = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
        for i in range(max_new):
            out[:, i] = np.asarray(tok[:, 0])
            logits, cache = step(jp, cache, tok, jnp.asarray(int(lens.max()) + i, jnp.int32))
            tok = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
        outs.append(out)
    return outs


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_requests_matches_reference_loop(arch, mesh):
    """Token for token; each batch's cache comes from `cache_template`
    (audio's cross cache stays zeros, ssm's stabiliser starts at -1e30)."""
    cfg, jcfg, jp, tp = _model(arch, seed=1)
    n_req, batch, max_prompt, max_new = 5, 2, 8, 4
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, max_prompt + 1)).astype(np.int32)
               for _ in range(n_req)]
    # float32 caches, as the reference loop's (dtype_override="float32")
    res = serve_requests(cfg, tp, prompts, batch=batch, max_prompt=max_prompt,
                         max_new=max_new, device="cpu", dtype="float32")
    want = _reference_serve(jcfg, mesh, jp, prompts, batch, max_prompt, max_new)
    assert len(res["tokens"]) == len(want)
    for got, exp in zip(res["tokens"], want):
        np.testing.assert_array_equal(got, exp)


def test_cache_templates_start_as_the_reference():
    """Zeros everywhere but the mLSTM stabiliser (-1e30); the hybrid ring
    is the window, audio's cross cache the encoder length."""
    for arch in FAMILY_ARCHS:
        cfg = reduced(get_config(arch))
        jcfg = j_reduced(j_get_config(arch))
        want = jax.tree.map(np.array, j_materialize(
            jax.random.PRNGKey(1), jlm.cache_template(jcfg, 3, 40), dtype_override="float32"))
        got = materialize(None, lm.cache_template(cfg, 3, 40), dtype_override="float32",
                          device="cpu")
        want_items = dict(tcommon.tree_items(want))
        got_items = dict(tcommon.tree_items(got))
        assert want_items.keys() == got_items.keys(), arch
        for path, w in want_items.items():
            np.testing.assert_array_equal(got_items[path].numpy(), w, err_msg=str(path))


# ---------------------------------------------------------------------------
# the blocks' pieces, against the reference functions, eagerly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,with_state", [(37, False), (37, True), (1, True), (16, False)])
def test_ssd_chunked_matches_reference(S, with_state, rng):
    """S = 37 pads a partial last chunk of 16; 2 groups over 4 heads."""
    B, nh, hd, G, N = 2, 4, 8, 2, 6
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    h0 = rng.standard_normal((B, nh, hd, N)).astype(np.float32) if with_state else None
    jy, jh = jm2._ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), 16,
                              None if h0 is None else jnp.asarray(h0))
    ty, th = tm2._ssd_chunked(*(torch.as_tensor(a) for a in (x, dt, A, Bm, Cm)), 16,
                              None if h0 is None else torch.as_tensor(h0))
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("S,with_state", [(37, False), (37, True), (1, True), (1, False)])
def test_chunked_mlstm_matches_reference(S, with_state, rng):
    B, nh, dk = 2, 3, 8
    q, k, v = (rng.standard_normal((B, S, nh, dk)).astype(np.float32) for _ in range(3))
    ig = (2 * rng.standard_normal((B, S, nh))).astype(np.float32)
    fg = (2 * rng.standard_normal((B, S, nh))).astype(np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((B, nh, dk, dk)).astype(np.float32),
                 rng.standard_normal((B, nh, dk)).astype(np.float32),
                 rng.standard_normal((B, nh)).astype(np.float32))
    jh, jst = jxl._chunked_mlstm(*(jnp.asarray(a) for a in (q, k, v, ig, fg)), 16,
                                 None if state is None else tuple(map(jnp.asarray, state)))
    th, tst = txl._chunked_mlstm(*(torch.as_tensor(a) for a in (q, k, v, ig, fg)), 16,
                                 None if state is None else tuple(map(torch.as_tensor, state)))
    _close(th, jh)
    for g, w in zip(tst, jst):
        _close(g, w)


def test_slstm_cell_matches_reference(rng):
    B, nh, hd = 3, 2, 8
    p = {"r_h": (0.3 * rng.standard_normal((nh, hd, 4 * hd))).astype(np.float32)}
    carry = tuple(rng.standard_normal((B, nh, hd)).astype(np.float32) for _ in range(4))
    xw = (2 * rng.standard_normal((B, 4 * nh * hd))).astype(np.float32)
    want = jxl._slstm_cell({k: jnp.asarray(v) for k, v in p.items()}, nh, hd,
                           tuple(map(jnp.asarray, carry)), jnp.asarray(xw))
    got = txl._slstm_cell({k: torch.as_tensor(v) for k, v in p.items()}, nh, hd,
                          tuple(map(torch.as_tensor, carry)), torch.as_tensor(xw))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("module", ["mamba2", "xlstm"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(module, with_state, rng):
    B, S, C, W = 2, 5, 12, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    st = rng.standard_normal((B, W - 1, C)).astype(np.float32) if with_state else None
    jfn, tfn = ((jm2._causal_conv, tm2._causal_conv) if module == "mamba2"
                else (jxl._causal_conv, txl._causal_conv))
    jo, jst = jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                  None if st is None else jnp.asarray(st))
    to, tst = tfn(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                  None if st is None else torch.as_tensor(st))
    _close(to, jo)
    _close(tst, jst)


def _block_params(rng, tmpl, scale=1.0):
    return {k: (scale * rng.standard_normal(l.shape) / np.sqrt(max(l.fan_in(), 1))
                ).astype(np.float32) if l.init == "normal" else
            (np.ones(l.shape, np.float32) if l.init == "ones" else
             0.1 * rng.standard_normal(l.shape).astype(np.float32))
            for k, l in tmpl.items()}


@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_block_decode_with_state_matches_reference(block, rng):
    """One block, prefill (no state) of 5 tokens and then 3 single-token
    steps carrying the state, output and state against the reference."""
    arch = "zamba2-2.7b" if block == "mamba2" else "xlstm-1.3b"
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jmod, tmod = (jm2, tm2) if block == "mamba2" else (jxl, txl)
    tmpl = getattr(jmod, f"{block}_template")(jcfg)
    p = _block_params(rng, tmpl)
    st_tmpl = getattr(jmod, f"{block}_state_template")(jcfg, 2)
    st = jax.tree.map(np.array, j_materialize(jax.random.PRNGKey(0), st_tmpl,
                                              dtype_override="float32"))
    jfn, tfn = getattr(jmod, f"{block}_block"), getattr(tmod, f"{block}_block")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jo, _ = jfn(jcfg, jp, jnp.asarray(x))
    to, _ = tfn(cfg, tp, torch.as_tensor(x))
    _close(to, jo)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.as_tensor(v) for k, v in st.items()}
    for _ in range(3):
        x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jo, jst = jfn(jcfg, jp, jnp.asarray(x), state=jst)
        to, tst = tfn(cfg, tp, torch.as_tensor(x), state=tst)
        _close(to, jo)
        assert tst.keys() == jst.keys()
        for k in jst:
            _close(tst[k], jst[k])


# (case, kwargs): whisper's encoder (non-causal, no RoPE), its decoder
# self-attention (causal, no RoPE), its cross-attention (K/V from kv_x,
# Skv != S, no RoPE), a cross-attention with RoPE (q rotated, k not), and
# a qkv-bias config's non-causal self-attention with RoPE
GQA_CASES = [("encoder", "whisper-large-v3", dict(causal=False, use_rope=False)),
             ("decoder_self", "whisper-large-v3", dict(causal=True, use_rope=False)),
             ("cross", "whisper-large-v3", dict(causal=False, use_rope=False, kv=11)),
             ("cross_rope", "qwen2-vl-72b", dict(causal=False, use_rope=True, kv=11)),
             ("noncausal_bias", "qwen2-vl-72b", dict(causal=False, use_rope=True))]


@pytest.mark.parametrize("case,arch,kw", GQA_CASES, ids=[c[0] for c in GQA_CASES])
def test_gqa_attention_options_match_reference(case, arch, kw, rng):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    p = _block_params(rng, jattn.gqa_template(jcfg))
    B, S = 2, 6
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    kv = kw.pop("kv", None)
    kv_x = None if kv is None else rng.standard_normal((B, kv, jcfg.d_model)).astype(np.float32)
    pos = np.arange(3, 3 + S)
    jo, _ = jattn.gqa_attention(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jnp.asarray(pos),
                                kv_x=None if kv_x is None else jnp.asarray(kv_x), **kw)
    to, _ = tattn.gqa_attention(cfg, {k: torch.as_tensor(v) for k, v in p.items()},
                                torch.as_tensor(x), torch.as_tensor(pos),
                                kv_x=None if kv_x is None else torch.as_tensor(kv_x), **kw)
    _close(to, jo)


@pytest.mark.parametrize("cache_index", [0, 5, 9, 11])
def test_gqa_cache_write_clamps_as_dynamic_update_slice(cache_index, rng):
    """A 3-token write into a 10-slot cache: starts past 7 are clamped to
    7, as `dynamic_update_slice` clamps them; kv_len stays index + 3."""
    jcfg, cfg = j_reduced(j_get_config("qwen2-vl-72b")), reduced(get_config("qwen2-vl-72b"))
    p = _block_params(rng, jattn.gqa_template(jcfg))
    B, S, L = 2, 3, 10
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, L, jcfg.n_kv_heads, jcfg.hdim)).astype(np.float32)
              for _ in range(2))
    pos = np.arange(cache_index, cache_index + S)
    jo, jc = jattn.gqa_attention(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), jnp.asarray(pos),
                                 cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                 cache_index=jnp.asarray(cache_index, jnp.int32))
    tcache = {"k": torch.as_tensor(kc.copy()), "v": torch.as_tensor(vc.copy())}
    to, tc = tattn.gqa_attention(cfg, {k: torch.as_tensor(v) for k, v in p.items()},
                                 torch.as_tensor(x), torch.as_tensor(pos),
                                 cache=tcache, cache_index=cache_index)
    _close(to, jo)
    start = min(cache_index, L - S)
    kept = np.r_[0:start, start + S:L]
    for k, old in (("k", kc), ("v", vc)):
        _close(tc[k], jc[k])
        # the same slots written: the rest hold the old values in both
        np.testing.assert_array_equal(tc[k].numpy()[:, kept], old[:, kept])
        np.testing.assert_array_equal(np.asarray(jc[k])[:, kept], old[:, kept])


def test_apply_mrope_matches_reference(rng):
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(4, 11)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 6, 6), 1e6)
    got = tcommon.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), (4, 6, 6), 1e6)
    _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_new_family_paths_load_neither_jax_nor_repro():
    """Forward, a decode step and a short serving run of each of the four
    families, reduced, on the CPU, in a fresh interpreter."""
    code = (
        "import sys, numpy as np, torch\n"
        "from repro_torch.configs import get_config, reduced\n"
        "from repro_torch.launch.serve import serve_requests\n"
        "from repro_torch.models import lm\n"
        "from repro_torch.models.common import materialize\n"
        f"for arch in {FAMILY_ARCHS!r}:\n"
        "    cfg = reduced(get_config(arch))\n"
        "    p = materialize(torch.Generator().manual_seed(0), lm.model_template(cfg),\n"
        "                    dtype_override='float32', device='cpu')\n"
        "    b = {'tokens': torch.zeros((1, 5), dtype=torch.int64)}\n"
        "    if cfg.family == 'audio':\n"
        "        b['frames'] = torch.zeros((1, cfg.enc_len, cfg.d_model))\n"
        "    assert lm.forward(cfg, p, b).shape == (1, 5, cfg.vocab)\n"
        "    c = materialize(None, lm.cache_template(cfg, 1, 4),\n"
        "                    dtype_override='float32', device='cpu')\n"
        "    lm.decode_step(cfg, p, c, b['tokens'][:, :1], 0)\n"
        "    serve_requests(cfg, p, [np.arange(4)], batch=1, max_prompt=4,\n"
        "                   max_new=2, device='cpu')\n"
        "bad = [m for m in sys.modules if m.startswith('jax') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
