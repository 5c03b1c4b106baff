"""The port's LM substrate in bf16, and the backward of its two LM kernels'
autograd Functions, against `repro` on the same numpy inputs (CPU).

bf16 parity is judged by the reference's own bf16 error.  For each family's
reduced config, on the same bf16 weights (the reference's `materialize` in
the templates' dtype), e_ref = max|ref_bf16 - ref_fp32| / max(1, max|ref_fp32|),
the fp32 run taking those weights exactly.  The port's bf16 result must lie
within BF16_MODEL_MULTIPLE x e_ref + TOL of the reference's bf16 result, on
the same scale.  Why 3: |port - ref_bf16| <= |port - ref_fp32| + e_ref; the
port rounds in bf16 at the same tensors as the reference but not always at
the same places (flash scales q in fp32, the MoE FFN keeps its
intermediates in fp32, other orders of summation), so its own distance to
fp32 is allowed up to 2 e_ref.  TOL (1e-4) is the port's fp32 limit.
Logits are compared, not greedy tokens: bf16 argmax ties make token
equality a coin toss.  chip_smoke.py holds bf16 decode against bf16 forward
on the card by the same multiple.

The reference runs on a (1, 1) Auto-axis mesh built here, as in
tests/test_torch_lm.py (`make_host_mesh` gives Explicit axes, which
`with_sharding_constraint` refuses under the installed jax).
"""
import importlib.util
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
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.moe_dispatch.kernel import grouped_ffn_pallas
from repro.kernels.moe_dispatch.ops import expert_ffn_einsum
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.models import lm as jlm
from repro.models.common import materialize as j_materialize
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_backward
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_magnitude,
                                                     flash_attention_delta_error,
                                                     flash_attention_ref)
from repro_torch.kernels.moe_dispatch.ops import grouped_ffn, grouped_ffn_backward
from repro_torch.kernels.moe_dispatch.ref import grouped_ffn_bwd_magnitude
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import lm
from repro_torch.models.common import materialize, tree_items

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCHS = ["qwen2-1.5b", "deepseek-v2-236b", "qwen2-vl-72b", "whisper-large-v3",
         "xlstm-1.3b", "zamba2-2.7b"]          # one config of each family
MULTIPLE = chip_smoke.BF16_MODEL_MULTIPLE
TOL = 1e-4
U = 2.0 ** -8                                  # bf16 unit roundoff
B, S = 2, 8


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


_MODELS = {}


def _model(arch):
    """(port cfg, reference cfg, reference bf16 params, the same as fp32,
    port bf16 params), cached."""
    if arch not in _MODELS:
        jcfg = j_reduced(j_get_config(arch))
        cfg = reduced(get_config(arch))
        jb = j_materialize(jax.random.PRNGKey(0), jlm.model_template(jcfg))
        jf = jax.tree.map(lambda a: a.astype(jnp.float32), jb)
        tb = lm_params_from_reference(jax.tree.map(np.array, jb), cfg, device="cpu")
        _MODELS[arch] = (cfg, jcfg, jb, jf, tb)
    return _MODELS[arch]


def _inputs(cfg, patches=True):
    rng = np.random.default_rng(3)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm" and patches:
        b["patch_embeds"] = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    return b


def _t(b):
    return {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind == "i" else v)
            for k, v in b.items()}


def _held(port, ref_bf16, ref_fp32):
    """(port's error, e_ref), both over max(1, max|ref_fp32|)."""
    scale = max(1.0, float(np.abs(ref_fp32).max()))
    return (float(np.abs(port - ref_bf16).max()) / scale,
            float(np.abs(ref_bf16 - ref_fp32).max()) / scale)


def _reference_decode(jcfg, mesh, params, tokens, steps):
    """Teacher-forced reference decode from the template's cache: logits
    (B, steps, V) and the final cache."""
    step = jax.jit(j_make_decode_step(jcfg, mesh))
    cache = j_materialize(jax.random.PRNGKey(1), jlm.cache_template(jcfg, B, S))
    out = []
    for pos in range(steps):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, pos:pos + 1]),
                             jnp.asarray(pos, jnp.int32))
        out.append(_f64(logits))
    return np.stack(out, 1), cache


def _port_decode(cfg, params, tokens, steps):
    step = make_decode_step(cfg)
    cache = materialize(None, lm.cache_template(cfg, B, S), device="cpu")
    tok = torch.as_tensor(tokens.astype(np.int64))
    out = []
    for pos in range(steps):
        logits, cache = step(params, cache, tok[:, pos:pos + 1], pos)
        out.append(_f64(logits))
    return np.stack(out, 1), cache


# ---------------------------------------------------------------------------
# bf16 serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_decode_match_reference(arch, mesh):
    cfg, jcfg, jb, jf, tb = _model(arch)
    batch = _inputs(cfg)
    fwd = jax.jit(lambda p, b: jlm.forward(jcfg, p, b, mesh=mesh))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_b, want_f = fwd(jb, jbatch), fwd(jf, jbatch)
    got = lm.forward(cfg, tb, _t(batch))
    if cfg.family == "moe":
        want_b, want_f, got = want_b[0], want_f[0], got[0]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, cfg.vocab)
    err, e_ref = _held(_f64(got), _f64(want_b), _f64(want_f))
    assert 0 < e_ref and err <= MULTIPLE * e_ref + TOL, (err, e_ref)

    tokens = _inputs(cfg, patches=False)["tokens"]
    want_b, _ = _reference_decode(jcfg, mesh, jb, tokens, S)
    want_f, _ = _reference_decode(jcfg, mesh, jf, tokens, S)
    got, _ = _port_decode(cfg, tb, tokens, S)
    err, e_ref = _held(got, want_b, want_f)
    assert 0 < e_ref and err <= MULTIPLE * e_ref + TOL, (err, e_ref)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
def test_bf16_recurrent_states_after_two_steps(arch, mesh):
    """The reference's bf16 decode returns its recurrent states in fp32; the
    port's cache holds them in fp32 from the first step (the conv and KV
    caches stay bf16) and they match the reference's, leaf by leaf."""
    cfg, jcfg, jb, jf, tb = _model(arch)
    tokens = _inputs(cfg)["tokens"]
    _, ref_b = _reference_decode(jcfg, mesh, jb, tokens, 2)
    _, ref_f = _reference_decode(jcfg, mesh, jf, tokens, 2)
    _, got = _port_decode(cfg, tb, tokens, 2)
    tmpl = dict(tree_items(lm.cache_template(cfg, B, S)))
    ref_b, ref_f = dict(tree_items(ref_b)), dict(tree_items(ref_f))
    promoted = {path for path, _ in tree_items(got) if path[-2] in lm._FP32_STATES
                and path[-1] in lm._FP32_STATES[path[-2]]}
    assert promoted
    for path, t in tree_items(got):
        assert tmpl[path].dtype == "bfloat16"
        want = "float32" if path in promoted else "bfloat16"
        assert str(t.dtype) == "torch." + want and str(ref_b[path].dtype) == want, path
        err, e_ref = _held(_f64(t), _f64(ref_b[path]), _f64(ref_f[path]))
        assert err <= MULTIPLE * e_ref + TOL, (path, err, e_ref)


# ---------------------------------------------------------------------------
# where the port rounds otherwise than the reference's model path, by design
# ---------------------------------------------------------------------------

def test_flash_scales_q_in_fp32_like_the_pallas_kernel(rng):
    """The port's flash (the plain version here, the CUDA kernel on the card)
    scales q in fp32, as the Pallas kernel does; the reference's scan path
    rounds q * scale to bf16 first.  The port equals the Pallas kernel to
    one bf16 ulp, and differs from the scan path by no more than that
    rounding can move the output: a score moves by at most
    d = U |q scale| |k|, a row's probabilities by a factor within
    exp(+-2 max d), so the output by (exp(2 max d) - 1) p|v|, plus the two
    results' own bf16 rounding.  (D = 48: at a power-of-4 head dim the
    scale is a power of 2 and q * scale rounds to itself.)"""
    Bq, Sq, H, K, D = 2, 64, 4, 2, 48
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 2
               for s in ((Bq, Sq, H, D), (Bq, Sq, K, D), (Bq, Sq, K, D)))
    qb, kb, vb = (torch.as_tensor(a).bfloat16() for a in (q, k, v))
    got = _f64(flash_attention(qb, kb, vb, causal=True))
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (qb, kb, vb)]
    pallas = _f64(flash_attention_pallas(*jb, causal=True))
    scan = _f64(j_flash(*jb, causal=True))
    assert np.all(np.abs(got - pallas) <= chip_smoke.BF16_ULP * np.abs(pallas) + 1e-6)
    diff = np.abs(got - scan)
    assert diff.max() > 0
    # the bound, in float64 from the bf16 inputs
    q64, k64, v64 = (t.double() for t in (qb, kb, vb))
    G = H // K
    qs = q64 * D ** -0.5
    kk, vv = k64.repeat_interleave(G, 2), v64.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kk)
    keep = torch.arange(Sq)[None, :] <= torch.arange(Sq)[:, None]
    p = s.masked_fill(~keep, float("-inf")).softmax(-1)
    d = (U * torch.einsum("bqhd,bkhd->bhqk", qs.abs(), kk.abs())).masked_fill(~keep, 0)
    spread = torch.expm1(2 * d.amax(-1, keepdim=True))
    bound = torch.einsum("bhqk,bkhd->bqhd", spread * p, vv.abs()).numpy()
    bound += U * (np.abs(got) + np.abs(scan))
    assert np.all(diff <= bound)


def test_moe_ffn_keeps_fp32_intermediates_like_the_pallas_kernel(rng):
    """The port's grouped FFN keeps h, u and silu(h) u in fp32, as the
    Pallas kernel does; the reference's `_local_moe` rounds each to bf16
    (its einsums, models/moe.py:79-82, transcribed below).  The port equals
    the Pallas kernel to one bf16 ulp, and differs from the einsums by no
    more than those roundings move the output: each of h, u, silu(h) and
    their product rounds by U, |silu'| <= 1.1, so a = silu(h) u moves by at
    most U (1.1 |h| |u| + 3 |silu(h) u|) (x 1.01 for second-order terms),
    carried through |Wd|, plus the two results' own rounding."""
    E, C, d, f = 3, 16, 64, 96
    counts = np.array([16, 9, 0], np.int32)
    live = (np.arange(C)[None, :] < counts[:, None])[..., None]
    x = np.where(live, rng.standard_normal((E, C, d)), 0).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * s[1] ** -0.5
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    tb = [torch.as_tensor(a).bfloat16() for a in [x] + ws]
    got = _f64(grouped_ffn(*tb, torch.as_tensor(counts)))
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tb]
    pallas = _f64(grouped_ffn_pallas(*jb, jnp.asarray(counts)))
    h = jnp.einsum("ecd,edf->ecf", jb[0], jb[1])
    u = jnp.einsum("ecd,edf->ecf", jb[0], jb[2])
    einsum = _f64(jnp.einsum("ecf,efd->ecd",
                             jax.nn.silu(h.astype(jnp.float32)).astype(h.dtype) * u, jb[3]))
    assert np.all(np.abs(got - pallas) <= chip_smoke.BF16_ULP * np.abs(pallas) + 1e-6)
    diff = np.abs(got - einsum)
    assert diff.max() > 0
    x64, wg, wu, wd = (t.double() for t in tb)
    h64, u64 = torch.bmm(x64, wg), torch.bmm(x64, wu)
    a_err = U * 1.01 * (1.1 * h64.abs() * u64.abs()
                        + 3 * (torch.nn.functional.silu(h64) * u64).abs())
    bound = torch.bmm(a_err, wd.abs()).numpy() + U * (np.abs(got) + np.abs(einsum))
    assert np.all(diff <= bound)


_drift_spec = importlib.util.spec_from_file_location("bf16_drift",
                                                     ROOT / "tools" / "bf16_drift.py")
bf16_drift = importlib.util.module_from_spec(_drift_spec)
_drift_spec.loader.exec_module(bf16_drift)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
def test_bf16_full_width_cut_meets_the_reference_error_chip_smoke_uses(arch, mesh):
    """At the published widths cut to one super-block (chip_smoke.py phase
    7b's configuration), on the seed-0 weights chip_smoke.py draws: their
    fingerprint is the one `BF16_REF_WEIGHTS` names, the port's bf16
    forward lies within MULTIPLE x e_ref + TOL of the reference's, and
    the port's own bf16-vs-fp32 error within MULTIPLE x the `BF16_REF_ERR`
    that phase 7b holds the card to."""
    row = bf16_drift.measure("full_width_cut", arch, 0, mesh)
    assert row["weights"] == chip_smoke.BF16_REF_WEIGHTS[arch]
    assert row["port_vs_ref"] <= MULTIPLE * row["e_ref"] + TOL
    assert row["e_port"] <= MULTIPLE * chip_smoke.BF16_REF_ERR[arch]
    assert row["fp32_port_vs_ref"] <= TOL


# ---------------------------------------------------------------------------
# the backward of the two LM kernels' autograd Functions
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = {
    # B, Sq, Sk, H, K, D, Dv, causal, window, kv_len
    "gqa_causal": (2, 40, 40, 6, 2, 16, 16, True, None, None),
    "mla_dv": (1, 33, 33, 4, 4, 24, 16, True, None, None),
    "window": (2, 48, 48, 4, 2, 16, 16, True, 12, None),
    "kv_len": (2, 3, 50, 4, 1, 16, 16, False, None, [37, 50]),
}


@pytest.mark.parametrize("case", list(FLASH_BWD_CASES))
def test_flash_backward_matches_reference_vjp(case, rng):
    """dq, dk, dv of the port's flash (plain forward on the CPU, the
    blockwise backward; 16-key blocks so several blocks and a ragged last
    one are walked) against `jax.vjp` of the reference's scan path, fp32,
    within 2e-5 x max(1, |ref|)."""
    Bq, Sq, Sk, H, K, D, Dv, causal, window, kv = FLASH_BWD_CASES[case]
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Bq, Sq, H, D), (Bq, Sk, K, D), (Bq, Sk, K, Dv)))
    do = rng.standard_normal((Bq, Sq, H, Dv)).astype(np.float32)
    kv_len = None if kv is None else np.array(kv, np.int32)
    ts = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*ts, causal=causal, window=window, block_k=16,
                          kv_len=None if kv_len is None else torch.as_tensor(kv_len))
    got = torch.autograd.grad(out, ts, torch.as_tensor(do))
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    _, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, causal=causal, window=window,
                                             block_k=16, kv_len=jkv),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        w = _f64(w)
        assert np.abs(_f64(g) - w).max() <= 2e-5 * max(1.0, np.abs(w).max())


def test_grouped_ffn_backward_matches_reference_vjp(rng):
    """d buckets and the three weight gradients of the port's grouped FFN
    against `jax.vjp` of the reference's `expert_ffn_einsum` on buckets
    whose dead rows are zero (as `dispatch` leaves them), fp32, with an
    output gradient that is not zero on the dead rows (the port gives them
    zero gradient; the einsum's is zero there too, h = u = 0)."""
    E, C, d, f = 4, 12, 32, 48
    counts = np.array([12, 5, 0, 1], np.int32)
    live = (np.arange(C)[None, :] < counts[:, None])[..., None]
    x = np.where(live, rng.standard_normal((E, C, d)), 0).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * s[1] ** -0.5
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    dy = rng.standard_normal((E, C, d)).astype(np.float32)
    ts = [torch.as_tensor(a).requires_grad_(True) for a in [x] + ws]
    got = torch.autograd.grad(grouped_ffn(*ts, torch.as_tensor(counts)), ts,
                              torch.as_tensor(dy))
    _, vjp = jax.vjp(expert_ffn_einsum, *(jnp.asarray(a) for a in [x] + ws))
    # the reference's dead rows carry dy through a zero output only after
    # the caller's combine; hold its gradient at the live rows' dy
    want = vjp(jnp.asarray(np.where(live, dy, 0)))
    for g, w in zip(got, want):
        w = _f64(w)
        assert np.abs(_f64(g) - w).max() <= 2e-5 * max(1.0, np.abs(w).max())
    assert not got[0][~torch.as_tensor(live[..., 0])].any()


def _attn64(q, k, v, *, causal=True, drop_diagonal=False, scale=1.0):
    """Dense attention in float64 (GQA, queries right-aligned)."""
    Bq, Sq, H, D = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    kk, vv = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, kk) * D ** -0.5
    q_pos = torch.arange(Sq)[:, None] + Sk - Sq
    keep = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        keep &= torch.arange(Sk)[None, :] <= q_pos
    if drop_diagonal:
        keep &= (torch.arange(Sk)[None, :] != q_pos) | (q_pos == 0)
    return torch.einsum("bhqk,bkhd->bqhd", s.masked_fill(~keep, float("-inf")).softmax(-1), vv)


def _ffn64(x, wg, wu, wd, counts, act=torch.nn.functional.silu):
    y = torch.bmm(act(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)
    live = torch.arange(x.shape[1])[None, :] < counts[:, None]
    return torch.where(live[..., None], y, 0.0)


def _grads64(fn, inputs, dy):
    xs = [t.double().requires_grad_(True) for t in inputs]
    return [g.detach() for g in torch.autograd.grad(fn(*xs), xs, dy.double())]


@pytest.mark.parametrize("kernel", ["flash_attention", "grouped_ffn"])
def test_chip_smoke_backward_limits_pass_fp32_rounding_and_fail_faults(kernel, rng):
    """The port's backward in fp32 stays within a fifth of the limit
    chip_smoke.py sets for kernel-path vs plain gradients (LM_BWD_TOL over
    the stage-by-stage magnitude), and gradients with a planted fault
    exceed it in at least one of the gradients."""
    abs_tol, rel_tol = chip_smoke.LM_BWD_TOL[kernel]
    if kernel == "flash_attention":
        shapes = ((1, 96, 4, 32), (1, 96, 2, 32), (1, 96, 2, 32), (1, 96, 4, 32))
        q, k, v, do = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                       for s in shapes)
        o = flash_attention_ref(q, k, v, causal=True, block_k=32)
        got = flash_attention_backward(q, k, v, o, do, causal=True, block_k=32)
        mags = flash_attention_bwd_magnitude(q, k, v, do, causal=True)
        exact = _grads64(_attn64, (q, k, v), do)
        faults = {"diagonal key dropped":
                  _grads64(lambda *a: _attn64(*a, drop_diagonal=True), (q, k, v), do),
                  "not causal": _grads64(lambda *a: _attn64(*a, causal=False), (q, k, v), do),
                  "scores scaled 1.001":
                  _grads64(lambda *a: _attn64(*a, scale=1.001), (q, k, v), do)}
    else:
        E, C, d, f = 3, 16, 64, 96
        counts = torch.tensor([16, 5, 0], dtype=torch.int32)
        x = torch.as_tensor(rng.standard_normal((E, C, d)).astype(np.float32))
        ws = [torch.as_tensor((rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32))
              for s in ((E, d, f), (E, d, f), (E, f, d))]
        dy = torch.as_tensor(rng.standard_normal((E, C, d)).astype(np.float32))
        got = grouped_ffn_backward(x, *ws, counts, dy)
        mags = grouped_ffn_bwd_magnitude(x, *ws, counts, dy)
        exact = _grads64(lambda *a: _ffn64(*a, counts), (x, *ws), dy)
        faults = {"no silu": _grads64(lambda *a: _ffn64(*a, counts, act=lambda t: t),
                                      (x, *ws), dy),
                  "gate and up swapped": _grads64(
                      lambda a, b, c, e: _ffn64(a, c, b, e, counts), (x, *ws), dy),
                  "a dead row live": _grads64(
                      lambda *a: _ffn64(*a, torch.tensor([16, 6, 0])), (x, *ws), dy)}
    limits = [abs_tol + rel_tol * m.double() for m in mags]
    for g, e, lim in zip(got, exact, limits):
        assert bool(((g.double() - e).abs() <= lim / 5).all())
    for name, wrong in faults.items():
        assert any(bool(((w - e).abs() > lim).any())
                   for w, e, lim in zip(wrong, exact, limits)), name


def test_flash_backward_on_a_bf16_output_stays_within_the_delta_bound(rng):
    """The backward reads the forward's output in ``delta``; an output
    rounded to bf16 moves dq and dk by no more than
    `flash_attention_delta_error` at one bf16 ulp of |o| (the term
    chip_smoke.py adds to its bf16 limit), dv not at all, and the bound is
    not vacuous: it is below the gradients' own size."""
    shapes = ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 24), (2, 64, 4, 24))
    q, k, v, do = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                   for s in shapes)
    o = flash_attention_ref(q, k, v, causal=True, block_k=16)
    exact = flash_attention_backward(q, k, v, o, do, causal=True, block_k=16)
    rounded = flash_attention_backward(q, k, v, o.bfloat16().float(), do, causal=True,
                                       block_k=16)
    bound = flash_attention_delta_error(q, k, v, do, chip_smoke.BF16_ULP, causal=True)
    for g, e, b in zip(rounded, exact, bound):
        assert bool(((g - e).abs() <= b + 1e-6).all())
    assert torch.equal(rounded[2], exact[2])
    for e, b in zip(exact[:2], bound[:2]):
        assert float(b.max()) < 0.1 * float(e.abs().max())


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_train_and_optim_load_neither_jax_nor_repro(tmp_path):
    """Two training steps of `launch/train.py` on the CPU with a
    checkpoint, and the optimizer, data, checkpointing and distributed
    modules, in a fresh interpreter."""
    code = (
        "import sys\n"
        "import repro_torch.optim, repro_torch.checkpointing, repro_torch.data\n"
        "import repro_torch.distributed\n"
        "from repro_torch.launch import train\n"
        "train.main(['--arch', 'deepseek-v2-236b', '--reduced', '--steps', '2',\n"
        "            '--batch', '2', '--seq', '8', '--device', 'cpu',\n"
        f"            '--ckpt-dir', {str(tmp_path)!r}, '--ckpt-every', '1'])\n"
        "bad = [m for m in sys.modules if m.startswith('jax') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "step_00000001" / "manifest.json").exists()
