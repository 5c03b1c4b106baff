"""The port's LM serving path against `repro.models.lm` on the same weights.

The reference runs on a (1, 1) ("data", "model") mesh with Auto axes that
this file builds itself: `make_host_mesh` (the `host_mesh` fixture) gives
Explicit axes under the installed jax, which `with_sharding_constraint`
refuses, and `moe_layer` needs a mesh.  Weights come from the reference's
`materialize` and reach the port through `lm_params_from_reference`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AxisType

from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.models import lm as jlm
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models.common import materialize as j_materialize
from repro_torch.configs import all_configs, get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.serve import serve_requests
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import lm
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models.common import materialize, tree_items

# all six families; tests/test_torch_lm_families.py holds the vlm, audio,
# ssm and hybrid ones to their own inputs (patch embeddings, a non-zero
# cross cache, a wrapped ring) and their blocks' pieces
ARCHS = ["smollm-135m", "qwen2-1.5b", "qwen3-32b", "command-r-35b",
         "deepseek-v2-236b", "deepseek-v3-671b", "qwen2-vl-72b", "whisper-large-v3",
         "xlstm-1.3b", "zamba2-2.7b"]
TOL = 1e-4   # x max(1, |ref|)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def _weights(cfg, seed=0):
    """Reference weights (numpy tree) and the port's tensors from them.  A
    balancing bias, zero at init, gets random values so routing uses it."""
    jp = j_materialize(jax.random.PRNGKey(seed), jlm.model_template(cfg),
                       dtype_override="float32")
    np_tree = jax.tree.map(np.array, jp)
    if cfg.moe is not None and cfg.moe.aux_free_bias:
        rng = np.random.default_rng(seed)
        for stack in ("layers",):
            b = np_tree[stack]["moe"]["router_bias"]
            np_tree[stack]["moe"]["router_bias"] = rng.standard_normal(b.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, np_tree)
    return jp, lm_params_from_reference(np_tree, cfg, device="cpu")


def _frames(cfg, B, seed=4):
    """The audio family's seeded frame embeddings (none for the others)."""
    if cfg.family != "audio":
        return {}
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(np.float32)}


def _reference_decode(cfg, mesh, jp, tokens, max_len):
    """Teacher-forced reference decode: logits (B, S, vocab)."""
    B, S = tokens.shape
    step = jax.jit(j_make_decode_step(cfg, mesh))
    cache = j_materialize(jax.random.PRNGKey(1), jlm.cache_template(cfg, B, max_len),
                          dtype_override="float32")
    out = []
    for pos in range(S):
        logits, cache = step(jp, cache, jnp.asarray(tokens[:, pos:pos + 1]),
                             jnp.asarray(pos, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_reference(arch, mesh):
    cfg = reduced(get_config(arch))
    jcfg = j_reduced(j_get_config(arch))
    jp, tp = _weights(jcfg)
    B, S = 2, 8
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = _frames(cfg, B)

    j_out = jax.jit(lambda p, t, e: jlm.forward(jcfg, p, {"tokens": t, **e}, mesh=mesh))(
        jp, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in extra.items()})
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
             **{k: torch.as_tensor(v) for k, v in extra.items()}}
    t_out = lm.forward(cfg, tp, batch)
    if cfg.family == "moe":
        (j_logits, j_aux), (t_logits, t_aux) = j_out, t_out
        _close(t_aux, j_aux)
    else:
        j_logits, t_logits = j_out, t_out
    assert t_logits.shape == (B, S, cfg.vocab)
    _close(t_logits, j_logits)

    # teacher-forced decode, step by step, against the reference's decode
    want = _reference_decode(jcfg, mesh, jp, tokens, S)
    step = make_decode_step(cfg)
    cache = materialize(None, lm.cache_template(cfg, B, S), dtype_override="float32",
                        device="cpu")
    tok = torch.as_tensor(tokens, dtype=torch.int64)
    for pos in range(S):
        logits, cache = step(tp, cache, tok[:, pos:pos + 1], pos)
        _close(logits, want[:, pos])
    # and the prefill step's next-token logits are the forward's last row
    _close(make_prefill_step(cfg)(tp, batch), t_logits[:, -1])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b"])
def test_serve_requests_matches_reference_loop(arch, mesh):
    """The greedy tokens of `serve_requests` equal those of the reference
    serving loop (`repro.launch.serve.main`'s) driven by its decode step."""
    cfg = reduced(get_config(arch))
    jcfg = j_reduced(j_get_config(arch))
    jp, tp = _weights(jcfg, seed=1)
    n_req, batch, max_prompt, max_new = 5, 2, 8, 4
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, max_prompt + 1)).astype(np.int32)
               for _ in range(n_req)]
    # float32 caches, as the reference loop's (dtype_override="float32")
    res = serve_requests(cfg, tp, prompts, batch=batch, max_prompt=max_prompt,
                         max_new=max_new, device="cpu", dtype="float32")

    step = jax.jit(j_make_decode_step(jcfg, mesh))
    queue, want = list(prompts), []
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
            logits, cache = step(jp, cache, tok,
                                 jnp.asarray(int(lens.max()) + i, jnp.int32))
            tok = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
        want.append(out)
    assert len(res["tokens"]) == len(want)
    for got, exp in zip(res["tokens"], want):
        np.testing.assert_array_equal(got, exp)
    n_steps = sum(max(len(p) for p in prompts[i:i + batch]) + max_new
                  for i in range(0, n_req, batch))
    assert len(res["step_s"]) == n_steps and res["tokens_per_s"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_module_matches_functions(arch):
    cfg = reduced(get_config(arch))
    params = materialize(torch.Generator().manual_seed(0), lm.model_template(cfg),
                         dtype_override="float32", device="cpu")
    model = lm.LM(cfg, params)
    assert not any(p.requires_grad for p in model.parameters())
    assert len(model.state_dict()) == len(list(tree_items(params)))
    tokens = torch.randint(0, cfg.vocab, (2, 4), generator=torch.Generator().manual_seed(1))
    extra = {k: torch.as_tensor(v) for k, v in _frames(cfg, 2).items()}
    got, want = model(tokens, **extra), lm.forward(cfg, params, {"tokens": tokens, **extra})
    if cfg.family == "moe":
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        got, want = got[0], want[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    cache = materialize(None, lm.cache_template(cfg, 2, 4), dtype_override="float32",
                        device="cpu")
    got, _ = model.decode_step(cache, tokens[:, :1], 0)
    assert got.shape == (2, 1, cfg.vocab)


def test_materialize_follows_the_template():
    cfg = reduced(get_config("qwen2-1.5b"))
    tmpl = dict(tree_items(lm.model_template(cfg)))
    params = dict(tree_items(materialize(torch.Generator().manual_seed(0),
                                         lm.model_template(cfg), device="cpu")))
    assert params.keys() == tmpl.keys()
    for path, l in tmpl.items():
        t = params[path]
        assert tuple(t.shape) == l.shape and t.dtype == getattr(torch, l.dtype)
        if l.init == "zeros":
            assert not t.any()
        elif l.init == "ones":
            assert bool((t == 1).all())
    emb = params[("embed",)].float()
    assert abs(float(emb.std()) - 0.02) < 2e-3


def test_lm_entry_points_run_on_cuda_unless_told_otherwise():
    """With no card visible, omitting ``device`` raises instead of quietly
    making parameters or serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    cfg = reduced(get_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        materialize(None, lm.cache_template(cfg, 1, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_requests(cfg, {}, [np.arange(4)], batch=1, max_prompt=4, max_new=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_reference_checks_names_and_shapes(arch):
    """A wrong shape or a missing leaf raises, at the top of the tree and
    at its deepest leaf (inside the ssm / hybrid super-block stacks)."""
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced(get_config(arch))
    np_tree = jax.tree.map(np.array, j_materialize(
        jax.random.PRNGKey(0), jlm.model_template(jcfg), dtype_override="float32"))
    lm_params_from_reference(np_tree, cfg, device="cpu")
    deepest = max((path for path, _ in tree_items(np_tree)), key=len)
    for path in (("embed",), deepest):
        *parents, name = path
        node = np_tree
        for k in parents:
            node = node[k]
        keep = node[name]
        node[name] = np.ones(3, np.float32)
        with pytest.raises(ValueError, match="shape"):
            lm_params_from_reference(np_tree, cfg, device="cpu")
        del node[name]
        with pytest.raises(ValueError, match="missing"):
            lm_params_from_reference(np_tree, cfg, device="cpu")
        node[name] = keep


def test_configs_are_the_references():
    ours, theirs = all_configs(), j_all_configs()
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert dataclasses.asdict(ours[name]) == dataclasses.asdict(theirs[name])
        assert dataclasses.asdict(reduced(ours[name])) == \
            dataclasses.asdict(j_reduced(theirs[name]))
        assert ours[name].param_count() == theirs[name].param_count()


@pytest.mark.parametrize("ffn", ["dense", "gelu"])
def test_ffns_match_reference(ffn, rng):
    cfg = j_reduced(j_get_config("qwen2-1.5b"))
    tmpl = (jmoe.dense_ffn_template(cfg) if ffn == "dense"
            else jmoe.gelu_ffn_template(cfg))
    p = {k: (rng.standard_normal(l.shape) * 0.2).astype(np.float32)
         for k, l in tmpl.items()}
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    j_fn, t_fn = ((jmoe.dense_ffn, tmoe.dense_ffn) if ffn == "dense"
                  else (jmoe.gelu_ffn, tmoe.gelu_ffn))
    want = j_fn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = t_fn({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x))
    _close(got, want, 2e-5)


def test_norms_rope_and_positions_match_reference(rng):
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w, b = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    tx, tw, tb = (torch.as_tensor(a) for a in (x, w, b))
    _close(tcommon.rms_norm(tx, tw, 1e-6), jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-6)
    _close(tcommon.layer_norm(tx, tw, tb), jcommon.layer_norm(*(jnp.asarray(a) for a in (x, w, b))), 1e-6)
    pos = np.arange(7, 12)
    tcos, tsin = tcommon.rope_freqs(16, 1e4, torch.as_tensor(pos))
    jcos, jsin = jcommon.rope_freqs(16, 1e4, jnp.asarray(pos))
    _close(tcos, jcos, 1e-6)
    _close(tsin, jsin, 1e-6)
    _close(tcommon.apply_rope(tx, tcos, tsin), jcommon.apply_rope(jnp.asarray(x), jcos, jsin), 1e-6)
    _close(tcommon.sinusoidal_positions(9, 16), jcommon.sinusoidal_positions(9, 16), 1e-6)
