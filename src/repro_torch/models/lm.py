"""Full-model assembly for the six LM families.

Ports ``repro.models.lm`` for one device:

  dense | vlm  — pre-norm GQA transformer (qk-norm / qkv-bias / parallel-block
                 / tied-embedding options); vlm prepends stub patch
                 embeddings (``batch["patch_embeds"]``) and returns the
                 logits of the text positions;
  moe          — DeepSeek: MLA attention + (first_dense dense layers, then
                 routed MoE layers with shared experts);
  audio        — Whisper encoder-decoder; the conv/mel frontend is a stub
                 (frame embeddings arrive as ``batch["frames"]``);
  ssm          — xLSTM super-blocks (slstm_every - 1 mLSTM + 1 sLSTM);
  hybrid       — Zamba2 super-blocks (shared_attn_every Mamba2 blocks + one
                 weight-shared attention/MLP block, whose decode cache is a
                 ring buffer of the attention window).

Parameters are the reference's tree — nested dicts of tensors, each layer
stack with a leading layer axis (the ssm and hybrid super-blocks nest a
second stack) — so weights carry across name for name
(:func:`repro_torch.convert.lm_params_from_reference`).  The reference's
``lax.scan`` over a stack is a Python loop over its layer axis here.  Where
the reference wraps a block in ``jax.checkpoint``, the port runs it through
``torch.utils.checkpoint`` (non-reentrant) whenever autograd records, so
training keeps each block's input and recomputes the rest in backward;
:func:`loss_fn` is the training objective.  Decode updates the cache in
place and returns it: KV caches by slice writes, recurrent states by
copying each block's new state into its cache views.

With a :class:`~repro_torch.core.exchange.ShardMesh` (``mesh=``) every
family runs laid out by its templates' specs, as the reference's GSPMD
places them: the batch split over data, attention, FFNs, shared experts and
the recurrent blocks' heads tensor parallel over model, the routed experts
expert parallel, ``embed`` and ``head`` split over the vocabulary (a lookup
masked to each rank's rows and psummed; logits all-gathered over model, so
the loss is the mesh-less cross entropy on each data shard's rows).  The
audio, ssm and hybrid families have one body a block for a mesh and for
none: without a mesh it runs as a lone rank on the whole leaves
(``common.lone_tree``), calling no collective.  Whole
parameters are sharded on entry (:func:`~repro_torch.models.common
.shard_params`); a :class:`~repro_torch.models.common.ShardedTree` is used
as it is.  The batch holds the rows of the process's data shards, in
order: the whole batch in one process, its shard's rows
(``TokenPipeline.shard_for``) under a process group; outputs come back
likewise.

Dtypes follow the reference's: parameters and caches in the templates'
dtype (bfloat16 unless overridden), the recurrences in float32.  The
reference's decode *returns* the xLSTM states (mLSTM ``C``, ``n``, ``m``;
sLSTM ``c``, ``n``, ``h``, ``m``) and the Mamba2 ``ssm`` state in float32
whatever the cache's dtype, so from its second step on it carries them in
float32.  The port promotes those leaves of the cache to float32 on the
first decode step (:func:`_promote_states`; a float32 cache is left as it
is), so copying a new state into the cache never rounds it; KV, MLA
latent and conv caches stay in the cache's dtype, as the reference casts
into them.  :class:`LM` is a thin ``nn.Module`` that registers the tensors
and calls these functions.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import runtime_flags
from ..configs.base import ArchConfig
from . import attention as A
from . import mamba2 as M2
from . import moe as MOE
from . import xlstm as XL
from .common import (ShardedTree, cross_entropy, join_blocks, layer, layer_norm, leaf,
                     lone_tree, materialize, model_sharded, rms_norm, row_parallel,
                     select_heads, shard_params, shard_zeros, sinusoidal_positions,
                     split_heads, stack_templates, tree_items)

FAMILIES = ("dense", "vlm", "moe", "audio", "ssm", "hybrid")
#: the families whose blocks have one body for a mesh and for none
ONE_BODY = ("audio", "ssm", "hybrid")
VLM_PATCHES = 256  # stub vision prefix length for the vlm family


def _require_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown LM family {cfg.family!r}")


def layer_stack_sizes(cfg: ArchConfig) -> Dict[str, int]:
    """Real trip count of each layer stack — the dry run extrapolates its
    probes' costs with these (``repro.models.lm.layer_stack_sizes``)."""
    if cfg.family in ("dense", "vlm"):
        return {"layers": cfg.n_layers}
    if cfg.family == "moe":
        d = {"layers": cfg.n_layers - cfg.moe.first_dense}
        if cfg.moe.first_dense:
            d["dense_layers"] = cfg.moe.first_dense
        return d
    if cfg.family == "audio":
        return {"layers": cfg.n_layers, "enc_layers": cfg.n_encoder_layers}
    if cfg.family == "ssm":
        return {"layers": cfg.n_layers // cfg.xlstm.slstm_every}
    if cfg.family == "hybrid":
        return {"layers": cfg.n_layers // cfg.shared_attn_every}
    raise ValueError(cfg.family)


def stack_range(name: str, n: int) -> range:
    """The layers a loop over stack ``name`` (of ``n``) runs: every one, or
    while the dry run probes (``runtime_flags.PROBE["stack_counts"]``) the
    first count it names for the stack (1 where it names none), as the
    reference's ``scan_blocks``."""
    stacks = runtime_flags.probe_stacks()
    return range(n if stacks is None else min(n, stacks.get(name, 1)))


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------

def _dense_block_template(cfg: ArchConfig) -> Dict:
    return {
        "ln1": leaf((cfg.d_model,), (None,), init="ones"),
        "attn": A.gqa_template(cfg),
        "ln2": leaf((cfg.d_model,), (None,), init="ones"),
        "ffn": MOE.dense_ffn_template(cfg),
    }


def _mla_block_template(cfg: ArchConfig, kind: str) -> Dict:
    t = {
        "ln1": leaf((cfg.d_model,), (None,), init="ones"),
        "attn": A.mla_template(cfg),
        "ln2": leaf((cfg.d_model,), (None,), init="ones"),
    }
    if kind == "moe":
        t["moe"] = MOE.moe_template(cfg)
    else:
        t["ffn"] = MOE.dense_ffn_template(cfg, cfg.moe.d_ff_dense)
    return t


def _ln_template(d: int) -> Dict:
    return {"w": leaf((d,), (None,), init="ones"), "b": leaf((d,), (None,), init="zeros")}


def _whisper_block_template(cfg: ArchConfig, cross: bool) -> Dict:
    d = cfg.d_model
    t = {"ln1": _ln_template(d), "attn": A.gqa_template(cfg), "ln3": _ln_template(d),
         "ffn": MOE.gelu_ffn_template(cfg)}
    if cross:
        t["ln2"] = _ln_template(d)
        t["xattn"] = A.gqa_template(cfg)
    return t


def _xlstm_super_template(cfg: ArchConfig) -> Dict:
    k = cfg.xlstm.slstm_every
    return {
        "mlstm": stack_templates({"ln": leaf((cfg.d_model,), (None,), init="ones"),
                                  "cell": XL.mlstm_template(cfg)}, k - 1),
        "slstm": {"ln": leaf((cfg.d_model,), (None,), init="ones"),
                  "cell": XL.slstm_template(cfg)},
    }


def _zamba_super_template(cfg: ArchConfig) -> Dict:
    return {
        "mamba": stack_templates({"ln": leaf((cfg.d_model,), (None,), init="ones"),
                                  "cell": M2.mamba2_template(cfg)},
                                 cfg.shared_attn_every),
    }


def model_template(cfg: ArchConfig) -> Dict:
    _require_family(cfg)
    d, V = cfg.d_model, cfg.vocab
    t: Dict = {"embed": leaf((V, d), ("model", None), scale=0.02)}
    if not cfg.tie_embeddings:
        t["head"] = leaf((d, V), (None, "model"), scale=0.02)
    t["ln_f"] = leaf((d,), (None,), init="ones")
    if cfg.family in ("dense", "vlm"):
        t["layers"] = stack_templates(_dense_block_template(cfg), cfg.n_layers)
    elif cfg.family == "moe":
        mo = cfg.moe
        if mo.first_dense:
            t["dense_layers"] = stack_templates(_mla_block_template(cfg, "dense"),
                                                mo.first_dense)
        t["layers"] = stack_templates(_mla_block_template(cfg, "moe"),
                                      cfg.n_layers - mo.first_dense)
    elif cfg.family == "audio":
        t["enc_layers"] = stack_templates(_whisper_block_template(cfg, cross=False),
                                          cfg.n_encoder_layers)
        t["layers"] = stack_templates(_whisper_block_template(cfg, cross=True),
                                      cfg.n_layers)
        t["ln_enc"] = _ln_template(d)
        t["ln_f"] = _ln_template(d)
    elif cfg.family == "ssm":
        t["layers"] = stack_templates(_xlstm_super_template(cfg),
                                      cfg.n_layers // cfg.xlstm.slstm_every)
    else:  # hybrid
        t["layers"] = stack_templates(_zamba_super_template(cfg),
                                      cfg.n_layers // cfg.shared_attn_every)
        t["shared"] = _dense_block_template(cfg)
    return t


def cache_template(cfg: ArchConfig, batch: int, max_len: int) -> Dict:
    _require_family(cfg)
    if cfg.family in ("dense", "vlm"):
        return {"layers": stack_templates(A.gqa_cache_template(cfg, batch, max_len),
                                          cfg.n_layers)}
    if cfg.family == "moe":
        t = {"layers": stack_templates(A.mla_cache_template(cfg, batch, max_len),
                                       cfg.n_layers - cfg.moe.first_dense)}
        if cfg.moe.first_dense:
            t["dense_layers"] = stack_templates(
                A.mla_cache_template(cfg, batch, max_len), cfg.moe.first_dense)
        return t
    if cfg.family == "audio":
        return {
            "layers": stack_templates(A.gqa_cache_template(cfg, batch, max_len),
                                      cfg.n_layers),
            # cross-attention K/V of the encoder output; nothing in the
            # serving loop fills it (zeros), as in the reference
            "cross": stack_templates(A.gqa_cache_template(cfg, batch, cfg.enc_len),
                                     cfg.n_layers),
        }
    if cfg.family == "ssm":
        return {"layers": stack_templates({
            "mlstm": stack_templates(XL.mlstm_state_template(cfg, batch),
                                     cfg.xlstm.slstm_every - 1),
            "slstm": XL.slstm_state_template(cfg, batch),
        }, cfg.n_layers // cfg.xlstm.slstm_every)}
    n_super = cfg.n_layers // cfg.shared_attn_every
    win = min(cfg.attn_window or max_len, max_len)
    return {
        "layers": stack_templates(
            {"mamba": stack_templates(M2.mamba2_state_template(cfg, batch),
                                      cfg.shared_attn_every)}, n_super),
        # the weight-shared attention block: one ring-buffer cache of the
        # window per application site
        "shared": stack_templates(A.gqa_cache_template(cfg, batch, win), n_super),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, dtype: Optional[str] = None,
               device=None, mesh=None):
    """A zero cache by :func:`cache_template` (``dtype`` overrides every
    leaf's): whole on ``device``, or with ``mesh`` a
    :class:`~repro_torch.models.common.ShardedTree` laid out by the
    template's specs (``batch`` the global batch)."""
    tmpl = cache_template(cfg, batch, max_len)
    if mesh is not None:
        return shard_zeros(tmpl, mesh, dtype)
    return materialize(None, tmpl, dtype_override=dtype, device=device)


def _n_layers(stack: Dict) -> int:
    return next(t for _, t in tree_items(stack)).shape[0]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _logits(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


def _dense_block(cfg, p, h, positions, cache=None, pos=None):
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    ao, cache = A.gqa_attention(cfg, p["attn"], hn, positions,
                                cache=cache, cache_index=pos)
    if cfg.parallel_block:  # command-r: attn and FFN in parallel
        return h + ao + MOE.dense_ffn(p["ffn"], hn)
    h = h + ao
    return h + MOE.dense_ffn(p["ffn"], rms_norm(h, p["ln2"], cfg.norm_eps))


def _mla_block(cfg, kind, p, h, positions, cache=None, pos=None, token_chunks=4):
    ao, _ = A.mla_attention(cfg, p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                            positions, cache=cache, cache_index=pos)
    h = h + ao
    hn = rms_norm(h, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        y, aux = MOE.moe_layer(cfg, p["moe"], hn, token_chunks=token_chunks)
        return h + y, aux
    return h + MOE.dense_ffn(p["ffn"], hn), None


def _lns(hs, p: ShardedTree, eps):
    """The layer norm ``p`` (``w``, ``b``) on each rank's rows."""
    return [layer_norm(h, w, b, eps) for h, w, b in
            zip(hs, p.gathered("w")[0], p.gathered("b")[0])]


def _rms(hs, p: ShardedTree, key: str, eps):
    return [rms_norm(h, w, eps) for h, w in zip(hs, p.gathered(key)[0])]


def _cross_cached(cfg, p: ShardedTree, hs, cross: ShardedTree):
    """Cross-attention of a decode step against the cached encoder K/V, as
    the reference's decode does it (q without bias, no RoPE): each rank's
    heads of ``hs @ wq`` (every head where they do not divide the model
    axis), the cache's KV heads they group with, the rank's row block of
    ``wo`` and a psum over model (``row_parallel``)."""
    mesh = p.mesh
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    wq, q_spec = p.gathered("wq")
    qs, q_heads = split_heads(mesh, [h @ w for h, w in zip(hs, wq)], H, Dh,
                              model_sharded(q_spec[-1]))
    kv_split = model_sharded(cross.specs["k"][2])
    outs = []
    for j, (q, r) in enumerate(zip(qs, mesh.local_ranks)):
        c = cross.blocks[j]
        n = c["k"].shape[2]
        have = range(mesh.axis_index(r, "model") * n, mesh.axis_index(r, "model") * n + n) \
            if kv_split else range(K)
        need = [h // (H // K) for h in q_heads[j]]
        o = A.flash_attention(q, select_heads(c["k"], have, need),
                              select_heads(c["v"], have, need), causal=False)
        outs.append(o.reshape(*o.shape[:2], -1))
    wo, wo_spec = p.gathered("wo")
    return row_parallel(mesh, outs, wo, wo_spec, full=len(q_heads[0]) == H)


def _whisper_block(cfg, p: ShardedTree, hs, positions, *, causal=True, encs=None,
                   cache=None, cross=None, pos=None):
    """A pre-LN whisper block on each rank's rows ``hs`` (one body: ``p`` a
    lone tree without a mesh).  An encoder block (no ``xattn``) attends h;
    a decoder block attends h causally (or through its self cache at
    ``pos``), then cross-attends the encoder output ``encs`` (prefill; each
    rank's rows of it, split over data as the tokens are) or the cross
    cache's K/V (decode, :func:`_cross_cached`).  Attention is head
    parallel (``attention._gqa_mesh``), the layer norms act on replicated
    activations and the MLP is tensor parallel (``moe._gelu_mesh``)."""
    mesh, eps = p.mesh, cfg.norm_eps
    ao, _ = A._gqa_mesh(cfg, p.sub("attn"), _lns(hs, p.sub("ln1"), eps), positions, mesh,
                        cache=cache, cache_index=pos, causal=causal, use_rope=False)
    hs = [h + a for h, a in zip(hs, ao)]
    if "xattn" in p:
        hn = _lns(hs, p.sub("ln2"), eps)
        if cross is None:
            co, _ = A._gqa_mesh(cfg, p.sub("xattn"), hn, positions, mesh, causal=False,
                                kv_xs=encs, use_rope=False)
        else:
            co = _cross_cached(cfg, p.sub("xattn"), hn, cross)
        hs = [h + c for h, c in zip(hs, co)]
    fo = MOE._gelu_mesh(p.sub("ffn"), _lns(hs, p.sub("ln3"), eps), mesh)
    return [h + f for h, f in zip(hs, fo)]


def _remat(fn, *args):
    """``jax.checkpoint``'s counterpart: when autograd records (grad mode on
    and a tensor among ``args``, or in their dicts, requires grad), run
    ``fn`` under ``torch.utils.checkpoint`` (its activations are recomputed
    in backward); otherwise just call it."""
    def needs_grad(a):
        if isinstance(a, ShardedTree):
            return needs_grad(a.blocks)
        if isinstance(a, dict):
            return any(needs_grad(v) for v in a.values())
        if isinstance(a, (list, tuple)):
            return any(needs_grad(v) for v in a)
        return isinstance(a, torch.Tensor) and a.requires_grad

    if torch.is_grad_enabled() and any(needs_grad(a) for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


#: cache leaves the reference's decode returns in float32, by block
_FP32_STATES = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m"),
                "mamba": ("ssm",)}


def _promote_states(cache: ShardedTree) -> None:
    """Replace the ssm / hybrid recurrent-state leaves of every local rank's
    block of ``cache`` that are not float32 by float32 copies (in the
    blocks' dicts, so the caller's cache holds them), as the reference's
    first decode step returns them."""
    for blk in cache.blocks:
        for block, keys in _FP32_STATES.items():
            state = blk["layers"].get(block)
            for k in keys if state is not None else ():
                if state[k].dtype != torch.float32:
                    state[k] = state[k].float()


def _set_state(state: Optional[ShardedTree], new) -> None:
    """Copy each rank's new recurrent state into its blocks of the cache."""
    if state is not None:
        for blk, nw in zip(state.blocks, new):
            for k, t in nw.items():
                blk[k].copy_(t)


def _xlstm_super(cfg, p: ShardedTree, hs, state=None):
    """slstm_every - 1 mLSTM blocks, then one sLSTM block, each residual,
    on each rank's rows; with ``state`` (decode), every block's state is
    updated in place."""
    eps, mesh = cfg.norm_eps, p.mesh
    ml = p.sub("mlstm")
    for j in range(ml.n_layers()):
        pj = ml.layer(j)
        sj = None if state is None else state.sub("mlstm").layer(j)
        ys, new = XL.mlstm_block(cfg, pj.sub("cell"), _rms(hs, pj, "ln", eps), mesh=mesh,
                                 state=sj)
        _set_state(sj, new)
        hs = [h + y for h, y in zip(hs, ys)]
    ss = None if state is None else state.sub("slstm")
    sl = p.sub("slstm")
    ys, new = XL.slstm_block(cfg, sl.sub("cell"), _rms(hs, sl, "ln", eps), mesh=mesh,
                             state=ss)
    _set_state(ss, new)
    return [h + y for h, y in zip(hs, ys)]


def _zamba_super(cfg, p: ShardedTree, shared: ShardedTree, hs, positions, state=None,
                 attn_cache=None, wpos=None):
    """shared_attn_every Mamba2 blocks, each residual, then the shared
    attention + MLP block, on each rank's rows; decode passes the Mamba2
    states (updated in place) and the shared block's ring cache with its
    slot ``wpos``.  The shared block's weights are the same at every
    super-block; under FSDP its leaves are all-gathered over data at each
    application (once a super-block, counted as any gather)."""
    mesh = p.mesh
    mb = p.sub("mamba")
    for j in range(mb.n_layers()):
        pj = mb.layer(j)
        sj = None if state is None else state.sub("mamba").layer(j)
        ys, new = M2.mamba2_block(cfg, pj.sub("cell"), _rms(hs, pj, "ln", cfg.norm_eps),
                                  mesh=mesh, state=sj)
        _set_state(sj, new)
        hs = [h + y for h, y in zip(hs, ys)]
    return _dense_block_mesh(cfg, mesh, shared, hs, positions, attn_cache, wpos)


# ---------------------------------------------------------------------------
# forward (prefill) and decode
# ---------------------------------------------------------------------------

def _tree(cfg, params, mesh) -> ShardedTree:
    """The parameter tree a one-body family reads: laid out on ``mesh``, or
    a lone rank's whole leaves as they are."""
    return lone_tree(params) if mesh is None else _sharded(cfg, params, mesh)


def _rows(x: torch.Tensor, mesh):
    """Each local rank's rows of ``x`` (a lone rank's: all of them)."""
    return [x] if mesh is None else local_rows(x, mesh)


def _encode(cfg, sp: ShardedTree, frames):
    """Whisper's encoder over each rank's frame rows."""
    dt = sp.blocks[0]["embed"].dtype
    encs = [f.to(dt) for f in frames]
    T = encs[0].shape[1]
    encs = [e + sinusoidal_positions(T, cfg.d_model, device=e.device).to(e.dtype)
            for e in encs]
    positions = torch.arange(T, device=encs[0].device)
    stack = sp.sub("enc_layers")
    for i in stack_range("enc_layers", stack.n_layers()):
        encs = _remat(partial(_whisper_block, cfg, causal=False), stack.layer(i), encs,
                      positions)
    return _lns(encs, sp.sub("ln_enc"), cfg.norm_eps)


def encode(cfg: ArchConfig, params: Dict, frames: torch.Tensor, *, mesh=None
           ) -> torch.Tensor:
    """Whisper's encoder over frame embeddings (B, T, d), the stub
    frontend's output: sinusoidal positions, the non-causal blocks, the
    final layer norm.  Part of :func:`forward` for the audio family.
    ``mesh`` as in :func:`forward`; the output is the rows of the process's
    data shards."""
    out = _encode(cfg, _tree(cfg, params, mesh), _rows(frames, mesh))
    return out[0] if mesh is None else join_rows(out, mesh, frames)


def _one_body_hidden(cfg: ArchConfig, sp: ShardedTree, batch, mesh):
    """The final-normed hidden states of each local rank's rows for the
    audio, ssm and hybrid families, whose blocks have one body for a mesh
    and for none (``sp`` a lone tree without ``mesh``)."""
    ranks, eps = sp.mesh, cfg.norm_eps
    xs = _embed_mesh(sp, _rows(batch["tokens"], mesh), ranks)
    S = xs[0].shape[1]
    positions = torch.arange(S, device=xs[0].device)
    stack = sp.sub("layers")
    if cfg.family == "audio":
        encs = _encode(cfg, sp, _rows(batch["frames"], mesh))
        xs = [x + sinusoidal_positions(S, cfg.d_model, device=x.device).to(x.dtype)
              for x in xs]
        for i in stack_range("layers", stack.n_layers()):
            xs = _remat(partial(_whisper_block, cfg, encs=encs), stack.layer(i), xs,
                        positions)
        return _lns(xs, sp.sub("ln_f"), eps)
    for i in stack_range("layers", stack.n_layers()):
        xs = (_remat(partial(_xlstm_super, cfg), stack.layer(i), xs) if cfg.family == "ssm"
              else _remat(partial(_zamba_super, cfg), stack.layer(i), sp.sub("shared"), xs,
                          positions))
    return _rms(xs, sp, "ln_f", eps)


@torch.no_grad()
def _one_body_decode(cfg: ArchConfig, sp: ShardedTree, cache, tokens, pos: int, mesh):
    ranks, eps = sp.mesh, cfg.norm_eps
    ct = lone_tree(cache) if mesh is None else cache
    xs = _embed_mesh(sp, _rows(tokens, mesh), ranks)
    positions = pos + torch.arange(tokens.shape[1], device=xs[0].device)
    stack, cl = sp.sub("layers"), ct.sub("layers")
    if cfg.family == "audio":
        max_len = cl.template["k"].shape[2]
        xs = [x + sinusoidal_positions(max_len, cfg.d_model)[pos].to(x.device, x.dtype)
              for x in xs]
        for i in stack_range("layers", stack.n_layers()):
            xs = _whisper_block(cfg, stack.layer(i), xs, positions, cache=cl.layer(i),
                                cross=ct.sub("cross").layer(i), pos=pos)
        hs = _lns(xs, sp.sub("ln_f"), eps)
    elif cfg.family == "ssm":
        _promote_states(ct)
        for i in stack_range("layers", stack.n_layers()):
            xs = _xlstm_super(cfg, stack.layer(i), xs, cl.layer(i))
        hs = _rms(xs, sp, "ln_f", eps)
    else:
        # the shared block's cache is a ring buffer of the window: the step
        # writes slot pos mod win and attends slots 0..that slot (kv_len),
        # so once the ring has wrapped the older slots past it drop out, as
        # in the reference (ROADMAP C.3)
        wpos = pos % ct.sub("shared").template["k"].shape[2]
        _promote_states(ct)
        for i in stack_range("layers", stack.n_layers()):
            xs = _zamba_super(cfg, stack.layer(i), sp.sub("shared"), xs, positions,
                              cl.layer(i), ct.sub("shared").layer(i), wpos)
        hs = _rms(xs, sp, "ln_f", eps)
    logits = logits_mesh(cfg, sp, hs, ranks, {"tokens": tokens})
    return (logits[0] if mesh is None else join_rows(logits, mesh, tokens)), cache


def forward(cfg: ArchConfig, params: Dict, batch: Dict, *, mesh=None
            ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Logits (B, S_tok, vocab) for training and prefill; the moe family
    returns (logits, summed router aux loss) as the reference does.
    ``batch`` holds ``tokens`` and, for vlm, optionally ``patch_embeds``
    (B, P, d); for audio, ``frames`` (B, T, d).  Each block is
    rematerialized when autograd records (:func:`_remat`).

    ``mesh`` (a :class:`~repro_torch.core.exchange.ShardMesh`): the
    layout of the module docstring; the logits (and the aux loss) on the
    tokens' device."""
    _require_family(cfg)
    if cfg.family in ONE_BODY:
        sp = _tree(cfg, params, mesh)
        logits = logits_mesh(cfg, sp, _one_body_hidden(cfg, sp, batch, mesh), sp.mesh, batch)
        return logits[0] if mesh is None else join_rows(logits, mesh, batch["tokens"])
    if mesh is not None:
        sp = _sharded(cfg, params, mesh)
        hs, aux = hidden_mesh(cfg, sp, batch, mesh)
        logits = join_rows(logits_mesh(cfg, sp, hs, mesh, batch), mesh, batch["tokens"])
        if cfg.family == "moe":
            return logits, aux[0].to(logits.device)
        return logits
    fam = cfg.family
    tokens = batch["tokens"]
    S_tok = tokens.shape[1]
    x = params["embed"][tokens]
    if fam == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)

    if fam in ("dense", "vlm"):
        for i in range(_n_layers(params["layers"])):
            x = _remat(partial(_dense_block, cfg), layer(params["layers"], i), x, positions)
        logits = _logits(cfg, params, rms_norm(x, params["ln_f"], cfg.norm_eps))
        return logits[:, -S_tok:] if fam == "vlm" else logits

    if fam == "moe":
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for name, kind in (("dense_layers", "dense"), ("layers", "moe")):
            if name not in params:
                continue
            for i in range(_n_layers(params[name])):
                x, aux = _remat(partial(_mla_block, cfg, kind), layer(params[name], i), x,
                                positions)
                if aux is not None:
                    aux_total = aux_total + aux
        return _logits(cfg, params, rms_norm(x, params["ln_f"], cfg.norm_eps)), aux_total

    raise ValueError(fam)


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict, *, mesh=None) -> torch.Tensor:
    """The training objective (``repro.models.lm.loss_fn``): next-token
    cross-entropy in float32 with a 1e-4 z-loss over the text logits (vlm:
    the positions after the patches; audio: the decoder tokens), plus
    1e-3 x the summed router aux loss for the moe family unless it balances
    with a router bias.

    With ``mesh``: the value is the mean over data shards of each shard's
    loss (:func:`mesh_loss`); its gradient is this process's share
    (:func:`mesh_objective`), so that differentiating it once in each
    process differentiates the global loss once.  A leaf replicated over
    an axis then holds a partial gradient on each rank of it, which a psum
    over that axis completes (``launch.steps.make_train_step``); whole
    parameters get their whole gradient through the sharding copies in
    one process."""
    if mesh is not None:
        losses = shard_losses(cfg, _sharded(cfg, params, mesh), batch, mesh)
        return _Reported.apply(mesh_objective(losses, mesh), mesh_loss(losses, mesh))
    out = forward(cfg, params, batch)
    aux = 0.0
    if cfg.family == "moe":
        out, aux_total = out
        if not cfg.moe.aux_free_bias:
            aux = 1e-3 * aux_total
    return cross_entropy(out[:, :-1], batch["tokens"][:, 1:]) + aux


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Dict, cache: Dict, tokens: torch.Tensor,
                pos: int, *, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1); pos: the position in the sequence
    (the hybrid family writes its attention cache at ``pos`` mod the
    window).  The cache is updated in place and returned.  ``mesh`` as in
    :func:`forward` (the MoE in one token chunk), the cache then a
    :class:`~repro_torch.models.common.ShardedTree` (:func:`init_cache`)."""
    _require_family(cfg)
    fam = cfg.family
    pos = int(pos)
    if fam in ONE_BODY:
        return _one_body_decode(cfg, _tree(cfg, params, mesh), cache, tokens, pos, mesh)
    if mesh is not None:
        return _decode_mesh(cfg, _sharded(cfg, params, mesh), cache, tokens, pos, mesh)
    x = params["embed"][tokens]
    positions = pos + torch.arange(tokens.shape[1], device=x.device)

    if fam in ("dense", "vlm"):
        for i in range(_n_layers(params["layers"])):
            x = _dense_block(cfg, layer(params["layers"], i), x, positions,
                             layer(cache["layers"], i), pos)
    elif fam == "moe":
        for name, kind in (("dense_layers", "dense"), ("layers", "moe")):
            if name not in params:
                continue
            for i in range(_n_layers(params[name])):
                x, _ = _mla_block(cfg, kind, layer(params[name], i), x, positions,
                                  layer(cache[name], i), pos, token_chunks=1)
    return _logits(cfg, params, rms_norm(x, params["ln_f"], cfg.norm_eps)), cache


# ---------------------------------------------------------------------------
# under a mesh
# ---------------------------------------------------------------------------

def _sharded(cfg: ArchConfig, params, mesh) -> ShardedTree:
    return shard_params(params, model_template(cfg), mesh)


def splits_rows(x: torch.Tensor, mesh) -> bool:
    """Whether ``x``'s rows split over the process's data shards; when they
    do not, every shard holds them all (``sanitize_spec``'s replication)."""
    return x.shape[0] % len(mesh.local_shards) == 0


def local_rows(x: torch.Tensor, mesh):
    """Each local rank's block of ``x``, whose rows are those of the
    process's data shards in order (the whole batch in one process), on
    the rank's device; all of them when they do not split."""
    if not splits_rows(x, mesh):
        return [x.to(mesh.rank_device(r)) for r in mesh.local_ranks]
    per = x.shape[0] // len(mesh.local_shards)
    return [x[mesh.local_shards.index(mesh.axis_index(r, "data")) * per:][:per]
            .to(mesh.rank_device(r)) for r in mesh.local_ranks]


def join_rows(xs, mesh, like: torch.Tensor) -> torch.Tensor:
    """The rows of the process's data shards, as ``like``'s were split."""
    if not splits_rows(like, mesh):
        return xs[0].to(like.device)
    return join_blocks(xs, mesh, like.device)


def _embed_mesh(sp: ShardedTree, tokens, mesh):
    """The vocabulary-parallel lookup: each rank looks up the tokens in its
    rows of ``embed``, zeroes the others, and the ranks' rows are psummed
    over model (one nonzero addend: exact)."""
    es, spec = sp.gathered("embed")
    if not model_sharded(spec[0]):
        return [e[t] for e, t in zip(es, tokens)]
    out = []
    for e, t, r in zip(es, tokens, mesh.local_ranks):
        n = e.shape[0]
        local = t - mesh.axis_index(r, "model") * n
        hit = (local >= 0) & (local < n)
        out.append(e[local.clamp(0, n - 1)] * hit[..., None].to(e.dtype))
    return mesh.psum(out, "model")


def logits_mesh(cfg: ArchConfig, sp: ShardedTree, hs, mesh, batch):
    """Each rank's logits of its data shard over the whole vocabulary: its
    vocabulary columns (``head``, or the tied ``embed``'s rows), all-gathered
    over model; vlm keeps the text positions."""
    if cfg.tie_embeddings:
        ws, spec = sp.gathered("embed")
        ls, sharded = [h @ w.T for h, w in zip(hs, ws)], model_sharded(spec[0])
    else:
        ws, spec = sp.gathered("head")
        ls, sharded = [h @ w for h, w in zip(hs, ws)], model_sharded(spec[-1])
    if sharded:
        ls = mesh.all_gather_axis(ls, "model", ls[0].dim() - 1)
    if cfg.family == "vlm":
        ls = [l[:, -batch["tokens"].shape[1]:] for l in ls]
    return ls


def _dense_block_mesh(cfg, mesh, sp, hs, positions, cache=None, pos=None):
    eps = cfg.norm_eps
    hn = [rms_norm(h, w, eps) for h, w in zip(hs, sp.gathered("ln1")[0])]
    ao, _ = A.gqa_attention(cfg, sp.sub("attn"), hn, positions, mesh=mesh, cache=cache,
                            cache_index=pos)
    if cfg.parallel_block:
        fo = MOE.dense_ffn(sp.sub("ffn"), hn, mesh=mesh)
        return [h + a + f for h, a, f in zip(hs, ao, fo)]
    hs = [h + a for h, a in zip(hs, ao)]
    hn = [rms_norm(h, w, eps) for h, w in zip(hs, sp.gathered("ln2")[0])]
    return [h + f for h, f in zip(hs, MOE.dense_ffn(sp.sub("ffn"), hn, mesh=mesh))]


def _moe_replicated(cfg, mesh, sp, hn, token_chunks):
    """The MoE on a batch every data shard holds whole: each shard routes
    its contiguous block of the B * S tokens (the reference's ``P(data,
    None)`` on the flat tokens) and the blocks are all-gathered back; when
    the tokens do not split either (a decode step of one sequence), every
    shard routes them all."""
    n = mesh.n_shards
    if hn[0].shape[0] * hn[0].shape[1] % n:
        return MOE.moe_layer(cfg, sp, hn, mesh=mesh, token_chunks=token_chunks)
    blocks = []
    for h, r in zip(hn, mesh.local_ranks):
        flat = h.reshape(-1, h.shape[-1])
        T = flat.shape[0] // n
        blocks.append(flat[mesh.axis_index(r, "data") * T:][:T][None])
    ys, aux = MOE.moe_layer(cfg, sp, blocks, mesh=mesh, token_chunks=token_chunks)
    ys = mesh.all_gather_axis([y[0] for y in ys], "data", 0)
    return [y.reshape(h.shape) for y, h in zip(ys, hn)], aux


def _mla_block_mesh(cfg, kind, mesh, sp, hs, positions, cache=None, pos=None,
                    token_chunks=4, split=True):
    eps = cfg.norm_eps
    hn = [rms_norm(h, w, eps) for h, w in zip(hs, sp.gathered("ln1")[0])]
    ao, _ = A.mla_attention(cfg, sp.sub("attn"), hn, positions, mesh=mesh, cache=cache,
                            cache_index=pos)
    hs = [h + a for h, a in zip(hs, ao)]
    hn = [rms_norm(h, w, eps) for h, w in zip(hs, sp.gathered("ln2")[0])]
    if kind == "moe":
        if split:
            ys, aux = MOE.moe_layer(cfg, sp.sub("moe"), hn, mesh=mesh,
                                    token_chunks=token_chunks)
        else:
            ys, aux = _moe_replicated(cfg, mesh, sp.sub("moe"), hn, token_chunks)
        return [h + y for h, y in zip(hs, ys)], aux
    return [h + f for h, f in zip(hs, MOE.dense_ffn(sp.sub("ffn"), hn, mesh=mesh))], None


def _stacks(cfg, sp):
    """(stack name, block kind) of the layer stacks, in order."""
    if cfg.family == "moe":
        return [(n, k) for n, k in (("dense_layers", "dense"), ("layers", "moe")) if n in sp]
    return [("layers", "dense")]


def hidden_mesh(cfg: ArchConfig, sp: ShardedTree, batch, mesh):
    """The final-normed hidden states of each local rank's data shard and,
    for the moe family, each rank's summed aux loss."""
    if cfg.family in ONE_BODY:
        hs = _one_body_hidden(cfg, sp, batch, mesh)
        return hs, [torch.zeros((), dtype=torch.float32, device=h.device) for h in hs]
    split = splits_rows(batch["tokens"], mesh)
    xs = _embed_mesh(sp, local_rows(batch["tokens"], mesh), mesh)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        xs = [torch.cat([pe.to(x.dtype), x], dim=1)
              for pe, x in zip(local_rows(batch["patch_embeds"], mesh), xs)]
    positions = torch.arange(xs[0].shape[1], device=xs[0].device)
    aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    for name, kind in _stacks(cfg, sp):
        stack = sp.sub(name)
        for i in stack_range(name, stack.n_layers()):
            if cfg.family == "moe":
                xs, a = _remat(partial(_mla_block_mesh, cfg, kind, mesh, split=split),
                               stack.layer(i), xs, positions)
                if a is not None:
                    aux = [t + u for t, u in zip(aux, a)]
            else:
                xs = _remat(partial(_dense_block_mesh, cfg, mesh), stack.layer(i), xs,
                            positions)
    return [rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, sp.gathered("ln_f")[0])], aux


def shard_losses(cfg: ArchConfig, sp: ShardedTree, batch, mesh) -> List[torch.Tensor]:
    """Each local rank's loss of its data shard (the mesh-less
    :func:`loss_fn` on the shard's rows, with the aux loss pmean'd over
    data)."""
    hs, aux = hidden_mesh(cfg, sp, batch, mesh)
    out = []
    for logits, tok, a in zip(logits_mesh(cfg, sp, hs, mesh, batch),
                              local_rows(batch["tokens"], mesh), aux):
        loss = cross_entropy(logits[:, :-1], tok[:, 1:])
        if cfg.family == "moe" and not cfg.moe.aux_free_bias:
            loss = loss + 1e-3 * a
        out.append(loss)
    return out


def mesh_loss(losses: List[torch.Tensor], mesh) -> torch.Tensor:
    """The global loss from :func:`shard_losses`: their pmean over data (no
    gradient), on the first local rank's device."""
    return mesh.pmean([l.detach() for l in losses], "data")[0]


def mesh_objective(losses: List[torch.Tensor], mesh) -> torch.Tensor:
    """What this process differentiates: the sum of its ranks' losses over
    the mesh's ranks (n_data x n_model), so that the sum over every process
    is the global loss, once."""
    dev = losses[0].device
    total = sum(l.to(dev) for l in losses)
    return total / (mesh.n_shards * mesh.model_axis)


class _Reported(torch.autograd.Function):
    """``value`` as the result, the gradient to ``objective``."""

    @staticmethod
    def forward(ctx, objective, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


@torch.no_grad()
def _decode_mesh(cfg: ArchConfig, sp: ShardedTree, cache, tokens, pos: int, mesh):
    if not isinstance(cache, ShardedTree):
        raise ValueError("with a mesh the cache is a ShardedTree: lm.init_cache(..., mesh=)")
    xs = _embed_mesh(sp, local_rows(tokens, mesh), mesh)
    positions = pos + torch.arange(tokens.shape[1], device=xs[0].device)
    for name, kind in _stacks(cfg, sp):
        stack, cstack = sp.sub(name), cache.sub(name)
        for i in stack_range(name, stack.n_layers()):
            if cfg.family == "moe":
                xs, _ = _mla_block_mesh(cfg, kind, mesh, stack.layer(i), xs, positions,
                                        cstack.layer(i), pos, token_chunks=1,
                                        split=splits_rows(tokens, mesh))
            else:
                xs = _dense_block_mesh(cfg, mesh, stack.layer(i), xs, positions,
                                       cstack.layer(i), pos)
    hs = [rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, sp.gathered("ln_f")[0])]
    return join_rows(logits_mesh(cfg, sp, hs, mesh, {"tokens": tokens}), mesh, tokens), cache


# ---------------------------------------------------------------------------
# module wrapper
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The parameter tree registered on a module (``state_dict`` keys are
    the tree's paths joined by ``.``); calls :func:`forward` and
    :func:`decode_step`."""

    def __init__(self, cfg: ArchConfig, params: Dict):
        super().__init__()
        _require_family(cfg)
        self.cfg = cfg
        self._paths = [path for path, _ in tree_items(params)]
        self.tree = nn.ModuleDict()
        for path, t in tree_items(params):
            mod = self.tree
            for k in path[:-1]:
                if k not in mod:
                    mod[k] = nn.ModuleDict()
                mod = mod[k]
            mod.register_parameter(path[-1], nn.Parameter(t, requires_grad=False))

    def params(self) -> Dict:
        """The parameter tree as nested dicts of tensors."""
        out: Dict = {}
        for path in self._paths:
            mod, node = self.tree, out
            for k in path[:-1]:
                mod, node = mod[k], node.setdefault(k, {})
            node[path[-1]] = getattr(mod, path[-1])
        return out

    def forward(self, tokens: torch.Tensor, **inputs):
        """``inputs``: ``patch_embeds`` (vlm) or ``frames`` (audio)."""
        return forward(self.cfg, self.params(), {"tokens": tokens, **inputs})

    def decode_step(self, cache: Dict, tokens: torch.Tensor, pos: int):
        return decode_step(self.cfg, self.params(), cache, tokens, pos)
