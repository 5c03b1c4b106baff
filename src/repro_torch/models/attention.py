"""Attention blocks: GQA (dense, vlm, audio and hybrid families) and MLA
(DeepSeek family).

Ports ``repro.models.attention``.  Prefill runs the blocked flash path
(``kernels/flash_attention``); decode writes the step's K/V (or, for MLA,
the latent) into the cache **in place** — the reference returns an updated
copy — and attends the filled prefix.  MLA decode is the absorbed form in
the latent space; its einsums stay ``torch.einsum`` (no Pallas kernel
computes them in the reference either).

With a :class:`~repro_torch.core.exchange.ShardMesh` the heads are tensor
parallel over ``model`` and the batch split over data, as the reference's
specs place them: each rank projects with its column blocks of ``wq`` /
``wk`` / ``wv`` (and biases), attends its heads, multiplies by its row
block of ``wo``, and the partial products are psummed over model.  Heads
that do not divide the axis are formed after an all-gather of the
projection over model (its columns split mid-head) and attended on every
rank, as GSPMD replicates them; with ``runtime_flags.OPT
["attn_batch_shard"]`` the batch is split over every axis instead
(:func:`_attn_batch_spec`).  A rank's query heads read the KV heads they
group with, whatever the KV heads' own layout.  MLA's absorbed decode
keeps the latent cache sequence-sharded over model and combines the
ranks' partial softmaxes exactly by their log-sum-exp.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .. import runtime_flags
from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from .common import (DP, DPM, ShardedTree, apply_rope, whole_rows, leaf, model_sharded,
                     rms_norm, rope_freqs, row_parallel, select_heads, shard_hint,
                     shard_params, split_heads)


def _attn_batch_spec(cfg: ArchConfig, mesh, batch: int):
    """The reference's choice (attention.py:24): heads over model, or, under
    ``OPT["attn_batch_shard"]`` when the heads do not divide the model axis
    and ``batch`` (the global batch) divides every axis, the batch over
    every axis."""
    if mesh is None or not runtime_flags.OPT["attn_batch_shard"]:
        return DP, "model"
    if cfg.n_heads % mesh.model_axis == 0 or batch % (mesh.n_shards * mesh.model_axis):
        return DP, "model"
    return DPM, None


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_template(cfg: ArchConfig) -> Dict:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    t = {
        "wq": leaf((d, H * Dh), (None, "model")),
        "wk": leaf((d, K * Dh), (None, "model")),
        "wv": leaf((d, K * Dh), (None, "model")),
        "wo": leaf((H * Dh, d), ("model", None)),
    }
    if cfg.qkv_bias:
        t["bq"] = leaf((H * Dh,), ("model",), init="zeros")
        t["bk"] = leaf((K * Dh,), ("model",), init="zeros")
        t["bv"] = leaf((K * Dh,), ("model",), init="zeros")
    if cfg.qk_norm:
        t["q_norm"] = leaf((Dh,), (None,), init="ones")
        t["k_norm"] = leaf((Dh,), (None,), init="ones")
    return t


def gqa_cache_template(cfg: ArchConfig, batch: int, max_len: int) -> Dict:
    K, Dh = cfg.n_kv_heads, cfg.hdim
    kv_spec = (DP, None, "model", None)
    return {
        "k": leaf((batch, max_len, K, Dh), kv_spec, init="zeros"),
        "v": leaf((batch, max_len, K, Dh), kv_spec, init="zeros"),
    }


def _write(buf: torch.Tensor, val: torch.Tensor, i: int) -> None:
    """``buf[:, i:i + S] = val`` with ``dynamic_update_slice``'s clamp of the
    start index to [0, len - S]."""
    S = val.shape[1]
    i = min(max(i, 0), buf.shape[1] - S)
    buf[:, i:i + S] = val.to(buf.dtype)


def gqa_attention(cfg: ArchConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor, *,
                  mesh=None, cache: Optional[Dict] = None,
                  cache_index: Optional[int] = None,
                  causal: bool = True, kv_x: Optional[torch.Tensor] = None,
                  use_rope: bool = True) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d).  Without a cache: self-attention over x (``causal`` or
    not), or cross-attention with K/V projected from ``kv_x`` (B, Skv, d)
    (the whisper decoder).  With ``cache`` + ``cache_index``: decode (writes
    K/V at cache_index, attends the filled prefix).  ``use_rope=False``
    skips the rotation (whisper's sinusoidal positions).

    With ``mesh``: ``p`` whole (sharded on entry by :func:`gqa_template`)
    or a :class:`ShardedTree`; ``x`` (and ``kv_x``) whole, split over data
    on entry and the output joined back, or a list of one (B / n_data, S,
    d) block a local rank, and the output likewise; ``cache`` a
    :class:`ShardedTree` by :func:`gqa_cache_template`."""
    if mesh is not None:
        sp = shard_params(p, gqa_template(cfg), mesh)
        xs = shard_hint(x, mesh, DP, None, None)
        kvs = None if kv_x is None else shard_hint(kv_x, mesh, DP, None, None)
        ys, cache = _gqa_mesh(cfg, sp, xs, positions, mesh, cache=cache,
                              cache_index=cache_index, causal=causal, kv_xs=kvs,
                              use_rope=use_rope)
        return (whole_rows(ys, mesh, x.device) if isinstance(x, torch.Tensor)
                else ys), cache
    B, S, d = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, Skv, K, Dh)
    v = v.reshape(B, Skv, K, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        cos, sin = rope_freqs(Dh, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        if kv_x is None and S == Skv:
            k = apply_rope(k, cos, sin)

    if cache is not None:
        i = int(cache_index)
        _write(cache["k"], k, i)
        _write(cache["v"], v, i)
        kv_len = torch.full((B,), i + S, dtype=torch.int32, device=x.device)
        o = flash_attention(q, cache["k"], cache["v"], causal=False,
                            window=cfg.attn_window, kv_len=kv_len)
    else:
        o = flash_attention(q, k, v, causal=causal, window=cfg.attn_window)
    o = o.reshape(B, S, H * Dh)
    return o @ p["wo"], cache


def _project(sp: ShardedTree, w: str, b: Optional[str], xs) -> Tuple[List[torch.Tensor], bool]:
    """Each rank's ``x @ w (+ b)`` on its column block of ``w``, and whether
    the columns are sharded over model."""
    ws, spec = sp.gathered(w)
    ys = [x @ w_ for x, w_ in zip(xs, ws)]
    if b is not None:
        ys = [y + b_ for y, b_ in zip(ys, sp.gathered(b)[0])]
    return ys, model_sharded(spec[-1])


def _columns_to_batch(mesh, ys, sharded: bool):
    """(B, S, C) column blocks over model -> (B / M, S, C): each model rank
    takes its batch block with every column (one all-to-all)."""
    M = mesh.model_axis
    if not sharded:
        return [y.reshape(M, -1, *y.shape[1:])[mesh.axis_index(r, "model")]
                for y, r in zip(ys, mesh.local_ranks)]
    ys = mesh.all_to_all([y.reshape(M, -1, *y.shape[1:]) for y in ys], "model")
    return [torch.cat(list(y), dim=-1) for y in ys]


def _batch_to_columns(mesh, os_, n_cols: int):
    """The inverse of :func:`_columns_to_batch` onto ``n_cols``-wide column
    blocks: (B / M, S, C) -> (B, S, n_cols), each model rank's block."""
    os_ = mesh.all_to_all([torch.stack(o.split(n_cols, dim=-1)) for o in os_], "model")
    return [o.reshape(-1, *o.shape[2:]) for o in os_]


def _gqa_mesh(cfg: ArchConfig, sp: ShardedTree, xs, positions, mesh, *, cache=None,
              cache_index=None, causal=True, kv_xs=None, use_rope=True):
    """:func:`gqa_attention` on every local rank's block (see the module
    docstring for the layout)."""
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    srcs = xs if kv_xs is None else kv_xs
    bias = cfg.qkv_bias
    qs, q_sh = _project(sp, "wq", "bq" if bias else None, xs)
    ks, k_sh = _project(sp, "wk", "bk" if bias else None, srcs)
    vs, v_sh = _project(sp, "wv", "bv" if bias else None, srcs)
    B, S = xs[0].shape[:2]
    Skv = srcs[0].shape[1]
    bspec, _ = _attn_batch_spec(cfg, mesh, B * mesh.n_shards)
    batch_split = bspec == DPM and cache is None
    if batch_split:
        qs, ks, vs = (_columns_to_batch(mesh, t, sh)
                      for t, sh in ((qs, q_sh), (ks, k_sh), (vs, v_sh)))
        qs = [q.reshape(*q.shape[:2], H, Dh) for q in qs]
        ks = [k.reshape(*k.shape[:2], K, Dh) for k in ks]
        vs = [v.reshape(*v.shape[:2], K, Dh) for v in vs]
        q_heads = k_heads = None
    else:
        qs, q_heads = split_heads(mesh, qs, H, Dh, q_sh)
        ks, k_heads = split_heads(mesh, ks, K, Dh, k_sh)
        vs, _ = split_heads(mesh, vs, K, Dh, v_sh)
    outs = []
    for j, (q, k, v) in enumerate(zip(qs, ks, vs)):
        if cfg.qk_norm:
            q = rms_norm(q, sp.gathered("q_norm")[0][j], cfg.norm_eps)
            k = rms_norm(k, sp.gathered("k_norm")[0][j], cfg.norm_eps)
        if use_rope:
            cos, sin = rope_freqs(Dh, cfg.rope_theta, positions.to(q.device))
            q = apply_rope(q, cos, sin)
            if kv_xs is None and S == Skv:
                k = apply_rope(k, cos, sin)
        if cache is not None:
            c = cache.blocks[j]
            i = int(cache_index)
            _write(c["k"], k, i)
            _write(c["v"], v, i)
            k, v = c["k"], c["v"]
        if q_heads is not None:
            need = [h // (H // K) for h in q_heads[j]]
            k, v = select_heads(k, k_heads[j], need), select_heads(v, k_heads[j], need)
        if cache is not None:
            kv_len = torch.full((q.shape[0],), int(cache_index) + S, dtype=torch.int32,
                                device=q.device)
            o = flash_attention(q, k, v, causal=False, window=cfg.attn_window,
                                kv_len=kv_len)
        else:
            o = flash_attention(q, k, v, causal=causal, window=cfg.attn_window)
        outs.append(o.reshape(*o.shape[:2], -1))
    wos, wo_spec = sp.gathered("wo")
    if batch_split:
        if model_sharded(wo_spec[0]):
            outs = _batch_to_columns(mesh, outs, wos[0].shape[0])
            return row_parallel(mesh, outs, wos, wo_spec, full=False), cache
        outs = mesh.all_gather_axis(outs, "model", 0)
        return row_parallel(mesh, outs, wos, wo_spec, full=True), cache
    full = len(q_heads[0]) == H
    return row_parallel(mesh, outs, wos, wo_spec, full=full), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek V2/V3)
# ---------------------------------------------------------------------------

def mla_template(cfg: ArchConfig) -> Dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope + m.qk_rope
    return {
        "wdq": leaf((d, m.q_lora), (None, None)),
        "q_norm": leaf((m.q_lora,), (None,), init="ones"),
        "wuq": leaf((m.q_lora, H * qk), (None, "model")),
        "wdkv": leaf((d, m.kv_lora + m.qk_rope), (None, None)),
        "kv_norm": leaf((m.kv_lora,), (None,), init="ones"),
        "wuk": leaf((m.kv_lora, H * m.qk_nope), (None, "model")),
        "wuv": leaf((m.kv_lora, H * m.v_dim), (None, "model")),
        "wo": leaf((H * m.v_dim, d), ("model", None)),
    }


def mla_cache_template(cfg: ArchConfig, batch: int, max_len: int) -> Dict:
    m = cfg.mla
    return {
        "ckv": leaf((batch, max_len, m.kv_lora), (DP, "model", None), init="zeros"),
        "krope": leaf((batch, max_len, m.qk_rope), (DP, "model", None), init="zeros"),
    }


def _mla_qkv(cfg: ArchConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    cq = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(B, S, H, m.qk_nope + m.qk_rope)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    cos, sin = rope_freqs(m.qk_rope, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)
    dkv = x @ p["wdkv"]
    ckv = rms_norm(dkv[..., :m.kv_lora], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., m.kv_lora:][:, :, None, :], cos, sin)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def mla_attention(cfg: ArchConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor, *,
                  mesh=None, cache: Optional[Dict] = None,
                  cache_index: Optional[int] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Prefill: latent expanded to per-head K/V, blocked flash (qk head dim
    qk_nope + qk_rope, v head dim v_dim).  Decode: *absorbed* attention in
    the latent space — the cache stays (kv_lora + qk_rope) wide per token.
    ``mesh``, ``p``, ``x`` and ``cache`` as in :func:`gqa_attention`, the
    cache by :func:`mla_cache_template`."""
    if mesh is not None:
        sp = shard_params(p, mla_template(cfg), mesh)
        xs = shard_hint(x, mesh, DP, None, None)
        ys, cache = _mla_mesh(cfg, sp, xs, positions, mesh, cache=cache,
                              cache_index=cache_index)
        return (whole_rows(ys, mesh, x.device) if isinstance(x, torch.Tensor)
                else ys), cache
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope, ckv, k_rope = _mla_qkv(cfg, p, x, positions)

    if cache is None:
        k_nope = (ckv @ p["wuk"]).reshape(B, S, H, m.qk_nope)
        v = (ckv @ p["wuv"]).reshape(B, S, H, m.v_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope)], dim=-1)
        o = flash_attention(q, k, v, causal=True)
        o = o.reshape(B, S, H * m.v_dim)
        return o @ p["wo"], None

    # ---- absorbed decode ---------------------------------------------------
    i = int(cache_index)
    _write(cache["ckv"], ckv, i)
    _write(cache["krope"], k_rope, i)
    ckv_c, kr_c = cache["ckv"].float(), cache["krope"].float()
    kv_len = i + S
    wuk = p["wuk"].reshape(m.kv_lora, H, m.qk_nope).float()
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), wuk)          # (B,S,H,kv_lora)
    scores = (torch.einsum("bshr,btr->bhst", q_abs, ckv_c)
              + torch.einsum("bshp,btp->bhst", q_rope.float(), kr_c))
    scores = scores * (m.qk_nope + m.qk_rope) ** -0.5
    valid = torch.arange(ckv_c.shape[1], device=x.device) < kv_len
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, ckv_c)                   # latent ctx
    wuv = p["wuv"].reshape(m.kv_lora, H, m.v_dim).float()
    o = torch.einsum("bshr,rhv->bshv", ctx, wuv)
    o = o.reshape(B, S, H * m.v_dim).to(x.dtype)
    return o @ p["wo"], cache


def _write_rows(buf: torch.Tensor, val: torch.Tensor, i: int, total: int, lo: int) -> None:
    """:func:`_write` into rank ``buf``, which holds positions ``lo`` to
    ``lo + buf.shape[1]`` of a ``total``-long sequence: the start is clamped
    on the whole sequence, then the rank writes the rows it holds."""
    S = val.shape[1]
    i = min(max(i, 0), total - S)
    a, b = max(i, lo), min(i + S, lo + buf.shape[1])
    if a < b:
        buf[:, a - lo:b - lo] = val[:, a - i:b - i].to(buf.dtype)


def _weight_heads(sp: ShardedTree, name: str, mesh, n_heads: int, per_head: int, heads):
    """Each rank's (rows, len(heads[j]), per_head) view of ``name``'s
    columns for its heads (its column block, or the all-gathered whole)."""
    ws, spec = sp.gathered(name)
    ws = [w.reshape(w.shape[0], -1, per_head) for w in ws]
    if model_sharded(spec[-1]) and n_heads % mesh.model_axis == 0:
        have = [range(mesh.axis_index(r, "model") * (n_heads // mesh.model_axis),
                      (mesh.axis_index(r, "model") + 1) * (n_heads // mesh.model_axis))
                for r in mesh.local_ranks]
    else:
        if model_sharded(spec[-1]):
            ws = mesh.all_gather_axis(ws, "model", 1)
        have = [range(n_heads)] * len(ws)
    return [w[:, h.start - hv.start:h.stop - hv.start] for w, h, hv in zip(ws, heads, have)]


def _mla_mesh(cfg: ArchConfig, sp: ShardedTree, xs, positions, mesh, *, cache=None,
              cache_index=None):
    """:func:`mla_attention` on every local rank's block: heads over model
    (``wuq`` / ``wuk`` / ``wuv`` column blocks, ``wo`` row block, a psum);
    the absorbed decode attends each rank's sequence slice of the latent
    cache with every head and combines the slices by log-sum-exp."""
    m = cfg.mla
    H, M = cfg.n_heads, mesh.model_axis
    qk = m.qk_nope + m.qk_rope
    wdq, wdkv = sp.gathered("wdq")[0], sp.gathered("wdkv")[0]
    qn, kvn = sp.gathered("q_norm")[0], sp.gathered("kv_norm")[0]
    cqs = [rms_norm(x @ w, n, cfg.norm_eps) for x, w, n in zip(xs, wdq, qn)]
    qs, q_sh = _project(sp, "wuq", None, cqs)
    qs, heads = split_heads(mesh, qs, H, qk, q_sh)
    ckvs, krs, qns, qrs = [], [], [], []
    for j, (x, q) in enumerate(zip(xs, qs)):
        cos, sin = rope_freqs(m.qk_rope, cfg.rope_theta, positions.to(x.device))
        qns.append(q[..., :m.qk_nope])
        qrs.append(apply_rope(q[..., m.qk_nope:], cos, sin))
        dkv = x @ wdkv[j]
        ckvs.append(rms_norm(dkv[..., :m.kv_lora], kvn[j], cfg.norm_eps))
        krs.append(apply_rope(dkv[..., m.kv_lora:][:, :, None, :], cos, sin)[:, :, 0])
    wos, wo_spec = sp.gathered("wo")
    full = len(heads[0]) == H

    if cache is None:
        kn, k_sh = _project(sp, "wuk", None, ckvs)
        kn, kh = split_heads(mesh, kn, H, m.qk_nope, k_sh)
        vv, v_sh = _project(sp, "wuv", None, ckvs)
        vv, vh = split_heads(mesh, vv, H, m.v_dim, v_sh)
        outs = []
        for j in range(len(xs)):
            B, S = xs[j].shape[:2]
            h = len(heads[j])
            k_nope = select_heads(kn[j], kh[j], heads[j])
            v = select_heads(vv[j], vh[j], heads[j])
            q = torch.cat([qns[j], qrs[j]], dim=-1)
            k = torch.cat([k_nope, krs[j][:, :, None, :].expand(B, S, h, m.qk_rope)], dim=-1)
            o = flash_attention(q, k, v, causal=True)
            outs.append(o.reshape(B, S, h * m.v_dim))
        return row_parallel(mesh, outs, wos, wo_spec, full=full), None

    # ---- absorbed decode ---------------------------------------------------
    i = int(cache_index)
    seq_split = model_sharded(cache.specs["ckv"][1])
    wuk = _weight_heads(sp, "wuk", mesh, H, m.qk_nope, heads)
    wuv = _weight_heads(sp, "wuv", mesh, H, m.v_dim, heads)
    qas = [torch.einsum("bshn,rhn->bshr", qn_.float(), w.float()) for qn_, w in zip(qns, wuk)]
    qrs = [q.float() for q in qrs]
    S = xs[0].shape[1]
    kv_len = i + S
    parts = []
    for j, r in enumerate(mesh.local_ranks):
        c = cache.blocks[j]
        T_l = c["ckv"].shape[1]
        lo = mesh.axis_index(r, "model") * T_l if seq_split else 0
        total = T_l * M if seq_split else T_l
        _write_rows(c["ckv"], ckvs[j], i, total, lo)
        _write_rows(c["krope"], krs[j], i, total, lo)
        parts.append((c["ckv"].float(), c["krope"].float(), lo))
    if seq_split and not full:
        # every head attends this rank's slice: gather the queries over model
        cat = mesh.all_gather_axis([torch.cat([a, b], dim=-1) for a, b in zip(qas, qrs)],
                                   "model", 2)
        qas = [t[..., :m.kv_lora] for t in cat]
        qrs = [t[..., m.kv_lora:] for t in cat]
    ctxs, stats = [], []
    for (ckv_c, kr_c, lo), qa, qr in zip(parts, qas, qrs):
        scores = (torch.einsum("bshr,btr->bhst", qa, ckv_c)
                  + torch.einsum("bshp,btp->bhst", qr, kr_c)) * qk ** -0.5
        valid = lo + torch.arange(ckv_c.shape[1], device=scores.device) < kv_len
        scores = torch.where(valid, scores, -1e30)
        if not seq_split:
            ctxs.append(torch.einsum("bhst,btr->bshr", torch.softmax(scores, dim=-1), ckv_c))
            continue
        # this slice's softmax numerator and sum about its own max; a slice
        # wholly past kv_len holds only -1e30, and its weight below is
        # exp(-1e30 - max) = 0
        mx = scores.amax(-1)
        e = torch.exp(scores - mx[..., None])
        ctxs.append(torch.einsum("bhst,btr->bshr", e, ckv_c))
        stats.append(torch.stack([mx, e.sum(-1)])[None])
    if seq_split:
        stats = mesh.all_gather_axis(stats, "model", 0)       # (M, 2, B, H, S)
        scaled = []
        for j, (r, st, ctx) in enumerate(zip(mesh.local_ranks, stats, ctxs)):
            w = torch.exp(st[:, 0] - st[:, 0].amax(0))          # (M, B, H, S)
            denom = (st[:, 1] * w).sum(0)
            mine = w[mesh.axis_index(r, "model")] / denom
            scaled.append(ctx * mine.permute(0, 2, 1)[..., None])
        ctxs = mesh.psum(scaled, "model")
        if not full:
            ctxs = [c[:, :, h.start:h.stop] for c, h in zip(ctxs, heads)]
    outs = [torch.einsum("bshr,rhv->bshv", ctx, w.float()).reshape(*ctx.shape[:2], -1)
            .to(x.dtype) for ctx, w, x in zip(ctxs, wuv, xs)]
    return row_parallel(mesh, outs, wos, wo_spec, full=full), cache
