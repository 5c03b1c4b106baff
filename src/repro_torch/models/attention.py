"""Attention blocks: GQA (dense, vlm, audio and hybrid families) and MLA
(DeepSeek family).

Ports ``repro.models.attention`` for one device.  Prefill runs the blocked
flash path (``kernels/flash_attention``); decode writes the step's K/V (or,
for MLA, the latent) into the cache **in place** — the reference returns an
updated copy — and attends the filled prefix.  MLA decode is the absorbed
form in the latent space; its einsums stay ``torch.einsum`` (no Pallas kernel
computes them in the reference either).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from .common import DP, apply_rope, leaf, rms_norm, rope_freqs


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
                  cache: Optional[Dict] = None, cache_index: Optional[int] = None,
                  causal: bool = True, kv_x: Optional[torch.Tensor] = None,
                  use_rope: bool = True) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d).  Without a cache: self-attention over x (``causal`` or
    not), or cross-attention with K/V projected from ``kv_x`` (B, Skv, d)
    (the whisper decoder).  With ``cache`` + ``cache_index``: decode (writes
    K/V at cache_index, attends the filled prefix).  ``use_rope=False``
    skips the rotation (whisper's sinusoidal positions)."""
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
                  cache: Optional[Dict] = None,
                  cache_index: Optional[int] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Prefill: latent expanded to per-head K/V, blocked flash (qk head dim
    qk_nope + qk_rope, v head dim v_dim).  Decode: *absorbed* attention in
    the latent space — the cache stays (kv_lora + qk_rope) wide per token."""
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
