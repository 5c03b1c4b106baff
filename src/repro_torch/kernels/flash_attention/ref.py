"""Plain PyTorch version of blocked (flash) attention.

The online softmax of ``repro.kernels.flash_attention.ops.flash_attention``'s
scan path (ops.py:39-89), written as a Python loop over KV blocks: GQA
(query head ``h`` reads KV head ``h // G``), causal and sliding-window masks
with right-aligned queries, a per-batch valid length ``kv_len``, and a value
head dim ``Dv`` that may differ from ``D`` (MLA).  Everything is computed in
float32 and the result is cast to ``q``'s dtype.  The CPU path of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` and the
yardstick ``chip_smoke.py`` holds the CUDA kernel against.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG = -1e30


def block_mask(Sq: int, Sk: int, k0: int, k1: int, causal: bool,
               window: Optional[int], base_len: torch.Tensor, dev) -> torch.Tensor:
    """(B, Sq, k1 - k0) bool: which of keys k0..k1 each query keeps —
    queries right-aligned against the Sk keys, causal and sliding-window
    masks, and keys at or past ``base_len`` (B,) dropped (padding past Sk
    too)."""
    q_pos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    k_pos = torch.arange(k0, k1, device=dev)[None, :]
    msk = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=dev)
    if causal:
        msk &= k_pos <= q_pos
    if window is not None:
        msk &= k_pos > q_pos - window
    return msk[None] & (k_pos[None] < base_len[:, None, None])


def online_softmax(q, k, v=None, *, causal: bool = True,
                   window: Optional[int] = None, block_k: int = 512,
                   kv_len: Optional[torch.Tensor] = None):
    """The scan path's online softmax over blocks of ``block_k`` keys, the
    keys zero-padded to whole blocks: each query row's running max ``m`` and
    sum ``l`` (B, K, G, Sq) and, with ``v``, its unnormalized output
    (B, K, G, Sq, Dv) (else None), all float32.  Shared by
    :func:`flash_attention_ref` and the backward, which needs ``m`` and
    ``l`` only.  A row with no valid key keeps m = ``_NEG`` and counts every
    key of every block, padding included, in ``l``."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    G = H // K
    dev = q.device
    qg = (q.float() * D ** -0.5).reshape(B, Sq, K, G, D)

    block_k = min(block_k, Sk)
    nblk = -(-Sk // block_k)
    pad = nblk * block_k - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = None if v is None else F.pad(v, (0, 0, 0, 0, 0, pad))

    base_len = (torch.full((B,), Sk, dtype=torch.int64, device=dev)
                if kv_len is None else kv_len.to(dev).long())

    o = (None if v is None else
         torch.zeros((B, K, G, Sq, v.shape[-1]), dtype=torch.float32, device=dev))
    m = torch.full((B, K, G, Sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    for j in range(nblk):
        kblk = k[:, j * block_k:(j + 1) * block_k].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kblk)          # (B,K,G,Sq,bk)
        msk = block_mask(Sq, Sk, j * block_k, (j + 1) * block_k, causal, window,
                         base_len, dev)
        s = torch.where(msk[:, None, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if v is not None:
            vblk = v[:, j * block_k:(j + 1) * block_k].float()
            o = o * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vblk)
        m = m_new
    return m, l, o


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, block_k: int = 512,
                        kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv); kv_len: (B,)
    int or None.  Returns (B, Sq, H, Dv) in q's dtype.

    A query row with no valid key averages the masked rows, as the scan
    path does (the CUDA kernel and the Pallas kernel give 0 there); no
    caller of the LM stack produces such a row."""
    B, Sq, H, _ = q.shape
    _, l, o = online_softmax(q, k, v, causal=causal, window=window, block_k=block_k,
                             kv_len=kv_len)
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _dense_probs(q, k, causal, window, kv_len):
    """q scaled and grouped (B, Sq, K, G, D), and the softmax p (B, K, G,
    Sq, Sk) in float32, computed densely (masked pairs 0)."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    dev = q.device
    qs = (q.float() * D ** -0.5).reshape(B, Sq, K, H // K, D)
    lens = (torch.full((B,), Sk, device=dev) if kv_len is None
            else kv_len.to(dev).long())
    keep = block_mask(Sq, Sk, 0, Sk, causal, window, lens, dev)[:, None, None]
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, k.float())
    return qs, torch.softmax(torch.where(keep, s, -torch.inf), dim=-1).nan_to_num(0.0)


def flash_attention_bwd_magnitude(q, k, v, do, *, causal: bool = True,
                                  window: Optional[int] = None,
                                  kv_len: Optional[torch.Tensor] = None):
    """(dq, dk, dv)-shaped float32 tensors: what the float32 rounding of the
    attention backward scales with, stage by stage, computed densely (a
    check's yardstick, for shapes whose (Sq, Sk) scores fit in memory).

    Scores s = (q scale) k round in proportion to S = |q scale| |k|; an
    error of S in a score moves p = softmax(s) by at most P = p (S + rowsum
    p S).  From there: dv = p^T do sums terms of (p + P)^T |do|; dp = do v^T
    of |do| |v|^T; o = p v of p |v| + P |v|, and delta = rowsum(do o) of
    rowsum(|do| that); ds = p (dp - delta) of Ds = p (|do| |v|^T + that) +
    P |dp - delta|; dq = ds k scale of Ds |k| scale, dk = ds^T (q scale) of
    Ds^T |q scale| (dk and dv summed over a KV head's G query heads)."""
    B, Sq, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    qs, p = _dense_probs(q, k, causal, window, kv_len)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, K, H // K, Dv)
    smag = torch.einsum("bqkgd,bskd->bkgqs", qs.abs(), kf.abs())
    pmag = p * (smag + (p * smag).sum(-1, keepdim=True))
    del smag
    va, doa = vf.abs(), dof.abs()
    dv = torch.einsum("bkgqs,bqkgd->bskd", p + pmag, doa)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, vf)
    omag = torch.einsum("bkgqs,bskd->bkgqd", p + pmag, va)
    delta = torch.einsum("bqkgd,bkgqd->bkgq", dof, o)
    dmag = torch.einsum("bqkgd,bkgqd->bkgq", doa, omag)
    del o, omag
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    dpmag = torch.einsum("bqkgd,bskd->bkgqs", doa, va)
    dsmag = p * (dpmag + dmag[..., None]) + pmag * (dp - delta[..., None]).abs()
    del dp, dpmag, p, pmag
    dq = torch.einsum("bkgqs,bskd->bqkgd", dsmag, kf.abs()) * D ** -0.5
    dk = torch.einsum("bkgqs,bqkgd->bskd", dsmag, qs.abs())
    return dq.reshape(B, Sq, H, D), dk, dv


def flash_attention_delta_error(q, k, v, do, o_rel: float, *, causal: bool = True,
                                window: Optional[int] = None,
                                kv_len: Optional[torch.Tensor] = None):
    """(dq, dk, dv)-shaped float32 bounds of how far the backward's
    gradients move when ``delta = rowsum(do o)`` reads an output ``o``
    rounded to within ``o_rel`` |o| (the forward's bf16 output), computed
    densely: delta moves by at most e = o_rel rowsum(|do| |o|), ds = p (dp -
    delta) by p e, dq = ds k scale by (p e) |k| scale, dk = ds^T (q scale)
    by (p e)^T |q scale| (summed over a KV head's G query heads); dv reads
    no delta."""
    B, Sq, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    qs, p = _dense_probs(q, k, causal, window, kv_len)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()).abs()
    e = o_rel * torch.einsum("bqkgd,bkgqd->bkgq", do.float().reshape(B, Sq, K, H // K, Dv).abs(), o)
    pe = p * e[..., None]
    del p, o
    dq = torch.einsum("bkgqs,bskd->bqkgd", pe, k.float().abs()) * D ** -0.5
    dk = torch.einsum("bkgqs,bqkgd->bskd", pe, qs.abs())
    return dq.reshape(B, Sq, H, D), dk, torch.zeros_like(v, dtype=torch.float32)
