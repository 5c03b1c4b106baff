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


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, block_k: int = 512,
                        kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv); kv_len: (B,)
    int or None.  Returns (B, Sq, H, Dv) in q's dtype.

    A query row with no valid key averages the masked rows, as the scan
    path does (the CUDA kernel and the Pallas kernel give 0 there); no
    caller of the LM stack produces such a row."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    Dv = v.shape[-1]
    G = H // K
    dev = q.device
    qg = (q.float() * D ** -0.5).reshape(B, Sq, K, G, D)

    block_k = min(block_k, Sk)
    nblk = -(-Sk // block_k)
    pad = nblk * block_k - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    q_pos = torch.arange(Sq, device=dev) + (Sk - Sq)
    base_len = (torch.full((B,), Sk, dtype=torch.int64, device=dev)
                if kv_len is None else kv_len.to(dev).long())

    o = torch.zeros((B, K, G, Sq, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, K, G, Sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    for j in range(nblk):
        kblk = k[:, j * block_k:(j + 1) * block_k].float()
        vblk = v[:, j * block_k:(j + 1) * block_k].float()
        k_pos = j * block_k + torch.arange(block_k, device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kblk)          # (B,K,G,Sq,bk)
        msk = torch.ones((Sq, block_k), dtype=torch.bool, device=dev)
        if causal:
            msk &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            msk &= k_pos[None, :] > q_pos[:, None] - window
        msk = msk[None] & (k_pos[None, None, :] < base_len[:, None, None])
        s = torch.where(msk[:, None, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vblk)
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)
