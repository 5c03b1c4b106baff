"""Blocked (flash) attention: the entry point the LM stack calls.

``flash_attention`` computes what ``repro.kernels.flash_attention.ops.
flash_attention`` computes.  CPU tensors take the plain PyTorch version
(``ref.py``, the reference's scan path as a loop over KV blocks of
``block_k``); CUDA tensors launch the hand-written kernel (``kernel.py``,
64-key tiles whatever ``block_k`` says), which raises rather than falling
back.  Meta tensors (the dry run) get the output the CUDA wrapper would
allocate and run nothing; a step's cost counter credits the kernel's own
work on every device (``kernels/cost.py``).

It is differentiable (:class:`FlashAttention`, a ``torch.autograd.Function``):
the forward is the dispatch above, unchanged, and the backward is
:func:`flash_attention_backward`, PyTorch ops over blocks of ``block_k``
keys on either device, which reads the forward's output.  The reference
differentiates its scan path with ``jax.value_and_grad`` and recomputes
each block's scores (``jax.checkpoint`` on the block body); no kernel of
the reference has a backward.  The backward never holds more than one
(Sq, ``block_k``) block of scores a head.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import cost
from . import kernel as K
from .ref import _NEG, block_mask, flash_attention_ref, online_softmax


def _forward(q, k, v, causal, window, block_k, kv_len):
    with cost.kernel("flash_attention",
                     lambda: cost.flash_cost(q, k, v, causal, window, kv_len)):
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       block_k=block_k, kv_len=kv_len)
        if kv_len is not None:
            kv_len = kv_len.to(device=q.device, dtype=torch.int32)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.device.type == "meta":
            return _meta_forward(q, v)
        return K.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len)


def _meta_forward(q, v):
    """The dry run's stand-in for the kernel on the meta device: the output
    the CUDA wrapper allocates, of its shape and dtype (the contiguous
    operands and the int32 ``kv_len`` were made as for the card).  It runs
    neither the kernel nor the plain version."""
    B, Sq, H, _ = q.shape
    return torch.empty((B, Sq, H, v.shape[-1]), dtype=q.dtype, device=q.device)


def flash_attention_backward(q, k, v, o, do, *, causal: bool = True,
                             window: Optional[int] = None, block_k: int = 512,
                             kv_len: Optional[torch.Tensor] = None):
    """Gradients (dq, dk, dv) of ``o = flash_attention(q, k, v, ...)`` for
    the output gradient ``do`` (B, Sq, H, Dv), in float32 and returned in
    the inputs' dtypes.

    ``delta = rowsum(do * o)`` reads the forward's output.  Each query row's
    max ``m`` and sum ``l`` come from the plain version's online softmax
    (:func:`~.ref.online_softmax`, scores only), so the backward pads and
    masks exactly as the forward it differentiates.  Then one pass over
    blocks of ``block_k`` keys recomputes each block's probabilities ``p =
    exp(s - m) / l`` and adds ``ds = p (do v^T - delta)`` into dq and,
    summed over the G query heads of a KV head (GQA), into dk; ``p^T do``
    into dv.  Masked pairs (causal, window, ``kv_len``) carry no gradient to
    q or k, as ``torch.where`` does in the plain version.  ``D`` and ``Dv``
    may differ (MLA)."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Kh
    dev = q.device
    scale = D ** -0.5
    m, l, _ = online_softmax(q, k, causal=causal, window=window, block_k=block_k,
                             kv_len=kv_len)
    l = torch.clamp(l, min=1e-30)
    qg = (q.float() * scale).reshape(B, Sq, Kh, G, D)
    dog = do.float().reshape(B, Sq, Kh, G, Dv)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dog, o.float().reshape(B, Sq, Kh, G, Dv))
    base_len = (torch.full((B,), Sk, dtype=torch.int64, device=dev)
                if kv_len is None else kv_len.to(dev).long())
    block_k = min(block_k, Sk)

    dq = torch.zeros((B, Sq, Kh, G, D), dtype=torch.float32, device=dev)
    dk = torch.empty((B, Sk, Kh, D), dtype=torch.float32, device=dev)
    dv = torch.empty((B, Sk, Kh, Dv), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        kb, vb = k[:, k0:k1].float(), v[:, k0:k1].float()
        msk = block_mask(Sq, Sk, k0, k1, causal, window, base_len, dev)[:, None, None]
        s = torch.where(msk, torch.einsum("bqkgd,bskd->bkgqs", qg, kb), _NEG)
        p = torch.exp(s - m[..., None]) / l[..., None]         # (B,K,G,Sq,bk)
        dv[:, k0:k1] = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vb)
        ds = torch.where(msk, p * (dp - delta[..., None]), 0.0)
        dq += torch.einsum("bkgqs,bskd->bqkgd", ds, kb)
        dk[:, k0:k1] = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
        del s, p, dp, ds
    dq = (dq * scale).reshape(B, Sq, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the kernel (or the plain version on the CPU)
    forward and :func:`flash_attention_backward` backward, which reads the
    forward's output."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, window, block_k):
        o = _forward(q, k, v, causal, window, block_k, kv_len)
        ctx.save_for_backward(q, k, v, kv_len, o)
        ctx.opts = dict(causal=causal, window=window, block_k=block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_len, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, do, kv_len=kv_len, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    block_k: int = 512,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv).  Returns
    (B, Sq, H, Dv).  Queries are right-aligned against keys (decode: Sq=1
    attends the whole cache); ``kv_len`` (B,) masks a partly filled cache.
    Differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, kv_len, causal, window, block_k)
