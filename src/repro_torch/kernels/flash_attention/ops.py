"""Blocked (flash) attention: the entry point the LM stack calls.

``flash_attention`` computes what ``repro.kernels.flash_attention.ops.
flash_attention`` computes.  CPU tensors take the plain PyTorch version
(``ref.py``, the reference's scan path as a loop over KV blocks of
``block_k``); CUDA tensors launch the hand-written kernel (``kernel.py``,
64-key tiles whatever ``block_k`` says), which raises rather than falling
back.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel as K
from .ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    block_k: int = 512,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv).  Returns
    (B, Sq, H, Dv).  Queries are right-aligned against keys (decode: Sq=1
    attends the whole cache); ``kv_len`` (B,) masks a partly filled cache."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   block_k=block_k, kv_len=kv_len)
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32)
    return K.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=window, kv_len=kv_len)
