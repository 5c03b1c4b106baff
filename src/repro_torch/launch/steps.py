"""Step factories for LM serving: prefill_step / decode_step closures for one
architecture, as ``repro.launch.steps`` builds them (one device, no mesh)."""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..models import lm


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch)`` -> next-token logits (B, vocab).
    ``batch`` goes to ``lm.forward`` as it is: ``tokens``, and
    ``patch_embeds`` (vlm) or ``frames`` (audio) where the family takes
    them."""
    def prefill_step(params, batch):
        out = lm.forward(cfg, params, batch)
        logits = out[0] if cfg.family == "moe" else out
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode_step(params, cache, tokens, pos)`` -> (logits (B, vocab),
    cache); the cache is updated in place."""
    def decode_step(params, cache, tokens, pos):
        logits, cache = lm.decode_step(cfg, params, cache, tokens, pos)
        return logits[:, -1], cache

    return decode_step
