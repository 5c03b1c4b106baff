"""Step factories: train_step / prefill_step / decode_step closures for one
architecture, as ``repro.launch.steps`` builds them (one device, no mesh).
Shared by the trainer (``train.py``), the serving loop (``serve.py``) and
``chip_smoke.py``."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import lm
from ..models.common import tree_items, tree_unflatten
from ..optim.adamw import AdamWState, adamw_update
from ..optim.schedule import wsd_schedule


def opt_state_bits(cfg: ArchConfig) -> int:
    """8-bit moments for the huge-expert models, as the reference picks."""
    return 8 if (cfg.moe and cfg.param_count() > 1e11) else 32


def make_train_step(cfg: ArchConfig, *, peak_lr: float = 3e-4,
                    total_steps: int = 10_000, microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    {"loss", "grad_norm", "lr"}): ``lm.loss_fn`` and its gradients by
    autograd (each block rematerialized), the WSD learning rate at the
    state's step, then :func:`repro_torch.optim.adamw.adamw_update`, which
    overwrites the parameters and moments in place (the returned trees are
    the caller's).  ``batch``: tensors on the parameters' device.

    ``microbatches > 1``: gradient accumulation over equal splits of the
    batch, summed in ``accum_dtype`` and divided by the count, the loss
    averaged, as the reference's ``lax.scan`` does."""
    bits = opt_state_bits(cfg)

    def train_step(params, opt_state: AdamWState, batch):
        leaves = [t for _, t in tree_items(params)]
        flags = [t.requires_grad for t in leaves]
        for t in leaves:
            t.requires_grad_(True)
        try:
            if microbatches == 1:
                lval = lm.loss_fn(cfg, params, batch)
                flat = list(torch.autograd.grad(lval, leaves))
                lval = lval.detach()
            else:
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                      for k, v in batch.items()}
                lval = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                flat = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                        for p in leaves]
                for i in range(microbatches):
                    l = lm.loss_fn(cfg, params, {k: v[i] for k, v in mb.items()})
                    for a, g in zip(flat, torch.autograd.grad(l, leaves)):
                        a.add_(g.to(accum_dtype))
                    lval = lval + l.detach()
                lval = lval / microbatches
                for a in flat:
                    a.div_(microbatches)
        finally:
            for t, f in zip(leaves, flags):
                t.requires_grad_(f)
        grads = tree_unflatten(params, flat)
        del flat
        lr = wsd_schedule(opt_state.step, peak_lr=peak_lr, total=total_steps)
        params, opt_state, gnorm = adamw_update(params, opt_state, grads, lr,
                                                state_bits=bits)
        return params, opt_state, {"loss": lval, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch)`` -> next-token logits (B, vocab).
    ``batch`` goes to ``lm.forward`` as it is: ``tokens``, and
    ``patch_embeds`` (vlm) or ``frames`` (audio) where the family takes
    them."""
    @torch.no_grad()
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
