"""Warmup-stable-decay LR schedule (production default), as
``repro.optim.schedule``: float32 arithmetic on a 0-d tensor."""
from __future__ import annotations

import torch


def wsd_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 200,
                 total: int = 10_000, decay_frac: float = 0.2,
                 min_ratio: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor, which keeps its
    device): linear warmup over ``warmup`` steps, flat at ``peak_lr``, then
    a linear decay to ``min_ratio`` x ``peak_lr`` over the last
    ``decay_frac`` of ``total``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    decay_start = total * (1 - decay_frac)
    frac = torch.clamp((step - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
    decay = peak_lr * (1 - (1 - min_ratio) * frac)
    return torch.where(step < decay_start, warm, torch.minimum(warm, decay))
