"""AdamW with global-norm clipping and optional compressed moments.

Ports ``repro.optim.adamw`` for one device.  ``state_bits=8`` stores the
first moment as int8 with a per-row float32 scale (m is zero-mean; linear
quantization is benign) and the second moment as bfloat16 (v spans many
orders of magnitude; bf16's exponent keeps the relative error ~0.4 %):
10 B/param of optimizer state become 3.1 B/param.  ``torch.round`` rounds
half to even, as ``jnp.round`` does.

The update's float32 arithmetic is the reference's, in the reference's
order.  It runs leaf by leaf and **in place**: each parameter and its
moments are overwritten, a large leaf in slices of whole rows of its last
axis (so the per-row int8 scales are unchanged), so the only transient is
one slice's float32 copy.  The reference returns new trees and donates the
old ones; here the caller's tensors are the new state.  The reference's
ZeRO-1 moment specs (``adamw_state_template``) and ``update_shardings``
have nothing to shard on one device and wait for a multi-card slice.
"""
from __future__ import annotations

import itertools
from typing import Any, Iterator, NamedTuple

import torch

from ..models.common import tree_items, tree_map

#: a larger leaf is updated in slices of at most this many elements
SLICE_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d: updates applied so far
    m: Any                  # first moments (float32, or int8 with m_scale)
    v: Any                  # second moments (float32, or bfloat16)
    m_scale: Any            # None (32-bit state) or per-row float32 scales
    v_scale: Any            # always None (kept for the reference's layout)


def _q8(x):
    """int8 quantize along the last axis; returns (q, scale)."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return torch.round(x / scale).to(torch.int8), scale.to(torch.float32)


def _dq8(q, scale):
    return q.to(torch.float32) * scale


def adamw_init(params, state_bits: int = 32) -> AdamWState:
    """Zero moments beside each parameter, on its device."""
    def zeros(dt, shape=None):
        return lambda p: torch.zeros(p.shape if shape is None else shape(p),
                                     dtype=dt, device=p.device)

    m = tree_map(zeros(torch.int8 if state_bits == 8 else torch.float32), params)
    v = tree_map(zeros(torch.bfloat16 if state_bits == 8 else torch.float32), params)
    ms = (tree_map(zeros(torch.float32, lambda p: p.shape[:-1] + (1,)), params)
          if state_bits == 8 else None)
    dev = next(t for _, t in tree_items(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=m, v=v, m_scale=ms, v_scale=None)


def _row_step(t: torch.Tensor) -> int:
    """Rows of ``t``'s last axis in a slice of at most :data:`SLICE_ELEMS`
    elements (at least one)."""
    return max(1, SLICE_ELEMS // t.shape[-1]) if t.dim() else 1


def _slices(t: torch.Tensor, step: int) -> Iterator[torch.Tensor]:
    """``t`` as rows of its last axis (a view: ``t`` is contiguous), ``step``
    rows a slice."""
    rows = t.view(-1, t.shape[-1]) if t.dim() else t.view(1, 1)
    for i in range(0, rows.shape[0], step):
        yield rows[i:i + step]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(sum(torch.sum(torch.square(s.float()))
                              for s in _slices(x.contiguous(), _row_step(x)))
                          for _, x in tree_items(tree)))


def adamw_update_impl(params, state: AdamWState, grads, lr, *,
                      b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                      weight_decay: float = 0.1, clip_norm: float = 1.0,
                      state_bits: int = 32):
    """One AdamW step in place.  Returns (params, new state, grad norm):
    ``params`` and the state's moment trees are the caller's tensors,
    overwritten; the new state has ``step`` + 1."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)

    def upd(p, g, m, v, msc):
        g = g.float() * scale
        m_f = _dq8(m, msc) if state_bits == 8 else m
        v_f = v.float() if state_bits == 8 else v
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * g * g
        upd_ = (m_f / bc1) / (torch.sqrt(v_f / bc2) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * upd_)
        if state_bits == 8:
            mq, ms2 = _q8(m_f)
            m.copy_(mq)
            msc.copy_(ms2)
            v.copy_(v_f)
        else:
            m.copy_(m_f)
            v.copy_(v_f)

    def leaves(tree):
        return [t for _, t in tree_items(tree)]

    flat_p = leaves(params)
    flat_ms = leaves(state.m_scale) if state_bits == 8 else [None] * len(flat_p)
    with torch.no_grad():
        for p, g, m, v, msc in zip(flat_p, leaves(grads), leaves(state.m),
                                   leaves(state.v), flat_ms):
            rows = _row_step(p)
            parts = [_slices(t, rows) for t in (p, g.contiguous(), m, v)]
            parts.append(_slices(msc, rows) if msc is not None else itertools.repeat(None))
            for args in zip(*parts):
                upd(*args)
    return params, AdamWState(step=step, m=state.m, v=state.v, m_scale=state.m_scale,
                              v_scale=None), gnorm


#: the update (no jit on this side; ``adamw_update_impl`` is the same function)
adamw_update = adamw_update_impl
