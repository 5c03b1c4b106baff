"""Capacity-bucketed MoE dispatch/combine and the grouped FFN.

Ports ``repro.kernels.moe_dispatch.ops`` (ops.py:28-111): top-k routing
with a degree-sort of assignments by expert (``route``), a gather of tokens
into per-expert capacity buckets whose dead slots are zero (``dispatch``),
the grouped SwiGLU FFN over the buckets (``grouped_ffn``), and a weighted
fixed-order sum back to tokens (``combine``; the reference's
``segment_sum``).  ``grouped_ffn`` takes the plain
PyTorch version (``ref.py``) for CPU tensors and launches the hand-written
kernel (``kernel.py``) for CUDA tensors, which raises rather than falling
back; meta tensors (the dry run) get what the CUDA wrapper would allocate
and run nothing, and a step's cost counter credits the kernel's own work
on every device (``kernels/cost.py``).  All functions are device-local.

Training differentiates them as the reference's ``jax.value_and_grad``
does its plain path (``use_pallas=False``): ``route``, ``dispatch`` and
``combine`` are torch ops (the top-k weights carry gradients, the indices
and counts do not), and ``grouped_ffn`` is a ``torch.autograd.Function``
(:class:`GroupedFfn`) whose forward is the dispatch above and whose
backward is :func:`grouped_ffn_backward`, ``torch.bmm`` in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import cost
from . import kernel as K
from .ref import grouped_ffn_ref


@dataclasses.dataclass
class Routing:
    """Static-shape routing plan for one device's tokens."""

    bucket_idx: torch.Tensor  # (T*k,) position in the flattened (E*C) buckets
    token_idx: torch.Tensor   # (T*k,) source token of each assignment (sorted order)
    unsort: torch.Tensor      # (T*k,) sorted position of token t's j-th choice, at t*k + j
    keep: torch.Tensor        # (T*k,) bool — False = dropped by capacity
    weight: torch.Tensor      # (T*k,) routing weight of each assignment
    counts: torch.Tensor      # (E,) live tokens per expert (pre-capacity-clip)
    aux_loss: torch.Tensor    # load-balance auxiliary loss (scalar)


def route(x, router_w, top_k: int, capacity: int, *, norm_topk: bool = True,
          router_bias: Optional[torch.Tensor] = None) -> Routing:
    """Top-k routing + capacity-bucket assignment. x: (T, d)."""
    T = x.shape[0]
    logits = (x @ router_w).float()
    if router_bias is not None:  # aux-loss-free balancing bias (DeepSeek-V3)
        logits = logits + router_bias
    probs = torch.softmax(logits, dim=-1)
    E = probs.shape[-1]
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    if norm_topk:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-20)

    flat_e = top_i.reshape(-1)                        # (T*k,)
    flat_w = top_p.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(top_k)
    se, order = torch.sort(flat_e, stable=True)       # degree-sort reorder
    st, sw = flat_t[order], flat_w[order]
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * top_k, device=x.device) - first   # rank within expert
    keep = pos < capacity
    bucket_idx = torch.where(keep, se * capacity + pos,
                             torch.full_like(se, E * capacity))  # sentinel slot

    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(T * top_k, device=x.device)

    # a static-shape count (``bincount``'s output shape depends on the data,
    # which syncs the host and stops a meta run); the same integers
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    f = counts.float() / max(T * top_k, 1)
    aux = E * torch.sum(f * probs.mean(0))
    return Routing(bucket_idx=bucket_idx, token_idx=st, unsort=unsort, keep=keep,
                   weight=sw.to(x.dtype), counts=counts, aux_loss=aux)


def dispatch(x, r: Routing, n_experts: int, capacity: int) -> torch.Tensor:
    """Gather tokens into (E, C, d) buckets (dead slots are zero)."""
    d = x.shape[-1]
    buckets = torch.zeros((n_experts * capacity + 1, d), dtype=x.dtype, device=x.device)
    buckets[r.bucket_idx] = x[r.token_idx]
    return buckets[:-1].reshape(n_experts, capacity, d)


def combine(y_buckets, r: Routing, n_tokens: int) -> torch.Tensor:
    """Gather expert outputs back to tokens, applying routing weights.

    Every token has exactly ``top_k`` assignments, so the weighted outputs
    are put back in token-major order (``r.unsort``) and each token's
    ``top_k`` rows are added left to right in its choice order, in the
    outputs' dtype: the same sum on every run and on both devices, where a
    scatter-add (``index_add_``) adds with atomics on the card in an order
    that changes between runs."""
    E, C, d = y_buckets.shape
    flat = torch.cat([y_buckets.reshape(E * C, d),
                      y_buckets.new_zeros((1, d))])
    vals = flat[r.bucket_idx] * (r.weight * r.keep)[:, None]
    per_token = vals[r.unsort].reshape(n_tokens, -1, d)
    out = per_token[:, 0]
    for j in range(1, per_token.shape[1]):
        out = out + per_token[:, j]
    return out


def _forward(buckets, w_gate, w_up, w_down, counts):
    with cost.kernel("grouped_ffn",
                     lambda: cost.grouped_ffn_cost(buckets, w_gate, w_up, w_down, counts)):
        if buckets.device.type == "cpu":
            return grouped_ffn_ref(buckets, w_gate, w_up, w_down, counts)
        args = (buckets.contiguous(), w_gate.contiguous(), w_up.contiguous(),
                w_down.contiguous(), counts.to(device=buckets.device, dtype=torch.int32))
        if buckets.device.type == "meta":
            return _meta_forward(*args)
        return K.grouped_ffn_cuda(*args)


def _meta_forward(buckets, w_gate, w_up, w_down, counts):
    """The dry run's stand-in for the kernel on the meta device: what the
    CUDA wrapper allocates, the (E, C, d) output and the (E, C, f) float32
    activations it hands the two launches.  It runs neither the kernel nor
    the plain version."""
    E, C, d = buckets.shape
    out = torch.empty((E, C, d), dtype=buckets.dtype, device=buckets.device)
    if out.numel():
        torch.empty((E, C, w_gate.shape[-1]), dtype=torch.float32, device=buckets.device)
    return out


#: the backward takes experts in groups of at most this many weight elements
#: (d x f) each, so its float32 copies of the weights stay small
BWD_GROUP_ELEMS = 1 << 26


def grouped_ffn_backward(buckets, w_gate, w_up, w_down, counts, dy):
    """Gradients (d buckets, d w_gate, d w_up, d w_down) of
    ``grouped_ffn(buckets, w_gate, w_up, w_down, counts)`` for the output
    gradient ``dy`` (E, C, d): the SwiGLU recomputed and differentiated with
    ``torch.bmm`` in float32, a group of experts at a time, returned in the
    inputs' dtypes.  Rows at or past ``counts[e]`` are zero in the output
    whatever the buckets hold, so they get zero gradient and add nothing to
    the weights'."""
    E, C, d = buckets.shape
    f = w_gate.shape[-1]
    live = (torch.arange(C, device=buckets.device)[None, :]
            < counts.to(buckets.device)[:, None])
    grads = [torch.empty_like(t) for t in (buckets, w_gate, w_up, w_down)]
    step = max(1, BWD_GROUP_ELEMS // (d * f))
    for e0 in range(0, E, step):
        sl = slice(e0, min(e0 + step, E))
        x = buckets[sl].float()
        wg, wu, wd = w_gate[sl].float(), w_up[sl].float(), w_down[sl].float()
        g = torch.where(live[sl][..., None], dy[sl].float(), 0.0)
        h, u = torch.bmm(x, wg), torch.bmm(x, wu)
        sig = torch.sigmoid(h)
        sh = h * sig                                          # silu(h)
        grads[3][sl] = torch.bmm((sh * u).transpose(1, 2), g)
        da = torch.bmm(g, wd.transpose(1, 2))
        dh = da * u * (sig * (1 + h * (1 - sig)))             # silu'(h)
        du = da * sh
        grads[0][sl] = (torch.bmm(dh, wg.transpose(1, 2))
                        + torch.bmm(du, wu.transpose(1, 2)))
        xt = x.transpose(1, 2)
        grads[1][sl] = torch.bmm(xt, dh)
        grads[2][sl] = torch.bmm(xt, du)
    return tuple(grads)


class GroupedFfn(torch.autograd.Function):
    """The grouped FFN with the kernel (or the plain version on the CPU)
    forward and :func:`grouped_ffn_backward` backward."""

    @staticmethod
    def forward(ctx, buckets, w_gate, w_up, w_down, counts):
        ctx.save_for_backward(buckets, w_gate, w_up, w_down, counts)
        return _forward(buckets, w_gate, w_up, w_down, counts)

    @staticmethod
    def backward(ctx, dy):
        return (*grouped_ffn_backward(*ctx.saved_tensors, dy), None)


def grouped_ffn(buckets, w_gate, w_up, w_down, counts) -> torch.Tensor:
    """Per-expert SwiGLU over (E, C, d) buckets; rows at or past
    ``counts[e]`` come back zero.  Differentiable in the buckets and the
    three weights."""
    return GroupedFfn.apply(buckets, w_gate, w_up, w_down, counts)


def moe_block(x, router_w, w_gate, w_up, w_down, *, top_k: int, capacity: int,
              norm_topk: bool = True,
              router_bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-local routed MoE: route -> dispatch -> grouped FFN -> combine.

    Returns (y, aux_loss)."""
    E = w_gate.shape[0]
    r = route(x, router_w, top_k, capacity, norm_topk=norm_topk,
              router_bias=router_bias)
    buckets = dispatch(x, r, E, capacity)
    y_buckets = grouped_ffn(buckets, w_gate, w_up, w_down,
                            torch.clamp(r.counts, max=capacity))
    return combine(y_buckets, r, x.shape[0]), r.aux_loss
