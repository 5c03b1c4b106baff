"""Shared model substrate: parameter templates, norms, RoPE.

Parameters are declared as :class:`ParamLeaf` templates (shape, dtype, init
scale) in nested dicts, the same trees as ``repro.models.common``; a layer
stack is a leading axis added by :func:`stack_templates`.
:func:`materialize` turns a template tree into tensors on a device.  The
sharding half of the reference (``spec`` entries, ``abstractify``,
``shard_hint``) has no work to do on one device; ``spec`` is kept so the
templates stay the reference's, and is not read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve

DP ="__dp__"    # the reference's batch-axes placeholder in specs (unused here)


@dataclasses.dataclass(frozen=True)
class ParamLeaf:
    shape: Tuple[int, ...]
    spec: Tuple  # logical PartitionSpec entries (None / 'model' / DP)
    init: str = "normal"     # normal | zeros | ones | full
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)
    dtype: str = "bfloat16"

    def fan_in(self) -> int:
        return self.shape[-2] if len(self.shape) >= 2 else 1


def leaf(shape, spec=None, init="normal", scale=None, dtype="bfloat16") -> ParamLeaf:
    spec = tuple(spec) if spec is not None else (None,) * len(shape)
    assert len(spec) == len(shape), (shape, spec)
    return ParamLeaf(tuple(int(s) for s in shape), spec, init, scale, dtype)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_items(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_unflatten(like, flat):
    """The items of ``flat``, in :func:`tree_items` order, placed in a tree of
    ``like``'s structure (nested dicts)."""
    it = iter(flat)
    out: dict = {}
    for path, _ in tree_items(like):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = next(it)
    return out


def stack_templates(tree, n: int):
    """Add a leading layer axis to every leaf."""
    return tree_map(lambda l: ParamLeaf((n,) + l.shape, (None,) + l.spec,
                                        l.init, l.scale, l.dtype), tree)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def materialize(gen: torch.Generator, tree, dtype_override: Optional[str] = None,
                device=None):
    """Tensors for a template tree: normal leaves are N(0, 1) · scale (scale
    1/sqrt(fan_in) unless the leaf names one), drawn in float32 from ``gen``
    on ``device`` (``cuda`` unless the caller names another; see
    :func:`repro_torch.device.resolve`) and cast to the leaf's dtype (or
    ``dtype_override``).  ``gen`` must live on ``device``; it may be None
    for a tree without normal leaves (a cache).  The numbers differ from the
    reference's ``jax.random`` draws; to run both packages on the same
    weights, convert the reference's tree instead
    (:func:`repro_torch.convert.lm_params_from_reference`)."""
    device = resolve(device)

    def one(l: ParamLeaf):
        dt = torch_dtype(dtype_override or l.dtype)
        if l.init == "zeros":
            return torch.zeros(l.shape, dtype=dt, device=device)
        if l.init == "ones":
            return torch.ones(l.shape, dtype=dt, device=device)
        if l.init == "full":
            return torch.full(l.shape, l.scale, dtype=dt, device=device)
        scale = l.scale if l.scale is not None else 1.0 / math.sqrt(max(l.fan_in(), 1))
        t = torch.randn(l.shape, generator=gen, dtype=torch.float32, device=device)
        return t.mul_(scale).to(dt)

    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    h = x.float()
    h = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps)
    return (h * w.float()).to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    h = x.float()
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * w.float() + b.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_mrope(x, positions, sections: Tuple[int, int, int], theta: float):
    """Multimodal RoPE (Qwen2-VL) as ``repro.models.common.apply_mrope``
    defines it: the modality frontend is a stub, so the (t, h, w) position
    streams all carry the text position and the rotation is 1-D RoPE;
    ``sections`` is not read.  Nothing calls it, as in the reference, whose
    ``gqa_attention`` applies 1-D RoPE to the vlm family too."""
    cos, sin = rope_freqs(x.shape[-1], theta, positions)
    return apply_rope(x, cos, sin)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, dtype=torch.float32, device=device)


def cross_entropy(logits, labels, *, z_loss: float = 1e-4):
    """Mean token cross-entropy in float32 plus ``z_loss`` x logsumexp^2
    (logit drift control), as ``repro.models.common.cross_entropy``.
    logits: (..., V); labels: (...) int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    ce = lse - gold
    return (ce + z_loss * lse ** 2).mean()
