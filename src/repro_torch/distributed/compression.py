"""Gradient compression for data parallelism over slow links.

Ports the pure functions of ``repro.distributed.compression``: int8
quantization of each gradient leaf with one float32 scale, and error
feedback (the residual ``g - dequantize(quantize(g))`` is carried into the
next step, so quantization error does not bias the expectation).  Its
``compressed_psum`` needs a collective across cards and waits for the
``torch.distributed`` backend.
"""
from __future__ import annotations

import torch

from ..models.common import tree_items, tree_unflatten


def quantize_grads(tree, residuals=None):
    """Tree of float grads -> (int8 tree, scale tree, new residual tree);
    ``residuals`` (the previous call's) are added before quantizing."""
    leaves = [g for _, g in tree_items(tree)]
    res = ([r for _, r in tree_items(residuals)] if residuals is not None
           else [None] * len(leaves))
    qs, scales, new_res = [], [], []
    for g, r in zip(leaves, res):
        g32 = g.float()
        if r is not None:
            g32 = g32 + r
        flat = g32.reshape(-1)
        amax = torch.max(torch.abs(flat))
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        new_res.append((flat - deq).reshape(g.shape))          # error feedback
        qs.append(q.reshape(g.shape))
        scales.append(scale)
    return (tree_unflatten(tree, qs), tree_unflatten(tree, scales),
            tree_unflatten(tree, new_res))


def dequantize_grads(q_tree, scale_tree):
    return tree_unflatten(q_tree, [q.float() * s for (_, q), (_, s) in
                                   zip(tree_items(q_tree), tree_items(scale_tree))])
