"""Gradient compression for data parallelism over slow links.

Ports ``repro.distributed.compression``: int8 quantization of each gradient
leaf with one float32 scale, error feedback (the residual ``g -
dequantize(quantize(g))`` is carried into the next step, so quantization
error does not bias the expectation), and :func:`compressed_psum`, the
error-feedback mean over one axis of a
:class:`~repro_torch.core.exchange.ShardMesh`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.exchange import ShardMesh
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


def compressed_psum(trees: Sequence, mesh: ShardMesh, axis: str,
                    residuals: Optional[Sequence] = None
                    ) -> Tuple[List, List]:
    """Error-feedback int8 mean of gradient trees over ``axis`` of ``mesh``
    (``repro.distributed.compression.compressed_psum``, there inside
    ``shard_map``).  ``trees`` holds one tree per local rank of the mesh
    (``mesh.local_ranks``: all of them in one process, one under a process
    group), ``residuals`` the previous call's, alike.

    Each rank quantizes locally; the fp32 contributions ``q x s`` are summed
    with one :meth:`~repro_torch.core.exchange.ShardMesh.psum` a leaf (the
    wire format of a real slow-link all-reduce is the int8 payload; the sum
    itself upcasts, as the reference's does) and divided by the axis size.
    Returns (mean trees, new residual trees), one of each a local rank."""
    n = mesh.axis_size(axis)
    res = residuals if residuals is not None else [None] * len(trees)
    quantized = [quantize_grads(t, r) for t, r in zip(trees, res)]
    qs = [[q for _, q in tree_items(qt)] for qt, _, _ in quantized]
    ss = [[s for _, s in tree_items(st)] for _, st, _ in quantized]
    means: List[List[torch.Tensor]] = [[] for _ in trees]
    for i in range(len(qs[0])):         # a leaf at a time: one fp32 copy alive
        contrib = [q[i].float() * s[i] for q, s in zip(qs, ss)]
        for j, total in enumerate(mesh.psum(contrib, axis)):
            means[j].append(total / n)
        del contrib
    return ([tree_unflatten(t, m) for t, m in zip(trees, means)],
            [r for _, _, r in quantized])
