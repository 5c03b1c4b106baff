"""ctypes wrappers for the CUDA relation-grouped edge GEMM and its
weight gradient in ``csrc/relation_gemm.cu``.

The wrappers check device, dtype (float32 rows and weights, int32 plan),
shapes (the GEMM's K a multiple of 8 and N of 4, the weight gradient's
both of 4), contiguity and 16-byte alignment, allocate the output (or add
to the one given) and launch on PyTorch's current stream; they read nothing
back from the card, so a launch never syncs the host.  Every call adds one
to its entry of :data:`LAUNCHES`; CPU tensors raise.  The plan comes from
``ops.relation_plan``, the plain versions are ``ops.relation_gemm_ref`` and
``ops.relation_wgrad_ref``, and ``ops.relation_gemm`` dispatches by device
and carries the backward.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import _build
from ..tile_spmm.kernel import _check

SOURCE = Path(__file__).resolve().parent / "csrc" / "relation_gemm.cu"
#: rows of a block's tile (the kernel's kBM): a relation's segment is cut
#: into tiles of this many edges
BLOCK_ROWS = 128
#: edges a weight-gradient block sums (the kernel's kWChunk)
WGRAD_CHUNK = 1024

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"relation_gemm": 0, "relation_wgrad": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        lib.zipper_relation_gemm.argtypes = [_P] * 7 + [_I] * 5 + [_P]
        lib.zipper_relation_gemm.restype = ctypes.c_int
        lib.zipper_relation_wgrad.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        lib.zipper_relation_wgrad.restype = ctypes.c_int
        _lib = lib
    return _lib


def _device(x) -> torch.device:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"the CUDA relation GEMM takes CUDA tensors, got {where}")
    return x.device


def _check_plan(plan, dev: torch.device) -> None:
    E, R = plan.n_edges, plan.n_relations
    for name, shape in (("src_rows", (E,)), ("dst_rows", (E,)),
                        ("seg", (R + 1,)), ("tile_off", (R + 1,))):
        _check(f"plan.{name}", getattr(plan, name), torch.int32, shape, dev)


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def relation_gemm_cuda(x: torch.Tensor, w: torch.Tensor, plan,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K) rows; w: (R, K, N); ``plan`` (``ops.RelationPlan``) over
    E edges.  Returns (E, N) with row ``plan.dst_rows[i]`` =
    ``x[plan.src_rows[i]] @ w[r]`` for the i-th edge of relation r's
    segment; rows no edge writes are left as allocated.  Given ``out``
    (float32, N columns), adds each edge's product to its row of ``out``
    instead (atomically: several edges may share one) and returns it."""
    dev = _device(x)
    R, K, N = w.shape
    _check("x", x, torch.float32, (x.shape[0], K), dev)
    _check("w", w, torch.float32, (plan.n_relations, K, N), dev)
    _check_plan(plan, dev)
    if K % 8 or N % 4:
        raise ValueError(f"K ({K}) must be a multiple of 8 and N ({N}) of 4")
    accumulate = out is not None
    if accumulate:
        _check("out", out, torch.float32, (out.shape[0], N), dev)
    else:
        out = torch.empty((plan.n_edges, N), dtype=torch.float32, device=dev)
    _check_aligned(x=x, w=w, out=out)
    if plan.n_edges == 0 or out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().zipper_relation_gemm(
            x.data_ptr(), w.data_ptr(), plan.src_rows.data_ptr(),
            plan.dst_rows.data_ptr(), plan.seg.data_ptr(),
            plan.tile_off.data_ptr(), out.data_ptr(), plan.n_edges, R, K, N,
            int(accumulate), stream)
    if err != 0:
        raise RuntimeError(f"zipper_relation_gemm failed to launch: CUDA error {err}")
    LAUNCHES["relation_gemm"] += 1
    return out


def relation_wgrad_cuda(x: torch.Tensor, dy: torch.Tensor, plan) -> torch.Tensor:
    """The weight gradient of :func:`relation_gemm_cuda`: (R, K, N), relation
    r's slice the sum over its edges of ``x[plan.src_rows[i]]^T
    dy[plan.dst_rows[i]]``; x: (M, K), dy: (*, N), K and N multiples of 4."""
    dev = _device(x)
    R, K, N = plan.n_relations, x.shape[1], dy.shape[1]
    _check("x", x, torch.float32, (x.shape[0], K), dev)
    _check("dy", dy, torch.float32, (dy.shape[0], N), dev)
    _check_plan(plan, dev)
    if K % 4 or N % 4:
        raise ValueError(f"K ({K}) and N ({N}) must be multiples of 4")
    _check_aligned(x=x, dy=dy)
    dw = torch.zeros((R, K, N), dtype=torch.float32, device=dev)
    if plan.n_edges == 0:
        return dw
    chunks = (plan.seg[1:] - plan.seg[:-1] + WGRAD_CHUNK - 1) // WGRAD_CHUNK
    chunk_off = torch.cat([chunks.new_zeros(1), torch.cumsum(chunks, 0)]).to(torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().zipper_relation_wgrad(
            x.data_ptr(), dy.data_ptr(), plan.src_rows.data_ptr(),
            plan.dst_rows.data_ptr(), plan.seg.data_ptr(), chunk_off.data_ptr(),
            dw.data_ptr(), plan.n_edges, R, K, N, stream)
    if err != 0:
        raise RuntimeError(f"zipper_relation_wgrad failed to launch: CUDA error {err}")
    LAUNCHES["relation_wgrad"] += 1
    return dw
