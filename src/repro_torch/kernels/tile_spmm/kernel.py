"""ctypes wrappers for the CUDA tile kernels in ``csrc/tile_spmm.cu``.

Each wrapper ends like its Pallas counterpart in
``repro.kernels.tile_spmm.kernel`` — ``(..., part_id, flags, *, n_parts)``
— checks device, dtype (float32 values, int32 indices), shape and
contiguity, allocates the output with ``torch.empty`` and launches on
PyTorch's current stream.  ``flags`` (the TPU's FIRST/LAST markers) is
shape-checked only: the CUDA kernels walk partition runs ``part_ptr`` or
an edge plan instead.  The segment softmaxes take per-edge operands, not
the TPU's: scores (T, E), ``col`` (T, E) and the source operand ``xsrc``
in place of a dense score block and gathered (T, E, F) values.  The
plan-walking kernels take their source operand in one of two forms, told
apart by its shape: the tiles' replica (T, S, F), which tile-local
``col`` indexes (row ``t S + col``), or the flat (V, F) store, which
global ``col`` (``src_ids[t, edge_src[t, e]]``) indexes (tile stride 0).
A caller that binds once passes ``part_ptr=`` (built on the host by
:func:`partition_ptr`) and the ``plan=`` (:mod:`.plan`); a wrapper given
neither derives it on the device, which syncs the host
(``torch.bincount``, the plan's sizes).  Tiles must be partition-major
(:func:`check_partition_major`, run once per bind on the host array).

Every launch adds one to its kernel's entry in :data:`LAUNCHES`; a wrapper
given anything but CUDA tensors raises.  The plain PyTorch versions live in
``ref.py``; ``ops.py`` dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import _build
from .plan import EdgePlan, coo_plan, csr_plan

SOURCE = Path(__file__).resolve().parent / "csrc" / "tile_spmm.cu"

FIRST, LAST = 1, 2

#: kernel launches since the last :func:`reset_launches`, by kernel name
LAUNCHES: Dict[str, int] = {"tile_spmm": 0, "tile_spmm_csr": 0,
                            "segment_softmax": 0, "segment_softmax_csr": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    "zipper_tile_spmm_coo": [_P] * 4 + [_I] * 4 + [_P],
    "zipper_tile_spmm_csr": [_P] * 10 + [_I] * 7 + [_P],
    "zipper_segment_softmax": [_P] * 11 + [_I] * 8 + [_P],
}
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def tile_flags(part_id: np.ndarray) -> np.ndarray:
    """FIRST/LAST markers per tile (partition-major tile order)."""
    T = len(part_id)
    f = np.zeros((T,), np.int32)
    for i in range(T):
        if i == 0 or part_id[i] != part_id[i - 1]:
            f[i] |= FIRST
        if i == T - 1 or part_id[i] != part_id[i + 1]:
            f[i] |= LAST
    return f


def partition_ptr(part_id: np.ndarray, n_parts: int) -> np.ndarray:
    """(P+1,) int32 partition runs of a partition-major ``part_id``, on the
    host: the tiles of p are [ptr[p], ptr[p+1])."""
    ptr = np.zeros(n_parts + 1, np.int32)
    ptr[1:] = np.cumsum(np.bincount(np.asarray(part_id), minlength=n_parts))
    return ptr


def check_partition_major(part_id: np.ndarray) -> None:
    """Raise unless ``part_id`` is non-decreasing: the kernels read each
    partition's tiles as one contiguous run."""
    part_id = np.asarray(part_id)
    if part_id.size > 1 and bool((np.diff(part_id) < 0).any()):
        raise ValueError("tiles are not partition-major: part_id decreases")


# ---------------------------------------------------------------------------
# argument checks and launch
# ---------------------------------------------------------------------------

def _check(name: str, t, dtype: torch.dtype, shape: Sequence[int],
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(t) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"the CUDA tile kernels take CUDA tensors, got {where}")
    return t.device


def _part_ptr(part_id: torch.Tensor, n_parts: int,
              given: Optional[torch.Tensor]) -> torch.Tensor:
    """(P+1,) int32 partition runs: tiles of p are [ptr[p], ptr[p+1]).
    ``given`` (precomputed) is checked and used as it is."""
    if given is not None:
        _check("part_ptr", given, torch.int32, (n_parts + 1,), part_id.device)
        return given
    counts = torch.bincount(part_id, minlength=n_parts)
    if counts.shape[0] != n_parts:
        raise ValueError(f"part_id holds a partition >= n_parts={n_parts}")
    ptr = torch.zeros(n_parts + 1, dtype=torch.int32, device=part_id.device)
    ptr[1:] = counts.cumsum(0)
    return ptr


def _check_plan(plan: EdgePlan, n_rows: int, device: torch.device):
    """Check an edge plan against the tiles' row count; return its group,
    zero-row and split-row counts."""
    if plan.n_rows != n_rows:
        raise ValueError(f"plan has {plan.n_rows} rows, the tiles {n_rows}")
    n_edge = plan.slot.shape[0]
    n_group, n_zero = plan.group_ptr.shape[0] - 1, plan.zero_row.shape[0]
    n_split = plan.split_row.shape[0]
    for name, shape in (("slot", (n_edge,)), ("edge_tgt", (n_edge,)),
                        ("group_ptr", (n_group + 1,)), ("zero_row", (n_zero,)),
                        ("split_row", (n_split,)), ("split_ptr", (n_split + 1,))):
        _check(f"plan.{name}", getattr(plan, name), torch.int32, shape, device)
    return n_group, n_zero, n_split


def _source(xsrc, T: int, device: torch.device):
    """(tile stride S, F) of a plan-walking kernel's source operand: the
    replica (T, S, F), tile t's rows starting at t S, or the flat (V, F)
    store that global column ids index, stride 0."""
    if xsrc.dim() == 2:
        _check("xsrc", xsrc, torch.float32, tuple(xsrc.shape), device)
        return 0, xsrc.shape[1]
    S, F = xsrc.shape[-2:]
    _check("xsrc", xsrc, torch.float32, (T, S, F), device)
    return S, F


def _launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed to launch: CUDA error {err}")
    LAUNCHES[kernel] += 1


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def tile_spmm_cuda(adj, xsrc, part_id, flags, *, n_parts: int,
                   part_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """COO tile SpMM: adj (T, D, S); xsrc (T, S, F); part_id/flags (T,)
    int32.  Returns (P, D, F) with out[p] = sum over p's tiles of A_t X_t."""
    dev = _device_of(adj)
    T, D, S = adj.shape
    F = xsrc.shape[-1]
    _check("adj", adj, torch.float32, (T, D, S), dev)
    _check("xsrc", xsrc, torch.float32, (T, S, F), dev)
    _check("part_id", part_id, torch.int32, (T,), dev)
    _check("flags", flags, torch.int32, (T,), dev)
    out = torch.empty((n_parts, D, F), dtype=torch.float32, device=dev)
    ptr = _part_ptr(part_id, n_parts, part_ptr)
    _launch("tile_spmm", "zipper_tile_spmm_coo", dev, adj.data_ptr(),
            xsrc.data_ptr(), ptr.data_ptr(), out.data_ptr(), n_parts, D, S, F)
    return out


def tile_spmm_csr_cuda(row_ptr, col, w, xsrc, part_id, flags, *,
                       n_parts: int, plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """CSR tile SpMM: row_ptr (T, D+1) and col (T, E) int32; w (T, E);
    xsrc the replica (T, S, F) with tile-local ``col``, or the flat (V, F)
    store with global ``col``.  Returns (P, D, F); padded edge slots are
    never read.  ``plan`` is the tile set's :class:`~.plan.EdgePlan` (built
    here, with a host sync, when absent); it holds the partition runs, so
    this wrapper takes no ``part_ptr``."""
    dev = _device_of(row_ptr)
    T, E = col.shape
    D = row_ptr.shape[1] - 1
    _check("row_ptr", row_ptr, torch.int32, (T, D + 1), dev)
    _check("col", col, torch.int32, (T, E), dev)
    _check("w", w, torch.float32, (T, E), dev)
    S, F = _source(xsrc, T, dev)
    _check("part_id", part_id, torch.int32, (T,), dev)
    _check("flags", flags, torch.int32, (T,), dev)
    if plan is None:
        plan = csr_plan(row_ptr, part_id, n_parts, E)
    n_rows = n_parts * D
    n_group, n_zero, n_split = _check_plan(plan, n_rows, dev)
    # the split rows' partial sums live in rows past the output
    buf = torch.empty((n_rows + plan.n_partial, F), dtype=torch.float32,
                      device=dev)
    _launch("tile_spmm_csr", "zipper_tile_spmm_csr", dev, plan.slot.data_ptr(),
            plan.edge_tgt.data_ptr(), plan.group_ptr.data_ptr(),
            plan.zero_row.data_ptr(), col.data_ptr(), w.data_ptr(),
            xsrc.data_ptr(), plan.split_row.data_ptr(), plan.split_ptr.data_ptr(),
            buf.data_ptr(), n_group, n_zero, n_split, n_rows, E, S, F)
    return buf[:n_rows].view(n_parts, D, F)


def _segment_softmax(kernel: str, coo: bool, plan: EdgePlan, col, scores,
                     xsrc, n_parts: int, D: int, dev) -> torch.Tensor:
    """Launch the plan-walking softmax (one C entry point, ``coo`` picks the
    liveness rule) and return the (P, D, F) output."""
    T, E = scores.shape
    S, F = _source(xsrc, T, dev)
    n_rows = n_parts * D
    n_group, n_zero, n_split = _check_plan(plan, n_rows, dev)
    # the split rows' partial (acc; m, l) live in rows past the output
    buf = torch.empty((n_rows + plan.n_partial, F), dtype=torch.float32,
                      device=dev)
    ml = torch.empty((plan.n_partial, 2), dtype=torch.float32, device=dev)
    _launch(kernel, "zipper_segment_softmax", dev, plan.slot.data_ptr(),
            plan.edge_tgt.data_ptr(), plan.group_ptr.data_ptr(),
            plan.zero_row.data_ptr(), col.data_ptr(), scores.data_ptr(),
            xsrc.data_ptr(), plan.split_row.data_ptr(), plan.split_ptr.data_ptr(),
            buf.data_ptr(), ml.data_ptr(), n_group, n_zero, n_split, n_rows,
            E, S, F, int(coo))
    return buf[:n_rows].view(n_parts, D, F)


def segment_softmax_cuda(edge_dst, n_edge, col, scores, xsrc, part_id, flags,
                         *, n_parts: int, dmax: int,
                         plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """COO online segment softmax on per-edge operands: edge_dst, col
    (T, E) int32 and n_edge (T,) int32 (the tiles' edge lists); scores
    (T, E) float32, an edge counting where its score is above -1e29; xsrc
    the replica (T, S, F) or the flat (V, F) store, as ``col`` is local or
    global.  Returns (P, dmax, F): out[p, d] = sum over the edges of row d
    in p's tiles of softmax(score) * xsrc[t, col[t, e]] (xsrc[col[t, e]]),
    0 for a row with no live edge.  ``plan`` is the tiles'
    :func:`~.plan.coo_plan` (built here, with host syncs, when absent).
    Padded slots are never read."""
    dev = _device_of(scores)
    T, E = scores.shape
    _check("edge_dst", edge_dst, torch.int32, (T, E), dev)
    _check("n_edge", n_edge, torch.int32, (T,), dev)
    _check("col", col, torch.int32, (T, E), dev)
    _check("scores", scores, torch.float32, (T, E), dev)
    _source(xsrc, T, dev)
    _check("part_id", part_id, torch.int32, (T,), dev)
    _check("flags", flags, torch.int32, (T,), dev)
    if plan is None:
        plan = coo_plan(edge_dst, n_edge, part_id, n_parts, dmax)
    return _segment_softmax("segment_softmax", True, plan, col, scores, xsrc,
                            n_parts, dmax, dev)


def segment_softmax_csr_cuda(row_ptr, col, scores, xsrc, part_id, flags, *,
                             n_parts: int,
                             plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """CSR online segment softmax: row_ptr (T, D+1) and col (T, E) int32;
    scores (T, E); xsrc the replica (T, S, F) or the flat (V, F) store, as
    ``col`` is local or global.  Returns (P, D, F), every real slot
    counting.  ``plan`` is the tiles' :func:`~.plan.csr_plan` (built here,
    with host syncs, when absent)."""
    dev = _device_of(row_ptr)
    T, E = col.shape
    D = row_ptr.shape[1] - 1
    _check("row_ptr", row_ptr, torch.int32, (T, D + 1), dev)
    _check("col", col, torch.int32, (T, E), dev)
    _check("scores", scores, torch.float32, (T, E), dev)
    _source(xsrc, T, dev)
    _check("part_id", part_id, torch.int32, (T,), dev)
    _check("flags", flags, torch.int32, (T,), dev)
    if plan is None:
        plan = csr_plan(row_ptr, part_id, n_parts, E)
    return _segment_softmax("segment_softmax_csr", False, plan, col, scores,
                            xsrc, n_parts, D, dev)
