"""ctypes wrappers for the four CUDA tile kernels in ``csrc/tile_spmm.cu``.

Each wrapper keeps the signature of its Pallas counterpart in
``repro.kernels.tile_spmm.kernel`` — ``(..., part_id, flags, *, n_parts)``
— checks device, dtype (float32 values, int32 indices), shape and
contiguity, allocates the output with ``torch.empty`` and launches on
PyTorch's current stream.  ``flags`` (the TPU's FIRST/LAST markers) is
shape-checked only: the CUDA kernels walk partition runs ``part_ptr``
instead.  A caller that binds once passes ``part_ptr=`` (built on the host
by :func:`partition_ptr`) and the CSR SpMM's ``plan=`` (:mod:`.plan`); a
wrapper given neither derives it from ``part_id`` on the device, which
syncs the host (``torch.bincount``, the plan's sizes).  Tiles must be
partition-major (:func:`check_partition_major`, run once per bind on the
host array).

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
from .plan import CsrPlan, csr_plan

SOURCE = Path(__file__).resolve().parent / "csrc" / "tile_spmm.cu"

FIRST, LAST = 1, 2

#: kernel launches since the last :func:`reset_launches`, by kernel name
LAUNCHES: Dict[str, int] = {"tile_spmm": 0, "tile_spmm_csr": 0,
                            "segment_softmax": 0, "segment_softmax_csr": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    "zipper_tile_spmm_coo": [_P] * 4 + [_I] * 4 + [_P],
    "zipper_tile_spmm_csr": [_P] * 10 + [_I] * 7 + [_P],
    "zipper_segment_softmax_coo": [_P] * 4 + [_I] * 4 + [_P],
    "zipper_segment_softmax_csr": [_P] * 5 + [_I] * 4 + [_P],
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


def _launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed to launch: CUDA error {err}")
    LAUNCHES[kernel] += 1


# ---------------------------------------------------------------------------
# the four kernels
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
                       n_parts: int, plan: Optional[CsrPlan] = None) -> torch.Tensor:
    """CSR tile SpMM: row_ptr (T, D+1) and col (T, E) int32; w (T, E);
    xsrc (T, S, F).  Returns (P, D, F); padded edge slots are never read.
    ``plan`` is the tile set's :class:`~.plan.CsrPlan` (built here, with a
    host sync, when absent); it holds the partition runs, so this wrapper
    takes no ``part_ptr``."""
    dev = _device_of(row_ptr)
    T, E = col.shape
    D = row_ptr.shape[1] - 1
    S, F = xsrc.shape[-2:]
    _check("row_ptr", row_ptr, torch.int32, (T, D + 1), dev)
    _check("col", col, torch.int32, (T, E), dev)
    _check("w", w, torch.float32, (T, E), dev)
    _check("xsrc", xsrc, torch.float32, (T, S, F), dev)
    _check("part_id", part_id, torch.int32, (T,), dev)
    _check("flags", flags, torch.int32, (T,), dev)
    if plan is None:
        plan = csr_plan(row_ptr, part_id, n_parts, E)
    n_rows = n_parts * D
    if plan.n_rows != n_rows:
        raise ValueError(f"plan has {plan.n_rows} rows, the tiles {n_rows}")
    n_edge = plan.slot.shape[0]
    n_group, n_zero = plan.group_ptr.shape[0] - 1, plan.zero_row.shape[0]
    n_split = plan.split_row.shape[0]
    for name, shape in (("slot", (n_edge,)), ("edge_tgt", (n_edge,)),
                        ("group_ptr", (n_group + 1,)), ("zero_row", (n_zero,)),
                        ("split_row", (n_split,)), ("split_ptr", (n_split + 1,))):
        _check(f"plan.{name}", getattr(plan, name), torch.int32, shape, dev)
    # the split rows' partial sums live in rows past the output
    buf = torch.empty((n_rows + plan.n_partial, F), dtype=torch.float32,
                      device=dev)
    _launch("tile_spmm_csr", "zipper_tile_spmm_csr", dev, plan.slot.data_ptr(),
            plan.edge_tgt.data_ptr(), plan.group_ptr.data_ptr(),
            plan.zero_row.data_ptr(), col.data_ptr(), w.data_ptr(),
            xsrc.data_ptr(), plan.split_row.data_ptr(), plan.split_ptr.data_ptr(),
            buf.data_ptr(), n_group, n_zero, n_split, n_rows, E, S, F)
    return buf[:n_rows].view(n_parts, D, F)


def segment_softmax_cuda(scores, vals, part_id, flags, *, n_parts: int,
                         part_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """COO online segment softmax: scores (T, D, E) per-edge columns with
    the -1e30 sentinel; vals (T, E, F).  Returns (P, D, F)."""
    dev = _device_of(scores)
    T, D, E = scores.shape
    F = vals.shape[-1]
    _check("scores", scores, torch.float32, (T, D, E), dev)
    _check("vals", vals, torch.float32, (T, E, F), dev)
    _check("part_id", part_id, torch.int32, (T,), dev)
    _check("flags", flags, torch.int32, (T,), dev)
    out = torch.empty((n_parts, D, F), dtype=torch.float32, device=dev)
    ptr = _part_ptr(part_id, n_parts, part_ptr)
    _launch("segment_softmax", "zipper_segment_softmax_coo", dev,
            scores.data_ptr(), vals.data_ptr(), ptr.data_ptr(), out.data_ptr(),
            n_parts, D, E, F)
    return out


def segment_softmax_csr_cuda(row_ptr, scores, vals, part_id, flags, *,
                             n_parts: int,
                             part_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CSR online segment softmax: row_ptr (T, D+1) int32; scores (T, E);
    vals (T, E, F) per-edge values.  Returns (P, D, F)."""
    dev = _device_of(row_ptr)
    T, E = scores.shape
    D = row_ptr.shape[1] - 1
    F = vals.shape[-1]
    _check("row_ptr", row_ptr, torch.int32, (T, D + 1), dev)
    _check("scores", scores, torch.float32, (T, E), dev)
    _check("vals", vals, torch.float32, (T, E, F), dev)
    _check("part_id", part_id, torch.int32, (T,), dev)
    _check("flags", flags, torch.int32, (T,), dev)
    out = torch.empty((n_parts, D, F), dtype=torch.float32, device=dev)
    ptr = _part_ptr(part_id, n_parts, part_ptr)
    _launch("segment_softmax_csr", "zipper_segment_softmax_csr", dev,
            row_ptr.data_ptr(), scores.data_ptr(), vals.data_ptr(),
            ptr.data_ptr(), out.data_ptr(),
            n_parts, D, E, F)
    return out
