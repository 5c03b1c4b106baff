"""ctypes wrapper for the CUDA grouped-FFN kernel in ``csrc/grouped_ffn.cu``.

The wrapper checks device, dtype (float32 or bfloat16 for the buckets and
all three weights; int32 counts), shapes (d and f multiples of 8),
contiguity and 16-byte alignment, allocates the
output and the (E, C, f) fp32 scratch with ``torch.empty``, picks the
kernel's launch configuration (:func:`launch_config`) and launches on
PyTorch's current stream.  Every call adds one to :data:`LAUNCHES` (the
kernel's two launches, gate/up then down, count as one); CPU tensors raise.
The plain version is ``ref.grouped_ffn_ref``; ``ops.grouped_ffn`` dispatches
by device.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import _build
from ..tile_spmm.kernel import _check

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_ffn.cu"
#: dynamic shared memory one block may use on an H100 (227 KB)
MAX_SMEM = 232_448
# the kernel's kBK, kSlice, kWarpCols, kMaxSlices
_BK, _SLICE, _WARP_COLS, _MAX_SLICES = 32, 8, 128, 8

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"grouped_ffn": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    LAUNCHES["grouped_ffn"] = 0


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        lib.zipper_grouped_ffn.argtypes = [_P] * 7 + [_I] * 9 + [_P]
        lib.zipper_grouped_ffn.restype = ctypes.c_int
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class FfnConfig:
    """Launch configuration of the grouped-FFN kernel (both launches).

    ``rows`` = 8 ``slices``: the row tile, one warp per 8-row slice and
    contraction share; ``ksplit`` warps share each 32-deep contraction step;
    ``cols``: the column tile of the gate/up launch and of the down launch;
    ``slots``: stages of the cp.async ring; ``smem``: dynamic shared-memory
    bytes a block takes."""

    rows: int
    slices: int
    ksplit: int
    cols: Tuple[int, int]
    slots: int
    smem: int

    @property
    def threads(self) -> int:
        return 32 * self.slices * self.ksplit


def launch_config(E: int, C: int, d: int, f: int, dtype: torch.dtype, *,
                  ksplit: Optional[int] = None,
                  slots: Optional[int] = None) -> FfnConfig:
    """The kernel's configuration for (E, C, d) buckets and f hidden units.

    The row tile covers the bucket in 8-row slices (C <= 64 in one tile, so
    a live expert's weights are read once a launch).  Warps split each
    contraction step 4 ways for 1-3 slices, 2 for 4-6, 1 for 7-8, so a
    block has 4 to 12 warps.  The ring has 4 slots, 3 where the block is
    small (C <= 16, decode: weight-read bound, so two blocks a SM count
    more than a deeper ring).  A slot holds the x tile (rows padded by 16
    bytes) and the weight tiles: 2 x 32 x 128 of the gate/up launch or 32 x
    256 of the down launch, whichever is larger; the ks > 0 warps' partial
    sums reuse the ring.  ``E``, ``d`` and ``f`` do not change it;
    ``ksplit`` and ``slots`` override the choice (for timing others)."""
    del E, d, f
    slices = max(1, min(-(-C // _SLICE), _MAX_SLICES))
    if ksplit is None:
        ksplit = 4 if slices <= 3 else 2 if slices <= 6 else 1
    if slots is None:
        slots = 3 if slices <= 2 else 4
    el = torch.finfo(dtype).bits // 8
    rows = _SLICE * slices
    gate = rows * (_BK + 16 // el) * el + 2 * _BK * _WARP_COLS * el
    down = rows * (_BK + 4) * 4 + _BK * 2 * _WARP_COLS * el
    reduce = (ksplit - 1) * slices * 32 * 64 * 4
    return FfnConfig(rows=rows, slices=slices, ksplit=ksplit,
                     cols=(_WARP_COLS, 2 * _WARP_COLS), slots=slots,
                     smem=max(slots * max(gate, down), reduce))


def row_slices(C: int, cfg: FfnConfig) -> List[Tuple[int, int]]:
    """(first row, rows) of every 8-row slice a warp owns, over the row
    tiles of a C-row bucket, rows past C cut off."""
    return [(r, min(_SLICE, C - r))
            for t0 in range(0, C, cfg.rows)
            for r in range(t0, min(t0 + cfg.rows, C), _SLICE)]


def issued_rows(counts: Sequence[int], C: int, cfg: FfnConfig) -> int:
    """Row slots the kernel's FMAs run over: 8 for every slice with a live
    row (a slice past ``counts[e]`` skips its FMAs)."""
    return sum(_SLICE for n in counts for r0, _ in row_slices(C, cfg)
               if r0 < min(int(n), C))


def grouped_ffn_cuda(buckets, w_gate, w_up, w_down, counts) -> torch.Tensor:
    """buckets: (E, C, d); w_gate/w_up: (E, d, f); w_down: (E, f, d);
    counts: (E,) int32 live rows per expert.  Returns (E, C, d) with rows at
    or past counts[e] zero."""
    if not isinstance(buckets, torch.Tensor) or buckets.device.type != "cuda":
        where = buckets.device if isinstance(buckets, torch.Tensor) else type(buckets).__name__
        raise ValueError(f"the CUDA grouped-FFN kernel takes CUDA tensors, got {where}")
    dev, dt = buckets.device, buckets.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"buckets have dtype {dt}, expected float32 or bfloat16")
    E, C, d = buckets.shape
    f = w_gate.shape[-1]
    _check("buckets", buckets, dt, (E, C, d), dev)
    _check("w_gate", w_gate, dt, (E, d, f), dev)
    _check("w_up", w_up, dt, (E, d, f), dev)
    _check("w_down", w_down, dt, (E, f, d), dev)
    _check("counts", counts, torch.int32, (E,), dev)
    if d % 8 or f % 8:
        raise ValueError(f"d ({d}) and f ({f}) must be multiples of 8")
    for name, t in (("buckets", buckets), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty((E, C, d), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    act = torch.empty((E, C, f), dtype=torch.float32, device=dev)
    cfg = launch_config(E, C, d, f, dt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().zipper_grouped_ffn(
            buckets.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), counts.data_ptr(), act.data_ptr(), out.data_ptr(),
            E, C, d, f, int(dt == torch.bfloat16), cfg.slices, cfg.ksplit,
            cfg.slots, cfg.smem, stream)
    if err != 0:
        raise RuntimeError(f"zipper_grouped_ffn failed to launch: CUDA error {err}")
    LAUNCHES["grouped_ffn"] += 1
    return out
