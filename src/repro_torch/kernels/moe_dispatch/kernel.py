"""ctypes wrapper for the CUDA grouped-FFN kernel in ``csrc/grouped_ffn.cu``.

The wrapper checks device, dtype (float32 or bfloat16 for the buckets and
all three weights; int32 counts), shapes (d and f multiples of 8),
contiguity and 16-byte alignment, allocates the
output and the (E, C, f) fp32 scratch with ``torch.empty`` and launches on
PyTorch's current stream.  Every call adds one to :data:`LAUNCHES` (the
kernel's two launches, gate/up then down, count as one); CPU tensors raise.
The plain version is ``ref.grouped_ffn_ref``; ``ops.grouped_ffn`` dispatches
by device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import _build
from ..tile_spmm.kernel import _check

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_ffn.cu"

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
        lib.zipper_grouped_ffn.argtypes = [_P] * 7 + [_I] * 5 + [_P]
        lib.zipper_grouped_ffn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().zipper_grouped_ffn(
            buckets.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), counts.data_ptr(), act.data_ptr(), out.data_ptr(),
            E, C, d, f, int(dt == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"zipper_grouped_ffn failed to launch: CUDA error {err}")
    LAUNCHES["grouped_ffn"] += 1
    return out
