"""ctypes wrapper for the CUDA flash-attention kernel in
``csrc/flash_attention.cu``.

The wrapper checks device, dtype (float32 or bfloat16, the same for q, k and
v; int32 ``kv_len``), shapes (head dims multiples of 4, at most 256),
contiguity and 16-byte alignment, allocates the output with
``torch.empty``, picks the kernel's tile configuration
(:func:`launch_config`) and launches on PyTorch's current stream.  Every
launch adds one to :data:`LAUNCHES`; CPU tensors raise.  The plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` dispatches by device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from ..tile_spmm.kernel import _check

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
#: dynamic shared memory one block may use on an H100 (227 KB)
MAX_SMEM = 232_448
_KEYS, _K_CHUNK, _STAGES = 64, 64, 3     # the kernel's kBK, kKC, kStages

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        lib.zipper_flash_attention.argtypes = [_P] * 5 + [_I] * 13 + [_P]
        lib.zipper_flash_attention.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch_config(Sq: int, D: int, Dv: int,
                  dtype: torch.dtype) -> Tuple[int, int, int]:
    """(rows, nv, shared-memory bytes) of the kernel for these shapes.

    A block takes 16 ``rows`` query rows: 8 (128 rows) for prefill, 4 when
    Dv > 128 (the accumulator of 8 rows would not fit the registers) or the
    queries are few, 1 for decode (Sq <= 16).  ``nv`` float4 output columns
    a lane: Dv <= 64 ``nv``, in {1, 2, 4}.  The bytes: Q (fp32, rows
    padded to D + 4) and P (64 + 4 columns) for 16 ``rows`` rows, and the
    3-slot K/V ring of 64 keys x (64 dims + 16 bytes)."""
    rows = 1 if Sq <= 16 else 4 if Sq <= 64 or Dv > 128 else 8
    nv = 1 if Dv <= 64 else 2 if Dv <= 128 else 4
    el = torch.finfo(dtype).bits // 8
    slot = _KEYS * (_K_CHUNK * el + 16)
    return rows, nv, 4 * 16 * rows * (D + 4 + _KEYS + 4) + _STAGES * slot


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv); kv_len: (B,)
    int32 or None.  Returns (B, Sq, H, Dv) in q's dtype."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        where = q.device if isinstance(q, torch.Tensor) else type(q).__name__
        raise ValueError(f"the CUDA flash kernel takes CUDA tensors, got {where}")
    dev, dt = q.device, q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q has dtype {dt}, expected float32 or bfloat16")
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    _check("q", q, dt, (B, Sq, H, D), dev)
    _check("k", k, dt, (B, Sk, K, D), dev)
    _check("v", v, dt, (B, Sk, K, Dv), dev)
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} KV heads")
    if max(D, Dv) > MAX_HEAD_DIM or D % 4 or Dv % 4:
        raise ValueError(f"head dims ({D}, {Dv}) must be multiples of 4 and "
                         f"at most {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if kv_len is not None:
        _check("kv_len", kv_len, torch.int32, (B,), dev)
    out = torch.empty((B, Sq, H, Dv), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    rows, nv, smem = launch_config(Sq, D, Dv, dt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().zipper_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, K, D, Dv, int(causal),
            -1 if window is None else int(window),
            int(dt == torch.bfloat16), rows, nv, smem, stream)
    if err != 0:
        raise RuntimeError(f"zipper_flash_attention failed to launch: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
