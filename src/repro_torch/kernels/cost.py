"""The work a step's cost counter credits to the hand-written LM kernels.

A kernel launched through ctypes is invisible to a ``TorchDispatchMode``,
and on the CPU its plain version runs other ops than the kernel.  So while
a counter is active (``launch.dryrun.StepCounter``), each kernel
dispatcher runs inside :func:`kernel`: the counter credits the kernel's own
FLOPs and bytes, by the bounds' formulas, and counts none of the ops run
inside (the plain version on the CPU, the wrapper's allocations on the
card, the meta branch's on the meta device), so the count is the same on
every device.  Bytes are each input read once and each output written
once.

* flash attention: H x kept (query, key) pairs x (2 D + 2 Dv) FLOPs a batch
  row; the pairs kept by the causal and window masks, and by ``kv_len``
  taken at the whole cache (an upper bound, exact where the cache is full,
  as in the dry run's decode at its last position);
* grouped FFN: 6 d f FLOPs a bucket row over all E x C capacity rows (an
  upper bound: the kernel skips 8-row slices past a bucket's live count,
  which the meta device cannot see).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


@contextlib.contextmanager
def kernel(name: str, cost: Callable[[], Tuple[int, int]]):
    """Around one kernel dispatch: the innermost counter among this
    thread's dispatch modes (one with a ``credit`` method), if any, credits
    ``cost()`` (FLOPs, bytes) to ``name`` and counts nothing the dispatch
    runs inside."""
    counters = [m for m in _get_current_dispatch_mode_stack() if hasattr(m, "credit")]
    if not counters:
        yield
        return
    c = counters[-1]
    flops, nbytes = cost()
    c.credit(name, flops, nbytes)
    c.suspended += 1
    try:
        yield
    finally:
        c.suspended -= 1


def _nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kept_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs of one batch row and head that the masks keep:
    queries right-aligned against the keys (query i at position Sk - Sq +
    i), keys at or before it when ``causal``, within ``window`` of it."""
    pos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(pos + 1, Sk) if causal else np.full(Sq, Sk, dtype=np.int64)
    lo = np.maximum(pos - window + 1, 0) if window is not None else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_cost(q, k, v, causal: bool, window: Optional[int], kv_len) -> Tuple[int, int]:
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    flops = B * H * kept_pairs(Sq, Sk, causal, window) * (2 * D + 2 * Dv)
    out = B * Sq * H * Dv * q.element_size()
    return flops, _nbytes(q, k, v, kv_len) + out


def grouped_ffn_cost(buckets, w_gate, w_up, w_down, counts) -> Tuple[int, int]:
    E, C, d = buckets.shape
    f = w_gate.shape[-1]
    return 6 * d * f * E * C, _nbytes(buckets, w_gate, w_up, w_down, counts, buckets)
