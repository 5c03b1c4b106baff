"""Batched multi-graph inference serving on the port's PyTorch runner.

Layers:

* :mod:`repro_torch.serve.signature` — size-class quantization and the
  structural request signature (copy of the reference's).
* :mod:`repro_torch.serve.cache` — the thread-safe LRU program cache with
  hit/miss/compile/eviction counters (copy of the reference's).
* :mod:`repro_torch.serve.engine` — :class:`InferenceServer`, the
  synchronous batch-at-a-time core on one device:
  ``submit(graphs, inputs) -> per-graph outputs``.

The async tier and its metrics are not ported yet.
"""
from .cache import CacheStats, ProgramCache  # noqa: F401
from .engine import InferenceServer  # noqa: F401
from .signature import (  # noqa: F401
    ShapeRegistry,
    canonical_tiles,
    quantize,
    serving_grid,
    size_class,
    structure_signature,
)
