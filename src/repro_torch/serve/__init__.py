"""Batched multi-graph inference serving on the port's PyTorch runner.

Layers:

* :mod:`repro_torch.serve.signature` — size-class quantization and the
  structural request signature (copy of the reference's).
* :mod:`repro_torch.serve.cache` — the thread-safe LRU program cache with
  hit/miss/compile/eviction counters (copy of the reference's).
* :mod:`repro_torch.serve.engine` — :class:`InferenceServer`, the
  synchronous batch-at-a-time core on one device:
  ``submit(graphs, inputs) -> per-graph outputs``, with the autotuned
  route (``tune_cache``).
* :mod:`repro_torch.serve.server` — :class:`AsyncInferenceServer`, the
  async tier: per-request deadlines, continuous batching by size class,
  admission control with structured :class:`Overloaded` shedding,
  background warmup, multi-tenant cache budgets (copy of the reference's;
  ``device=`` reaches each engine through ``register_model``).
* :mod:`repro_torch.serve.metrics` — :class:`ServeMetrics`, p50/p99
  latency, queue depth, batch fill, shed counts (copy of the reference's).
"""
from .cache import CacheStats, ProgramCache  # noqa: F401
from .engine import InferenceServer  # noqa: F401
from .metrics import Histogram, ServeMetrics  # noqa: F401
from .server import (  # noqa: F401
    AsyncInferenceServer,
    Overloaded,
    Ticket,
)
from .signature import (  # noqa: F401
    ShapeRegistry,
    canonical_tiles,
    quantize,
    serving_grid,
    size_class,
    structure_signature,
)
