"""PyTorch/CUDA port of the ZIPPER reproduction (``repro``), for Hopper.

Module paths mirror ``repro``: ``repro/core/pipeline.py`` has its
counterpart at ``repro_torch/core/pipeline.py``.  The numpy front end
(graphs, tracer, compiler, schedule, tiling, serving signatures) is a copy
of the reference's, so both packages lower a model to the same
``ScheduledProgram``; the engines are PyTorch and the four tile kernels are
hand-written CUDA C++ for ``sm_90a`` (``kernels/tile_spmm/csrc``).

This package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
