"""R-GCN's relation-grouped edge GEMM: the grouping plan, the dispatch and
the plain PyTorch version (``ops.py``), the CUDA kernel (``csrc/``,
``kernel.py``)."""
