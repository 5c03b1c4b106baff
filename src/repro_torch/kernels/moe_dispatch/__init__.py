"""Capacity-bucketed MoE: routing, dispatch and combine (``ops.py``), the
grouped-FFN CUDA kernel (``csrc/``, ``kernel.py``) and its plain PyTorch
version (``ref.py``)."""
