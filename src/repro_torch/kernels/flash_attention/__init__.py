"""Blocked (flash) attention: CUDA kernel (``csrc/``, ``kernel.py``), its
plain PyTorch version (``ref.py``) and the device dispatch (``ops.py``)."""
