"""Fault tolerance (``fault.py``, a copy of the reference's) and gradient
compression (``compression.py``)."""
from .fault import FailureDetector, ElasticPlan, plan_remesh  # noqa: F401
from .compression import quantize_grads, dequantize_grads  # noqa: F401
