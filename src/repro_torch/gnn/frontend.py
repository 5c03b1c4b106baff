"""The *classic GNN programming model* frontend (paper Figure 5).

Thin re-export of the whole-graph tracer — model authors write against
``TT`` tensors and ``GraphRef`` GOPs exactly as they would against DGL/PyG
whole-graph tensors; the ZIPPER compiler recovers graph semantics from the
recorded trace.
"""
from ..core.trace import GnnTrace, GraphRef, TT, trace_model  # noqa: F401
