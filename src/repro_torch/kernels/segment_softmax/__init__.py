"""Segment softmax over ZIPPER partition tiles (GAT edge softmax).

The kernel lives beside the tile-SpMM kernels (same tile layout, the same
edge plan as the CSR SpMM); this package re-exports it under the kernel
taxonomy's name.
"""
from ..tile_spmm.kernel import (segment_softmax_csr_cuda,  # noqa: F401
                                segment_softmax_cuda)      # noqa: F401
from ..tile_spmm.ref import (segment_softmax_coo_ref,      # noqa: F401
                             segment_softmax_csr_ref,      # noqa: F401
                             segment_softmax_plan_ref,     # noqa: F401
                             segment_softmax_ref)          # noqa: F401
from ..tile_spmm.ops import (densify_edge_scores,          # noqa: F401
                             gat_aggregate, gat_aggregate_csr)  # noqa: F401
