"""The relation-grouped edge GEMM (``relation_gemm_kernel``): every traced
layer's edge-transform bound (``work_rel``) over the kernel's device time,
percent.  Nothing where the kernel did not run."""
from gnnbench import work_rel

KERNEL = "relation_gemm_kernel"


def read(reading):
    prof = reading.get("profile")
    t = prof.kernel_seconds((KERNEL,)) if prof is not None else None
    if not t or "relations" not in reading:
        return None
    F, R = reading["F"], reading["relations"]
    bound = sum(k * reading["layers"] * work_rel.relgemm_bound_s(E, F, F, R)
                for _, E, k in reading["graphs"])
    return 100.0 * bound / t
