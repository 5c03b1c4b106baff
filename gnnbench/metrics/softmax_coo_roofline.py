"""The COO online segment softmax (``softmax_plan_kernel<true, ...>`` +
``softmax_merge_kernel``): the served requests' aggregation bound over
their device time, percent (padded duplicates count nothing)."""
from gnnbench.roofline import kernel_roofline

KERNELS = ("softmax_plan_kernel<true,", "softmax_merge_kernel")


def read(reading):
    return kernel_roofline(reading, KERNELS, gat=True)
