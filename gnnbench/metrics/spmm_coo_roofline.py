"""The COO tile SpMM (``coo_spmm_kernel``): the served requests'
aggregation bound over its device time, percent (padded duplicates do
work and count nothing)."""
from gnnbench.roofline import kernel_roofline

KERNELS = ("coo_spmm_kernel",)


def read(reading):
    return kernel_roofline(reading, KERNELS, gat=False)
