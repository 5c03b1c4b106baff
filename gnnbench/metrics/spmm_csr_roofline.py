"""The CSR tile SpMM (``csr_spmm_kernel`` + ``csr_merge_kernel``): both
layers' aggregation bound over their device time, percent."""
from gnnbench.roofline import kernel_roofline

KERNELS = ("csr_spmm_kernel", "csr_merge_kernel")


def read(reading):
    return kernel_roofline(reading, KERNELS, gat=False)
