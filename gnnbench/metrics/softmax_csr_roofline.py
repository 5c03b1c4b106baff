"""The CSR online segment softmax (``softmax_plan_kernel<false, ...>`` +
``softmax_merge_kernel``): both layers' aggregation bound over their
device time, percent."""
from gnnbench.roofline import kernel_roofline

KERNELS = ("softmax_plan_kernel<false,", "softmax_merge_kernel")


def read(reading):
    return kernel_roofline(reading, KERNELS, gat=True)
