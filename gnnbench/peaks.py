"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, 700 W).

A share of a roofline or of a peak is stated against these, with the
card's power limit printed beside it.
"""
FP32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12       # 80 GB HBM3
