"""What the plain references share: the transform's matmul in a stated
precision.

``precision="fp32"`` is float32 with TF32 off, as the configurations
state.  ``"tf32"`` is the control, the nearest precision below: on a card
cuBLAS runs the product in TF32; elsewhere the operands are rounded to
TF32's 10-bit mantissa (round to nearest even) and multiplied in float32,
which is what TF32's tensor cores compute.
"""
from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32")


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    on_card = a.device.type == "cuda"
    if precision == "tf32" and not on_card:
        a, b = round_to_tf32(a), round_to_tf32(b)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32" and on_card
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
