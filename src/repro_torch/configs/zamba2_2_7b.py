"""Zamba2-2.7B — Mamba2 backbone + a shared attention+MLP block applied every
6 layers (weights shared across applications).  The shared attention uses a
sliding window at long context (deviation noted in DESIGN.md §5), making the
arch sub-quadratic and long_500k-eligible. [arXiv:2411.15242; hf]"""
from .base import ArchConfig, SSMCfg, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
    shared_attn_every=6, attn_window=4096,
    source="arXiv:2411.15242",
))
