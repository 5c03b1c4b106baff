"""Qwen2-VL-72B — VLM; transformer backbone only (patch-embed frontend is a
stub per spec: input_specs feeds precomputed patch/frame embeddings for the
vision pathway; the LM path tokenizes normally).  M-RoPE sections per the
tech report. [arXiv:2409.12191; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128,
    qkv_bias=True,                      # qwen2 family uses QKV bias
    mrope_sections=(16, 24, 24),        # M-RoPE (t, h, w) sections
    rope_theta=1e6, tie_embeddings=False,
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B-Instruct",
))
