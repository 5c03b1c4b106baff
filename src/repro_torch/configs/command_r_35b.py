"""Command-R 35B — GQA, no biases, parallel attention+FFN block.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000, head_dim=128,
    parallel_block=True, rope_theta=8e6, tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
))
