"""SmolLM-135M — llama-architecture small dense LM. [hf:HuggingFaceTB/SmolLM-135M]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, head_dim=64,
    rope_theta=1e4, tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
))
