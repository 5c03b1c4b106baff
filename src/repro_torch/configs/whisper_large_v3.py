"""Whisper-large-v3 — encoder-decoder; the conv/mel frontend is a STUB
(input_specs provides precomputed frame embeddings, enc_len=1500).
[arXiv:2212.04356; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    encdec=True, n_encoder_layers=32, enc_len=1500,
    rope_theta=1e4,  # unused: whisper uses sinusoidal absolute positions
    source="arXiv:2212.04356",
))
