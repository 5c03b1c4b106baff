"""xLSTM-1.3B — sLSTM + mLSTM blocks (7:1 mix), no separate FFN (d_ff=0:
the blocks carry their own up/down projections). [arXiv:2405.04517; unverified]"""
from .base import ArchConfig, XLSTMCfg, register

CONFIG = register(ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    xlstm=XLSTMCfg(proj_factor=2.0, conv_width=4, slstm_every=8, chunk=128),
    source="arXiv:2405.04517",
))
