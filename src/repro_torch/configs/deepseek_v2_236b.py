"""DeepSeek-V2 236B — MLA (kv_lora=512), 2 shared + 160 routed top-6,
1 leading dense layer. [arXiv:2405.04434; hf]"""
from .base import ArchConfig, MLACfg, MoECfg, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    mla=MLACfg(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoECfg(n_routed=160, n_shared=2, top_k=6, d_ff_expert=1536,
               d_ff_dense=12288, first_dense=1, norm_topk=False),
    rope_theta=1e4,
    source="arXiv:2405.04434",
))
