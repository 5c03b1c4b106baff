"""DeepSeek-V3 671B — MLA attention, 1 shared + 256 routed experts top-8,
aux-loss-free balancing bias, 3 leading dense layers.  (MTP head omitted —
noted in DESIGN.md.) [arXiv:2412.19437; hf]"""
from .base import ArchConfig, MLACfg, MoECfg, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280,
    mla=MLACfg(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoECfg(n_routed=256, n_shared=1, top_k=8, d_ff_expert=2048,
               d_ff_dense=18432, first_dense=3, norm_topk=True,
               aux_free_bias=True),
    rope_theta=1e4,
    source="arXiv:2412.19437",
))
