"""Architecture configuration schema + registry.

One ``configs/<arch_id>.py`` per assigned architecture instantiates an
:class:`ArchConfig`.  ``reduced()`` derives the CPU smoke-test config of the
same family (small widths / few layers / few experts) — the full config is
exercised only through the dry-run (ShapeDtypeStructs, no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_routed: int
    n_shared: int
    top_k: int
    d_ff_expert: int
    d_ff_dense: int          # dense-FFN width for the first_dense leading layers
    first_dense: int = 0     # leading dense layers (DeepSeek)
    norm_topk: bool = True
    aux_free_bias: bool = False   # DeepSeek-V3 aux-loss-free balancing
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int
    kv_lora: int
    qk_nope: int
    qk_rope: int
    v_dim: int


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    proj_factor: float = 2.0
    conv_width: int = 4
    slstm_every: int = 8      # every k-th layer is an sLSTM block
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    parallel_block: bool = False     # command-r style parallel attn+FFN
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    # hybrid (zamba2): one shared attn+MLP block applied every k layers
    shared_attn_every: int = 0
    # enc-dec (whisper): encoder layer count; frontend is a stub that feeds
    # precomputed frame embeddings of length enc_len
    encdec: bool = False
    n_encoder_layers: int = 0
    enc_len: int = 1500
    # long-context decode: sliding window for attention blocks (hybrids);
    # None => full attention (arch is then skipped for long_500k)
    attn_window: Optional[int] = None
    dtype: str = "bfloat16"
    # citation / provenance tag
    source: str = ""

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-window)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm",):
            # xlstm: per-block ~ (proj in/out + qkv)   rough model
            pf = self.xlstm.proj_factor if self.xlstm else 2.0
            blk = int(d * d * pf * 2 + 3 * (d * pf) * (d * pf) / 4)
            return emb + L * blk
        if self.family == "hybrid" and self.ssm:
            di = self.ssm.expand * d
            blk = d * 2 * di + di * d + di * 16  # in/out proj + misc
            shared = 4 * d * d + 3 * d * self.d_ff
            return emb + L * blk + shared
        attn = 2 * d * (self.n_heads * self.hdim) + 2 * d * (self.n_kv_heads * self.hdim)
        if self.mla:
            m = self.mla
            attn = (d * m.q_lora + m.q_lora * self.n_heads * (m.qk_nope + m.qk_rope)
                    + d * (m.kv_lora + m.qk_rope)
                    + m.kv_lora * self.n_heads * (m.qk_nope + m.v_dim)
                    + self.n_heads * m.v_dim * d)
        if self.moe:
            mo = self.moe
            n_moe_layers = L - mo.first_dense
            ffn = 3 * d * mo.d_ff_expert * (mo.n_routed + mo.n_shared)
            dense_ffn = 3 * d * mo.d_ff_dense
            total = emb + L * attn + n_moe_layers * (ffn + d * mo.n_routed) \
                + mo.first_dense * dense_ffn
            return int(total)
        enc_mult = 2 if self.encdec else 1  # decoder adds cross-attn
        layers = L + self.n_encoder_layers
        return int(emb + layers * (attn * (1.5 if self.encdec else 1.0) + 3 * d * self.d_ff))

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only routed top-k)."""
        if not self.moe:
            return self.param_count()
        d, L, mo = self.d_model, self.n_layers, self.moe
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        m = self.mla
        attn = (d * m.q_lora + m.q_lora * self.n_heads * (m.qk_nope + m.qk_rope)
                + d * (m.kv_lora + m.qk_rope)
                + m.kv_lora * self.n_heads * (m.qk_nope + m.v_dim)
                + self.n_heads * m.v_dim * d) if m else \
            (2 * d * self.n_heads * self.hdim + 2 * d * self.n_kv_heads * self.hdim)
        ffn_act = 3 * d * mo.d_ff_expert * (mo.top_k + mo.n_shared)
        return int(emb + L * attn + (L - mo.first_dense) * (ffn_act + d * mo.n_routed)
                   + mo.first_dense * 3 * d * mo.d_ff_dense)


#: the four assigned input-shape cells (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        from . import ALL_ARCHS  # noqa: F401  (forces registration)
    return _REGISTRY[name]


def all_configs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        from . import ALL_ARCHS  # noqa: F401
    return dict(_REGISTRY)


def shape_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch × shape) cell."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention — long_500k requires sub-quadratic (DESIGN.md §5)"
    return True, ""


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke", family=cfg.family,
        n_layers=min(cfg.n_layers, 4) if cfg.shared_attn_every or (cfg.xlstm is not None) else 2,
        d_model=64,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0, vocab=256, head_dim=16,
        qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias, parallel_block=cfg.parallel_block,
        mrope_sections=(4, 6, 6) if cfg.mrope_sections else None,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
        tie_embeddings=cfg.tie_embeddings,
        encdec=cfg.encdec, n_encoder_layers=2 if cfg.encdec else 0,
        enc_len=16 if cfg.encdec else 1500,
        attn_window=min(cfg.attn_window, 32) if cfg.attn_window else None,
        dtype="float32", source=cfg.source,
    )
    if cfg.moe:
        kw["moe"] = MoECfg(n_routed=8, n_shared=cfg.moe.n_shared, top_k=2,
                           d_ff_expert=32, d_ff_dense=96,
                           first_dense=min(cfg.moe.first_dense, 1),
                           norm_topk=cfg.moe.norm_topk,
                           aux_free_bias=cfg.moe.aux_free_bias)
        kw["n_layers"] = 3 if cfg.moe.first_dense else 2
    if cfg.mla:
        kw["mla"] = MLACfg(q_lora=32, kv_lora=32, qk_nope=16, qk_rope=8, v_dim=16)
        kw["head_dim"] = None
    if cfg.ssm:
        kw["ssm"] = SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16,
                           n_groups=1, chunk=16)
    if cfg.xlstm:
        kw["xlstm"] = XLSTMCfg(proj_factor=2.0, conv_width=4, slstm_every=2, chunk=16)
        kw["n_layers"] = 4
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 2
        kw["n_layers"] = 4
    return ArchConfig(**kw)
