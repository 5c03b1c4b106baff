"""Full-model assembly for the LM families the port serves.

Ports ``repro.models.lm`` for one device and two families:

  dense  — pre-norm GQA transformer (qk-norm / qkv-bias / parallel-block /
           tied-embedding options);
  moe    — DeepSeek: MLA attention + (first_dense dense layers, then routed
           MoE layers with shared experts).

Parameters are the reference's tree — nested dicts of tensors, each layer
stack with a leading layer axis — so weights carry across name for name
(:func:`repro_torch.convert.lm_params_from_reference`).  The reference's
``lax.scan`` over a stack is a Python loop over its layer axis here, and
``jax.checkpoint`` is dropped (inference only).  :class:`LM` is a thin
``nn.Module`` that registers the tensors and calls these functions.  The
vlm, audio, ssm and hybrid families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import attention as A
from . import moe as MOE
from .common import layer, leaf, rms_norm, stack_templates, tree_items

FAMILIES = ("dense", "moe")


def _require_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP A.9: vlm, audio, ssm and hybrid)")


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------

def _dense_block_template(cfg: ArchConfig) -> Dict:
    return {
        "ln1": leaf((cfg.d_model,), (None,), init="ones"),
        "attn": A.gqa_template(cfg),
        "ln2": leaf((cfg.d_model,), (None,), init="ones"),
        "ffn": MOE.dense_ffn_template(cfg),
    }


def _mla_block_template(cfg: ArchConfig, kind: str) -> Dict:
    t = {
        "ln1": leaf((cfg.d_model,), (None,), init="ones"),
        "attn": A.mla_template(cfg),
        "ln2": leaf((cfg.d_model,), (None,), init="ones"),
    }
    if kind == "moe":
        t["moe"] = MOE.moe_template(cfg)
    else:
        t["ffn"] = MOE.dense_ffn_template(cfg, cfg.moe.d_ff_dense)
    return t


def model_template(cfg: ArchConfig) -> Dict:
    _require_family(cfg)
    d, V = cfg.d_model, cfg.vocab
    t: Dict = {"embed": leaf((V, d), ("model", None), scale=0.02)}
    if not cfg.tie_embeddings:
        t["head"] = leaf((d, V), (None, "model"), scale=0.02)
    t["ln_f"] = leaf((d,), (None,), init="ones")
    if cfg.family == "dense":
        t["layers"] = stack_templates(_dense_block_template(cfg), cfg.n_layers)
    else:
        mo = cfg.moe
        if mo.first_dense:
            t["dense_layers"] = stack_templates(_mla_block_template(cfg, "dense"),
                                                mo.first_dense)
        t["layers"] = stack_templates(_mla_block_template(cfg, "moe"),
                                      cfg.n_layers - mo.first_dense)
    return t


def cache_template(cfg: ArchConfig, batch: int, max_len: int) -> Dict:
    _require_family(cfg)
    if cfg.family == "dense":
        return {"layers": stack_templates(A.gqa_cache_template(cfg, batch, max_len),
                                          cfg.n_layers)}
    t = {"layers": stack_templates(A.mla_cache_template(cfg, batch, max_len),
                                   cfg.n_layers - cfg.moe.first_dense)}
    if cfg.moe.first_dense:
        t["dense_layers"] = stack_templates(
            A.mla_cache_template(cfg, batch, max_len), cfg.moe.first_dense)
    return t


def _n_layers(stack: Dict) -> int:
    return next(t for _, t in tree_items(stack)).shape[0]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _logits(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


def _dense_block(cfg, p, h, positions, cache=None, pos=None):
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    ao, cache = A.gqa_attention(cfg, p["attn"], hn, positions,
                                cache=cache, cache_index=pos)
    if cfg.parallel_block:  # command-r: attn and FFN in parallel
        return h + ao + MOE.dense_ffn(p["ffn"], hn)
    h = h + ao
    return h + MOE.dense_ffn(p["ffn"], rms_norm(h, p["ln2"], cfg.norm_eps))


def _mla_block(cfg, kind, p, h, positions, cache=None, pos=None, token_chunks=4):
    ao, _ = A.mla_attention(cfg, p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                            positions, cache=cache, cache_index=pos)
    h = h + ao
    hn = rms_norm(h, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        y, aux = MOE.moe_layer(cfg, p["moe"], hn, token_chunks=token_chunks)
        return h + y, aux
    return h + MOE.dense_ffn(p["ffn"], hn), None


# ---------------------------------------------------------------------------
# forward (prefill) and decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(cfg: ArchConfig, params: Dict, batch: Dict
            ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Logits (B, S, vocab) for prefill; the moe family returns
    (logits, summed router aux loss) as the reference does."""
    _require_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)

    if cfg.family == "dense":
        for i in range(_n_layers(params["layers"])):
            x = _dense_block(cfg, layer(params["layers"], i), x, positions)
        return _logits(cfg, params, rms_norm(x, params["ln_f"], cfg.norm_eps))

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, kind in (("dense_layers", "dense"), ("layers", "moe")):
        if name not in params:
            continue
        for i in range(_n_layers(params[name])):
            x, aux = _mla_block(cfg, kind, layer(params[name], i), x, positions)
            if aux is not None:
                aux_total = aux_total + aux
    return _logits(cfg, params, rms_norm(x, params["ln_f"], cfg.norm_eps)), aux_total


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Dict, cache: Dict, tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1); pos: index into the cache.  The
    cache is updated in place and returned."""
    _require_family(cfg)
    pos = int(pos)
    x = params["embed"][tokens]
    positions = pos + torch.arange(tokens.shape[1], device=x.device)

    if cfg.family == "dense":
        for i in range(_n_layers(params["layers"])):
            x = _dense_block(cfg, layer(params["layers"], i), x, positions,
                             layer(cache["layers"], i), pos)
    else:
        for name, kind in (("dense_layers", "dense"), ("layers", "moe")):
            if name not in params:
                continue
            for i in range(_n_layers(params[name])):
                x, _ = _mla_block(cfg, kind, layer(params[name], i), x, positions,
                                  layer(cache[name], i), pos, token_chunks=1)
    return _logits(cfg, params, rms_norm(x, params["ln_f"], cfg.norm_eps)), cache


# ---------------------------------------------------------------------------
# module wrapper
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The parameter tree registered on a module (``state_dict`` keys are
    the tree's paths joined by ``.``); calls :func:`forward` and
    :func:`decode_step`."""

    def __init__(self, cfg: ArchConfig, params: Dict):
        super().__init__()
        _require_family(cfg)
        self.cfg = cfg
        self._paths = [path for path, _ in tree_items(params)]
        self.tree = nn.ModuleDict()
        for path, t in tree_items(params):
            mod = self.tree
            for k in path[:-1]:
                if k not in mod:
                    mod[k] = nn.ModuleDict()
                mod = mod[k]
            mod.register_parameter(path[-1], nn.Parameter(t, requires_grad=False))

    def params(self) -> Dict:
        """The parameter tree as nested dicts of tensors."""
        out: Dict = {}
        for path in self._paths:
            mod, node = self.tree, out
            for k in path[:-1]:
                mod, node = mod[k], node.setdefault(k, {})
            node[path[-1]] = getattr(mod, path[-1])
        return out

    def forward(self, tokens: torch.Tensor):
        return forward(self.cfg, self.params(), {"tokens": tokens})

    def decode_step(self, cache: Dict, tokens: torch.Tensor, pos: int):
        return decode_step(self.cfg, self.params(), cache, tokens, pos)
