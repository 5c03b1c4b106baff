"""Step factories: train_step / prefill_step / decode_step closures for one
(arch, mesh) pair, as ``repro.launch.steps`` builds them.  Shared by the
trainer (``train.py``), the serving loop (``serve.py``) and
``chip_smoke.py``.  ``mesh=None`` is one device; a
:class:`~repro_torch.core.exchange.ShardMesh` lays the model out by its
specs (``models/lm.py``), FSDP and ZeRO-1 under ``runtime_flags.OPT``.
:func:`abstract_state` gives one cell's inputs with nothing allocated, for
the dry run (``launch/dryrun.py``)."""
from __future__ import annotations

from typing import List

import torch

from .. import runtime_flags
from ..configs.base import ArchConfig
from ..models import lm
from ..models.common import (DP, ParamLeaf, ShardedTree, abstractify, shard_params,
                             spec_axes, tree_items, tree_map, tree_unflatten)
from ..optim.adamw import (AdamWState, adamw_state_template, adamw_update, shard_state,
                           zero1_dim)
from ..optim.schedule import wsd_schedule


def opt_state_bits(cfg: ArchConfig) -> int:
    """8-bit moments for the huge-expert models, as the reference picks."""
    return 8 if (cfg.moe and cfg.param_count() > 1e11) else 32


def maybe_fsdp(tmpl):
    """``OPT["fsdp_params"]``: also shard every parameter's largest
    unsharded dimension of at least 256 (layer-stack dimensions are
    smaller) over the data axes, as the reference's ``maybe_fsdp``.  Such a
    leaf is all-gathered over data where a layer uses it
    (``ShardedTree.gathered``) and its gradient comes back reduce-scattered
    (the all-gather's transpose): ZeRO-3."""
    if not runtime_flags.OPT["fsdp_params"]:
        return tmpl

    def f(l: ParamLeaf):
        if any(s == DP for s in l.spec):
            return l  # already data-sharded (expert-parallel weights)
        cand = [i for i, s in enumerate(l.spec) if s is None and l.shape[i] >= 256]
        if not cand:
            return l
        i = max(cand, key=lambda j: l.shape[j])
        return ParamLeaf(l.shape, l.spec[:i] + (DP,) + l.spec[i + 1:], l.init, l.scale,
                         l.dtype)

    return tree_map(f, tmpl)


def _reduce(mesh, gs: List[torch.Tensor], p_spec, m_spec) -> List[torch.Tensor]:
    """One leaf's gradients, one a local rank, each the partial derivative
    of what its process differentiates, completed over the axes the leaf
    is replicated on: a psum over model, then over data a psum or, where
    the moment splits the leaf over data (ZeRO-1), a psum-scatter into the
    moment's block."""
    held = {a for e in p_spec for a in spec_axes(e)}
    if "model" not in held:
        gs = mesh.psum(gs, "model")
    if "data" not in held:
        dim = zero1_dim(p_spec, m_spec)
        gs = (mesh.psum(gs, "data") if dim is None
              else mesh.psum_scatter(gs, "data", dim))
    return gs


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaf for every leaf, zeros for a leaf the loss does not
    read (command-r's ``ln2`` in its parallel block), as ``jax.grad``
    gives."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(gs, leaves)]


def make_train_step(cfg: ArchConfig, mesh=None, *, peak_lr: float = 3e-4,
                    total_steps: int = 10_000, microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    {"loss", "grad_norm", "lr"}): ``lm.loss_fn`` and its gradients by
    autograd (each block rematerialized), the WSD learning rate at the
    state's step, then :func:`repro_torch.optim.adamw.adamw_update`, which
    overwrites the parameters and moments in place (the returned trees are
    the caller's).  ``batch``: tensors on the parameters' device.

    ``microbatches > 1``: gradient accumulation over equal splits of the
    batch, summed in ``accum_dtype`` and divided by the count, the loss
    averaged, as the reference's ``lax.scan`` does.

    With ``mesh``: ``params`` and ``opt_state`` are sharded on entry (by
    :func:`maybe_fsdp` of the model template and
    :func:`~repro_torch.optim.adamw.adamw_state_template`, both read when
    the step is made) unless they already are, and the sharded ones are
    returned; ``batch`` holds the rows of the process's data shards.  Each
    process differentiates its share of the loss (``lm.loss_fn``); each
    leaf's gradient is completed over the axes it is replicated on
    (:func:`_reduce`: with the share's 1 / (n_data x n_model) that is the
    reference's pmean over data) into the moments' layout, where a
    microbatch's gradient accumulates, so under ZeRO-1 the accumulator is
    split over data as the moments are.  A data shard's microbatch ``i``
    is its rows ``i * B_loc / microbatches`` on; with equal blocks that is
    the reference's gradient up to summation order, except that the moe
    family routes each block's tokens together."""
    bits = opt_state_bits(cfg)
    if mesh is not None:
        return _mesh_train_step(cfg, mesh, peak_lr=peak_lr, total_steps=total_steps,
                                microbatches=microbatches, accum_dtype=accum_dtype)

    def train_step(params, opt_state: AdamWState, batch):
        leaves = [t for _, t in tree_items(params)]
        flags = [t.requires_grad for t in leaves]
        for t in leaves:
            t.requires_grad_(True)
        try:
            if microbatches == 1:
                lval = lm.loss_fn(cfg, params, batch)
                flat = _grads(lval, leaves)
                lval = lval.detach()
            else:
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                      for k, v in batch.items()}
                lval = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                flat = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                        for p in leaves]
                for i in range(microbatches):
                    l = lm.loss_fn(cfg, params, {k: v[i] for k, v in mb.items()})
                    for a, g in zip(flat, _grads(l, leaves)):
                        a.add_(g.to(accum_dtype))
                    lval = lval + l.detach()
                lval = lval / microbatches
                for a in flat:
                    a.div_(microbatches)
        finally:
            for t, f in zip(leaves, flags):
                t.requires_grad_(f)
        grads = tree_unflatten(params, flat)
        del flat
        lr = wsd_schedule(opt_state.step, peak_lr=peak_lr, total=total_steps)
        params, opt_state, gnorm = adamw_update(params, opt_state, grads, lr,
                                                state_bits=bits)
        return params, opt_state, {"loss": lval, "grad_norm": gnorm, "lr": lr}

    return train_step


def _mesh_train_step(cfg: ArchConfig, mesh, *, peak_lr, total_steps, microbatches,
                     accum_dtype):
    bits = opt_state_bits(cfg)
    tmpl = maybe_fsdp(lm.model_template(cfg))
    n_local = len(mesh.local_shards)

    def micro(batch, i):
        """Microbatch ``i`` of every local data shard, in shard order."""
        return {k: v.reshape(n_local, microbatches, -1, *v.shape[1:])[:, i]
                .reshape(-1, *v.shape[1:]) for k, v in batch.items()}

    def train_step(params, opt_state: AdamWState, batch):
        sp = shard_params(params, tmpl, mesh)
        opt_state = shard_state(opt_state, sp)
        p_specs = [s for _, s in tree_items(sp.specs)]
        m_specs = [s for _, s in tree_items(opt_state.m.specs)]
        leaves = [[t for _, t in tree_items(b)] for b in sp.blocks]
        flat = [t for ls in leaves for t in ls]
        flags = [t.requires_grad for t in flat]
        acc, lsum = None, None
        try:
            for t in flat:
                t.requires_grad_(True)
            for i in range(microbatches):
                b = batch if microbatches == 1 else micro(batch, i)
                losses = lm.shard_losses(cfg, sp, b, mesh)
                got = _grads(lm.mesh_objective(losses, mesh), flat)
                n = len(leaves[0])
                red = []
                for li in range(n):
                    # each leaf's raw gradients go as its reduced ones come
                    gs = [got[j * n + li] for j in range(len(leaves))]
                    for j in range(len(leaves)):
                        got[j * n + li] = None
                    red.append(_reduce(mesh, gs, p_specs[li], m_specs[li]))
                    del gs
                if acc is None:
                    # ranks of one process may share a reduced gradient:
                    # each accumulates into a copy of its own
                    acc = red if microbatches == 1 else \
                        [[g.to(accum_dtype, copy=True) for g in gs] for gs in red]
                else:
                    for aa, gs in zip(acc, red):
                        for a, g in zip(aa, gs):
                            a.add_(g)
                l = lm.mesh_loss(losses, mesh)
                lsum = l if lsum is None else lsum + l
                del losses, got, red
        finally:
            for t, f in zip(flat, flags):
                t.requires_grad_(f)
        if microbatches > 1:
            acc = [[a.div_(microbatches) for a in aa] for aa in acc]
        grads = ShardedTree(mesh, opt_state.m.template, opt_state.m.specs,
                            [tree_unflatten(sp.template, [aa[j] for aa in acc])
                             for j in range(len(leaves))])
        del acc
        lr = wsd_schedule(opt_state.step, peak_lr=peak_lr, total=total_steps)
        sp, opt_state, gnorm = adamw_update(sp, opt_state, grads, lr, state_bits=bits)
        return sp, opt_state, {"loss": lsum / microbatches, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """``prefill_step(params, batch)`` -> next-token logits (B, vocab).
    ``batch`` goes to ``lm.forward`` as it is: ``tokens``, and
    ``patch_embeds`` (vlm) or ``frames`` (audio) where the family takes
    them.  With ``mesh`` only the last position's logits are all-gathered
    over the vocabulary; ``params`` whole (sharded each call) or a
    :class:`~repro_torch.models.common.ShardedTree`."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if mesh is not None:
            sp = shard_params(params, lm.model_template(cfg), mesh)
            hs, _ = lm.hidden_mesh(cfg, sp, batch, mesh)
            last = lm.logits_mesh(cfg, sp, [h[:, -1:] for h in hs], mesh,
                                  {"tokens": batch["tokens"][:, -1:]})
            return lm.join_rows(last, mesh, batch["tokens"])[:, -1]
        out = lm.forward(cfg, params, batch)
        logits = out[0] if cfg.family == "moe" else out
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):
    """``decode_step(params, cache, tokens, pos)`` -> (logits (B, vocab),
    cache); the cache is updated in place (with ``mesh``, a
    :class:`~repro_torch.models.common.ShardedTree` from ``lm.init_cache``)."""
    def decode_step(params, cache, tokens, pos):
        logits, cache = lm.decode_step(cfg, params, cache, tokens, pos, mesh=mesh)
        return logits[:, -1], cache

    return decode_step


# ---------------------------------------------------------------------------
# abstract inputs (the dry-run contract)
# ---------------------------------------------------------------------------

def abstract_state(cfg: ArchConfig, mesh, shape_name: str, *, with_opt: bool):
    """(params, optimizer state or None, cache or None, batch) of one cell
    on ``mesh``, as ``repro.launch.steps.abstract_state``: every tree a
    :class:`~repro_torch.models.common.ShardedTree` of ``meta`` blocks
    (``abstractify``), nothing allocated.  Params by :func:`maybe_fsdp` of
    the model template; the moments by ``adamw_state_template`` at
    :func:`opt_state_bits` (8-bit for the huge MoEs; ZeRO-1 under its flag),
    in an ``AdamWState`` whose ``step`` is the local rank 0's meta scalar;
    the cache by ``lm.cache_template`` for a decode cell; the batch by
    ``data.pipeline.make_batch_specs``."""
    from ..configs.base import SHAPES
    from ..data.pipeline import make_batch_specs

    S, B, kind = SHAPES[shape_name]
    tmpl = maybe_fsdp(lm.model_template(cfg))
    params = abstractify(tmpl, mesh)
    opt = None
    if with_opt:
        ot = adamw_state_template(tmpl, state_bits=opt_state_bits(cfg))
        step = abstractify({"step": ot["step"]}, mesh).blocks[0]["step"]
        opt = AdamWState(step=step, m=abstractify(ot["m"], mesh), v=abstractify(ot["v"], mesh),
                         m_scale=None if ot["m_scale"] is None
                         else abstractify(ot["m_scale"], mesh),
                         v_scale=None)
    cache = abstractify(lm.cache_template(cfg, B, S), mesh) if kind == "decode" else None
    return params, opt, cache, make_batch_specs(cfg, shape_name, mesh)
