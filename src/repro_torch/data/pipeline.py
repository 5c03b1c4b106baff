"""Deterministic sharded token pipeline (numpy), as ``repro.data.pipeline``.

The pipeline synthesizes a reproducible token stream (a hash-mixed
counter, not a device generator, so batches are computable on any host):

* the global batch for step ``s`` is a pure function of ``(seed, s)`` — any
  host can regenerate any shard, which makes restart and re-assignment
  trivial;
* ``shard_for(step, host, n_hosts)`` returns the host's slice.

The arrays equal the reference's bit for bit.  :func:`make_batch_specs`
gives the abstract inputs of the dry run: one rank's blocks of a cell's
batch on the ``meta`` device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..configs.base import SHAPES, ArchConfig
from ..models.common import DP, ShardedTree, abstractify, leaf
from ..models.lm import VLM_PATCHES


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 — stateless hash of a counter array."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass
class TokenPipeline:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """``tokens`` (B, S) int32 (vlm: S - 256, after the patches), and
        ``patch_embeds`` (vlm) or ``frames`` (audio) float32."""
        B, S = self.global_batch, self.seq_len
        base = np.uint64(self.seed) * np.uint64(1 << 40) + np.uint64(step) * np.uint64(B * S)
        ctr = base + np.arange(B * S, dtype=np.uint64)
        toks = (_mix(ctr) % np.uint64(self.cfg.vocab)).astype(np.int32).reshape(B, S)
        out = {"tokens": toks}
        if self.cfg.family == "vlm":
            emb = (_mix(ctr[: B * VLM_PATCHES * 4]).astype(np.float32) / 2**64 - 0.5)
            out["tokens"] = toks[:, : S - VLM_PATCHES]
            out["patch_embeds"] = np.resize(
                emb, (B, VLM_PATCHES, self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "audio":
            fr = (_mix(ctr[: B * 16]).astype(np.float32) / 2**64 - 0.5)
            out["frames"] = np.resize(
                fr, (B, self.cfg.enc_len, self.cfg.d_model)).astype(np.float32)
        return out

    def shard_for(self, step: int, host: int, n_hosts: int) -> Dict[str, np.ndarray]:
        gb = self.global_batch_at(step)
        per = self.global_batch // n_hosts
        return {k: v[host * per:(host + 1) * per] for k, v in gb.items()}


def make_batch_specs(cfg: ArchConfig, shape_name: str, mesh,
                     dtype: torch.dtype = torch.bfloat16) -> ShardedTree:
    """The batch of one (arch x shape) cell laid out on ``mesh`` with nothing
    allocated (``models.common.abstractify``): ``tokens`` (B, S) int32 split
    over the batch axes ((B, 1) for decode; vlm S - 256, after the patches),
    ``patch_embeds`` (vlm) and ``frames`` (audio) in ``dtype``, the keys,
    shapes, dtypes and specs of ``repro.data.pipeline.make_batch_specs``."""
    S, B, kind = SHAPES[shape_name]
    dt = str(dtype).replace("torch.", "")
    if kind == "decode":
        return abstractify({"tokens": leaf((B, 1), (DP, None), dtype="int32")}, mesh)
    S_tok = S - VLM_PATCHES if cfg.family == "vlm" else S
    specs = {"tokens": leaf((B, S_tok), (DP, None), dtype="int32")}
    if cfg.family == "vlm":
        specs["patch_embeds"] = leaf((B, VLM_PATCHES, cfg.d_model), (DP, None, None), dtype=dt)
    if cfg.family == "audio":
        specs["frames"] = leaf((B, cfg.enc_len, cfg.d_model), (DP, None, None), dtype=dt)
    return abstractify(specs, mesh)
