"""Serving launcher: batched prefill + greedy decode over a request queue.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --reduced \
      --requests 8 --max-new 16 [--device cpu]

The loop of ``repro.launch.serve``, for any of the six LM families:
requests with different prompt lengths are padded into a fixed decode
batch, prefilled by teacher-forcing the prompts through ``decode_step``
(filling the batch's cache from ``lm.cache_template``: KV caches, or the
ssm / hybrid recurrent states; audio's cross cache stays zeros, as in the
reference), then decoded greedily.  ``--reduced`` serves the smoke-scale
config in float32, as the reference's does; otherwise parameters and
caches take the templates' dtype (bfloat16).  Runs on ``cuda`` unless
``--device`` names another device.  ``--mesh DATA,MODEL`` (with
``--devices`` in one process, or under ``torchrun``; see
``launch/train.py``) serves any of the families laid out by their specs:
each batch split over data, each process decoding its data shards' rows,
the KV caches and recurrent states sharded as ``lm.cache_template`` says.
``--production-mesh`` serves on the 16 x 16 production mesh under
``torchrun`` (256 processes; ``launch/mesh.py``).
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, reduced
from ..configs.base import ArchConfig
from ..device import resolve
from ..models import lm
from ..models.common import materialize, shard_params
from .steps import make_decode_step
from .train import build_mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_requests(cfg: ArchConfig, params: Dict, prompts: Sequence[np.ndarray], *,
                   batch: int, max_prompt: int, max_new: int, device=None,
                   dtype: Optional[str] = None, mesh=None) -> Dict:
    """Serve ``prompts`` (int token arrays, each at most ``max_prompt``
    long) in batches of ``batch``: teacher-forced prefill through the decode
    step, then ``max_new`` greedy tokens.  Each batch's cache is made in
    ``dtype`` (a torch dtype name), or in the cache template's dtypes when
    it is None (then the ssm / hybrid recurrent states are carried in
    float32 from the first step, as the reference's are).

    With ``mesh`` the parameters are sharded once, each batch's rows split
    over data (every shard holds them all when they do not divide) and its
    cache a
    :class:`~repro_torch.models.common.ShardedTree`; every process passes
    the same prompts and gets its data shards' rows back.

    Returns ``tokens`` (one (B, max_new) int array per batch), ``step_s``
    (host seconds of every decode step, synchronised with the device),
    ``seconds`` and ``tokens_per_s`` (generated tokens over ``seconds``)."""
    dev = resolve(device) if mesh is None else mesh.rank_device(mesh.local_ranks[0])
    step = make_decode_step(cfg, mesh)
    if mesh is not None:
        params = shard_params(params, lm.model_template(cfg), mesh)
    max_len = max_prompt + max_new
    queue = list(prompts)
    outs: List[np.ndarray] = []
    step_s: List[float] = []
    done_tokens = 0

    def timed_step(cache, tok, pos):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok, pos)
        tok = torch.argmax(logits, -1, keepdim=True)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        return tok, cache

    _sync(dev)
    t_start = time.perf_counter()
    while queue:
        batch_reqs, queue = queue[:batch], queue[batch:]
        B = len(batch_reqs)
        lens = np.array([len(p) for p in batch_reqs])
        padded = np.zeros((B, max_prompt), np.int64)
        for i, p in enumerate(batch_reqs):
            padded[i, :len(p)] = p
        cache = lm.init_cache(cfg, B, max_len, dtype=dtype, device=dev, mesh=mesh)
        if mesh is not None and mesh.group is not None and B % mesh.n_shards == 0:
            per = B // mesh.n_shards     # this process's shard's rows
            padded = padded[mesh.local_shards[0] * per:][:per]
        prompt_t = torch.as_tensor(padded, device=dev)
        # prefill: teacher-force prompts through decode, filling the cache
        tok = None
        for pos in range(int(lens.max())):
            tok, cache = timed_step(cache, prompt_t[:, pos:pos + 1], pos)
        # greedy decode
        out = np.zeros((len(padded), max_new), np.int64)
        for i in range(max_new):
            out[:, i] = tok[:, 0].cpu().numpy()
            tok, cache = timed_step(cache, tok, int(lens.max()) + i)
        outs.append(out)
        done_tokens += len(padded) * max_new
    seconds = time.perf_counter() - t_start
    return dict(tokens=outs, step_s=step_s, seconds=seconds,
                tokens_per_s=done_tokens / seconds,
                step_p50_s=statistics.median(step_s))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="", help="DATA,MODEL: serve on a mesh")
    ap.add_argument("--devices", default="",
                    help="one process: the mesh's devices, comma-separated")
    ap.add_argument("--production-mesh", action="store_true",
                    help="serve on the 16 x 16 production mesh (torchrun, 256 ranks)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve(args.device)
    mesh = build_mesh(args.mesh, args.devices, dev, args.production_mesh)
    if mesh is not None:
        dev = mesh.rank_device(mesh.local_ranks[0])
    dtype = "float32" if args.reduced else None
    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg), dtype_override=dtype, device=dev)

    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, rng.integers(4, args.max_prompt + 1))
             for _ in range(args.requests)]
    res = serve_requests(cfg, params, queue, batch=args.batch,
                         max_prompt=args.max_prompt, max_new=args.max_new,
                         device=dev, dtype=dtype, mesh=mesh)
    for b, out in enumerate(res["tokens"]):
        lens = [len(p) for p in queue[b * args.batch:(b + 1) * args.batch]]
        print(f"served batch of {len(out)}: prompts {lens}, "
              f"first seq -> {out[0, :8].tolist()}...", flush=True)
    n_tok = sum(o.size for o in res["tokens"])
    print(f"served {args.requests} requests, {n_tok} tokens "
          f"in {res['seconds']:.1f}s ({res['tokens_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
