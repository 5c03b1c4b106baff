"""Training launcher: the end-to-end training loop with checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --reduced --batch 8 --seq 128 --ckpt-dir CKPT [--device cpu]

The loop of ``repro.launch.train`` on one device: the token pipeline's
batch for each step, ``make_train_step`` (loss, gradients, AdamW in place),
a checkpoint every ``--ckpt-every`` steps and at the end, and a restart
from the latest committed step when ``--ckpt-dir`` holds one.
``--reduced`` runs the smoke-scale config in float32, as the reference's
does; otherwise parameters take the templates' dtype (bfloat16).  Runs on
``cuda`` unless ``--device`` names another device.  The reference's
``--production-mesh`` (a TPU pod mesh) has no counterpart here.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpointing import CheckpointManager
from ..configs import get_config, reduced
from ..data.pipeline import TokenPipeline
from ..device import resolve
from ..models import lm
from ..models.common import materialize
from ..optim.adamw import adamw_init
from .steps import make_train_step, opt_state_bits


def batch_tensors(batch, dev: torch.device):
    """The pipeline's numpy batch as tensors on ``dev`` (tokens as int64)."""
    return {k: torch.as_tensor(v, device=dev).long() if v.dtype.kind == "i"
            else torch.as_tensor(v, device=dev) for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (float32)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve(args.device)

    pipe = TokenPipeline(cfg, seq_len=args.seq, global_batch=args.batch)
    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg),
                         dtype_override="float32" if args.reduced else None, device=dev)
    opt_state = adamw_init(params, state_bits=opt_state_bits(cfg))
    start = 0

    ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every) if args.ckpt_dir else None
    if ckpt is not None:
        restored = ckpt.restore_latest({"params": params, "opt": opt_state})
        if restored[0] is not None:
            start = restored[0] + 1
            params, opt_state = restored[1]["params"], restored[1]["opt"]
            print(f"resumed from step {restored[0]}")

    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps)
    for step in range(start, args.steps):
        batch = batch_tensors(pipe.global_batch_at(step), dev)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        if ckpt is not None:
            ckpt.maybe_save(step, {"params": params, "opt": opt_state})
        print(f"step {step:5d} loss {loss:8.4f} gnorm {float(metrics['grad_norm']):8.3f} "
              f"lr {float(metrics['lr']):.2e} {time.time()-t0:6.2f}s", flush=True)
    if ckpt is not None:
        ckpt.maybe_save(args.steps - 1, {"params": params, "opt": opt_state}, force=True)
        ckpt.wait()
    return params


if __name__ == "__main__":
    main()
