"""Training launcher: the end-to-end training loop with checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --reduced --batch 8 --seq 128 --ckpt-dir CKPT [--device cpu]

The loop of ``repro.launch.train`` on one device: the token pipeline's
batch for each step, ``make_train_step`` (loss, gradients, AdamW in place),
a checkpoint every ``--ckpt-every`` steps and at the end, and a restart
from the latest committed step when ``--ckpt-dir`` holds one.
``--reduced`` runs the smoke-scale config in float32, as the reference's
does; otherwise parameters take the templates' dtype (bfloat16).  Runs on
``cuda`` unless ``--device`` names another device.

``--mesh DATA,MODEL`` trains on a (data, model)
:class:`~repro_torch.core.exchange.ShardMesh`, laid out by the templates'
specs (FSDP and ZeRO-1 under ``runtime_flags.OPT``).  Under ``torchrun``
each process is one rank of the group's mesh
(``ShardMesh.from_process_group``; NCCL on ``cuda:$LOCAL_RANK``, gloo with
``--device cpu``), reads its data shard's rows
(``TokenPipeline.shard_for``) and writes its own checkpoint shard; in one
process ``--devices`` lists the mesh's devices (a card named more than
once holds logical ranks; a list is never repeated silently):

  python -m repro_torch.launch.train --arch qwen2-1.5b --mesh 2,2 \
      --devices cuda:0,cuda:0,cuda:0,cuda:0
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2-1.5b --mesh 2,2

``--production-mesh`` trains on the reference's 16 x 16 production mesh:
under ``torchrun`` with 256 processes (``launch/mesh.py``; it raises on
any other world).  What one rank of it holds and does is what the dry run
reports without a card (``launch/dryrun.py``).
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..checkpointing import CheckpointManager
from ..configs import get_config, reduced
from ..core.exchange import ShardMesh
from ..data.pipeline import TokenPipeline
from ..device import resolve
from ..models import lm
from ..models.common import materialize, shard_params
from ..optim.adamw import adamw_init
from .mesh import make_production_mesh
from .steps import make_train_step, maybe_fsdp, opt_state_bits


def batch_tensors(batch, dev: torch.device):
    """The pipeline's numpy batch as tensors on ``dev`` (tokens as int64)."""
    return {k: torch.as_tensor(v, device=dev).long() if v.dtype.kind == "i"
            else torch.as_tensor(v, device=dev) for k, v in batch.items()}


def build_mesh(shape: str, devices: str, dev: torch.device, production: bool = False):
    """The ``--mesh DATA,MODEL`` mesh: over the ``torchrun`` group when one
    launched this process (initialized here from its environment), else
    over ``--devices``; None without ``--mesh``.  ``production``
    (``--production-mesh``): the 16 x 16 production mesh over the
    ``torchrun`` group (``launch.mesh.make_production_mesh``), which needs
    256 processes."""
    if production:
        if shape:
            raise ValueError("--production-mesh and --mesh exclude each other")
        if "WORLD_SIZE" not in os.environ:
            raise ValueError("--production-mesh runs under torchrun, one process a rank "
                             "of the 16 x 16 mesh")
        if not dist.is_initialized():
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        return make_production_mesh()
    if not shape:
        return None
    n_data, n_model = (int(v) for v in shape.split(","))
    if "WORLD_SIZE" in os.environ:
        if not dist.is_initialized():
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        if dist.get_world_size() != n_data * n_model:
            raise ValueError(f"--mesh {shape} needs {n_data * n_model} processes, "
                             f"torchrun started {dist.get_world_size()}")
        return ShardMesh.from_process_group(n_model, device=None if dev.type == "cuda" else dev)
    if not devices:
        raise ValueError("--mesh in one process needs --devices, one per rank "
                         "(name a card more than once for logical ranks)")
    return ShardMesh(devices.split(","), n_data, n_model)


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
    ap.add_argument("--mesh", default="", help="DATA,MODEL: train on a mesh")
    ap.add_argument("--devices", default="",
                    help="one process: the mesh's devices, comma-separated")
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the 16 x 16 production mesh (torchrun, 256 ranks)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve(args.device)
    mesh = build_mesh(args.mesh, args.devices, dev, args.production_mesh)
    if mesh is not None:
        dev = mesh.rank_device(mesh.local_ranks[0])
    host, n_hosts = (0, 1) if mesh is None or mesh.group is None else \
        (mesh.rank, len(mesh.devices))
    say = print if host == 0 else (lambda *a, **k: None)

    pipe = TokenPipeline(cfg, seq_len=args.seq, global_batch=args.batch)
    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg),
                         dtype_override="float32" if args.reduced else None, device=dev)
    if mesh is not None:
        params = shard_params(params, maybe_fsdp(lm.model_template(cfg)), mesh)
    opt_state = adamw_init(params, state_bits=opt_state_bits(cfg))
    start = 0

    ckpt = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every, host_id=host,
                              n_hosts=n_hosts) if args.ckpt_dir else None)
    if ckpt is not None:
        restored = ckpt.restore_latest({"params": params, "opt": opt_state})
        if restored[0] is not None:
            start = restored[0] + 1
            params, opt_state = restored[1]["params"], restored[1]["opt"]
            say(f"resumed from step {restored[0]}")

    step_fn = make_train_step(cfg, mesh, peak_lr=args.lr, total_steps=args.steps)
    for step in range(start, args.steps):
        if mesh is None or mesh.group is None:
            batch = batch_tensors(pipe.global_batch_at(step), dev)
        else:
            batch = batch_tensors(pipe.shard_for(step, mesh.local_shards[0], mesh.n_shards),
                                  dev)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        if ckpt is not None:
            ckpt.maybe_save(step, {"params": params, "opt": opt_state})
        say(f"step {step:5d} loss {loss:8.4f} gnorm {float(metrics['grad_norm']):8.3f} "
            f"lr {float(metrics['lr']):.2e} {time.time()-t0:6.2f}s", flush=True)
    if ckpt is not None:
        ckpt.maybe_save(args.steps - 1, {"params": params, "opt": opt_state}, force=True)
        ckpt.wait()
    return params


if __name__ == "__main__":
    main()
