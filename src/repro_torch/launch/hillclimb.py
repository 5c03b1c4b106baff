"""Hill-climb driver of the dry run: the counterpart of
``repro.launch.hillclimb``.

Re-runs one (arch x shape) cell of the dry run (``launch/dryrun.py``: rank
0 of the 16 x 16 production mesh on the meta device) under optimization
variants, and records them beside the baselines.  A variant is tokens
joined by ``+``:

  <flag>    — a ``runtime_flags.OPT`` name, switched on (``attn_batch_shard``,
              ``moe_rs_combine``, ``moe_fp8_dispatch``, ``zero1_opt_state``,
              ``fsdp_params``, ``remat_save_dots``)
  mb<N>     — gradient accumulation over N microbatches (accumulated in
              bf16 for the moe family, fp32 otherwise)
  cap<F>    — MoE capacity factor override
  baseline  — nothing changed

Each variant writes ``reports/dryrun_torch/hillclimb/<arch>__<shape>__<variant>.json``
with the dry run's schema; ``runtime_flags.OPT`` is restored afterwards.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell deepseek-v2-236b/train_4k \
      --variant moe_rs_combine

The reference scales its probe totals by N for ``mb<N>``, because its
probe lowers the one-microbatch step; here the probe runs the microbatched
step itself, whose Python loop the counter sees whole, so nothing is scaled
(ROADMAP C.11).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Optional

import torch

from .. import runtime_flags
from ..configs.base import SHAPES, get_config
from .dryrun import REPORT_DIR, _probe_costs, run_step
from .mesh import make_production_mesh, mesh_device_count


def parse_variant(cfg, variant: str):
    """(cfg, microbatches, OPT flags) of a variant string; an unknown token
    raises ``ValueError``."""
    microbatches = 1
    flags = dict(runtime_flags.OPT)
    for part in variant.split("+"):
        if part.startswith("mb") and part[2:].isdigit():
            microbatches = int(part[2:])
        elif part.startswith("cap"):
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(part[3:])))
        elif part in runtime_flags.OPT:
            flags[part] = True
        elif part == "baseline":
            pass
        else:
            raise ValueError(f"unknown variant token {part}")
    return cfg, microbatches, flags


def run_variant(arch: str, shape: str, variant: str, *, force: bool = False, cfg=None,
                mesh=None, report_dir: Optional[pathlib.Path] = None) -> dict:
    """One variant of one cell (``cfg`` and ``mesh`` replace ``arch``'s
    config and the production mesh's rank 0, as in ``dryrun.run_cell``)."""
    outdir = (report_dir or REPORT_DIR) / "hillclimb"
    outdir.mkdir(parents=True, exist_ok=True)
    outfile = outdir / f"{arch}__{shape}__{variant}.json"
    if outfile.exists() and not force:
        return json.loads(outfile.read_text())

    cfg, microbatches, flags = parse_variant(cfg or get_config(arch), variant)
    mesh = mesh or make_production_mesh(abstract_rank=0)
    S, B, kind = SHAPES[shape]
    accum = torch.bfloat16 if cfg.moe else torch.float32
    rec = {"arch": arch, "shape": shape, "variant": variant, "kind": kind,
           "n_devices": mesh_device_count(mesh), "params": cfg.param_count(),
           "active_params": cfg.active_param_count(), "microbatches": microbatches}
    old = dict(runtime_flags.OPT)
    runtime_flags.OPT.update(flags)
    t0 = time.perf_counter()
    try:
        rec.update(run_step(cfg, mesh, shape, microbatches=microbatches, accum_dtype=accum))
        rec["status"] = "ok"
        rec["probe"] = _probe_costs(cfg, mesh, shape, microbatches=microbatches,
                                    accum_dtype=accum)
        rec["seconds"] = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    finally:
        runtime_flags.OPT.clear()
        runtime_flags.OPT.update(old)
    outfile.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch/shape")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split("/")
    rec = run_variant(arch, shape, args.variant, force=args.force)
    if rec["status"] == "ok":
        tot = rec["probe"]["totals"]
        coll = sum(v for k, v in tot.items() if k.startswith("coll_"))
        print(f"{arch}/{shape} [{args.variant}] ok "
              f"flops={tot['flops']:.3e} coll={coll / 1e9:.1f}GB/dev "
              f"temp={rec['memory']['temp_size_in_bytes'] / 2**30:.1f}GB "
              f"run={rec['seconds']:.0f}s")
    else:
        print(f"{arch}/{shape} [{args.variant}] ERROR: {rec['error'][:200]}")
    return rec


if __name__ == "__main__":
    main()
