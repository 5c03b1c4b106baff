"""Multi-pod dry run on the meta device: the counterpart of
``repro.launch.dryrun``.

For every (architecture x input shape x mesh) cell, one rank (rank 0) of
the 16 x 16 or 2 x 16 x 16 production mesh runs the real eager step on the
``meta`` device, where nothing is allocated:

* its inputs are rank 0's blocks of the params, optimizer state, cache and
  batch (``launch.steps.abstract_state``: meta tensors, each leaf's global
  shape and spec beside it);
* the mesh is an abstract rank (``ShardMesh.abstract``): every collective
  returns a meta tensor of its result's shape and adds to the census;
* the two LM kernels take their meta branch (the output the CUDA wrapper
  allocates, nothing run), and the step's counter credits their own work.

``train`` runs ``make_train_step`` (forward, backward through the
rematerialized blocks, the AdamW update in place), ``prefill``
``make_prefill_step``, ``decode`` ``make_decode_step`` at the cache's last
position.  Each cell records the reference's schema where the quantity is
the same:

* ``flops``: ``torch.utils.flop_counter``'s formulas (FlopCounterMode's
  ``flop_registry``) over every dispatched op, plus the kernels' credited
  FLOPs (``kernels/cost.py``);
* ``bytes_accessed``: each dispatched op's tensor inputs and outputs, view
  ops left out, plus the kernels' credited bytes: eager PyTorch's traffic
  with no fusion (not XLA's ``bytes accessed``);
* ``memory``: ``argument_size_in_bytes`` (the rank's params, optimizer
  state, cache and batch blocks, exactly), ``temp_size_in_bytes`` (the peak
  of the live bytes, each storage counted once while it is alive, minus the
  arguments), ``output_size_in_bytes`` and ``alias_size_in_bytes`` (what
  the step returns, and the part of it that is an argument updated in
  place);
* ``collective_bytes`` / ``collective_counts``: the census (result bytes
  per device by kind, a backward's transposes included);
* ``fits``: arguments + temp within the card's memory (the visible card's
  ``total_memory``; without one, an H100's nominal 80 GB).

Single-mesh cells also carry ``probe``: the reference's 1- and 2-layer
probes (``runtime_flags.PROBE["stack_counts"]``) extrapolated by
``layer_stack_sizes``, ssm / hybrid train and prefill past 8,192 tokens
probed at 4,096 and scaled by ``seq_scale``.  Here nothing is hidden in a
loop, so the probe is a cheaper estimate, held against the full count.

Results land in ``reports/dryrun_torch/<mesh>/<arch>__<shape>.json``
(existing cells are kept unless ``--force``):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch qwen3-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both            # full sweep

No card is needed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import runtime_flags
from ..configs.base import SHAPES, all_configs, get_config, shape_applicable
from ..models.common import ShardedTree
from ..models.lm import layer_stack_sizes
from .mesh import make_production_mesh, mesh_device_count
from .steps import abstract_state, make_decode_step, make_prefill_step, make_train_step

REPORT_DIR = pathlib.Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"
#: an H100's memory when no card is visible (nominal, decimal)
H100_BYTES = 80 * 10**9
FLOPS_DEFINITION = ("torch.utils.flop_counter.flop_registry over the dispatched ops, "
                    "plus the LM kernels' credited FLOPs (kernels/cost.py)")
BYTES_DEFINITION = ("eager PyTorch traffic, no fusion: each dispatched non-view op's "
                    "tensor inputs and outputs, plus the LM kernels' credited bytes")


class StepCounter(TorchDispatchMode):
    """FLOPs, bytes and (``track_memory``) live bytes of the ops run under
    it, on any device.  The LM kernels' dispatchers credit their own work
    (``kernels/cost.py``), and nothing they run inside is counted.

    The live bytes count each storage once while it is alive, keyed by the
    storage (views share one; meta storages have no address), freed when
    its last view dies, autograd's saved tensors included; :meth:`hold`
    counts the arguments, which exist before the step.

    On the meta device an op's result depends only on its inputs'
    metadata, and many of torch's meta functions are Python, 100-300 us a
    call.  So a functional op (no view, nothing mutated, fresh outputs) is
    run once per signature (op, the tensors' shapes, strides and dtypes,
    the other arguments) and replayed from then on as ``empty_strided``
    outputs of the recorded layout, with its recorded FLOPs and bytes: the
    sLSTM's per-token loop repeats a few signatures 32,768 times."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self._replay: Dict = {}
        self.track_memory = track_memory
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.suspended = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def credit(self, name: str, flops: int, nbytes: int) -> None:
        if self.suspended:
            return
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)

    def hold(self, *trees) -> int:
        """Count the tensors of ``trees`` as live; returns their bytes."""
        before = self.live
        for t in _tensors(trees):
            self._track(t)
        self.peak = max(self.peak, self.live)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _signature(func, args, kwargs)
        hit = self._replay.get(key) if key is not None else None
        if hit is not None:
            (kind, layouts), flops, nbytes = hit
            out = [torch.empty_strided(shape, stride, dtype=dt, device="meta")
                   for shape, stride, dt in layouts]
            out = out[0] if kind is None else kind(out)
        else:
            out = func(*args, **kwargs)
            flops = nbytes = 0
            if func._overloadpacket in flop_registry:
                flops = int(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
            if not func.is_view:
                nbytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            if key is not None:
                layouts = _fresh_layouts(out, args)
                if layouts is not None:
                    self._replay[key] = (layouts, flops, nbytes)
        if self.track_memory:
            for t in _tensors(out):
                self._track(t)
            self.peak = max(self.peak, self.live)
        if not self.suspended:
            self.ops += 1
            self.flops += flops
            self.bytes += nbytes
        return out


def _signature(func, args, kwargs):
    """The replay key of a functional op on meta tensors, or None."""
    if func.is_view or func._schema.is_mutable:
        return None
    key = [func]
    meta = False
    for a in _flat((args, kwargs)):
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                return None
            meta = True
            key.append((tuple(a.shape), a.stride(), a.dtype))
        elif a is None or isinstance(a, (bool, int, float, str, torch.dtype, torch.device,
                                         torch.layout, torch.memory_format)):
            key.append(a)
        else:
            return None
    key.append(tuple(sorted(kwargs)))
    return tuple(key) if meta else None


def _fresh_layouts(out, args):
    """(container, (shape, stride, dtype) of each output) when every output
    is a fresh tensor (its own storage, offset 0, exactly its size), else
    None; the container is None for a single tensor."""
    outs = [out] if isinstance(out, torch.Tensor) else out
    if not isinstance(outs, (tuple, list)) or not all(
            isinstance(t, torch.Tensor) for t in outs):
        return None
    seen = {id(t.untyped_storage()) for t in _tensors(args)}
    layouts = []
    for t in outs:
        st = t.untyped_storage()
        need = (sum((n - 1) * s for n, s in zip(t.shape, t.stride())) + 1
                if t.numel() else 0) * t.element_size()
        if id(st) in seen or t.storage_offset() or st.nbytes() != need:
            return None
        seen.add(id(st))
        layouts.append((tuple(t.shape), t.stride(), t.dtype))
    return (None if isinstance(out, torch.Tensor) else type(out)), layouts


def _flat(obj):
    """The leaves of nested tuples, lists and dicts (and of ShardedTrees'
    blocks)."""
    if isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _flat(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _flat(x)
    elif isinstance(obj, ShardedTree):
        yield from _flat(obj.blocks)
    else:
        yield obj


def _tensors(obj):
    return [x for x in _flat(obj) if isinstance(x, torch.Tensor)]


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _storages(obj) -> Dict[int, int]:
    return {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in _tensors(obj)}


def device_budget():
    """(bytes, label) of the card a cell must fit: the visible card's
    memory, else an H100's nominal 80 GB."""
    if torch.cuda.is_available():
        p = torch.cuda.get_device_properties(0)
        return int(p.total_memory), p.name
    return H100_BYTES, "NVIDIA H100 80GB (nominal, no card visible)"


def run_step(cfg, mesh, shape: str, *, track_memory: bool = True, microbatches: int = 1,
             accum_dtype: Optional[torch.dtype] = None) -> dict:
    """Rank ``mesh.local_ranks[0]``'s step of one cell on ``mesh`` (an
    abstract rank), counted: FLOPs, bytes, memory, the census."""
    S, B, kind = SHAPES[shape]
    params, opt, cache, batch = abstract_state(cfg, mesh, shape, with_opt=kind == "train")
    rows = batch.blocks[0]
    counter = StepCounter(track_memory=track_memory)
    args = counter.hold(params, opt, cache, batch)
    mesh.reset_census()
    n0 = mesh.collectives
    t0 = time.perf_counter()
    with counter:
        if kind == "train":
            step = make_train_step(cfg, mesh, microbatches=microbatches,
                                   accum_dtype=accum_dtype or torch.float32)
            out = step(params, opt, rows)
        elif kind == "prefill":
            out = make_prefill_step(cfg, mesh)(params, rows)
        else:
            out = make_decode_step(cfg, mesh)(params, cache, rows["tokens"], S - 1)
    seconds = time.perf_counter() - t0
    coll_bytes, coll_counts = mesh.census()
    held = _storages((params, opt, cache, batch))
    outs = _storages(out)
    rec = dict(run_s=seconds, flops=counter.flops, flops_definition=FLOPS_DEFINITION,
               bytes_accessed=counter.bytes, bytes_definition=BYTES_DEFINITION,
               kernels=counter.kernels, dispatched_ops=counter.ops,
               collective_bytes=coll_bytes, collective_counts=coll_counts,
               collectives=mesh.collectives - n0)
    if track_memory:
        budget, label = device_budget()
        temp = counter.peak - args
        rec["memory"] = dict(
            argument_size_in_bytes=args, temp_size_in_bytes=temp,
            output_size_in_bytes=sum(outs.values()),
            alias_size_in_bytes=sum(n for k, n in outs.items() if k in held),
            peak_bytes=counter.peak)
        rec.update(fits=args + temp <= budget, fits_budget_bytes=budget,
                   fits_budget_of=label)
    return rec


def _probe_costs(cfg, mesh, shape: str, *, microbatches: int = 1,
                 accum_dtype: Optional[torch.dtype] = None) -> dict:
    """1- and 2-layer probes extrapolated to per-step totals, as the
    reference's: total = f(base) + sum_s (L_s - 1) (f(stack s at 2) -
    f(base)); ssm / hybrid train and prefill past 8,192 tokens probe at
    4,096 and scale by S / 4,096 (``seq_scale``)."""
    sizes = layer_stack_sizes(cfg)
    S, B, kind = SHAPES[shape]
    seq_scale = 1.0
    probe_shape = shape
    if cfg.family in ("ssm", "hybrid") and kind in ("train", "prefill") and S > 8192:
        SHAPES["__probe__"] = (4096, B, kind)
        probe_shape = "__probe__"
        seq_scale = S / 4096.0

    def measure(stack_counts):
        runtime_flags.PROBE["stack_counts"] = stack_counts
        try:
            r = run_step(cfg, mesh, probe_shape, track_memory=False,
                         microbatches=microbatches, accum_dtype=accum_dtype)
        finally:
            runtime_flags.PROBE["stack_counts"] = None
        return {"flops": float(r["flops"]), "bytes": float(r["bytes_accessed"]),
                **{f"coll_{k}": float(v) for k, v in r["collective_bytes"].items()}}

    try:
        base_counts = {s: 1 for s in sizes}
        base = measure(base_counts)
        total = dict(base)
        per_stack = {}
        for s, L in sizes.items():
            if L <= 1:
                continue
            two = measure({**base_counts, s: 2})
            delta = {k: two[k] - base[k] for k in base}
            per_stack[s] = delta
            for k in total:
                total[k] += (L - 1) * delta[k]
        if seq_scale != 1.0:
            total = {k: v * seq_scale for k, v in total.items()}
        return {"totals": total, "base": base, "per_stack_delta": per_stack,
                "stack_sizes": sizes, "seq_scale": seq_scale}
    finally:
        SHAPES.pop("__probe__", None)


def run_cell(arch: str, shape: str, mesh_kind: str, *, force: bool = False,
             probe: bool = True, cfg=None, mesh=None,
             report_dir: Optional[pathlib.Path] = None) -> dict:
    """One cell, recorded under ``report_dir`` (default ``REPORT_DIR``)
    ``/<mesh_kind>/<arch>__<shape>.json``.  ``cfg`` and ``mesh`` replace
    ``arch``'s config and the production mesh's rank 0 (tests run reduced
    configs on small abstract meshes).  A failing cell is recorded as
    ``"status": "error"`` with its traceback."""
    cfg = cfg or get_config(arch)
    outdir = (report_dir or REPORT_DIR) / mesh_kind
    outdir.mkdir(parents=True, exist_ok=True)
    outfile = outdir / f"{arch}__{shape}.json"
    if outfile.exists() and not force:
        return json.loads(outfile.read_text())

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "status": "skipped", "reason": reason}
        outfile.write_text(json.dumps(rec, indent=1))
        return rec

    mesh = mesh or make_production_mesh(mesh_kind == "multipod", abstract_rank=0)
    S, B, kind = SHAPES[shape]
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "kind": kind,
           "seq_len": S, "global_batch": B,
           "params": cfg.param_count(), "active_params": cfg.active_param_count(),
           "n_devices": mesh_device_count(mesh), "pods": mesh.pods,
           "rank": mesh.local_ranks[0], "device": "meta", "torch": torch.__version__}
    try:
        rec.update(run_step(cfg, mesh, shape))
        rec["status"] = "ok"
        if probe and mesh_kind == "single":
            rec["probe"] = _probe_costs(cfg, mesh, shape)
    except Exception as e:  # noqa: BLE001 — a failing cell is a fault to record
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    outfile.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=("single", "multipod", "both"), default="both")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = sorted(all_configs()) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, force=args.force)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_err += st == "error"
                msg = f"[{mesh_kind:8s}] {arch:20s} {shape:12s} {st:8s}"
                if st == "ok":
                    mem = rec["memory"]
                    msg += (f" flops={rec['flops']:.3e} "
                            f"rank={(mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']) / 1e9:.2f}GB "
                            f"fits={rec['fits']} "
                            f"coll={sum(rec['collective_bytes'].values()) / 1e9:.2f}GB "
                            f"run={rec['run_s']:.0f}s")
                elif st == "error":
                    msg += " " + rec["error"][:120]
                print(msg, flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} error={n_err}", flush=True)


if __name__ == "__main__":
    main()
