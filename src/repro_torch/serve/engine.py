"""`InferenceServer` — the batched multi-graph serving front door (port of
``repro.serve.engine``).

``submit(graphs, inputs)`` serves a whole request batch through ONE
ScheduledProgram execution per size class:

1. group incoming graphs by :func:`~repro_torch.serve.signature.size_class`;
2. per group, :func:`~repro_torch.gnn.graphs.batch_graphs` merges the
   members into a block-diagonal super-graph, padded (vertices, edge-input
   rows, tile batch) onto the class's registered canonical shapes
   (:class:`~repro_torch.serve.signature.ShapeRegistry`);
3. the structural signature keys the
   :class:`~repro_torch.serve.cache.ProgramCache` — a hit reuses a built
   :class:`~repro_torch.core.pipeline.PipelinedRunner` (or, for large
   classes under ``shard_devices``, a
   :class:`~repro_torch.core.pipeline.ShardedRunner`) via ``run_with``
   (rebind tile operands, no rebuild);
4. merged outputs are sliced back into per-graph tensors on the device.

While the recorder (:mod:`repro_torch.spans`) is on, a group records
``engine.merge``, ``engine.tile`` (child ``engine.tile_wait``, the wait
for the shape registry's lock), ``engine.inputs`` (with the counters
``engine.h2d_bytes`` / ``engine.h2d_tensors``) and ``engine.cache``; the
runner records its own.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import spans
from ..convert import params_from_reference, to_device
from ..core import compiler as C
from ..core import schedule as S
from ..core.exchange import ShardMesh, default_devices
from ..core.pipeline import (PipelinedRunner, ShardedRunner,
                             shard_layout_signature)
from ..device import resolve
from ..gnn import models as M
from ..gnn.graphs import Graph, batch_graphs
from .cache import ProgramCache
from .signature import (ShapeRegistry, quantize, size_class,
                        structure_signature)


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.shape[0] == rows:
        return arr
    out = np.zeros((rows,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


class InferenceServer:
    """Serve streams of small graphs through cached PyTorch runners.

    ``model`` may be a registered model name
    (``repro_torch.gnn.models.MODELS``) or a pre-compiled
    :class:`~repro_torch.core.compiler.CompiledGNN`; ``params`` set here
    (numpy or tensors) are the default weights for every request.  Requests
    run on ``device`` (``cuda`` unless named).

    ``tune_cache`` (a :class:`~repro_torch.launch.autotune.TuneCache`)
    routes size classes with a tuned entry onto the tuned tile config: the
    tuned grid, vertex reorder and edge layout replace the
    :func:`~repro_torch.serve.signature.serving_grid` defaults, and the
    canonical tile batch is size-bucketed with registry-managed per-bucket
    caps.  Tuned and default registrations and cache keys never alias:
    both carry the tuned config key.

    ``shard_devices=N`` routes *large* size classes — padded vertex count
    >= ``shard_min_vertices`` — through a data-parallel
    :class:`~repro_torch.core.pipeline.ShardedRunner` over N shards of the
    mesh ``shard_mesh_devices`` (the visible cards unless named; N logical
    shards on one card need that card named N times), with contiguous
    partition assignment and power-of-two per-shard tile caps, so
    structurally-similar requests share one runner.  The cache key then
    carries the shard count, the realized shard layout, the
    ``kernel_dispatch`` flag and the mesh's devices: a sharded runner never
    aliases a single-device one, another mesh or a scan-scheduled variant.  A
    tuned shard count caps the mesh size and never raises it.
    """

    def __init__(self, model: Union[str, C.CompiledGNN],
                 params: Optional[Dict] = None, *,
                 n_layers: int = 1, kernel_dispatch: bool = True,
                 cache_capacity: int = 32, target_part: int = 256,
                 shard_devices: Optional[int] = None,
                 shard_min_vertices: int = 2048,
                 shard_model_axis: int = 1,
                 shard_mesh_devices: Optional[Sequence] = None,
                 tune_cache=None,
                 cache: Optional[ProgramCache] = None,
                 shapes: Optional[ShapeRegistry] = None,
                 cache_owner: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """Build a server around one compiled model.

        Args:
            model: registered model name or a pre-compiled
                :class:`~repro_torch.core.compiler.CompiledGNN`.
            params: default weights for every request (a request may
                override them).
            n_layers: stack depth when ``model`` is a name; must agree with
                a pre-compiled model's layer count.
            kernel_dispatch: run the CUDA gather kernels (else the scan
                schedule).
            cache_capacity: LRU capacity when no shared ``cache`` is given.
            target_part: vertices per destination partition for the
                default serving grid.
            shard_devices: route large classes over N shards.
            shard_min_vertices: padded-vertex threshold for the sharded
                route.
            shard_model_axis: feature-axis width of the sharded route's
                2-D mesh — ``M > 1`` splits each boundary exchange into
                per-rank slices over ``shard_devices * M`` devices; part of
                the cache key, so different splits never alias.
            shard_mesh_devices: the ordered device list of the sharded
                route's mesh; the visible cards (or ``[device]`` off CUDA)
                unless named.
            tune_cache: optional
                :class:`~repro_torch.launch.autotune.TuneCache` routing
                tuned classes onto tuned tile configs.
            cache: a shared :class:`ProgramCache`; defaults to a private
                cache of ``cache_capacity``.
            shapes: a shared :class:`ShapeRegistry`; defaults to private.
            cache_owner: tenant tag for per-owner cache budgets; defaults
                to the compiled model's name.
            device: where requests run; ``cuda`` unless named.

        Raises:
            ValueError: on a layer-count conflict or an unrealizable
                ``shard_devices``.
            RuntimeError: when ``cuda`` is asked for and no card is visible.
        """
        self.device = resolve(device)
        if shard_model_axis < 1:
            raise ValueError(
                f"shard_model_axis must be >= 1, got {shard_model_axis}")
        self.shard_mesh_devices = (
            default_devices(self.device) if shard_mesh_devices is None
            else [torch.device(d) for d in shard_mesh_devices])
        if shard_devices is not None:
            # fail at configuration time, not when the first large batch
            # arrives hours into a serving session
            ShardMesh(self.shard_mesh_devices, shard_devices, shard_model_axis)
        if isinstance(model, str):
            self.compiled = C.compile_gnn(
                M.trace_named(model) if n_layers == 1
                else M.trace_stacked(model, n_layers))
        else:
            if n_layers != 1 and n_layers != model.n_layers:
                raise ValueError(
                    f"n_layers={n_layers} conflicts with the pre-compiled "
                    f"model's {model.n_layers} layers")
            self.compiled = model
        self.params = None if params is None else params_from_reference(
            params, self.device, self.compiled.trace)
        self.kernel_dispatch = kernel_dispatch
        self.target_part = target_part
        self.shard_devices = shard_devices
        self.shard_min_vertices = shard_min_vertices
        self.shard_model_axis = shard_model_axis
        self._mesh_key = ("mesh", tuple(str(d) for d in self.shard_mesh_devices),
                          str(self.device))
        self.tune_cache = tune_cache
        self.sp = self.compiled.schedule(self.kernel_dispatch)
        self._kernel_tags = tuple(sorted(
            {g.kernel for ph in self.sp.phases for g in ph.gathers}
            - {S.KERNEL_SCAN}))
        self.cache = cache if cache is not None \
            else ProgramCache(capacity=cache_capacity)
        self.shapes = shapes if shapes is not None \
            else ShapeRegistry(target_part=target_part)
        self.cache_owner = (cache_owner if cache_owner is not None
                            else self.compiled.name)
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._graphs_served = 0
        self._batches_run = 0
        self._sharded_batches = 0

    # ------------------------------------------------------------------ API
    def submit(self, graphs: Sequence[Graph], inputs: Sequence[Dict],
               params: Optional[Dict] = None) -> List[List[torch.Tensor]]:
        """Run the model over every graph; returns per-graph output lists
        (vertex-space tensors on the server's device, same order as the
        model's declared outputs)."""
        if len(graphs) != len(inputs):
            raise ValueError(f"{len(graphs)} graphs but {len(inputs)} inputs")
        if not graphs:
            return []
        if params is not None:
            params = params_from_reference(params, self.device,
                                           self.compiled.trace)
        else:
            params = self.params
        if params is None:
            raise ValueError("no params bound to the server or the request")

        groups: Dict[tuple, List[int]] = {}
        for i, g in enumerate(graphs):
            groups.setdefault(size_class(g), []).append(i)

        results: List[Optional[List[torch.Tensor]]] = [None] * len(graphs)
        for idxs in groups.values():
            outs = self._run_group([graphs[i] for i in idxs],
                                   [inputs[i] for i in idxs], params)
            for i, out in zip(idxs, outs):
                results[i] = out
        with self._stats_lock:
            self._requests += 1
            self._graphs_served += len(graphs)
        return results  # fully populated: every index belongs to one group

    def stats(self) -> Dict:
        """Serving counters: requests/graphs/batches served, cache size and
        hit/miss/compile counts, layer count, sharded-batch count."""
        return dict(requests=self._requests, graphs=self._graphs_served,
                    batches=self._batches_run, cache_size=len(self.cache),
                    n_layers=self.compiled.n_layers,
                    sharded_batches=self._sharded_batches,
                    cache=self.cache.stats.as_dict())

    @property
    def compile_count(self) -> int:
        """Total runner builds so far (flat after warmup on a
        repeated-signature stream)."""
        return self.cache.stats.compiles

    @property
    def cache_hits(self) -> int:
        """Request batches served by an already-built runner."""
        return self.cache.stats.hits

    @property
    def cache_misses(self) -> int:
        """Request batches that had to build a runner."""
        return self.cache.stats.misses

    # ------------------------------------------------------------ internals
    def _run_group(self, graphs: List[Graph], inputs: List[Dict],
                   params: Dict[str, torch.Tensor]) -> List[List[torch.Tensor]]:
        with spans.span("engine.merge"):
            batch = batch_graphs(graphs)
        # class keys carry the program identity (name + layer count) so
        # registrations of different programs never alias
        class_key = (self.compiled.name, self.compiled.n_layers,
                     size_class(graphs[0]), quantize(len(graphs), floor=1))
        tuned = None
        if self.tune_cache is not None:
            from ..launch.autotune import program_key
            tuned = self.tune_cache.get(
                program_key(self.compiled, self.kernel_dispatch), class_key)
        if tuned is not None:
            # tuned route: tuned grid + reorder + edge layout + size-bucketed
            # tile batch; the registration key carries the config so default
            # and tuned canonical shapes of one class never alias
            tuned_key = ("tuned",) + tuned.key()
            shape_key, tiling = class_key + (tuned_key,), dict(
                grid=(tuned.n_dst_parts, tuned.n_src_parts),
                reorder=tuned.reorder, layout=tuned.layout,
                n_buckets=tuned.n_buckets)
        else:
            tuned_key, shape_key, tiling = (), class_key, {}
        with spans.span("engine.tile"):
            # the registry's lock (reentrant) taken here first, so that the
            # wait for it is a span of its own; canonical re-enters it
            with spans.span("engine.tile_wait"):
                self.shapes._lock.acquire()
            try:
                merged_graph, tiles, E_pad, ro = self.shapes.canonical(
                    shape_key, batch.graph, **tiling)
            finally:
                self.shapes._lock.release()
        V_pad = merged_graph.n_vertices

        merged_inputs: Dict[str, torch.Tensor] = {}
        with spans.span("engine.inputs"):
            for rows, space in ((V_pad, self.sp.vertex_inputs),
                                (E_pad, self.sp.edge_inputs)):
                for _, name in space:
                    t = to_device(_pad_rows(np.concatenate(
                        [np.asarray(inp[name]) for inp in inputs]), rows),
                        self.device)
                    spans.count("engine.h2d_bytes", t.nbytes)
                    spans.count("engine.h2d_tensors")
                    merged_inputs[name] = t

        n_dev = (self.shard_devices
                 if self.shard_devices and self.shard_devices > 1
                 and V_pad >= self.shard_min_vertices else 1)
        if tuned is not None and n_dev > 1:
            # the tuned shard count caps (never raises) the mesh size
            n_dev = max(1, min(n_dev, tuned.n_shards))
        if n_dev > 1:
            # sharded route: the key carries the devices a runner is bound
            # to (servers that share a cache may name different meshes),
            # the mesh size, the realized shard layout, the dispatch flag,
            # the reorder mode and the tuned config
            key = structure_signature(self.compiled, tiles, E_pad,
                                      self.kernel_dispatch,
                                      reorder=ro.mode) + (
                self._mesh_key,
                shard_layout_signature(tiles, n_dev, mode="contiguous",
                                       quantize_tile_cap=True,
                                       kernel_dispatch=self.kernel_dispatch,
                                       kernels=self._kernel_tags,
                                       model_axis=self.shard_model_axis),
                tuned_key)

            def build():
                return ShardedRunner(self.compiled, ro.graph, tiles, n_dev,
                                     mode="contiguous", quantize_tile_cap=True,
                                     devices=self.shard_mesh_devices,
                                     kernel_dispatch=self.kernel_dispatch,
                                     reordering=ro,
                                     model_axis=self.shard_model_axis,
                                     device=self.device)
        else:
            key = structure_signature(self.compiled, tiles, E_pad,
                                      self.kernel_dispatch,
                                      reorder=ro.mode) + (tuned_key,)

            def build():
                return PipelinedRunner(self.compiled, ro.graph, tiles,
                                       kernel_dispatch=self.kernel_dispatch,
                                       reordering=ro, device=self.device)
        with spans.span("engine.cache"):
            runner = self.cache.get_or_build(key, build, owner=self.cache_owner)
        if n_dev > 1:
            with self._stats_lock:
                self._sharded_batches += 1
        with torch.inference_mode():    # serving records no autograd graph
            outs = runner.run_with(tiles, merged_inputs, params, reordering=ro)
        with self._stats_lock:
            self._batches_run += 1

        o = batch.vertex_offsets
        return [[out[o[g]:o[g + 1]] for out in outs]
                for g in range(len(graphs))]
