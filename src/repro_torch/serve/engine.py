"""`InferenceServer` — the batched multi-graph serving front door (port of
``repro.serve.engine``, single-device route).

``submit(graphs, inputs)`` serves a whole request batch through ONE
ScheduledProgram execution per size class:

1. group incoming graphs by :func:`~repro_torch.serve.signature.size_class`;
2. per group, :func:`~repro_torch.gnn.graphs.batch_graphs` merges the
   members into a block-diagonal super-graph, padded (vertices, edge-input
   rows, tile batch) onto the class's registered canonical shapes
   (:class:`~repro_torch.serve.signature.ShapeRegistry`);
3. the structural signature keys the
   :class:`~repro_torch.serve.cache.ProgramCache` — a hit reuses a built
   :class:`~repro_torch.core.pipeline.PipelinedRunner` via ``run_with``
   (rebind tile operands, no rebuild);
4. merged outputs are sliced back into per-graph tensors on the device.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..convert import params_from_reference, to_device
from ..core import compiler as C
from ..core.pipeline import PipelinedRunner
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

    Sharded serving (``shard_devices > 1``) is not ported yet and raises
    ``NotImplementedError``.
    """

    def __init__(self, model: Union[str, C.CompiledGNN],
                 params: Optional[Dict] = None, *,
                 n_layers: int = 1, kernel_dispatch: bool = True,
                 cache_capacity: int = 32, target_part: int = 256,
                 shard_devices: Optional[int] = None,
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
            shard_devices: sharded serving; only ``None`` or 1 (ROADMAP
                A.7 ports the sharded route).
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
            ValueError: on a layer-count conflict or ``shard_devices < 1``.
            NotImplementedError: for ``shard_devices > 1``.
            RuntimeError: when ``cuda`` is asked for and no card is visible.
        """
        if shard_devices is not None and shard_devices < 1:
            raise ValueError(f"shard_devices must be >= 1, got {shard_devices}")
        if shard_devices is not None and shard_devices > 1:
            raise NotImplementedError(
                "sharded serving (shard_devices > 1) is not ported yet: "
                "ROADMAP A.7 (sharded execution)")
        self.device = resolve(device)
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
        self.tune_cache = tune_cache
        self.sp = self.compiled.schedule(self.kernel_dispatch)
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
        hit/miss/compile counts, layer count."""
        return dict(requests=self._requests, graphs=self._graphs_served,
                    batches=self._batches_run, cache_size=len(self.cache),
                    n_layers=self.compiled.n_layers,
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
            merged_graph, tiles, E_pad, ro = self.shapes.canonical(
                class_key + (tuned_key,), batch.graph,
                grid=(tuned.n_dst_parts, tuned.n_src_parts),
                reorder=tuned.reorder, layout=tuned.layout,
                n_buckets=tuned.n_buckets)
        else:
            tuned_key = ()
            merged_graph, tiles, E_pad, ro = self.shapes.canonical(
                class_key, batch.graph)
        V_pad = merged_graph.n_vertices

        merged_inputs: Dict[str, torch.Tensor] = {}
        for rows, space in ((V_pad, self.sp.vertex_inputs),
                            (E_pad, self.sp.edge_inputs)):
            for _, name in space:
                merged_inputs[name] = to_device(_pad_rows(np.concatenate(
                    [np.asarray(inp[name]) for inp in inputs]), rows),
                    self.device)

        key = structure_signature(self.compiled, tiles, E_pad,
                                  self.kernel_dispatch,
                                  reorder=ro.mode) + (tuned_key,)
        runner = self.cache.get_or_build(
            key, lambda: PipelinedRunner(self.compiled, ro.graph, tiles,
                                         kernel_dispatch=self.kernel_dispatch,
                                         reordering=ro, device=self.device),
            owner=self.cache_owner)
        outs = runner.run_with(tiles, merged_inputs, params, reordering=ro)
        with self._stats_lock:
            self._batches_run += 1

        o = batch.vertex_offsets
        return [[out[o[g]:o[g + 1]] for out in outs]
                for g in range(len(graphs))]
