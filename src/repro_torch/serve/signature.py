"""Structural request signatures and size-class quantization.

The serving cache must key compiled programs on *structure*, never on edge
lists: a :class:`~repro.core.pipeline.PipelinedRunner`'s compilation depends
only on the scheduled program (kernel tags + feature dims) and the padded
tile-set shapes.  Everything here exists to make those shapes *repeat*
across a stream of similar-but-not-identical graphs:

* :func:`quantize` snaps counts up to powers of two, so small variance in
  V/E maps onto one size class;
* :func:`serving_grid` picks the tiling grid deterministically from the
  padded vertex count;
* :class:`ShapeRegistry` fixes each class's padded shapes from its first
  request (plus growth headroom), so every later request of the class pads
  onto *identical* shapes — pure quantization would flake whenever a
  realized dimension straddles a power-of-two boundary;
* :func:`canonical_tiles` is the stateless power-of-two variant for one-shot
  use;
* :func:`structure_signature` combines the program and tile signatures into
  the cache key.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Hashable, Optional, Tuple, Union

from ..core import compiler as C
from ..core.tiling import (BucketedTileSet, TileSet, bucket_tiles, grid_tile,
                           pad_tileset)
from ..gnn.graphs import Graph, pad_graph


def quantize(n: int, floor: int = 8) -> int:
    """Round ``n`` up to the next power of two, at least ``floor``."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def size_class(graph: Graph) -> Tuple[int, int, bool]:
    """Coarse per-graph bucket the server groups requests by: quantized
    (V, E) plus whether the graph carries edge types."""
    return (quantize(graph.n_vertices), quantize(max(graph.n_edges, 1)),
            graph.edge_type is not None)


def serving_grid(n_vertices: int, target_part: int = 256,
                 max_parts: int = 64) -> Tuple[int, int]:
    """Deterministic (n_dst_parts, n_src_parts) for a quantized vertex count
    — the same size class must always tile on the same grid."""
    parts = min(quantize(max(n_vertices // target_part, 1), floor=1), max_parts)
    return parts, parts


def canonical_tiles(graph: Graph, grid: Tuple[int, int],
                    pad_multiple: int = 8) -> TileSet:
    """Sparse-tile ``graph`` and snap the batch onto quantized shapes.

    The result's :meth:`~repro.core.tiling.TileSet.shape_signature` is stable
    across graphs of one size class with similar degree structure, which is
    what turns a stream of distinct graphs into program-cache hits.
    """
    ts = grid_tile(graph, grid[0], grid[1], sparse=True,
                   pad_multiple=pad_multiple)
    return pad_tileset(ts, quantize(ts.n_tiles, floor=1),
                       quantize(ts.s_max), quantize(ts.e_max))


def _round_up(x: float, multiple: int) -> int:
    return int(math.ceil(x / multiple)) * multiple


class ShapeRegistry:
    """Per-size-class canonical padded shapes, fixed at first sight.

    Keys are caller-chosen; :class:`~repro.serve.engine.InferenceServer`
    prefixes them with the compiled program's identity (model name + layer
    count), so multi-layer and single-layer programs of one model never
    alias a registration even when a registry is shared.

    The first request of a class registers padded dimensions with
    ``headroom`` (default 25%) over what it realized; every later request of
    the class pads onto exactly those shapes — a guaranteed program-cache
    hit.  Only a request that *exceeds* a registered dimension bumps the
    class (shapes grow monotonically, costing one recompile), so a
    steady-state stream converges to zero recompilations regardless of where
    realized sizes sit relative to power-of-two boundaries.
    """

    def __init__(self, headroom: float = 0.25, target_part: int = 256,
                 pad_multiple: int = 8):
        """Create an empty registry.

        Args:
            headroom: growth factor applied over the first-seen dimensions
                (0.25 = register 25% above what the first request realized).
            target_part: vertices per destination partition fed to
                :func:`serving_grid` when no explicit grid is given.
            pad_multiple: row-count multiple tile shapes are padded to.
        """
        self.headroom = headroom
        self.target_part = target_part
        self.pad_multiple = pad_multiple
        self._shapes: Dict[Hashable, Dict] = {}
        # the async tier canonicalizes concurrently from worker threads; the
        # grow-monotonically registration must not interleave
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._shapes)

    def canonical(self, key: Hashable, graph: Graph,
                  grid: Optional[Tuple[int, int]] = None,
                  reorder: Optional[str] = None, layout: str = "coo",
                  n_buckets: Optional[int] = None
                  ) -> Tuple[Graph, Union[TileSet, BucketedTileSet], int,
                             "Reordering"]:
        """Pad ``graph`` and its tile batch onto the class's registered
        shapes; returns (padded graph, padded tiles, padded edge-row count,
        reordering).  ``grid`` overrides the deterministic
        :func:`serving_grid` choice — the autotuned-config route; callers
        must then key the registration by the tuned config too, so default
        and tuned shapes never alias.  ``reorder``/``layout`` select the
        paper §5.3 degree sort and the within-tile edge storage: the degree
        permutation is computed over the *padded* graph (filler vertices are
        degree-0 and sink to the tail), the returned
        :class:`~repro.core.reorder.Reordering` maps request-order vertex IO
        into/out of the runner, and the tiles are built over the reordered
        graph — callers keying registrations by the tuned config therefore
        also key them by reorder + layout.  ``n_buckets > 1`` additionally
        size-buckets the padded batch with *registered* per-bucket column
        caps: bucket tile counts are a pure function of the registered tile
        count, and the caps grow monotonically exactly like the raw tile
        dims, so bucketed shapes cannot flake across requests the way bare
        power-of-two snapping does when a realized bucket maximum straddles
        a boundary (degree reordering makes that variance routine).
        Thread-safe: concurrent calls for one class serialize, so the
        registered dimensions only ever grow.
        """
        from ..core import reorder as R

        with self._lock:
            grow = 1.0 + self.headroom
            entry = self._shapes.setdefault(
                key, dict(v_pad=0, e_rows=0, tile=(0, 0, 0)))
            V, E = graph.n_vertices, max(graph.n_edges, 1)
            if V > entry["v_pad"]:
                entry["v_pad"] = _round_up(V * grow, 64)
            if E > entry["e_rows"]:
                entry["e_rows"] = _round_up(E * grow, 64)
            padded = pad_graph(graph, entry["v_pad"])
            if reorder in (None, "identity"):
                ro = R.identity_order(padded)
            elif reorder in ("degree", "in", "out"):
                ro = R.degree_sort(padded,
                                   by="out" if reorder == "out" else "in")
            else:
                raise ValueError(f"unknown reorder mode {reorder!r}")
            if grid is None:
                grid = serving_grid(entry["v_pad"], self.target_part)
            raw = grid_tile(ro.graph, grid[0], grid[1], sparse=True,
                            pad_multiple=self.pad_multiple, layout=layout)
            T, s, e = entry["tile"]
            if raw.n_tiles > T:
                T = _round_up(raw.n_tiles * grow, 2)
            T = max(T, 1)    # an edgeless graph tiles to zero tiles; keep one
            # filler so the kernels always see a non-empty grid
            if raw.s_max > s:
                s = _round_up(raw.s_max * grow, self.pad_multiple)
            if raw.e_max > e:
                e = _round_up(raw.e_max * grow, self.pad_multiple)
            entry["tile"] = (T, s, e)
            ts = pad_tileset(raw, T, s, e)
            if n_buckets is None or n_buckets <= 1:
                return padded, ts, entry["e_rows"], ro
            bt = bucket_tiles(ts, n_buckets, pad_multiple=self.pad_multiple)
            caps = entry.setdefault("buckets", {}).setdefault(n_buckets, [])
            grown = []
            for i, b in enumerate(bt.buckets):
                if i >= len(caps):
                    caps.append((0, 0))
                cs, ce = caps[i]
                if b.s_max > cs:
                    cs = _round_up(b.s_max * grow, self.pad_multiple)
                if b.e_max > ce:
                    ce = _round_up(b.e_max * grow, self.pad_multiple)
                caps[i] = (cs, ce)
                grown.append(pad_tileset(b, b.n_tiles, cs, ce))
            bt = BucketedTileSet(buckets=grown,
                                 tile_index=list(bt.tile_index),
                                 source=bt.source)
            return padded, bt, entry["e_rows"], ro


def structure_signature(model: Union[str, C.CompiledGNN],
                        tiles: Union[TileSet, BucketedTileSet],
                        padded_edges: int = 0,
                        kernel_dispatch: bool = True,
                        reorder: str = "identity") -> Tuple:
    """The compiled-program cache key: program structure + tile shapes +
    the padded edge-input row count (edge-space input arrays are traced, so
    their length is a compilation input too) + the vertex reorder mode.
    Raw edge lists never enter.  The tile shape signature leads with the
    edge layout and the runner's compiled permutation plumbing depends on
    the reorder mode, so CSR/COO and identity/degree programs can never
    alias one cache entry.
    """
    if isinstance(model, str):
        from ..gnn import models as M
        model = C.compile_gnn(M.trace_named(model))
    return (model.structure_signature(kernel_dispatch),
            tiles.shape_signature(), int(padded_edges), str(reorder))
