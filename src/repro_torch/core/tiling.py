"""Grid-based graph tiling (paper §5.1, §5.3).

The adjacency matrix is split into a P (destination partitions) × S (source
partitions) grid of *tiles*.  Each tile uniquely owns the edges whose dst is
in its destination partition and src in its source partition.

* **regular tiling** — a tile's source-vertex set is the *whole* source
  partition (vertices loaded whether or not they have edges in the tile).
* **sparse tiling** — only source vertices with ≥1 edge in the tile are kept
  (compaction); empty tiles are dropped entirely.

JAX needs static shapes, so tiles are padded to (S_max, E_max) with explicit
``n_src`` / ``n_edge`` counts; masked tails contribute nothing (sum) / -inf
(max).  The padded batch is what the pipelined executor ``lax.scan``s over
and what the Pallas tile kernel consumes.

On power-law graphs a single global (S_max, E_max) is dominated by a handful
of dense tiles, so most scan iterations are zero padding.
:func:`bucket_tiles` post-processes a :class:`TileSet` into a
:class:`BucketedTileSet`: tiles are size-binned by (n_edge, n_src) and each
bin is padded only to its own maxima (CSR row-bucketing adapted to grid
tiles).  The pipelined executor runs one scan per bucket with shared
accumulators, so numerics match the global-pad path while the padded
edge-slot waste drops by the bucket-size ratio.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from ..gnn.graphs import Graph


@dataclasses.dataclass
class TileSet:
    """Padded, partition-ordered tile batch."""

    # per-tile payload (T = number of tiles kept)
    src_ids: np.ndarray     # (T, S_max) int32 — global source-vertex ids
    edge_src: np.ndarray    # (T, E_max) int32 — local index into src_ids row
    edge_dst: np.ndarray    # (T, E_max) int32 — dst offset within the tile's partition
    edge_gid: np.ndarray    # (T, E_max) int32 — global edge index (for edge feats)
    n_src: np.ndarray       # (T,) int32
    n_edge: np.ndarray      # (T,) int32
    part_id: np.ndarray     # (T,) int32 — destination partition of each tile
    # per-partition metadata (P,)
    part_start: np.ndarray  # (P,) int32 — first dst vertex id of the partition
    part_size: np.ndarray   # (P,) int32
    # config
    n_dst_parts: int
    n_src_parts: int
    sparse: bool
    n_vertices: int
    n_edges: int
    # intra-tile edge layout: "coo" keeps edges in arrival order; "csr" sorts
    # the real edge slots of each tile by local dst row and adds per-tile row
    # pointers (see :func:`csr_tiles`), so kernels walk contiguous rows
    # instead of scanning padded edge slots.
    layout: str = "coo"
    row_ptr: Optional[np.ndarray] = None  # (T, D_max+1) int32, csr only

    @property
    def n_tiles(self) -> int:
        return int(self.src_ids.shape[0])

    @property
    def s_max(self) -> int:
        return int(self.src_ids.shape[1])

    @property
    def e_max(self) -> int:
        return int(self.edge_src.shape[1])

    # ---- cost accounting (paper Fig 11: off-chip access model) -------------
    def src_vertex_loads(self) -> int:
        """Total source-vertex embedding rows loaded from off-chip."""
        return int(self.n_src.sum())

    def dst_vertex_loads(self) -> int:
        """Destination rows are loaded once per partition per phase."""
        return int(self.part_size.sum())

    def edge_index_bytes(self) -> int:
        """Edge-index traffic: COO ships (src, dst) int32 pairs per edge;
        CSR ships one column index per edge plus each tile's (D_max+1)-entry
        row-pointer table."""
        E = int(self.n_edge.sum())
        if self.layout == "csr":
            width = self.row_ptr.shape[1] if self.row_ptr is not None else 1
            return E * 4 + self.n_tiles * width * 4
        return E * 2 * 4

    def offchip_read_bytes(self, dim: int, dtype_bytes: int = 4,
                           dst_streams: int = 1) -> int:
        vert = (self.src_vertex_loads() + dst_streams * self.dst_vertex_loads()) * dim * dtype_bytes
        return vert + self.edge_index_bytes()

    def tiles_of_partition(self, p: int) -> np.ndarray:
        return np.nonzero(self.part_id == p)[0]

    # ---- padding accounting (what the static-shape executor actually pays) --
    def padded_src_slots(self) -> int:
        return self.n_tiles * self.s_max

    def padded_edge_slots(self) -> int:
        return self.n_tiles * self.e_max

    def padding_efficiency(self) -> float:
        """Fraction of padded edge slots holding a real edge (1.0 = no waste)."""
        return int(self.n_edge.sum()) / max(self.padded_edge_slots(), 1)

    def padded_dims_of_tile(self, t: int) -> Tuple[int, int]:
        """(src_slots, edge_slots) the executor materializes for tile ``t``."""
        return self.s_max, self.e_max

    # ---- structural identity (program-cache key; serving layer) ------------
    def shape_signature(self) -> Tuple:
        """Everything a jitted runner's compilation depends on — padded tile
        shapes and the partition table — and nothing edge-list-specific.
        Two tile sets with equal signatures can share one compiled program.
        ``layout`` is part of the signature: CSR and COO tile sets lower to
        different kernels and must never alias one cached program."""
        return ("tiles", self.layout, self.n_tiles, self.s_max, self.e_max,
                self.n_dst_parts, self.n_src_parts, self.n_vertices,
                tuple(self.part_start.tolist()),
                tuple(self.part_size.tolist()))


def _even_bounds(n: int, parts: int) -> np.ndarray:
    """parts+1 boundaries of an even split of range(n)."""
    return np.linspace(0, n, parts + 1).round().astype(np.int64)


def grid_tile(graph: Graph, n_dst_parts: int, n_src_parts: int,
              sparse: bool = True, pad_multiple: int = 8,
              layout: str = "coo") -> TileSet:
    """Grid-based tiling; ``sparse=False`` reproduces regular tiling.

    ``layout="csr"`` post-converts the tile batch via :func:`csr_tiles`.
    """
    if layout not in ("coo", "csr"):
        raise ValueError(f"unknown tile layout {layout!r}")
    V, E = graph.n_vertices, graph.n_edges
    db = _even_bounds(V, n_dst_parts)
    sb = _even_bounds(V, n_src_parts)
    dpart = np.searchsorted(db, graph.dst, side="right") - 1
    spart = np.searchsorted(sb, graph.src, side="right") - 1

    # bucket edges by (dst_part, src_part), partition-major order
    key = dpart.astype(np.int64) * n_src_parts + spart
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    uniq, starts = np.unique(key_sorted, return_index=True)
    ends = np.append(starts[1:], E)

    tiles = []  # (part, src_part, edge_idx_sorted_slice)
    for k, s, e in zip(uniq, starts, ends):
        tiles.append((int(k // n_src_parts), int(k % n_src_parts), order[s:e]))
    if not sparse:
        # regular tiling keeps every (p, s) cell, even empty ones
        present = {(p, s) for p, s, _ in tiles}
        for p in range(n_dst_parts):
            for s in range(n_src_parts):
                if (p, s) not in present:
                    tiles.append((p, s, np.empty(0, dtype=np.int64)))
        tiles.sort(key=lambda t: (t[0], t[1]))

    rows = []
    for p, s, eidx in tiles:
        esrc_g = graph.src[eidx]
        edst_g = graph.dst[eidx]
        if sparse:
            srcs, esrc_local = np.unique(esrc_g, return_inverse=True)
        else:
            srcs = np.arange(sb[s], sb[s + 1], dtype=np.int64)
            esrc_local = esrc_g - sb[s]
        rows.append({
            "p": p,
            "srcs": srcs.astype(np.int32),
            "esrc": esrc_local.astype(np.int32),
            "edst": (edst_g - db[p]).astype(np.int32),
            "egid": eidx.astype(np.int32),
        })

    def _pad_to(x: int) -> int:
        return max(pad_multiple, int(math.ceil(max(x, 1) / pad_multiple)) * pad_multiple)

    s_max = _pad_to(max((len(r["srcs"]) for r in rows), default=1))
    e_max = _pad_to(max((len(r["esrc"]) for r in rows), default=1))
    T = len(rows)

    src_ids = np.zeros((T, s_max), np.int32)
    edge_src = np.zeros((T, e_max), np.int32)
    edge_dst = np.zeros((T, e_max), np.int32)
    edge_gid = np.zeros((T, e_max), np.int32)
    n_src = np.zeros((T,), np.int32)
    n_edge = np.zeros((T,), np.int32)
    part_id = np.zeros((T,), np.int32)
    for i, r in enumerate(rows):
        k, m = len(r["srcs"]), len(r["esrc"])
        src_ids[i, :k] = r["srcs"]
        edge_src[i, :m] = r["esrc"]
        edge_dst[i, :m] = r["edst"]
        edge_gid[i, :m] = r["egid"]
        n_src[i], n_edge[i], part_id[i] = k, m, r["p"]

    ts = TileSet(
        src_ids=src_ids, edge_src=edge_src, edge_dst=edge_dst, edge_gid=edge_gid,
        n_src=n_src, n_edge=n_edge, part_id=part_id,
        part_start=db[:-1].astype(np.int32),
        part_size=np.diff(db).astype(np.int32),
        n_dst_parts=n_dst_parts, n_src_parts=n_src_parts, sparse=sparse,
        n_vertices=V, n_edges=E)
    return csr_tiles(ts) if layout == "csr" else ts


def csr_tiles(tiles: TileSet) -> TileSet:
    """Convert a COO tile batch to CSR-within-tile layout (§5.3 / ROADMAP 3).

    Per tile, the *real* edge slots ``[:n_edge]`` are stably sorted by local
    destination row — ``edge_src``/``edge_dst``/``edge_gid`` are permuted
    together, so ``edge_src[t, row_ptr[t, d]:row_ptr[t, d+1]]`` is dst row
    ``d``'s contiguous column-index run.  ``row_ptr`` is (T, D_max+1) with
    ``D_max = part_size.max()``; rows past a tile's partition size (and all
    rows of zero-edge filler tiles) get empty ``[ptr, ptr)`` runs.  Padded
    edge slots stay after ``row_ptr[t, -1] == n_edge[t]`` where no row
    pointer can reach them, so CSR kernels need no tail masking.
    """
    if tiles.layout == "csr":
        return tiles
    T = tiles.n_tiles
    dmax = int(tiles.part_size.max()) if tiles.part_size.size else 1
    edge_src = tiles.edge_src.copy()
    edge_dst = tiles.edge_dst.copy()
    edge_gid = tiles.edge_gid.copy()
    row_ptr = np.zeros((T, dmax + 1), np.int32)
    for t in range(T):
        ne = int(tiles.n_edge[t])
        if ne == 0:
            continue
        perm = np.argsort(edge_dst[t, :ne], kind="stable")
        edge_src[t, :ne] = edge_src[t, perm]
        edge_gid[t, :ne] = edge_gid[t, perm]
        edge_dst[t, :ne] = edge_dst[t, perm]
        counts = np.bincount(edge_dst[t, :ne], minlength=dmax)
        row_ptr[t, 1:] = np.cumsum(counts[:dmax]).astype(np.int32)
    return dataclasses.replace(tiles, edge_src=edge_src, edge_dst=edge_dst,
                               edge_gid=edge_gid, layout="csr", row_ptr=row_ptr)


@dataclasses.dataclass
class BucketedTileSet:
    """Size-binned tile batch: each bucket is a :class:`TileSet` padded only
    to its own (S_max, E_max).

    Buckets share the partition metadata of the source tile set; per-bucket
    tile order is partition-major (required by the Pallas FIRST/LAST flag
    protocol) with the heaviest tile of each partition first — a
    deterministic largest-processing-time order that load-balances the
    stream slots.  ``tile_index[b][i]`` is the row of bucket ``b``'s tile
    ``i`` in the original tile set.
    """

    buckets: List[TileSet]
    tile_index: List[np.ndarray]
    source: TileSet

    # ---- flattened view (bucket-major), for cost models over "all tiles" ---
    def __post_init__(self):
        self.n_src = np.concatenate([b.n_src for b in self.buckets])
        self.n_edge = np.concatenate([b.n_edge for b in self.buckets])
        self.part_id = np.concatenate([b.part_id for b in self.buckets])
        self._pad_s = np.concatenate(
            [np.full(b.n_tiles, b.s_max, np.int64) for b in self.buckets])
        self._pad_e = np.concatenate(
            [np.full(b.n_tiles, b.e_max, np.int64) for b in self.buckets])

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_tiles(self) -> int:
        return sum(b.n_tiles for b in self.buckets)

    @property
    def n_dst_parts(self) -> int:
        return self.source.n_dst_parts

    @property
    def n_src_parts(self) -> int:
        return self.source.n_src_parts

    @property
    def sparse(self) -> bool:
        return self.source.sparse

    @property
    def layout(self) -> str:
        return self.source.layout

    @property
    def n_vertices(self) -> int:
        return self.source.n_vertices

    @property
    def n_edges(self) -> int:
        return self.source.n_edges

    @property
    def part_start(self) -> np.ndarray:
        return self.source.part_start

    @property
    def part_size(self) -> np.ndarray:
        return self.source.part_size

    def tiles_of_partition(self, p: int) -> np.ndarray:
        return np.nonzero(self.part_id == p)[0]

    # ---- cost accounting ---------------------------------------------------
    def src_vertex_loads(self) -> int:
        return int(self.n_src.sum())

    def dst_vertex_loads(self) -> int:
        return self.source.dst_vertex_loads()

    def offchip_read_bytes(self, dim: int, dtype_bytes: int = 4,
                           dst_streams: int = 1) -> int:
        return self.source.offchip_read_bytes(dim, dtype_bytes, dst_streams)

    def padded_src_slots(self) -> int:
        return int(self._pad_s.sum())

    def padded_edge_slots(self) -> int:
        return int(self._pad_e.sum())

    def padding_efficiency(self) -> float:
        return int(self.n_edge.sum()) / max(self.padded_edge_slots(), 1)

    def padded_dims_of_tile(self, t: int) -> Tuple[int, int]:
        return int(self._pad_s[t]), int(self._pad_e[t])

    def shape_signature(self) -> Tuple:
        return ("btiles", tuple(b.shape_signature() for b in self.buckets),
                self.source.shape_signature())


def _repack(tiles: TileSet, idx: np.ndarray, pad_multiple: int) -> TileSet:
    """A TileSet over ``tiles[idx]`` re-padded to the selection's own maxima."""
    def _pad_to(x: int) -> int:
        return max(pad_multiple, int(math.ceil(max(x, 1) / pad_multiple)) * pad_multiple)

    s_max = _pad_to(int(tiles.n_src[idx].max(initial=0)))
    e_max = _pad_to(int(tiles.n_edge[idx].max(initial=0)))
    return TileSet(
        src_ids=np.ascontiguousarray(tiles.src_ids[idx, :s_max]),
        edge_src=np.ascontiguousarray(tiles.edge_src[idx, :e_max]),
        edge_dst=np.ascontiguousarray(tiles.edge_dst[idx, :e_max]),
        edge_gid=np.ascontiguousarray(tiles.edge_gid[idx, :e_max]),
        n_src=tiles.n_src[idx].copy(), n_edge=tiles.n_edge[idx].copy(),
        part_id=tiles.part_id[idx].copy(),
        part_start=tiles.part_start, part_size=tiles.part_size,
        n_dst_parts=tiles.n_dst_parts, n_src_parts=tiles.n_src_parts,
        sparse=tiles.sparse, n_vertices=tiles.n_vertices, n_edges=tiles.n_edges,
        layout=tiles.layout,
        row_ptr=None if tiles.row_ptr is None else tiles.row_ptr[idx].copy())


def bucket_tiles(tiles: TileSet, n_buckets: int = 4,
                 pad_multiple: int = 8) -> BucketedTileSet:
    """Post-pass: bin tiles by size so each bin pads to its own maxima.

    Tiles are sorted by (n_edge, n_src) and split into ``n_buckets``
    contiguous equal-count bins.  The realized bucket count is exactly
    ``min(n_buckets, n_tiles)`` — the bin bounds are strictly increasing by
    construction (every bin gets at least one tile), never collapsed through
    rounding or dedup, so a config sweep over ``n_buckets`` (the autotuner)
    maps each requested count onto a distinct, deterministic layout and
    cache keys derived from the bucket shapes stay stable.  Within a bin
    tiles are ordered partition-major, heaviest first per partition —
    deterministic, and load-balanced for the multi-stream schedule.
    """
    T = tiles.n_tiles
    if T == 0:
        return BucketedTileSet(buckets=[tiles],
                               tile_index=[np.empty(0, np.int64)], source=tiles)
    n_buckets = max(1, min(n_buckets, T))
    order = np.lexsort((tiles.n_src, tiles.n_edge))  # (n_edge, n_src) asc
    # i-th bound = i*T//n: strictly increasing whenever T >= n_buckets
    # (guaranteed by the cap above), unlike round()+unique which can merge
    # near-uniform splits and silently change the realized bucket count
    bounds = (np.arange(n_buckets + 1, dtype=np.int64) * T) // n_buckets
    assert len(np.unique(bounds)) == n_buckets + 1

    buckets: List[TileSet] = []
    index: List[np.ndarray] = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sel = order[lo:hi]
        # partition-major; within a partition largest-first (LPT), ties by row
        sub = np.lexsort((sel, -tiles.n_edge[sel].astype(np.int64),
                          tiles.part_id[sel]))
        sel = sel[sub]
        buckets.append(_repack(tiles, sel, pad_multiple))
        index.append(sel)
    return BucketedTileSet(buckets=buckets, tile_index=index, source=tiles)


def pad_tileset(tiles: TileSet, n_tiles: int, s_max: int, e_max: int) -> TileSet:
    """Pad a (partition-major) tile set to ``(n_tiles, s_max, e_max)`` with
    zero-edge filler tiles, so structurally-similar graphs snap onto one
    shape signature and share a compiled program (serving cache).

    Filler tiles carry ``part_id = P-1`` and append after the real tiles,
    extending the last partition's run: under the Pallas FIRST/LAST flag
    protocol they add a zero adjacency block to that partition's accumulator
    (or, if the partition had no real tiles, flush an all-zero block — the
    correct empty-gather result), and the ``lax.scan`` path masks them out
    via ``n_edge = 0``.
    """
    if (n_tiles, s_max, e_max) == (tiles.n_tiles, tiles.s_max, tiles.e_max):
        return tiles
    if (n_tiles < tiles.n_tiles or s_max < tiles.s_max or e_max < tiles.e_max):
        raise ValueError(
            f"pad_tileset cannot shrink {(tiles.n_tiles, tiles.s_max, tiles.e_max)}"
            f" -> {(n_tiles, s_max, e_max)}")
    T = tiles.n_tiles

    def grow(a: np.ndarray, cols: int) -> np.ndarray:
        out = np.zeros((n_tiles, cols), a.dtype)
        out[:T, :a.shape[1]] = a
        return out

    def grow1(a: np.ndarray, fill: int = 0) -> np.ndarray:
        out = np.full((n_tiles,), fill, a.dtype)
        out[:T] = a
        return out

    # filler tiles get an all-zero row_ptr: every CSR row run is [0, 0) —
    # the correct empty-tile contribution under the FIRST/LAST protocol
    row_ptr = (None if tiles.row_ptr is None
               else grow(tiles.row_ptr, tiles.row_ptr.shape[1]))
    return TileSet(
        src_ids=grow(tiles.src_ids, s_max),
        edge_src=grow(tiles.edge_src, e_max),
        edge_dst=grow(tiles.edge_dst, e_max),
        edge_gid=grow(tiles.edge_gid, e_max),
        n_src=grow1(tiles.n_src), n_edge=grow1(tiles.n_edge),
        part_id=grow1(tiles.part_id, fill=tiles.n_dst_parts - 1),
        part_start=tiles.part_start, part_size=tiles.part_size,
        n_dst_parts=tiles.n_dst_parts, n_src_parts=tiles.n_src_parts,
        sparse=tiles.sparse, n_vertices=tiles.n_vertices, n_edges=tiles.n_edges,
        layout=tiles.layout, row_ptr=row_ptr)


def build_tiles(graph: Graph, n_dst_parts: int, n_src_parts: int, *,
                sparse: bool = True, pad_multiple: int = 8,
                reorder: Optional[str] = None, n_buckets: Optional[int] = None,
                layout: str = "coo"):
    """One-stop tiling entry: optional degree reordering + grid tiling
    (+ size bucketing).

    ``reorder`` opts into the paper's §5.3 Degree Sorting before tiling:
    ``"degree"``/``"in"`` sort by in-degree, ``"out"`` by out-degree
    (``None`` keeps vertex ids).  Concentrating high-degree vertices into the
    low-id partitions shrinks the sparse tiles elsewhere, which also tightens
    the padded (S_max, E_max) envelope the static-shape executors pay for.
    ``n_buckets`` additionally post-bins tiles via :func:`bucket_tiles`.
    ``layout="csr"`` converts each tile to CSR-within-tile storage
    (:func:`csr_tiles`) before any bucketing.

    Returns ``(tiles, reordering)`` — run with ``reordering.graph`` and
    permute features in / outputs back through the
    :class:`~repro.core.reorder.Reordering` (the identity mapping when
    ``reorder=None``).
    """
    from . import reorder as R

    if reorder in (None, "identity"):
        ro = R.identity_order(graph)
    elif reorder in ("degree", "in", "out"):
        ro = R.degree_sort(graph, by="out" if reorder == "out" else "in")
    else:
        raise ValueError(f"unknown reorder mode {reorder!r}")
    tiles = grid_tile(ro.graph, n_dst_parts, n_src_parts, sparse=sparse,
                      pad_multiple=pad_multiple, layout=layout)
    if n_buckets is not None:
        tiles = bucket_tiles(tiles, n_buckets, pad_multiple=pad_multiple)
    return tiles, ro

