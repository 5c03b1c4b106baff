"""Multi-streamed execution model (paper §5.2, §7.2).

Builds the stream-task dependency graph for a compiled model over a tile
set: one **dStream** processes partitions sequentially; within the current
partition, up to ``n_sstreams`` sStreams and ``n_estreams`` eStreams process
tiles concurrently.  Dependencies reproduce the SIGNAL/WAIT protocol:

    dStream(p).pre  --SIGNAL-->  sStream(tile)  --SIGNAL.E-->  eStream(tile)
    all eStream(tiles of p)  --(gather barrier)-->  dStream(p).post

For multi-layer programs the default (``inter_layer="barrier"``) chains
every level after ALL of the previous level's barriers — the classic
layer-by-layer execution.  ``inter_layer="pipelined"`` relaxes the layer
boundary to its true data dependencies: a layer-``l+1`` tile's sStream task
waits only on the layer-``l`` gather barriers of the partitions that
*produce its source vertices*, so early partitions' next-layer tile compute
interleaves with late partitions' gather drain (the paper's tile × operator
parallelism applied across the whole stacked program).

The event-driven engine that executes this graph against hardware resources
lives in :mod:`repro.core.simulator`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .isa import Instr, SDEFunctions, DISPATCH_CYCLES
from .tiling import BucketedTileSet, TileSet


@dataclasses.dataclass
class HWConfig:
    """ZIPPER hardware configuration (paper Table 4 defaults)."""

    freq_ghz: float = 1.0
    n_mu: int = 1
    n_vu: int = 2
    n_sstreams: int = 4
    n_estreams: int = 4
    # MU: one 32x128 output-stationary systolic array per instance
    mu_rows: int = 32
    mu_cols: int = 128
    # VU: eight 32-wide SIMD cores per instance
    vu_lanes: int = 8 * 32
    # memory
    hbm_gbps: float = 256.0     # HBM-1.0 (paper); TPUv5e profile uses 819
    uem_mbytes: float = 21.0    # unified embedding memory (eDRAM)
    th_kbytes: float = 256.0    # tile hub SRAM
    dtype_bytes: int = 4
    # chip-to-chip link bandwidth (multi-chip scaling, PAPERS.md co-design
    # direction; the paper itself is single-chip)
    interconnect_gbps: float = 100.0

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_gbps / self.freq_ghz  # GB/s / GHz = bytes/ns = bytes/cycle

    @property
    def interconnect_bytes_per_cycle(self) -> float:
        return self.interconnect_gbps / self.freq_ghz

    def scaled(self, **kw) -> "HWConfig":
        return dataclasses.replace(self, **kw)


#: TPU-v5e-like configuration for the hardware-adaptation experiments
TPU_V5E_LIKE = HWConfig(freq_ghz=0.94, n_mu=4, n_vu=4, hbm_gbps=819.0,
                        uem_mbytes=128.0, mu_rows=128, mu_cols=128)


@dataclasses.dataclass
class Task:
    """A stream task: a straight-line instruction burst bound to a tile or
    partition.  ``deps`` are task ids that must complete first."""

    tid: int
    kind: str                      # 's' | 'e' | 'd'
    instrs: List[Tuple[Instr, int, int, int]]  # (template, m, k, n) bound dims
    deps: List[int]
    bytes_in: int = 0              # off-chip loads this task issues
    bytes_out: int = 0
    label: str = ""
    # structured identity (what the label encodes) so analyses never have to
    # parse label strings: SDE level, destination partition, flattened tile
    # index (s/e tasks only), and the dStream role ("drain" = per-partition
    # accumulator/drain compute, "barrier" = end-of-partition gather barrier)
    level: int = -1
    part: int = -1
    tile: int = -1
    role: str = ""                 # "s" | "e" | "drain" | "barrier"


def instr_cycles(ins: Instr, m: int, hw: HWConfig) -> int:
    """Latency model per instruction class (paper §7.1 units)."""
    if m == 0:
        return 0
    if ins.unit == "MU":
        # output-stationary systolic: each (mu_rows x mu_cols) output block
        # streams K inputs plus fill/drain
        blocks = math.ceil(m / hw.mu_rows) * math.ceil(ins.n / hw.mu_cols)
        fill = hw.mu_rows + hw.mu_cols
        cyc = blocks * (ins.k + fill)
        if ins.opcode == "BMM":
            # per-row weight selection defeats weight-stationary reuse:
            # weight stream refetched per block group (paper §8.3 observes
            # BMM dilutes tiling benefit via on-chip access latency)
            cyc = int(cyc * 2.0)
        return cyc + DISPATCH_CYCLES
    if ins.unit == "VU":
        lanework = m * max(ins.n, 1)
        cyc = math.ceil(lanework / hw.vu_lanes)
        if ins.opcode.startswith(("SCTR", "GTHR", "DENS", "SFTM")):
            cyc += m  # edge-list indirection: one TH lookup per item
        if ins.opcode == "GEMV":
            cyc = math.ceil(m * ins.k / hw.vu_lanes)
        # one dispatch per *instruction*: a fused ELW chain pays it once
        return cyc + DISPATCH_CYCLES
    return DISPATCH_CYCLES


def _source_partitions(tiles) -> List[np.ndarray]:
    """Per tile (flattened order), the destination partitions covering its
    source vertices — the partitions whose previous-layer gather results the
    tile's source compute reads."""
    def one(ts: TileSet) -> List[np.ndarray]:
        out = []
        for t in range(ts.n_tiles):
            ids = ts.src_ids[t, :int(ts.n_src[t])]
            out.append(np.unique(
                np.searchsorted(ts.part_start, ids, side="right") - 1))
        return out
    if isinstance(tiles, BucketedTileSet):
        return [ps for b in tiles.buckets for ps in one(b)]
    return one(tiles)


def build_task_graph(sde: SDEFunctions, tiles: TileSet, hw: HWConfig,
                     padded: bool = False, inter_layer: str = "barrier",
                     parts: Optional[Sequence[int]] = None
                     ) -> Tuple[List[Task], Dict[str, int]]:
    """Lower (SDE functions × tile set) into the stream task DAG.

    ``tiles`` may be a :class:`TileSet` or a
    :class:`~repro.core.tiling.BucketedTileSet` (the flattened per-tile view
    is used).  With ``padded=True`` every tile is costed at its batch's
    padded (S_max, E_max) instead of its true (n_src, n_edge) — the cost the
    static-shape ``lax.scan`` executor actually pays, which is what makes
    global padding vs size-bucketed batches comparable in the simulator.

    ``inter_layer`` controls multi-layer scheduling: ``"barrier"`` (default)
    chains each level globally after every barrier of the previous one;
    ``"pipelined"`` relaxes *layer-boundary* levels to per-partition data
    dependencies — a next-layer sStream task waits only on (a) its own
    partition's dStream-pre task (accumulator handoff) and (b) the dStream
    drain tasks of the partitions producing its source vertices, matching
    the executed :class:`~repro.core.pipeline.PipelinedRunner` dataflow
    (source replicas read *drained* previous-layer values, so the drain
    compute of the producing partitions is a true dependency; each drain in
    turn waits only on its own partition's gather barrier).  Within a layer
    the strict chain is kept, so the two modes isolate exactly the
    inter-layer overlap.

    ``parts`` restricts the graph to the given destination partitions — the
    per-chip view of a sharded execution (one chip owns whole partitions,
    see :class:`~repro.core.tiling.ShardPlan`); boundary source-partition
    dependencies on partitions outside the set are cross-chip edges and are
    costed separately by ``simulator.simulate_sharded``.
    """
    if inter_layer not in ("barrier", "pipelined"):
        raise ValueError(f"unknown inter_layer mode {inter_layer!r}")
    pipelined = inter_layer == "pipelined"
    part_list = (list(range(tiles.n_dst_parts)) if parts is None
                 else [int(p) for p in parts])
    tasks: List[Task] = []
    stats = {"offchip_read": 0, "offchip_write": 0, "macs": 0, "elw_ops": 0}
    by = hw.dtype_bytes

    def _bind(instrs: List[Instr], n_src: int, n_edge: int, n_dst: int):
        out = []
        for ins in instrs:
            m, k, n = ins.bound(n_src, n_edge, n_dst)
            out.append((ins, m, k, n))
            if ins.unit == "MU":
                stats["macs"] += m * k * n
            elif ins.unit == "VU":
                stats["elw_ops"] += m * max(n, 1)
        return out

    src_parts = _source_partitions(tiles) if pipelined else None
    tid = 0
    prev_d: Optional[int] = None
    bar_prev: Dict[int, int] = {}   # partition -> its last d-task of lvl-1
    for lvl in sde.all_levels():
        s_t, e_t, d_t = sde.s.get(lvl, []), sde.e.get(lvl, []), sde.d.get(lvl, [])
        has_tile_work = bool(s_t or e_t)
        boundary = (pipelined and lvl > 0
                    and sde.layer_of(lvl) != sde.layer_of(lvl - 1))
        bar_cur: Dict[int, int] = {}
        d_pres: Dict[int, Task] = {}

        def emit_tiles(p: int):
            """s/e tasks + gather barrier for partition ``p`` at ``lvl``."""
            nonlocal tid, prev_d
            d_pre = d_pres[p]
            n_dst = int(tiles.part_size[p])
            e_tasks: List[int] = []
            for t in tiles.tiles_of_partition(p):
                ns, ne = int(tiles.n_src[t]), int(tiles.n_edge[t])
                if ne == 0 and tiles.sparse:
                    continue
                if padded:
                    ns, ne = tiles.padded_dims_of_tile(t)
                sdeps = [d_pre.tid]
                if boundary:
                    # source replicas read the DRAINED previous-layer values,
                    # so the producing partitions' drain tasks are the true
                    # dependency (each drain waits only on its own barrier)
                    sdeps += [d_pres[int(ps)].tid for ps in src_parts[t]
                              if int(ps) in d_pres and int(ps) != p]
                st = Task(tid, "s", _bind(s_t, ns, ne, n_dst), deps=sdeps,
                          bytes_in=ns * sde.src_load_dim * by,
                          label=f"s[{lvl}].{p}.{t}",
                          level=lvl, part=p, tile=int(t), role="s")
                tasks.append(st); tid += 1
                if getattr(sde, "layout", "coo") == "csr":
                    # CSR tile: one column index per edge plus the (n_dst+1)
                    # row-pointer vector, instead of the COO (src, dst) pair
                    eidx_bytes = ne * 4 + (n_dst + 1) * 4
                else:
                    eidx_bytes = ne * 8  # COO pair
                et = Task(tid, "e", _bind(e_t, ns, ne, n_dst), deps=[st.tid],
                          bytes_in=eidx_bytes + ne * sde.edge_feat_dim * by,
                          label=f"e[{lvl}].{p}.{t}",
                          level=lvl, part=p, tile=int(t), role="e")
                tasks.append(et); tid += 1
                e_tasks.append(et.tid)
            # gather barrier: next dStream step waits for all tiles of p
            barrier = Task(tid, "d", [], deps=e_tasks or [d_pre.tid],
                           bytes_out=(n_dst * sde.out_dim * by
                                      if lvl == sde.max_level - 1 or lvl == sde.max_level else 0),
                           label=f"dbar[{lvl}].{p}",
                           level=lvl, part=p, role="barrier")
            tasks.append(barrier); tid += 1
            prev_d = barrier.tid
            bar_cur[p] = barrier.tid

        # dStream "pre" part per (level, partition).  At a pipelined layer
        # boundary every partition's drain is created first (dep: only its
        # own previous barrier) so tile tasks can reference the drains of
        # the partitions producing their source values; otherwise tile tasks
        # interleave with the strict dStream chain as before.
        for p in part_list:
            n_dst = int(tiles.part_size[p])
            if boundary:
                deps = [bar_prev[p]] if p in bar_prev else []
            else:
                deps = [prev_d] if prev_d is not None else []
            d_pre = Task(tid, "d", _bind(d_t, 0, 0, n_dst), deps=deps,
                         bytes_in=n_dst * sde.dst_load_dim * by,
                         label=f"d[{lvl}].{p}",
                         level=lvl, part=p, role="drain")
            tasks.append(d_pre); tid += 1
            prev_d = d_pre.tid
            bar_cur[p] = d_pre.tid
            d_pres[p] = d_pre
            if not boundary and has_tile_work:
                emit_tiles(p)
        if boundary and has_tile_work:
            for p in part_list:
                emit_tiles(p)
        bar_prev = bar_cur

    for t in tasks:
        stats["offchip_read"] += t.bytes_in
        stats["offchip_write"] += t.bytes_out
    return tasks, stats
