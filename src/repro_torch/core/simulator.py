"""Event-driven, cycle-approximate simulator of the ZIPPER architecture
(paper §7, §8.1 "Performance Simulation").

Executes the stream task DAG from :mod:`repro.core.streams` against the
hardware resources: ``n_mu`` Matrix Units, ``n_vu`` Vector Units, one HBM
channel, and the s/e stream slots.  The two-level scheduling of the paper is
reproduced: a first-ready-first-serve scheduler admits tasks into stream
slots; a dispatcher issues each task's instructions to a free target unit
(FIFO per unit class).

Outputs: total cycles, per-unit busy cycles (utilization), off-chip traffic,
and the energy/area models of §8.1.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import math
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from .isa import Instr
from .streams import HWConfig, Task, build_task_graph, instr_cycles
from .isa import SDEFunctions
from .tiling import TileSet

# ---------------------------------------------------------------------------
# energy / area constants (paper §8.1 methodology)
# ---------------------------------------------------------------------------

ENERGY = {
    "mac_pj": 0.56,          # per MAC, 16 nm systolic synthesis class
    "vu_op_pj": 0.12,        # per SIMD lane-op
    "uem_pj_per_byte": 0.35, # eDRAM access (Cacti 6.5, converted to 16 nm)
    "th_pj_per_byte": 0.11,  # SRAM tile hub
    "offchip_pj_per_bit": 7.0,  # paper: 7 pJ/bit HBM
}

AREA_MM2 = {"MU": 1.00, "VU": 0.06, "UEM": 52.31, "TH": 0.15}  # paper Table 5


@dataclasses.dataclass
class SimResult:
    cycles: int
    time_ms: float
    unit_busy: Dict[str, int]
    utilization: Dict[str, float]
    offchip_read: int
    offchip_write: int
    macs: int
    elw_ops: int
    energy_mj: float
    n_tasks: int

    def speedup_over(self, other: "SimResult") -> float:
        return other.time_ms / self.time_ms


def area_mm2(hw: HWConfig) -> float:
    """Paper Table 5 composition for an arbitrary unit count."""
    return (AREA_MM2["MU"] * hw.n_mu + AREA_MM2["VU"] * hw.n_vu
            + AREA_MM2["UEM"] * hw.uem_mbytes / 21.0 + AREA_MM2["TH"])


def _energy_mj(stats: Dict[str, int], hw: HWConfig) -> float:
    onchip_bytes = (stats["macs"] * 2 + stats["elw_ops"] * 2) * hw.dtype_bytes
    pj = (stats["macs"] * ENERGY["mac_pj"]
          + stats["elw_ops"] * ENERGY["vu_op_pj"]
          + onchip_bytes * ENERGY["uem_pj_per_byte"]
          + (stats["offchip_read"] + stats["offchip_write"]) * 8 * ENERGY["offchip_pj_per_bit"])
    return pj * 1e-9  # pJ -> mJ


def simulate(tasks: List[Task], stats: Dict[str, int], hw: HWConfig) -> SimResult:
    """Discrete-event simulation with unit contention and stream slots."""
    n_tasks = len(tasks)
    indeg = [0] * n_tasks
    succs: List[List[int]] = [[] for _ in range(n_tasks)]
    for t in tasks:
        for d in t.deps:
            indeg[t.tid] += 1
            succs[d].append(t.tid)

    # resources: unit -> free count
    free = {"MU": hw.n_mu, "VU": hw.n_vu, "MEM": 1, "CTRL": 1 << 30}
    slots = {"s": hw.n_sstreams, "e": hw.n_estreams, "d": 1}
    busy = {"MU": 0, "VU": 0, "MEM": 0, "CTRL": 0}

    # per-task instruction programs: list of (unit, cycles)
    progs: List[List[Tuple[str, int]]] = []
    for t in tasks:
        prog: List[Tuple[str, int]] = []
        if t.bytes_in:
            prog.append(("MEM", max(1, int(t.bytes_in / hw.hbm_bytes_per_cycle))))
        for ins, m, k, n in t.instrs:
            ins2 = dataclasses.replace(ins, k=k, n=n)
            cyc = instr_cycles(ins2, m, hw)
            if cyc:
                prog.append((ins.unit, cyc))
        if t.bytes_out:
            prog.append(("MEM", max(1, int(t.bytes_out / hw.hbm_bytes_per_cycle))))
        if not prog:
            prog.append(("CTRL", 1))
        progs.append(prog)

    # event heap: (time, seq, kind, payload)
    heap: List[Tuple[int, int, str, tuple]] = []
    seq = 0
    # FIFOs: tasks awaiting a stream slot / (task, pc) awaiting a unit
    ready_q: Dict[str, Deque[int]] = {k: collections.deque() for k in ("s", "e", "d")}
    unit_q: Dict[str, Deque[Tuple[int, int]]] = {u: collections.deque() for u in free}
    pc = [0] * n_tasks

    def admit(tid_: int, now: int):
        """Try to put a ready task into a stream slot."""
        k = tasks[tid_].kind
        if slots[k] > 0:
            slots[k] -= 1
            issue(tid_, now)
        else:
            ready_q[k].append(tid_)

    def issue(tid_: int, now: int):
        """Dispatch the task's next instruction to its unit (or queue)."""
        nonlocal seq
        unit, cyc = progs[tid_][pc[tid_]]
        if free[unit] > 0:
            free[unit] -= 1
            busy[unit] += cyc
            heapq.heappush(heap, (now + cyc, seq, "instr_done", (tid_, unit, cyc)))
            seq += 1
        else:
            unit_q[unit].append((tid_, pc[tid_]))

    now = 0
    for t in tasks:
        if indeg[t.tid] == 0:
            admit(t.tid, 0)

    completed = 0
    while heap:
        now, _, ev, payload = heapq.heappop(heap)
        if ev != "instr_done":
            continue
        tid_, unit, _cyc = payload
        free[unit] += 1
        # feed a queued instruction into the freed unit (first-ready-first-serve)
        if unit_q[unit]:
            qtid, _qpc = unit_q[unit].popleft()
            free[unit] -= 1
            u2, cyc2 = progs[qtid][pc[qtid]]
            assert u2 == unit
            busy[unit] += cyc2
            # the global seq counter keeps re-issued events deterministically
            # ordered among same-cycle completions
            heapq.heappush(heap, (now + cyc2, seq, "instr_done", (qtid, unit, cyc2)))
            seq += 1
        pc[tid_] += 1
        if pc[tid_] < len(progs[tid_]):
            issue(tid_, now)
            continue
        # task complete: release stream slot, wake dependents
        completed += 1
        k = tasks[tid_].kind
        slots[k] += 1
        if ready_q[k]:
            admit(ready_q[k].popleft(), now)
        for s2 in succs[tid_]:
            indeg[s2] -= 1
            if indeg[s2] == 0:
                admit(s2, now)

    assert completed == n_tasks, f"deadlock: {completed}/{n_tasks} tasks done"
    total = max(now, 1)
    n_inst = {"MU": hw.n_mu, "VU": hw.n_vu, "MEM": 1}
    util = {u: busy[u] / (total * n_inst[u]) for u in ("MU", "VU", "MEM")}
    return SimResult(
        cycles=total,
        time_ms=total / (hw.freq_ghz * 1e6),
        unit_busy=dict(busy),
        utilization=util,
        offchip_read=stats["offchip_read"],
        offchip_write=stats["offchip_write"],
        macs=stats["macs"],
        elw_ops=stats["elw_ops"],
        energy_mj=_energy_mj(stats, hw),
        n_tasks=n_tasks,
    )


def simulate_model(sde: SDEFunctions, tiles: TileSet,
                   hw: Optional[HWConfig] = None,
                   padded: bool = False,
                   inter_layer: str = "barrier") -> SimResult:
    """``tiles`` may be a TileSet or BucketedTileSet; ``padded=True`` costs
    each tile at its batch's padded shape (see ``streams.build_task_graph``),
    so bucketed batching's reduced padding shows up as fewer cycles.
    ``inter_layer="pipelined"`` relaxes layer-boundary barriers to their true
    data dependencies (multi-layer programs), modeling the same overlap the
    fused multi-layer schedule exploits."""
    hw = hw or HWConfig()
    tasks, stats = build_task_graph(sde, tiles, hw, padded=padded,
                                    inter_layer=inter_layer)
    return simulate(tasks, stats, hw)


@dataclasses.dataclass
class ShardedSimResult:
    """Multi-chip cost model: per-chip event-driven simulation plus the
    layer-boundary exchange traffic (the one cross-chip all-gather of the
    drained partition layout per boundary)."""

    n_chips: int
    cycles: int                      # max per-chip cycles + exchange stalls
    time_ms: float
    per_chip_cycles: List[int]
    exchange_cycles: int             # total cycles spent in boundary exchanges
    exchange_bytes: int              # total cross-chip traffic
    n_exchanges: int
    chip_results: List[SimResult]
    exchange: str = "restricted"     # exchange cost model used
    model_axis: int = 1              # feature-axis mesh width (2-D mesh)
    edge_cut_rows: int = 0           # rows the restricted exchange ships/boundary

    def speedup_over(self, other) -> float:
        return other.time_ms / self.time_ms

    @property
    def balance(self) -> float:
        """max / mean per-chip cycles (1.0 = perfectly balanced)."""
        mean = sum(self.per_chip_cycles) / max(len(self.per_chip_cycles), 1)
        return max(self.per_chip_cycles) / max(mean, 1.0)


def _scale_sde_model(sde: SDEFunctions, m: int) -> SDEFunctions:
    """Column-parallel feature split for the 2-D mesh's ``model`` axis: each
    of ``m`` ranks computes a ``ceil(n / m)``-wide slice of every
    instruction's output lanes (contractions keep their full ``krows``) and
    loads/stores its slice of the vertex features."""
    def sdim(n: int) -> int:
        return max(1, -(-int(n) // m))

    def scale(bucket):
        return {lvl: [dataclasses.replace(i, n=sdim(i.n)) for i in instrs]
                for lvl, instrs in bucket.items()}

    return dataclasses.replace(
        sde, s=scale(sde.s), e=scale(sde.e), d=scale(sde.d),
        src_load_dim=sdim(sde.src_load_dim),
        dst_load_dim=sdim(sde.dst_load_dim), out_dim=sdim(sde.out_dim))


def simulate_sharded(sde: SDEFunctions, tiles: TileSet,
                     hw: Optional[HWConfig] = None, n_chips: int = 2,
                     padded: bool = False, inter_layer: str = "pipelined",
                     mode: str = "cost",
                     exchange_dim: Optional[int] = None,
                     exchange: str = "restricted",
                     model_axis: int = 1) -> ShardedSimResult:
    """Cost a sharded execution over ``n_chips`` chips, each owning whole
    destination partitions (:func:`~repro.core.tiling.plan_shards`).

    Each chip's task graph (its partitions only) runs through the
    event-driven simulator independently; chips synchronize at the
    ``n_layers - 1`` layer boundaries.  Per-boundary drained widths come
    from the static exchange census (``sde.boundary_dims``) so stacks with
    mixed hidden widths cost each boundary its own width;
    ``exchange_dim`` overrides them all, and the pre-census fallback is
    ``max(src_load_dim, out_dim)``.  Final outputs are written to each
    chip's own HBM (already costed as task ``bytes_out``), so they add no
    exchange.

    ``exchange`` picks the boundary-collective cost model:

    * ``"restricted"`` — the neighbor-restricted exchange: each shard ships
      only the rows remote shards' gather blocks actually read
      (:func:`~repro.core.tiling.exchange_sets`), costed by actual cut
      bytes; per-boundary cycles are the busiest chip's max of send/recv
      bytes over the link bandwidth.
    * ``"allgather"`` — the concat all-gather baseline: every chip receives
      every row (ring model: each link carries ``(K-1)/K`` of the buffer).

    ``model_axis=M > 1`` grows the mesh to 2-D ``("shards", "model")`` for
    wide hidden dims: per-chip compute and the shards-axis exchange width
    shrink to the rank's ``ceil(width / M)`` feature slice, and each
    boundary additionally pays a model-axis gather reassembling full-width
    rows for the next layer's contraction.
    """
    from .tiling import exchange_sets, plan_shards

    if model_axis < 1:
        raise ValueError(f"model_axis must be >= 1, got {model_axis}")
    hw = hw or HWConfig()
    plan = plan_shards(tiles, n_chips, mode=mode)
    sde_rank = _scale_sde_model(sde, model_axis) if model_axis > 1 else sde
    chips: List[SimResult] = []
    for k in range(n_chips):
        tasks, stats = build_task_graph(sde_rank, tiles, hw, padded=padded,
                                        inter_layer=inter_layer,
                                        parts=plan.parts_of_shard[k])
        chips.append(simulate(tasks, stats, hw))

    K, M = n_chips, model_axis
    n_exch = max(sde.n_layers - 1, 0) if (K > 1 or M > 1) else 0
    fallback = max(max(sde.src_load_dim, sde.out_dim), 1)
    if exchange_dim is not None:
        widths = [max(int(exchange_dim), 1)] * n_exch
    elif len(sde.boundary_dims) == n_exch:
        widths = [max(int(w), 1) for w in sde.boundary_dims]
    else:
        widths = [fallback] * n_exch
    rows = int(tiles.part_size.sum())
    ex = exchange_sets(tiles, plan) if (K > 1 and exchange == "restricted") \
        else None
    if K > 1 and exchange not in ("restricted", "allgather"):
        raise ValueError(f"unknown exchange cost model {exchange!r}")
    bw = hw.interconnect_bytes_per_cycle
    exch_cycles = 0
    exch_bytes = 0
    for w in widths:
        wm = max(1, -(-w // M))                  # per-rank feature slice
        if ex is not None:
            out_b = ex.pair_rows.sum(axis=1) * wm * hw.dtype_bytes
            in_b = ex.pair_rows.sum(axis=0) * wm * hw.dtype_bytes
            busiest = int(np.maximum(out_b, in_b).max()) if K > 1 else 0
            exch_cycles += int(math.ceil(busiest / bw))
            exch_bytes += ex.cut_rows * wm * hw.dtype_bytes * M
        elif K > 1:
            full = rows * wm * hw.dtype_bytes
            exch_cycles += int(math.ceil(full * (K - 1) / K / bw))
            exch_bytes += full * (K - 1) * M
        if M > 1:
            # model-axis reassembly: each rank gathers the other (M-1)
            # slices of every row it will read next layer (all rows under
            # all-gather; own + received rows under the restricted exchange)
            if ex is not None:
                need = np.bincount(ex.owner_of_row, minlength=K).astype(
                    np.int64) + ex.pair_rows.sum(axis=0)
                need_max = int(need.max())
            else:
                need_max = rows
            mbytes = need_max * (w - wm) * hw.dtype_bytes
            exch_cycles += int(math.ceil(mbytes * (M - 1) / M / bw))
            exch_bytes += mbytes * K * M

    total = max(c.cycles for c in chips) + exch_cycles
    return ShardedSimResult(
        n_chips=n_chips, cycles=total,
        time_ms=total / (hw.freq_ghz * 1e6),
        per_chip_cycles=[c.cycles for c in chips],
        exchange_cycles=exch_cycles,
        exchange_bytes=int(exch_bytes),
        n_exchanges=n_exch, chip_results=chips,
        exchange=exchange if K > 1 else "local",
        model_axis=model_axis,
        edge_cut_rows=(ex.cut_rows if ex is not None else 0))


def serialized_baseline(sde: SDEFunctions, tiles: TileSet,
                        hw: Optional[HWConfig] = None,
                        padded: bool = False) -> SimResult:
    """Non-pipelined tiling baseline (paper Fig 4b): one stream of each kind,
    so tiles are processed strictly one after another."""
    hw = (hw or HWConfig()).scaled(n_sstreams=1, n_estreams=1)
    tasks, stats = build_task_graph(sde, tiles, hw, padded=padded)
    # serialize: chain every task after the previous one
    for i in range(1, len(tasks)):
        if i - 1 not in tasks[i].deps:
            tasks[i].deps.append(i - 1)
    return simulate(tasks, stats, hw)
