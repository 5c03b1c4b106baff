"""Schedule hazard analysis + static exchange census (ISSUE 6 pass 3).

``analyze_task_graph`` is a static race detector over the stream-task DAG
from :func:`repro.core.streams.build_task_graph`: it proves every
cross-tile / cross-layer read is *ordered after its producing drain task*
through dependency edges alone.  In ``inter_layer="barrier"`` mode that is
the global property (every task of level ``l`` descends from every
level-``l-1`` gather barrier); in ``"pipelined"`` mode the layer boundary
is relaxed to true data dependencies, so the analyzer re-derives — from the
tile set, independently of the builder — which partitions produce each
tile's source vertices and demands exactly those drains as ancestors.

``exchange_census`` re-implements the :class:`ShardedRunner` publish-set
derivation (gather-tainted tile-side reads) *statically* from the
:class:`ScheduledProgram` and counts the collectives a sharded execution
must issue — exactly ``n_layers`` for the paper models — replacing the
regex-over-HLO census as the first-line check.  The derivation covers both
schedule variants: kernel gathers drain into the same per-phase ``publish``
call as scan gathers (their ``src_value_id`` tile reads and receive
accumulators enter ``reads`` identically), so the census invariant holds
with Pallas kernel dispatch on or off.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import schedule as S
from ..streams import Task
from .diagnostics import Diagnostic


# ---------------------------------------------------------------------------
# task-graph hazard analysis
# ---------------------------------------------------------------------------

def _tile_source_parts(tiles) -> List[np.ndarray]:
    """Per flattened tile, the destination partitions owning its source
    vertices — re-derived here so the analyzer never trusts the builder's
    ``_source_partitions``."""
    def one(ts) -> List[np.ndarray]:
        return [np.unique(np.searchsorted(
                    ts.part_start, ts.src_ids[t, :int(ts.n_src[t])],
                    side="right") - 1)
                for t in range(ts.n_tiles)]
    if hasattr(tiles, "buckets"):
        return [ps for b in tiles.buckets for ps in one(b)]
    return one(tiles)


def analyze_task_graph(tasks: Sequence[Task], *, sde=None, tiles=None,
                       inter_layer: str = "barrier",
                       parts: Optional[Sequence[int]] = None
                       ) -> List[Diagnostic]:
    """Static race detection over a stream-task DAG.

    ``sde`` (the :class:`~repro.core.isa.SDEFunctions` the graph was built
    from) supplies the level→layer map for boundary detection; ``tiles``
    supplies the source-partition ground truth for the pipelined checks.
    Without them only the structural (ZH202) and barrier-coverage (ZH203)
    checks run.
    """
    diags: List[Diagnostic] = []
    by_tid: Dict[int, Task] = {}

    # --- ZH202: structural validity (unique tids, backward-only deps) ------
    for t in tasks:
        if t.tid in by_tid:
            diags.append(Diagnostic(
                "ZH202", f"task id {t.tid} used twice ({by_tid[t.tid].label}"
                         f" and {t.label})", block=t.label, origin="hazard"))
        by_tid[t.tid] = t
    for t in tasks:
        for d in t.deps:
            if d not in by_tid:
                diags.append(Diagnostic(
                    "ZH202", f"dep {d} does not exist", block=t.label,
                    origin="hazard"))
            elif d >= t.tid:
                diags.append(Diagnostic(
                    "ZH202", f"dep {d} ({by_tid[d].label}) is not older "
                             f"than this task", block=t.label,
                    origin="hazard"))
    if any(d.code == "ZH202" for d in diags):
        return diags  # ancestor closure needs a sane DAG

    # ancestor closure as bitmasks over tid order (tasks arrive toposorted
    # by construction; ZH202 above guaranteed deps point backwards)
    anc: Dict[int, int] = {}
    for t in sorted(tasks, key=lambda t: t.tid):
        m = 0
        for d in t.deps:
            m |= anc[d] | (1 << d)
        anc[t.tid] = m

    def ordered_after(t: Task, producer_tid: int) -> bool:
        return bool(anc[t.tid] >> producer_tid & 1)

    # --- ZH203: every gather barrier covers its partition's e-tasks --------
    e_of: Dict[Tuple[int, int], List[Task]] = {}
    for t in tasks:
        if t.role == "e":
            e_of.setdefault((t.level, t.part), []).append(t)
    for t in tasks:
        if t.role != "barrier":
            continue
        missing = [e.tid for e in e_of.get((t.level, t.part), [])
                   if not ordered_after(t, e.tid)]
        if missing:
            diags.append(Diagnostic(
                "ZH203", f"barrier does not cover tile task(s) "
                         f"{[by_tid[m].label for m in missing]}",
                phase=t.level, block=t.label, origin="hazard"))

    # per (level, part): the LAST d-kind task — the handle the next level's
    # reads must be ordered after (the barrier when the level has tile work,
    # else the drain itself)
    last_d: Dict[Tuple[int, int], Task] = {}
    drain_of: Dict[Tuple[int, int], Task] = {}
    for t in tasks:
        if t.kind != "d":
            continue
        key = (t.level, t.part)
        if key not in last_d or t.tid > last_d[key].tid:
            last_d[key] = t
        if t.role == "drain":
            drain_of[key] = t
    levels = sorted({t.level for t in tasks})

    if inter_layer == "barrier":
        # --- global property: level l descends from EVERY level-(l-1)
        # barrier (the classic layer-by-layer chain) -----------------------
        for li, lvl in enumerate(levels[1:], start=1):
            prev = [d for (L, _), d in last_d.items() if L == levels[li - 1]]
            for t in tasks:
                if t.level != lvl:
                    continue
                for b in prev:
                    if not ordered_after(t, b.tid):
                        diags.append(Diagnostic(
                            "ZH201", f"not ordered after level-{b.level} "
                                     f"barrier {b.label}", phase=t.level,
                            block=t.label, origin="hazard"))
        return diags

    # --- pipelined: layer boundaries relaxed to data dependencies ----------
    if sde is None:
        return diags
    boundaries = {lvl for i, lvl in enumerate(levels)
                  if i > 0 and sde.layer_of(lvl) != sde.layer_of(levels[i - 1])}
    src_parts = _tile_source_parts(tiles) if tiles is not None else None
    part_set = ({t.part for t in tasks if t.part >= 0}
                if parts is None else {int(p) for p in parts})
    cross_chip = 0

    for t in tasks:
        if t.level not in boundaries:
            continue
        if t.role == "drain":
            # accumulator handoff: the drain reads its OWN partition's
            # previous-layer gather result
            prev_lvl = levels[levels.index(t.level) - 1]
            prod = last_d.get((prev_lvl, t.part))
            if prod is not None and not ordered_after(t, prod.tid):
                diags.append(Diagnostic(
                    "ZH201", f"boundary drain not ordered after its own "
                             f"partition's barrier {prod.label}",
                    phase=t.level, block=t.label, origin="hazard"))
        elif t.role == "s" and src_parts is not None:
            # cross-tile/cross-layer read: source replicas read DRAINED
            # previous-layer values of the partitions that produce them
            need = {int(q) for q in src_parts[t.tile]}
            cross_chip += len(need - part_set)
            for q in sorted(need & part_set):
                prod = drain_of.get((t.level, q))
                if prod is None:
                    diags.append(Diagnostic(
                        "ZH201", f"no drain task for producing partition "
                                 f"{q} at level {t.level}", phase=t.level,
                        block=t.label, origin="hazard"))
                elif not ordered_after(t, prod.tid):
                    diags.append(Diagnostic(
                        "ZH201", f"reads partition {q}'s drained values "
                                 f"but is not ordered after {prod.label}",
                        phase=t.level, block=t.label, origin="hazard"))
    if cross_chip:
        diags.append(Diagnostic(
            "ZH206", f"{cross_chip} boundary source-partition read(s) "
                     f"fall outside this chip's partitions; they are "
                     f"covered by the inter-chip exchange", origin="hazard"))
    return diags


# ---------------------------------------------------------------------------
# static exchange census
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExchangeCensus:
    """What a sharded execution of this program must exchange.

    ``events`` are the individual ``publish()`` calls the runner traces (one
    ``jax.lax.all_gather`` each).  ``n_collectives`` counts them *after*
    merging adjacent events with no tile work in between: a layer boundary
    drains the gather result at the end of phase ``L`` and the dst store at
    the start of phase ``L+1`` back to back, both reading only device-local
    state, so XLA's all-gather combiner folds them into ONE collective in
    the lowered HLO — exactly one per layer boundary, ``n_layers`` total.
    """

    n_collectives: int                       # merged all-gathers per forward
    publish: FrozenSet[int]                  # vertex node ids exchanged
    tainted: FrozenSet[int]                  # gather-tainted vertex nodes
    #: (phase level, "dst"|"gather", ids drained by that publish call)
    events: Tuple[Tuple[int, str, Tuple[int, ...]], ...]
    #: vertex node ids drained per *merged* collective, in execution order
    #: (len == n_collectives); the last group is the output drain, the rest
    #: are layer boundaries — the simulator takes per-boundary widths here
    groups: Tuple[Tuple[int, ...], ...] = ()


def exchange_census(sp: S.ScheduledProgram) -> ExchangeCensus:
    """Re-derive :meth:`ShardedRunner._publish_ids` and the per-phase
    publish calls statically from the scheduled program."""
    tainted: Set[int] = set()
    for seg in sp.prog.vertex_segments():
        for n in seg.toposort():
            if n.op == "recvInEdge" or any(i in tainted for i in n.inputs):
                tainted.add(n.id)

    node_op = {n.id: n.op for seg in sp.prog.segments
               for n in seg.nodes.values()}
    reads: Set[int] = set(sp.outputs)
    for ph in sp.phases:
        for n in ph.src.nodes:
            reads.update(n.inputs)
        for g in ph.gathers:
            if g.src_value_id is not None:
                reads.add(g.src_value_id)
    for rnid, vnid in sp.scatter_value_of.items():
        if node_op.get(rnid) == "recvSrc":
            reads.add(vnid)
    publish = ((reads & tainted) | set(sp.outputs)) \
        - {nid for nid, _ in sp.vertex_inputs}

    # replay the runner's publish() call sites in execution order; a "work"
    # marker between two publishes keeps them in separate combiner groups
    stream: List[object] = []
    for ph in sp.phases:
        drained = tuple(sorted(set(ph.dst.store_ids) & publish))
        if drained:
            stream.append((ph.level, "dst", drained))
        if ph.has_tile_work:
            stream.append("work")
            drained = tuple(sorted(
                {g.acc.recv_id for g in ph.gathers} & publish))
            if drained:
                stream.append((ph.level, "gather", drained))
    events = tuple(ev for ev in stream if ev != "work")
    groups: List[Tuple[int, ...]] = []
    prev_was_pub = False
    for ev in stream:
        if ev == "work":
            prev_was_pub = False
        else:
            ids = ev[2]
            if not prev_was_pub:
                groups.append(tuple(ids))
            else:
                groups[-1] = groups[-1] + tuple(ids)
            prev_was_pub = True
    return ExchangeCensus(n_collectives=len(groups),
                          publish=frozenset(publish),
                          tainted=frozenset(tainted), events=events,
                          groups=tuple(groups))


def verify_exchange(sp: S.ScheduledProgram, *, tiles=None, plan=None,
                    n_shards: Optional[int] = None,
                    mode: str = "mincut") -> List[Diagnostic]:
    """ZH204/ZH205: the census must come out at exactly one collective per
    layer (the boundary drains, plus the final output drain), and nothing
    untainted may ride the exchange (it would be recomputed locally).

    With ``tiles`` (plus either a :class:`~repro.core.tiling.ShardPlan` or
    ``n_shards``/``mode`` to build one) the pass additionally proves the
    *neighbor-restricted* exchange covers every read the sharded runner
    performs: each cross-shard gather-source read must appear in its owning
    shard's send set (ZH207), every ``recvDst`` accumulator row must be
    device-local under the plan (ZH208), and send sets must hold only rows
    their shard owns (ZH209).  A clean proof is recorded as a ZH210 info
    with the cut-vs-all-gather row counts.  The read sets are re-derived
    per tile with explicit ``n_src`` slicing — a deliberately different
    code path from :func:`repro.core.tiling.exchange_sets`, so the checker
    never trusts the builder it is checking.
    """
    census = exchange_census(sp)
    diags: List[Diagnostic] = []
    if census.n_collectives != sp.n_layers:
        where = [f"phase {lvl} ({kind}: {list(ids)})"
                 for lvl, kind, ids in census.events]
        diags.append(Diagnostic(
            "ZH204", f"{census.n_collectives} collective(s) after combiner "
                     f"grouping != {sp.n_layers} layer(s): {where}",
            origin="census"))
    for nid in sorted(census.publish - census.tainted):
        diags.append(Diagnostic(
            "ZH205", f"exchanged value %{nid} is not gather-tainted; "
                     f"source replicas could recompute it locally",
            node=nid, origin="census"))
    if tiles is not None:
        diags += _verify_exchange_coverage(tiles, plan=plan,
                                           n_shards=n_shards, mode=mode)
    return diags


_MAX_COVERAGE_DIAGS = 8      # cap per-code emission; totals go in the message


def _verify_exchange_coverage(tiles, *, plan=None,
                              n_shards: Optional[int] = None,
                              mode: str = "mincut") -> List[Diagnostic]:
    """Statically prove the restricted exchange covers every sharded read."""
    from ..tiling import BucketedTileSet, exchange_sets, plan_shards

    if plan is None:
        if n_shards is None:
            raise ValueError(
                "exchange coverage proof needs plan= or n_shards=")
        plan = plan_shards(tiles, n_shards, mode=mode)
    ex = exchange_sets(tiles, plan)
    K = plan.n_shards
    part_start = np.asarray(tiles.part_start)
    part_size = np.asarray(tiles.part_size)
    send_sets = [frozenset(map(int, rows)) for rows in ex.send_rows]
    diags: List[Diagnostic] = []

    # ZH208 (plan side): every partition must be assigned to exactly one
    # shard, consistently between parts_of_shard and shard_of_part — else a
    # recvDst accumulator would be gathered on one device and read on another
    seen_parts: Set[int] = set()
    for k, ps in enumerate(plan.parts_of_shard):
        for p in map(int, ps):
            if p in seen_parts or int(plan.shard_of_part[p]) != k:
                diags.append(Diagnostic(
                    "ZH208", f"partition {p} assignment inconsistent: listed "
                             f"under shard {k} but owned by shard "
                             f"{int(plan.shard_of_part[p])}",
                    origin="census"))
            seen_parts.add(p)

    # ZH209: a shard's send set may hold only rows it owns (ownership
    # re-derived from the destination partition ranges)
    n209 = 0
    for k, rows in enumerate(ex.send_rows):
        if len(rows) == 0:
            continue
        owner = plan.shard_of_part[
            np.searchsorted(part_start, rows, side="right") - 1]
        bad = owner != k
        for r, o in zip(map(int, np.asarray(rows)[bad]),
                        map(int, owner[bad])):
            n209 += 1
            if n209 <= _MAX_COVERAGE_DIAGS:
                diags.append(Diagnostic(
                    "ZH209", f"shard {k} send set holds row {r} owned by "
                             f"shard {o}", origin="census"))

    # ZH207/ZH208 (tile side): walk every tile with explicit n_src/n_edge
    # slicing and demand each cross-shard source read is in the owner's
    # send set, and each dst accumulator offset stays inside the partition
    n207 = n208 = 0
    cross_slots = 0

    def walk(ts) -> None:
        nonlocal n207, n208, cross_slots
        part_id = np.asarray(ts.part_id)
        for t in range(ts.n_tiles):
            p = int(part_id[t])
            k = int(plan.shard_of_part[p])
            ne = int(ts.n_edge[t])
            if ne:
                off = np.asarray(ts.edge_dst[t, :ne])
                bad = off[(off < 0) | (off >= int(part_size[p]))]
                for o in map(int, bad[:_MAX_COVERAGE_DIAGS]):
                    n208 += 1
                    if n208 <= _MAX_COVERAGE_DIAGS:
                        diags.append(Diagnostic(
                            "ZH208", f"tile {t} dst offset {o} escapes "
                                     f"partition {p} (size "
                                     f"{int(part_size[p])}); its recvDst "
                                     f"row is not local to shard {k}",
                            block="dst", origin="census"))
            rows = np.asarray(ts.src_ids[t, :int(ts.n_src[t])])
            owners = plan.shard_of_part[
                np.searchsorted(part_start, rows, side="right") - 1]
            remote = owners != k
            cross_slots += int(remote.sum())
            for r, o in zip(map(int, rows[remote]), map(int, owners[remote])):
                if r not in send_sets[o]:
                    n207 += 1
                    if n207 <= _MAX_COVERAGE_DIAGS:
                        diags.append(Diagnostic(
                            "ZH207", f"shard {k} reads row {r} owned by "
                                     f"shard {o} but the row is missing "
                                     f"from shard {o}'s send set",
                            block="gather", origin="census"))

    if isinstance(tiles, BucketedTileSet):
        for b in tiles.buckets:
            walk(b)
    else:
        walk(tiles)

    for code, n in (("ZH207", n207), ("ZH208", n208), ("ZH209", n209)):
        if n > _MAX_COVERAGE_DIAGS:
            diags.append(Diagnostic(
                code, f"... {n - _MAX_COVERAGE_DIAGS} further finding(s) "
                      f"of this code suppressed ({n} total)",
                origin="census"))
    if n207 == n208 == n209 == 0 and not diags:
        allgather_rows = tiles.n_vertices * max(0, K - 1)
        diags.append(Diagnostic(
            "ZH210", f"restricted-exchange coverage proven for "
                     f"{plan.mode!r} plan over {K} shard(s): "
                     f"{cross_slots} cross-shard read slot(s) covered by "
                     f"{ex.cut_rows} shipped row(s)/boundary "
                     f"(all-gather would ship {allgather_rows})",
            origin="census"))
    return diags
