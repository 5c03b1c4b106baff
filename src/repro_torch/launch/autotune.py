"""Schedule-aware tile autotuner (paper follow-up: the tiling/partition
configuration is a first-class performance lever, searched per graph class
rather than fixed).

Searches the tile-config lattice — grid (``n_dst_parts`` x ``n_src_parts``)
x ``n_buckets`` x shard count x vertex ``reorder`` (identity / degree,
paper §5.3) x within-tile edge ``layout`` (COO / CSR) — for one compiled
program over a representative graph of a class.  The harness repurposes the
``launch/hillclimb.py`` pattern (variant -> scored JSON-able record,
deltas against a baseline) for this lattice:

1. the *cheap objective* is :func:`~repro.core.simulator.simulate_sharded`'s
   padded cost model over the **kernel-dispatch** schedule (``padded=True``
   charges what the padded tile batch actually executes, which is what the
   config controls);
2. a greedy hill-climb walks one ladder step per dimension from the default
   config, keeping every evaluated trial;
3. the top candidates are *confirmed by wall clock* on the real runner
   (cheap-model ranking decides the search, measured time decides the
   winner among the finalists);
4. the winner lands in a :class:`TuneCache` keyed by program structure +
   graph class, with the realized shard-layout signature recorded for
   provenance — the serving engine consults the cache per size class and
   routes large requests onto the tuned config.

Pure library: no XLA flags are touched at import (unlike the dryrun
hillclimb driver, which forces a 512-device host platform), so it is safe
to import from tests and the serving engine.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import compiler as C
from ..core import isa
from ..core import tiling
from ..core.simulator import simulate_sharded
from ..core.streams import HWConfig
from ..gnn.graphs import Graph

#: ladder per search dimension — one hill-climb step moves to the adjacent
#: rung; powers of two keep every visited config cache-quantization-friendly
_PART_LADDER = (2, 4, 8, 16, 32, 64)
_BUCKET_LADDER = (1, 2, 4, 8)
_SHARD_LADDER = (1, 2, 4, 8)
#: categorical dimensions — the hill-climb move set offers a toggle to every
#: other choice (paper §5.3 degree sorting; CSR-within-tile edge storage)
_REORDER_CHOICES = ("identity", "degree")
_LAYOUT_CHOICES = ("coo", "csr")
_SHARD_MODE_CHOICES = ("cost", "mincut")


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One point of the search lattice."""
    n_dst_parts: int = 8
    n_src_parts: int = 8
    n_buckets: int = 4
    n_shards: int = 1
    #: vertex order fed to the tiler ("identity" | "degree")
    reorder: str = "identity"
    #: within-tile edge storage ("coo" | "csr")
    layout: str = "coo"
    #: shard planner ("cost" LPT | "mincut" locality refinement)
    shard_mode: str = "cost"

    def __post_init__(self):
        if self.reorder not in _REORDER_CHOICES:
            raise ValueError(f"unknown reorder mode {self.reorder!r}")
        if self.layout not in _LAYOUT_CHOICES:
            raise ValueError(f"unknown tile layout {self.layout!r}")
        if self.shard_mode not in _SHARD_MODE_CHOICES:
            raise ValueError(f"unknown shard mode {self.shard_mode!r}")

    def key(self) -> Tuple[int, int, int, int, str, str, str]:
        """Hashable identity used to dedupe trials during the search."""
        return (self.n_dst_parts, self.n_src_parts,
                self.n_buckets, self.n_shards, self.reorder, self.layout,
                self.shard_mode)

    def to_dict(self) -> Dict[str, object]:
        """JSON-able field dict (inverse of :meth:`from_dict`)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "TileConfig":
        """Rebuild a config from :meth:`to_dict` output.  Numeric fields are
        coerced to int so JSON round-trips are exact; the categorical
        reorder/layout fields stay strings.  Records written before those
        fields existed load with their defaults (identity/COO — exactly what
        those tunings searched)."""
        vals: Dict[str, object] = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            vals[f.name] = str(v) if isinstance(f.default, str) else int(v)
        return cls(**vals)


@dataclasses.dataclass
class Trial:
    """One evaluated config: simulated cycles always, wall clock only for
    confirmed finalists."""
    config: TileConfig
    cycles: int
    balance: float
    exchange_cycles: int
    wall_s: Optional[float] = None

    def to_dict(self) -> Dict:
        """JSON-able record of the trial (config nested via its own dict)."""
        return dict(config=self.config.to_dict(), cycles=self.cycles,
                    balance=self.balance,
                    exchange_cycles=self.exchange_cycles,
                    wall_s=self.wall_s)


@dataclasses.dataclass
class TuneResult:
    """Outcome of one :func:`autotune` run: the winner plus the full
    evaluated-trial record (for reports and for re-ranking offline)."""
    best: Trial
    trials: List[Trial]            # every config the search evaluated
    confirmed: List[Trial]         # finalists with wall_s measured
    n_evals: int

    def to_dict(self) -> Dict:
        """JSON-able report payload (all trials serialized)."""
        return dict(best=self.best.to_dict(), n_evals=self.n_evals,
                    trials=[t.to_dict() for t in self.trials],
                    confirmed=[t.to_dict() for t in self.confirmed])


def build_tiles(graph: Graph, cfg: TileConfig):
    """The tile batch a config realizes (optional degree reorder + sparse
    grid tiling in the config's edge layout + bucketing).  Returns
    ``(tiles, reordering)``; run against ``reordering.graph`` and permute
    vertex IO through the :class:`~repro.core.reorder.Reordering`."""
    return tiling.build_tiles(
        graph, cfg.n_dst_parts, cfg.n_src_parts, sparse=True,
        reorder=cfg.reorder, layout=cfg.layout,
        n_buckets=cfg.n_buckets if cfg.n_buckets > 1 else None)


def padded_cost(compiled: C.CompiledGNN, graph: Graph, cfg: TileConfig,
                hw: Optional[HWConfig] = None,
                kernel_dispatch: bool = True) -> Trial:
    """Cheap objective: simulated padded cycles of the (kernel-dispatch)
    schedule under this config's tile batch and shard count.  The SDE
    templates are emitted for the config's edge layout, so CSR trials are
    costed with the E-proportional gather model rather than the dense
    per-tile matmul."""
    sde = isa.emit_sde(compiled.schedule(kernel_dispatch), layout=cfg.layout)
    tiles, _ = build_tiles(graph, cfg)
    r = simulate_sharded(sde, tiles, hw or HWConfig(), n_chips=cfg.n_shards,
                         padded=True, mode=cfg.shard_mode)
    return Trial(config=cfg, cycles=int(r.cycles), balance=float(r.balance),
                 exchange_cycles=int(r.exchange_cycles))


def _step(ladder: Sequence[int], value: int, direction: int,
          cap: Optional[int] = None) -> Optional[int]:
    if value not in ladder:
        return None
    i = ladder.index(value) + direction
    if not 0 <= i < len(ladder):
        return None
    nxt = ladder[i]
    return nxt if cap is None or nxt <= cap else None


def neighbors(cfg: TileConfig, graph: Graph, max_shards: int = 8,
              kernel_dispatch: bool = True) -> List[TileConfig]:
    """One ladder step in each dimension and direction plus one toggle per
    categorical dimension (the hill-climb move set).  Grid dimensions are
    capped by the vertex count so a tiny class can't tile onto more
    partitions than vertices.  The CSR layout toggle is only offered for
    kernel-dispatch schedules — the scan engine consumes the dense per-tile
    adjacency that CSR storage deliberately drops."""
    out: List[TileConfig] = []
    pcap = max(2, graph.n_vertices)
    for d in (-1, 1):
        for field, ladder, cap in (
                ("n_dst_parts", _PART_LADDER, pcap),
                ("n_src_parts", _PART_LADDER, pcap),
                ("n_buckets", _BUCKET_LADDER, None),
                ("n_shards", _SHARD_LADDER, max_shards)):
            nxt = _step(ladder, getattr(cfg, field), d, cap)
            if nxt is not None:
                out.append(dataclasses.replace(cfg, **{field: nxt}))
    toggles = [("reorder", _REORDER_CHOICES)]
    if kernel_dispatch:
        toggles.append(("layout", _LAYOUT_CHOICES))
    if cfg.n_shards > 1:
        # the planner only matters on a real mesh: single-shard configs
        # keep one canonical key instead of two aliased lattice points
        toggles.append(("shard_mode", _SHARD_MODE_CHOICES))
    for field, choices in toggles:
        for alt in choices:
            if alt != getattr(cfg, field):
                out.append(dataclasses.replace(cfg, **{field: alt}))
    return out


def hillclimb(compiled: C.CompiledGNN, graph: Graph,
              start: Optional[TileConfig] = None, *,
              hw: Optional[HWConfig] = None, max_evals: int = 48,
              max_shards: int = 8,
              kernel_dispatch: bool = True) -> List[Trial]:
    """Greedy deterministic hill-climb over the config lattice.

    From ``start`` (default :class:`TileConfig`), evaluates every neighbor,
    moves to the best strict improvement, repeats until a local optimum or
    ``max_evals`` simulator calls.  Returns ALL evaluated trials sorted by
    cycles ascending (ties broken by config key, so the ranking is stable).
    """
    hw = hw or HWConfig()
    seen: Dict[Tuple, Trial] = {}

    def ev(cfg: TileConfig) -> Trial:
        """Evaluate a config once; repeat lookups are free."""
        if cfg.key() not in seen:
            seen[cfg.key()] = padded_cost(compiled, graph, cfg, hw,
                                          kernel_dispatch)
        return seen[cfg.key()]

    cur = ev(start or TileConfig())
    while len(seen) < max_evals:
        cand = [ev(n)
                for n in neighbors(cur.config, graph, max_shards,
                                   kernel_dispatch=kernel_dispatch)
                if len(seen) < max_evals or n.key() in seen]
        better = [t for t in cand if t.cycles < cur.cycles]
        if not better:
            break
        cur = min(better, key=lambda t: (t.cycles, t.config.key()))
    return sorted(seen.values(), key=lambda t: (t.cycles, t.config.key()))


def confirm_wallclock(compiled: C.CompiledGNN, graph: Graph,
                      trials: Sequence[Trial],
                      inputs: Dict, params: Dict, *, top: int = 2,
                      repeats: int = 3,
                      kernel_dispatch: bool = True,
                      device=None, devices=None) -> List[Trial]:
    """Measure the real runner on the ``top`` cheapest trials (median of
    ``repeats`` after a warmup call) on ``device`` (``cuda`` unless named)
    and attach ``wall_s`` in place.  On a card each call is timed by a pair
    of CUDA events recorded around it after a synchronize (the stream's
    span, host gaps included); on the CPU by ``time.perf_counter``.  Shard
    counts are clamped to the mesh ``devices`` (the visible cards, or
    ``[device]`` off CUDA, unless named) — the simulator may legitimately
    prefer an 8-chip layout the host cannot realize; a finalist with more
    than one shard runs a ``ShardedRunner`` over the mesh."""
    import torch

    from ..convert import to_device
    from ..core.exchange import default_devices
    from ..core.pipeline import PipelinedRunner, ShardedRunner
    from ..device import resolve

    dev = resolve(device)
    devices = (default_devices(dev) if devices is None
               else [torch.device(d) for d in devices])
    inputs = {k: to_device(v, dev) for k, v in inputs.items()}
    params = {k: to_device(v, dev) for k, v in params.items()}
    confirmed: List[Trial] = []
    with torch.inference_mode():    # timing records no autograd graph
        for t in list(trials)[:max(1, top)]:
            cfg = t.config
            tiles, ro = build_tiles(graph, cfg)
            n_dev = min(cfg.n_shards, len(devices))
            if n_dev > 1:
                runner = ShardedRunner(compiled, ro.graph, tiles, n_dev,
                                       mode=cfg.shard_mode, devices=devices,
                                       kernel_dispatch=kernel_dispatch,
                                       reordering=ro, device=dev)
            else:
                runner = PipelinedRunner(compiled, ro.graph, tiles,
                                         kernel_dispatch=kernel_dispatch,
                                         reordering=ro, device=dev)
            runner(inputs, params)                               # bind + warm
            times = []
            for _ in range(max(1, repeats)):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    runner(inputs, params)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    runner(inputs, params)
                    times.append(time.perf_counter() - t0)
            t.wall_s = float(np.median(times))
            confirmed.append(t)
    return confirmed


def autotune(compiled: C.CompiledGNN, graph: Graph, *,
             inputs: Optional[Dict] = None, params: Optional[Dict] = None,
             start: Optional[TileConfig] = None, hw: Optional[HWConfig] = None,
             max_evals: int = 48, max_shards: int = 8, top: int = 2,
             repeats: int = 3, kernel_dispatch: bool = True,
             device=None, devices=None) -> TuneResult:
    """Full search: hill-climb on the simulator, then (when ``inputs`` and
    ``params`` are given) wall-clock confirmation of the finalists — the
    measured winner among them becomes :attr:`TuneResult.best`; without
    IO the cheapest simulated trial wins outright."""
    trials = hillclimb(compiled, graph, start, hw=hw, max_evals=max_evals,
                       max_shards=max_shards, kernel_dispatch=kernel_dispatch)
    confirmed: List[Trial] = []
    if inputs is not None and params is not None:
        confirmed = confirm_wallclock(compiled, graph, trials, inputs, params,
                                      top=top, repeats=repeats,
                                      kernel_dispatch=kernel_dispatch,
                                      device=device, devices=devices)
        best = min(confirmed, key=lambda t: (t.wall_s, t.cycles))
    else:
        best = trials[0]
    return TuneResult(best=best, trials=trials, confirmed=confirmed,
                      n_evals=len(trials))


# ---------------------------------------------------------------------------
# cache: tuned configs by (program structure, graph class)
# ---------------------------------------------------------------------------

def program_key(compiled: C.CompiledGNN, kernel_dispatch: bool = True) -> str:
    """Stable string identity of the scheduled program the tuning ran
    against (kernel tags included, so scan and kernel tunings never alias)."""
    return repr(compiled.structure_signature(kernel_dispatch))


class TuneCache:
    """Tuned-config store keyed by (program structure, graph class).

    The value records the winning :class:`TileConfig` plus the shard-layout
    signature it realized on the representative graph — provenance that a
    consumer (or a later re-tune) can use to detect that the entry was
    produced under a different layout regime.  JSON round-trips, so a tuning
    run can be persisted next to the benchmark reports and loaded into a
    serving process."""

    def __init__(self):
        self._entries: Dict[Tuple[str, str], Dict] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _k(prog_key: str, class_key) -> Tuple[str, str]:
        return (str(prog_key), repr(class_key))

    def put(self, prog_key: str, class_key, config: TileConfig, *,
            layout_signature=None, cycles: Optional[int] = None) -> None:
        """Record (or overwrite) the winning config for a program + class,
        with optional layout-signature/cycles provenance."""
        self._entries[self._k(prog_key, class_key)] = dict(
            config=config.to_dict(),
            layout_signature=(None if layout_signature is None
                              else repr(layout_signature)),
            cycles=cycles)

    def get(self, prog_key: str, class_key) -> Optional[TileConfig]:
        """The tuned config for a program + class, or ``None`` if untuned
        (the serving engine's per-size-class lookup)."""
        e = self._entries.get(self._k(prog_key, class_key))
        return None if e is None else TileConfig.from_dict(e["config"])

    def entry(self, prog_key: str, class_key) -> Optional[Dict]:
        """The full stored record (config + provenance), or ``None``."""
        return self._entries.get(self._k(prog_key, class_key))

    # ------------------------------------------------------- persistence
    def to_json(self) -> str:
        """Serialize every entry as a sorted JSON list (stable diffs)."""
        return json.dumps(
            [dict(prog_key=pk, class_key=ck, **e)
             for (pk, ck), e in sorted(self._entries.items())], indent=1)

    @classmethod
    def from_json(cls, text: str) -> "TuneCache":
        """Rebuild a cache from :meth:`to_json` text (unknown keys kept
        out; missing provenance fields default to ``None``)."""
        out = cls()
        for row in json.loads(text):
            out._entries[(row["prog_key"], row["class_key"])] = dict(
                config=row["config"],
                layout_signature=row.get("layout_signature"),
                cycles=row.get("cycles"))
        return out

    def save(self, path: str) -> None:
        """Write :meth:`to_json` to ``path``."""
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TuneCache":
        """Read a cache previously written by :meth:`save`."""
        with open(path) as f:
            return cls.from_json(f.read())


def tune_for_class(compiled: C.CompiledGNN, graph: Graph, class_key, *,
                   cache: Optional[TuneCache] = None,
                   kernel_dispatch: bool = True, **kw) -> TuneResult:
    """Tune one graph class and record the winner in ``cache`` under the
    program + class key (the lookup the serving engine performs)."""
    from ..core.pipeline import shard_layout_signature
    from ..core import schedule as S

    result = autotune(compiled, graph, kernel_dispatch=kernel_dispatch, **kw)
    if cache is not None:
        cfg = result.best.config
        sp = compiled.schedule(kernel_dispatch)
        tags = tuple(sorted({g.kernel for ph in sp.phases
                             for g in ph.gathers} - {S.KERNEL_SCAN}))
        sig = shard_layout_signature(build_tiles(graph, cfg)[0],
                                     max(1, cfg.n_shards),
                                     mode=cfg.shard_mode,
                                     kernel_dispatch=kernel_dispatch,
                                     kernels=tags)
        cache.put(program_key(compiled, kernel_dispatch), class_key, cfg,
                  layout_signature=sig, cycles=result.best.cycles)
    return result
