"""Fault tolerance and elastic scaling logic.

At 1000+ nodes the relevant machinery is:

* **failure detection** — heartbeat registry with a timeout; on a real
  cluster heartbeats arrive over the control plane, here they are injected
  by tests (the *logic* — who is declared dead, when — is what we own);
* **elastic re-mesh** — given the surviving host set, compute the largest
  usable (data × model) mesh, a deterministic host→coordinate assignment,
  and the checkpoint-resharding plan.  Restore runs through
  ``checkpointing.restore_checkpoint`` with the new mesh's shardings: the
  checkpoint stores full logical arrays, so *any* smaller mesh can resume;
* **straggler mitigation** — the data pipeline is a pure function of
  (seed, step, shard), so re-assigning a straggler's shard to a spare is a
  table update (``reassign_shards``), not a data migration.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class FailureDetector:
    """Heartbeat timeout detector (control-plane logic)."""

    timeout_s: float = 30.0
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)

    def heartbeat(self, host: int, now: Optional[float] = None):
        self._last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items() if now - t > self.timeout_s)

    def alive_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items() if now - t <= self.timeout_s)


@dataclasses.dataclass
class ElasticPlan:
    data: int                      # new data-axis size
    model: int                     # new model-axis size (kept fixed: TP is
                                   # topology-bound inside a host/板)
    host_of_coord: Dict[Tuple[int, int], int]
    dropped_hosts: List[int]
    note: str = ""

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def plan_remesh(alive: Sequence[int], *, devices_per_host: int = 4,
                model: int = 16) -> ElasticPlan:
    """Largest (data × model) mesh the survivors can form.

    The model axis is preserved (TP segments must stay within their ICI
    domain); the data axis shrinks to the largest multiple the surviving
    device count supports.  Host→coordinate assignment is deterministic in
    the sorted survivor order, so every host derives the same plan without
    coordination.
    """
    alive = sorted(alive)
    total = len(alive) * devices_per_host
    if total < model:
        raise RuntimeError(f"not enough devices ({total}) for model={model}")
    data = total // model
    # deterministic snake assignment of hosts to mesh rows
    host_of_coord: Dict[Tuple[int, int], int] = {}
    flat = 0
    for d in range(data):
        for m in range(model):
            host_of_coord[(d, m)] = alive[(flat // devices_per_host) % len(alive)]
            flat += 1
    return ElasticPlan(data=data, model=model, host_of_coord=host_of_coord,
                       dropped_hosts=[],
                       note=f"{len(alive)} hosts -> mesh ({data},{model})")


def reassign_shards(step: int, n_shards: int, alive: Sequence[int],
                    stragglers: Sequence[int] = ()) -> Dict[int, int]:
    """shard -> host map; stragglers' shards move to the fastest survivors.

    Deterministic in (step, survivor set): every host computes the same map.
    """
    workers = [h for h in sorted(alive) if h not in set(stragglers)]
    if not workers:
        raise RuntimeError("no healthy workers")
    return {s: workers[(s + step) % len(workers)] for s in range(n_shards)}
