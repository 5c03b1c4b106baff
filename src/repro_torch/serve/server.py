"""Asynchronous serving front-end: continuous batching under latency SLOs.

:class:`AsyncInferenceServer` turns the synchronous batch-at-a-time
:class:`~repro.serve.engine.InferenceServer` into a service loop (ROADMAP
item 1).  Individual graphs arrive via :meth:`~AsyncInferenceServer.submit`
with a per-request deadline and get a :class:`Ticket` back immediately; a
scheduler thread forms batches **by size class and deadline** — ship a
partial batch when the oldest member's slack is about to expire, fill to
the class cap otherwise — and a small worker pool overlaps the
pad/compile/run of different size classes.  The request lifecycle is
documented end to end in ``docs/SERVING.md``:

    submit -> admission control -> per-(model, size-class) queue
           -> batch former (deadline- and cap-driven)
           -> worker pool -> InferenceServer.submit (pad + cached runner)
           -> per-request tickets resolved, metrics recorded

Admission control keeps the queue bounded: when full, the configured
shed policy either rejects the new request (``reject-new``) or evicts the
globally oldest pending one (``drop-oldest``); either way the victim's
ticket resolves to a structured :class:`Overloaded` result — callers never
see an exception from the middle of the pipeline.

Multi-tenancy: several models (and layer counts) registered on one server
share one :class:`~repro.serve.cache.ProgramCache`, each under its own
eviction budget (:meth:`~repro.serve.cache.ProgramCache.set_budget`), so a
chatty tenant cannot flush another tenant's warm runners.

Background warmup (:meth:`~AsyncInferenceServer.start`) pre-compiles each
registered model's canonical shapes through the exact serving path, so the
first real request of a warmed class never pays a compile; a real request
racing the warmup for the same class blocks on the in-flight build inside
the cache and still compiles exactly once.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..core import compiler as C
from ..gnn.graphs import Graph
from .cache import ProgramCache
from .engine import InferenceServer
from .metrics import ServeMetrics
from .signature import ShapeRegistry, size_class

#: structured shed reasons (the ``Overloaded.reason`` vocabulary)
QUEUE_FULL = "queue-full"
DROPPED_OLDEST = "dropped-oldest"
DEADLINE_EXPIRED = "deadline-expired"
SHUTDOWN = "shutdown"

SHED_POLICIES = ("reject-new", "drop-oldest")
FILL_POLICIES = ("pad", "none")


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Structured admission-control result: the request was shed, not served.

    Returned through :meth:`Ticket.result` instead of raising, so a caller
    under load sees a typed, inspectable outcome (reason + queue state) and
    can retry, back off, or degrade gracefully.
    """

    #: one of ``queue-full`` / ``dropped-oldest`` / ``deadline-expired`` /
    #: ``shutdown``
    reason: str
    #: pending requests at shed time (the pressure signal)
    queue_depth: int
    model: str = ""
    message: str = ""


class Ticket:
    """Handle for one in-flight request (a minimal thread-safe future).

    Resolves exactly once — either with the request's per-output arrays,
    with a structured :class:`Overloaded`, or with an exception raised by
    the execution path (re-raised from :meth:`result`).
    """

    def __init__(self, model: str, deadline_s: float):
        """Create an unresolved ticket (done by the serving machinery)."""
        self.model = model
        self.deadline_s = deadline_s
        self.t_enqueue = time.monotonic()
        self._done = threading.Event()
        self._value: Union[None, List, Overloaded] = None
        self._exc: Optional[BaseException] = None

    # ------------------------------------------------------------ resolution
    def _resolve(self, value) -> None:
        self._value = value
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()

    # ------------------------------------------------------------ inspection
    def done(self) -> bool:
        """Whether the ticket has resolved (served, shed, or failed)."""
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until resolved (or ``timeout`` seconds); returns done()."""
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        """The request's outputs, or an :class:`Overloaded` if it was shed.

        Raises:
            TimeoutError: not resolved within ``timeout`` seconds.
            BaseException: whatever the execution path raised, re-raised
                here (never from inside the scheduler).
        """
        if not self._done.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value

    @property
    def ok(self) -> bool:
        """True once resolved with real outputs (not shed, not failed)."""
        return (self.done() and self._exc is None
                and not isinstance(self._value, Overloaded))


@dataclasses.dataclass
class _Request:
    """One queued unit of work: a graph + inputs + its ticket."""

    graph: Graph
    inputs: Dict
    ticket: Ticket
    deadline: float                   # absolute, time.monotonic() terms
    seq: int                          # admission order (drop-oldest victim key)


class _Tenant:
    """One registered model: its engine plus batching/warmup settings."""

    def __init__(self, name: str, engine: InferenceServer, max_batch: int,
                 warmup_graphs: Sequence[Graph]):
        self.name = name
        self.engine = engine
        self.max_batch = max_batch
        self.warmup_graphs = list(warmup_graphs)


class AsyncInferenceServer:
    """Continuous-batching async serving tier over cached compiled programs.

    Typical use::

        server = AsyncInferenceServer(max_queue=256, shed_policy="reject-new")
        server.register_model("gcn", compiled, params,
                              warmup_graphs=[representative_graph])
        server.start()                       # background warmup begins
        t = server.submit(graph, inputs, model="gcn", deadline_s=0.5)
        out = t.result(timeout=2.0)          # arrays, or Overloaded
        server.close()                       # graceful drain

    The scheduler ships a batch for a (model, size-class) queue when it
    reaches the model's ``max_batch`` cap, or earlier when the oldest
    member's remaining slack drops to ``dispatch_margin_s`` (the estimated
    service time) — so p99 stays bounded by the configured deadline while
    throughput comes from full batches whenever load allows.
    """

    def __init__(self, *, max_queue: int = 256,
                 shed_policy: str = "reject-new",
                 default_deadline_s: float = 2.0,
                 dispatch_margin_s: float = 0.25,
                 n_workers: int = 2,
                 cache_capacity: int = 64,
                 fill_policy: str = "pad",
                 metrics: Optional[ServeMetrics] = None):
        """Configure the serving tier (no threads start until
        :meth:`start`).

        Args:
            max_queue: bound on total pending requests across all models.
            shed_policy: ``reject-new`` (bounce the arriving request) or
                ``drop-oldest`` (evict the globally oldest pending one).
            default_deadline_s: deadline slack for requests that give none.
            dispatch_margin_s: ship a partial batch when the oldest
                member's remaining slack falls to this margin (set it near
                the expected batch service time).
            n_workers: worker threads running pad/compile/run — >1 overlaps
                size classes (and warmup with real traffic).
            cache_capacity: total entries of the shared program cache.
            fill_policy: ``pad`` duplicates the last member of a partial
                batch up to the class cap (stable canonical shapes, zero
                steady-state recompiles at any fill); ``none`` ships
                partial batches as-is (less compute, but each distinct
                quantized batch count registers its own shapes once).
            metrics: a shared :class:`~repro.serve.metrics.ServeMetrics`;
                defaults to a fresh registry.

        Raises:
            ValueError: on an unknown policy or a non-positive bound.
        """
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {shed_policy!r}")
        if fill_policy not in FILL_POLICIES:
            raise ValueError(f"fill_policy must be one of {FILL_POLICIES}, "
                             f"got {fill_policy!r}")
        if max_queue < 1 or n_workers < 1:
            raise ValueError("max_queue and n_workers must be >= 1")
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.default_deadline_s = default_deadline_s
        self.dispatch_margin_s = dispatch_margin_s
        self.n_workers = n_workers
        self.fill_policy = fill_policy
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.cache = ProgramCache(capacity=cache_capacity)
        self.shapes = ShapeRegistry()
        self._tenants: Dict[str, _Tenant] = {}
        self._queues: Dict[Tuple, List[_Request]] = {}
        self._depth = 0
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._started = False
        self._scheduler: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight = 0                 # batches handed to the pool

    # ----------------------------------------------------------- registration
    def register_model(self, name: str,
                       model: Union[str, C.CompiledGNN],
                       params: Dict, *,
                       n_layers: int = 1,
                       max_batch: int = 16,
                       cache_budget: Optional[int] = None,
                       warmup_graphs: Sequence[Graph] = (),
                       **engine_kw) -> InferenceServer:
        """Register a tenant model and build its engine over the shared cache.

        Args:
            name: tenant name — the ``model=`` key requests are routed by
                (distinct names may wrap the same model at different layer
                counts; cache keys never alias).
            model: model name or pre-compiled program (engine semantics).
            params: the tenant's weights.
            n_layers: stack depth when ``model`` is a name.
            max_batch: the tenant's batch cap per dispatched batch.
            cache_budget: max program-cache entries this tenant may hold
                (``None`` = only the global capacity bounds it).
            warmup_graphs: representative graphs whose size classes
                :meth:`start` pre-compiles in the background.
            **engine_kw: forwarded to
                :class:`~repro.serve.engine.InferenceServer`.

        Returns:
            The tenant's engine (exposed for stats/introspection).

        Raises:
            ValueError: duplicate name, bad cap, or registration after
                :meth:`close`.
        """
        with self._lock:
            if self._closed:
                raise ValueError("server is closed")
            if name in self._tenants:
                raise ValueError(f"model {name!r} already registered")
            if max_batch < 1:
                raise ValueError("max_batch must be >= 1")
        engine = InferenceServer(model, params, n_layers=n_layers,
                                 cache=self.cache, shapes=self.shapes,
                                 cache_owner=name, **engine_kw)
        if cache_budget is not None:
            self.cache.set_budget(name, cache_budget)
        tenant = _Tenant(name, engine, max_batch, warmup_graphs)
        with self._lock:
            self._tenants[name] = tenant
        return engine

    # ------------------------------------------------------------- lifecycle
    def start(self, warmup: bool = True) -> "AsyncInferenceServer":
        """Start the scheduler thread and worker pool (idempotent).

        With ``warmup=True`` every registered tenant's ``warmup_graphs``
        are pre-compiled in the background through the real serving path
        (full-cap batches, so the canonical class shapes and the compiled
        runner both land before the first real request of the class).
        """
        with self._lock:
            if self._started:
                return self
            self._started = True
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_workers,
                thread_name_prefix="serve-worker")
            self._scheduler = threading.Thread(
                target=self._scheduler_loop, name="serve-scheduler",
                daemon=True)
            self._scheduler.start()
        if warmup:
            self._launch_warmup()
        return self

    def __enter__(self) -> "AsyncInferenceServer":
        """Context-manager entry: :meth:`start` with warmup."""
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        """Context-manager exit: graceful :meth:`close`."""
        self.close()

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> None:
        """Stop the server; idempotent, safe with zero requests ever sent.

        Args:
            drain: serve everything already queued before stopping
                (``False`` sheds the backlog with reason ``shutdown``).
            timeout: max seconds to wait for the scheduler to finish
                draining (``None`` = wait for a full drain).

        New submissions after close resolve immediately as
        :class:`Overloaded` (reason ``shutdown``).
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # an unstarted server has no scheduler to drain the backlog, so
            # a "graceful" close must still resolve every pending ticket
            if not drain or not self._started:
                for q in self._queues.values():
                    for r in q:
                        self._shed_locked(r, SHUTDOWN)
                    del q[:]
                self._depth = 0
            started = self._started
            self._cond.notify_all()
        if started:
            self._scheduler.join(timeout)
            self._pool.shutdown(wait=True)

    # -------------------------------------------------------------- ingress
    def submit(self, graph: Graph, inputs: Dict, *,
               model: Optional[str] = None,
               deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue one graph; returns immediately with a :class:`Ticket`.

        Args:
            graph: the request graph.
            inputs: the model's per-graph input arrays.
            model: tenant name (optional when exactly one is registered).
            deadline_s: latency budget from now; ``None`` uses the server
                default.  A non-positive budget sheds immediately
                (``deadline-expired``) — the caller asked for an answer in
                the past.

        Returns:
            The request's ticket (already resolved when shed at admission).

        Raises:
            KeyError: unknown ``model``.
            ValueError: no model registered, or ambiguous default.
        """
        name = self._resolve_model(model)
        slack = (self.default_deadline_s if deadline_s is None
                 else float(deadline_s))
        ticket = Ticket(name, slack)
        req = _Request(graph=graph, inputs=inputs, ticket=ticket,
                       deadline=ticket.t_enqueue + slack,
                       seq=next(self._seq))
        with self._lock:
            if self._closed:
                self._shed_locked(req, SHUTDOWN)
                return ticket
            if slack <= 0:
                self._shed_locked(req, DEADLINE_EXPIRED)
                return ticket
            if self._depth >= self.max_queue:
                if self.shed_policy == "reject-new":
                    self._shed_locked(req, QUEUE_FULL)
                    return ticket
                self._drop_oldest_locked()
            key = (name, size_class(graph))
            self._queues.setdefault(key, []).append(req)
            self._depth += 1
            self.metrics.on_submit(self._depth)
            self._cond.notify_all()
        return ticket

    def submit_many(self, graphs: Sequence[Graph], inputs: Sequence[Dict],
                    **kw) -> List[Ticket]:
        """Vector :meth:`submit` — one ticket per graph, same options."""
        if len(graphs) != len(inputs):
            raise ValueError(f"{len(graphs)} graphs but {len(inputs)} inputs")
        return [self.submit(g, i, **kw) for g, i in zip(graphs, inputs)]

    # ------------------------------------------------------------ inspection
    @property
    def queue_depth(self) -> int:
        """Pending (admitted, not yet dispatched) requests right now."""
        with self._lock:
            return self._depth

    def stats(self) -> Dict:
        """Aggregated serving state: metrics snapshot, per-tenant engine
        stats, shared-cache counters and per-owner entry counts."""
        with self._lock:
            tenants = dict(self._tenants)
            depth = self._depth
        return dict(queue_depth=depth,
                    metrics=self.metrics.snapshot(),
                    cache=dict(self.cache.stats.as_dict(),
                               size=len(self.cache),
                               owners=self.cache.owner_counts()),
                    models={n: t.engine.stats() for n, t in tenants.items()})

    # ---------------------------------------------------------- shed helpers
    def _resolve_model(self, model: Optional[str]) -> str:
        with self._lock:
            if model is not None:
                if model not in self._tenants:
                    raise KeyError(f"model {model!r} not registered "
                                   f"(have {sorted(self._tenants)})")
                return model
            if len(self._tenants) == 1:
                return next(iter(self._tenants))
            raise ValueError(
                "model= is required when zero or several models are "
                f"registered (have {sorted(self._tenants)})")

    def _shed_locked(self, req: _Request, reason: str) -> None:
        self.metrics.on_shed(reason)
        req.ticket._resolve(Overloaded(
            reason=reason, queue_depth=self._depth, model=req.ticket.model,
            message=f"request shed at admission/queue ({reason})"))

    def _drop_oldest_locked(self) -> None:
        """Evict the globally oldest pending request (drop-oldest policy)."""
        oldest_key, oldest_idx, oldest_seq = None, -1, None
        for key, q in self._queues.items():
            for i, r in enumerate(q):
                if oldest_seq is None or r.seq < oldest_seq:
                    oldest_key, oldest_idx, oldest_seq = key, i, r.seq
        if oldest_seq is None:           # queue bound hit with nothing queued
            return
        victim = self._queues[oldest_key].pop(oldest_idx)
        self._depth -= 1
        self._shed_locked(victim, DROPPED_OLDEST)

    # -------------------------------------------------------------- scheduler
    def _scheduler_loop(self) -> None:
        """Batch former: runs until closed and (when draining) drained."""
        while True:
            batches: List[Tuple[_Tenant, List[_Request]]] = []
            with self._lock:
                while True:
                    now = time.monotonic()
                    batches = self._form_batches_locked(now)
                    if batches:
                        break
                    if self._closed and self._depth == 0:
                        return
                    self._cond.wait(timeout=self._wake_in_locked(now))
            for tenant, reqs in batches:
                live = self._expire_batch(reqs)
                if not live:
                    continue
                with self._lock:
                    self._inflight += 1
                self._pool.submit(self._run_batch, tenant, live)

    def _form_batches_locked(self, now: float
                             ) -> List[Tuple[_Tenant, List[_Request]]]:
        """Pop every group that is ripe: full to its cap, deadline-pressed,
        or unconditionally when the server is draining for shutdown."""
        out: List[Tuple[_Tenant, List[_Request]]] = []
        for key in list(self._queues):
            q = self._queues[key]
            if not q:
                del self._queues[key]
                continue
            tenant = self._tenants[key[0]]
            ripe = (len(q) >= tenant.max_batch
                    or self._closed
                    or min(r.deadline for r in q) - now
                    <= self.dispatch_margin_s)
            if not ripe:
                continue
            take = q[:tenant.max_batch]
            self._queues[key] = q[tenant.max_batch:]
            self._depth -= len(take)
            self.metrics.on_batch(len(take), tenant.max_batch, self._depth)
            out.append((tenant, take))
        return out

    def _wake_in_locked(self, now: float) -> float:
        """Sleep until the next deadline gets margin-close (bounded 0.5s)."""
        soonest = min((r.deadline for q in self._queues.values() for r in q),
                      default=now + 0.5)
        return min(max(soonest - self.dispatch_margin_s - now, 0.001), 0.5)

    def _expire_batch(self, reqs: List[_Request]) -> List[_Request]:
        """Shed members whose deadline already passed; keep the rest."""
        now = time.monotonic()
        live: List[_Request] = []
        for r in reqs:
            if r.deadline < now:
                with self._lock:
                    self._shed_locked(r, DEADLINE_EXPIRED)
            else:
                live.append(r)
        return live

    # ---------------------------------------------------------------- worker
    def _run_batch(self, tenant: _Tenant, reqs: List[_Request]) -> None:
        """Worker-pool body: pad/fill, run the engine, resolve tickets."""
        try:
            graphs = [r.graph for r in reqs]
            inputs = [r.inputs for r in reqs]
            t_dispatch = time.monotonic()
            if self.fill_policy == "pad" and len(graphs) < tenant.max_batch:
                # duplicate the last member up to the cap: the quantized
                # batch count — hence the canonical class shapes — stays
                # identical for every fill level, so partial batches can
                # never trigger a steady-state recompile
                fill = tenant.max_batch - len(graphs)
                graphs = graphs + [graphs[-1]] * fill
                inputs = inputs + [inputs[-1]] * fill
            outs = tenant.engine.submit(graphs, inputs)
            now = time.monotonic()
            for r, out in zip(reqs, outs):
                self.metrics.on_complete(
                    now - r.ticket.t_enqueue, t_dispatch - r.ticket.t_enqueue)
                r.ticket._resolve(out)
        except BaseException as exc:      # surfaced via ticket.result()
            for r in reqs:
                if not r.ticket.done():
                    r.ticket._fail(exc)
        finally:
            with self._lock:
                self._inflight -= 1
                self._cond.notify_all()

    # ---------------------------------------------------------------- warmup
    def _launch_warmup(self) -> None:
        """Queue one background warmup task per (tenant, warmup graph)."""
        specs: List[Tuple[_Tenant, Graph]] = []
        with self._lock:
            for tenant in self._tenants.values():
                for g in tenant.warmup_graphs:
                    specs.append((tenant, g))
        if not specs:
            return
        total = len(specs)
        self.metrics.on_warmup(0, total)
        done = itertools.count(1)

        def _one(tenant: _Tenant, g: Graph) -> None:
            self._warm_class(tenant, g)
            self.metrics.on_warmup(next(done), total)

        for tenant, g in specs:
            self._pool.submit(_one, tenant, g)

    def _warm_class(self, tenant: _Tenant, graph: Graph) -> None:
        """Compile one size class by serving a synthetic full-cap batch.

        Runs the *real* path (register canonical shapes, build + jit the
        runner, execute once), so the class is warm in every layer the
        first genuine request will touch.  Failures are swallowed after
        being counted — warmup must never take the serving loop down.
        """
        from ..gnn import models as M

        try:
            inputs = M.init_inputs(tenant.engine.compiled.trace, graph)
            n = tenant.max_batch if self.fill_policy == "pad" else 1
            tenant.engine.submit([graph] * n, [inputs] * n)
        except Exception:
            self.metrics.on_shed("warmup-failed")

    def warmup_done(self) -> bool:
        """Whether every background warmup task has finished."""
        snap = self.metrics.snapshot()["warmup"]
        return snap["done"] >= snap["total"]
